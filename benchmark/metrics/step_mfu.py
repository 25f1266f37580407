"""The whole decode step's share of the chip's peak, in roofline form
(decode at M <= 2 is bound by bytes): the least time the card could take
for every row or step the server decoded for the window's requests (each
from the configuration's shapes and format at its live position:
models/<m>.py `row_bound_s`), over the time the decode loops took, summed
over the server's `decode` spans, the loops that ran those rows (%).  The
prefill or encoder, the DAC, WAV encoding and HTTP lie outside it."""


def read(ctx):
    server = ctx["server"]
    loops_s = sum(t1 - t0 for name, t0, t1 in server["spans"] if name == "decode") * 1e-9
    if loops_s <= 0:
        return None
    model, cfg = ctx["model"], ctx["cfg"]
    work = sum(model.row_bound_s(cfg, pos) for rec in server["served"].values()
               for pos in model.decode_positions(rec))
    return 100.0 * work / loops_s
