#!/usr/bin/env python3
"""Device time of the decode GEMVs, qgemv_int8 and qgemv_int4, of the
tts_tpu_torch package beside this script, at the five Orpheus-3B linears:
x in bf16 as the decode layers pass it, and at the lm_head also in f32 as
the head passes it; and at Parler-TTS mini v1's three (attn, fc1, fc2) on
f32 x, as its decode step passes it.  Timed as chip_smoke.py phase 3
times them (CUDA-graph replays, weights rotated past the L2), with
torch._weight_int4pack_mm on the same int4 weights and x as the
yardstick, after half a second of matrix products that let the clocks
settle; each shape is timed twice over and the second round kept.  The
kernel is timed first in each round, and a function timed first read
0.2-0.8 us more on an H100 than the same function timed last: compare a
row with the same row of another checkout, not with its alternatives.
Each row also counts the device kernels one call runs
(_ext.device_activity).

    python3 gemv_timing.py [LABEL] [--alternatives]

It imports chip_smoke and tts_tpu_torch from its own directory, so a copy
placed in another checkout times that checkout's kernels with the same
harness.  To compare a parent commit with a change on one card, run both
in one call, in turns: parent, change, change, parent.  --alternatives
(this checkout only) also times other geometries of the same kernel
beside gemv_plan's: for a call that takes the cluster instance, other K
splits, to at most one CTA per SM (the plan's rule for layers whose column
tiles do not fill the card), half and twice that, and to at least one CTA
per SM; for a call that takes the small-call instance, its column tiles
of 8 to 64 at 128, 256 and 512 threads a CTA, and the cluster instance as
its own plan would launch it.
Prints one JSON line: {"label", "card", "rows": [{"kernel", "shape", "x",
"us", "library_us", "device_kernels", "alternatives"}]}; needs one card.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402


def geometries(K: int, N: int, sms: int, packed: bool) -> dict:
    """{label: GemvPlan}.  The cluster instance: K split in a power of two
    up to 8 ways, to at most (le) or at least (ge) one CTA per SM, and half
    and twice the former.  The small-call instance: column tiles of 8-64 at
    128, 256 or 512 threads a CTA (each thread 4 columns and a power of two
    of rows, at most 32), and the cluster instance's own plan."""
    from tts_tpu_torch.ops import _ext
    from tts_tpu_torch.ops import qmatmul as tq

    nblk = K // (64 if packed else 32)
    if tq.gemv_plan(K, N, sms, packed).rows:
        rows = K // (2 if packed else 1)
        alts = {}
        for tile_n in (8, 16, 32, 64):
            for threads in (128, 256, 512):
                r = tile_n // 4 * rows // threads
                if r in (1, 2, 4, 8, 16, 32) and r * threads == tile_n // 4 * rows:
                    alts[f"tile {tile_n} x {threads} threads"] = tq.GemvPlan(tile_n, 1, nblk, r)
        alts["cluster"] = tq._gemv_cluster_plan(K, N, sms, packed)
        return alts

    def cluster(splits):
        per = -(-nblk // splits)
        return tq.GemvPlan(_ext.GEOMETRY["GEMV_TILE_N"], -(-nblk // per), per, 0)

    tiles = -(-N // _ext.GEOMETRY["GEMV_TILE_N"])
    le = ge = 1
    while 2 * le <= min(8, nblk) and 2 * le * tiles <= sms:
        le *= 2
    while ge < min(8, nblk) and ge * tiles < sms:
        ge *= 2
    return {"<=1 CTA/SM": cluster(le), ">=1 CTA/SM": cluster(ge), "half": cluster(max(1, le // 2)),
            "twice": cluster(min(2 * le, 8, nblk))}


def main() -> int:
    card = cs.environment()
    import torch

    from tts_tpu_torch.ops import _ext
    from tts_tpu_torch.ops import qmatmul as tq

    cs.build()
    dev = torch.device("cuda")
    sms = _ext.sm_count(0)
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(200):                # ~0.5 s of work: the clocks settle first
        a @ a
    torch.cuda.synchronize()
    rows = []
    shapes = [(name, K, N, (torch.bfloat16,) + (torch.float32,) * (name == "lm_head"))
              for name, (K, N) in cs.LINEAR_SHAPES.items()]
    shapes += [(f"parler {name}", K, N, (torch.float32,))
               for name, (K, N) in cs.PARLER_SHAPES.items()]
    for bits, fn in ((8, tq.qgemv_int8), (4, tq.qgemv_int4)):
        for i, (name, K, N, xdtypes) in enumerate(shapes):
            ws = cs.rotating_weights(K, N, dev, i + bits, int4=bits == 4)
            for xdtype in xdtypes:
                x = torch.randn((1, K), device=dev).to(xdtype)
                fns = {"kernel": lambda j: fn(x, *ws[j % len(ws)])}
                if bits == 4:
                    lib_ws = [cs.int4_library_weight(*w) for w in ws]
                    xb = x.bfloat16()
                    fns["library"] = lambda j: torch._weight_int4pack_mm(
                        xb, lib_ws[j % len(lib_ws)][0], 32, lib_ws[j % len(lib_ws)][1])
                alts = {}
                if "--alternatives" in sys.argv:
                    alts = geometries(K, N, sms, bits == 4)
                    for geo, plan in alts.items():
                        fns[geo] = launch(_ext, fn.__name__, x, ws, plan)
                kernels = len(_ext.device_activity(lambda: fn(x, *ws[0])))
                cs.timed(fns, {k: 20 for k in fns})        # a first round, not kept
                t = cs.timed(fns, {k: 20 for k in fns})
                rows.append({"kernel": fn.__name__, "shape": name, "x": str(xdtype)[6:],
                             "us": t["kernel"] * 1e3,
                             "library_us": t["library"] * 1e3 if "library" in t else None,
                             "device_kernels": kernels,
                             "alternatives": {k: [list(alts[k]), t[k] * 1e3] for k in alts}})
                alt = "".join(f"  {k} {t[k] * 1e3:.2f}" for k in alts)
                print(f"{fn.__name__} {name:13s} x={rows[-1]['x']:8s} {rows[-1]['us']:8.2f} us  "
                      f"{kernels} device kernels{alt}", flush=True)
            del ws
    label = next((arg for arg in sys.argv[1:] if not arg.startswith("--")),
                 os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps({"label": label, "card": card, "rows": rows}))
    return 0


def launch(_ext, name, x, ws, plan):
    """fn(j): the kernel of `name` on weights ws[j % len] with the geometry
    `plan` (a GemvPlan) in place of gemv_plan's."""
    import torch

    lib = _ext.load()
    K, N = x.shape[1], ws[0][0].shape[1]
    outs = [torch.empty((1, N), device=x.device) for _ in ws]

    def run(j):
        w, sc = ws[j % len(ws)]
        out = outs[j % len(ws)]
        _ext.check(name, getattr(lib, name)(x.data_ptr(), x.dtype == torch.float32, w.data_ptr(),
                                            sc.data_ptr(), out.data_ptr(), K, N, *plan,
                                            _ext.stream_ptr(x)))
        return out
    return run


if __name__ == "__main__":
    sys.exit(main())
