#!/usr/bin/env python3
"""Device time of the prefill GEMMs, qgemm_int8 and qgemm_int4, of the
tts_tpu_torch package beside this script, at the four Orpheus-3B linears the
prefill runs (qkv, o, gateup, down) and at M = 8, 32, 52 and 64 (an 8-token
verify step, and the prompt lengths of chip_smoke.py's requests): x in
bf16, as the prefill's layers pass it, and in f32.  Timed as chip_smoke.py
phase 3 times them (CUDA-graph replays, weights rotated past the L2), with
torch._weight_int4pack_mm on the same int4 weights and bf16 x as the
yardstick, after half a second of matrix products that let the clocks
settle; each shape is timed twice over and the second round kept.  Each row
also counts the device kernels one call runs.

    python3 gemm_timing.py [LABEL]

It imports chip_smoke and tts_tpu_torch from its own directory, so a copy
placed in another checkout times that checkout's kernels through that
checkout's wrappers (a wrapper that casts bf16 x to f32 is timed with its
cast).  To compare a parent commit with a change on one card, run both in
one call, in turns: parent, change, change, parent.
Prints one JSON line: {"label", "card", "rows": [{"kernel", "shape", "M",
"x", "us", "library_us", "device_kernels"}]}; needs one card.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

SHAPES = ("qkv", "o", "gateup", "down")
GEMM_M = (8, 32, 52, 64)


def main() -> int:
    card = cs.environment()
    import torch

    from tts_tpu_torch.ops import _ext
    from tts_tpu_torch.ops import qmatmul as tq

    cs.build()
    dev = torch.device("cuda")
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(200):                # ~0.5 s of work: the clocks settle first
        a @ a
    torch.cuda.synchronize()
    rows = []
    for bits, fn in ((8, tq.qgemm_int8), (4, tq.qgemm_int4)):
        for i, name in enumerate(SHAPES):
            K, N = cs.LINEAR_SHAPES[name]
            ws = cs.rotating_weights(K, N, dev, 100 + i + bits, int4=bits == 4)
            lib_ws = [cs.int4_library_weight(*w) for w in ws] if bits == 4 else []
            for M in GEMM_M:
                for xdtype in (torch.bfloat16, torch.float32):
                    x = torch.randn((M, K), device=dev).to(xdtype)
                    fns = {"kernel": lambda j: fn(x, *ws[j % len(ws)])}
                    if bits == 4:
                        xb = x.bfloat16()
                        fns["library"] = lambda j: torch._weight_int4pack_mm(
                            xb, lib_ws[j % len(lib_ws)][0], 32, lib_ws[j % len(lib_ws)][1])
                    kernels = len(_ext.device_activity(lambda: fn(x, *ws[0])))
                    cs.timed(fns, {k: 30 for k in fns})        # a first round, not kept
                    t = cs.timed(fns, {k: 30 for k in fns})
                    rows.append({"kernel": fn.__name__, "shape": name, "M": M,
                                 "x": str(xdtype)[6:], "us": t["kernel"] * 1e3,
                                 "library_us": t["library"] * 1e3 if "library" in t else None,
                                 "device_kernels": kernels})
                    print(f"{fn.__name__} {name:7s} M={M:3d} x={rows[-1]['x']:8s} "
                          f"{rows[-1]['us']:8.2f} us  {kernels} device kernels", flush=True)
            del ws, lib_ws
    label = next((arg for arg in sys.argv[1:] if not arg.startswith("--")),
                 os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps({"label": label, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
