"""Stage-trace helpers: summaries of logits that a runner records when its
`capture_trace` is set (prompt ids, step-0 logit statistics, the head of the
token stream, the first codec frames), enough to place a mismatch with a
reference in the front end, prefill, decode or codec.

The port's own copy of `tts_tpu/utils/trace.py`, plus `profile_request`:
the card's own attribution of one request (device kernels, busy time and
share) under torch.profiler, which `bench_torch.py` and `chip_smoke.py`
report.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time

import numpy as np


def logit_stats(row: np.ndarray, top: int = 5) -> dict:
    """Summary statistics of one logits row [V] (finite entries only:
    models mask invalid ids to -inf)."""
    row = np.asarray(row, np.float64)
    finite = row[np.isfinite(row)]
    order = np.argsort(row)[::-1][:top]
    return {
        "min": float(finite.min()) if len(finite) else 0.0,
        "max": float(finite.max()) if len(finite) else 0.0,
        "mean": float(finite.mean()) if len(finite) else 0.0,
        "argmax": int(row.argmax()),
        "top_ids": [int(i) for i in order],
        "top_logits": [round(float(row[i]), 4) for i in order],
    }


def multihead_logit_stats(mat: np.ndarray) -> dict:
    """Per-head argmax and head 0's detail for [H, V] logits (Parler's
    parallel codebook heads)."""
    mat = np.asarray(mat, np.float64)
    return {
        "per_head_argmax": [int(i) for i in mat.argmax(axis=-1)],
        "head0": logit_stats(mat[0]),
    }


def profile_request(runner, text: str, config, trace_path: str | None = None) -> dict:
    """One warm request on a card under torch.profiler: the time during
    which some kernel ran on the device (kernel intervals merged), as a
    share of the profiled wall and of the same request's wall unprofiled
    just before (the median of three; the profiler's own cost lengthens
    the first), the device kernels it ran, and the ten with the most
    device time.  The Chrome trace is written to `trace_path`, or to a
    temporary file that is removed.  Raises RuntimeError if the profiler
    recorded no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.generate(text, config)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        resp = runner.generate(text, config)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    keep = trace_path is not None
    if not keep:
        fd, trace_path = tempfile.mkstemp(suffix=".json", prefix="profile_request_")
        os.close(fd)
    try:
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if not keep:
            os.remove(trace_path)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernel")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"request": text, "wall_ms": wall_ms, "unprofiled_wall_ms": plain_ms,
            "audio_s": resp.duration_s, "device_kernels": len(kernels),
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e3 / wall_ms,
            "device_busy_share_of_unprofiled_wall": busy / 1e3 / plain_ms,
            "first_to_last_kernel_ms": (end - spans[0][0]) / 1e3,
            "top_kernels": [{"name": n[:120], "calls": c, "device_ms": t / 1e3}
                            for n, (c, t) in top]}
