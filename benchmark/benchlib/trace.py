"""The traced slice's device operations, read from torch.profiler's Chrome
trace: busy time, the operations with the most time, and the longest idle
gaps named by what the server's host was doing then."""

from __future__ import annotations

import json

from benchlib import intervals

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list[tuple[str, str, float, float]]:
    """(category, name, start us, duration us) of every device operation."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["cat"], e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def summarize(ops, window_s: float, ns_on: int, host_spans) -> dict:
    """Busy seconds of the slice [first op, first op + window_s], the ops
    inside it, and the breakdown: the ten names with the most device time
    and the ten longest idle gaps, each named by the innermost host span
    (wall-clock ns, aligned so that the slice starts at ns_on) around it."""
    if not ops:
        return {"ops": [], "busy_s": 0.0, "window_s": window_s,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo = min(o[2] for o in ops)
    hi = lo + window_s * 1e6
    inside = [o for o in ops if o[2] < hi]
    spans = [(o[2], o[2] + o[3]) for o in inside]
    by_name: dict = {}
    for _, name, _, dur in inside:
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(intervals.gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]

    def label(a, b):
        t = ns_on + ((a + b) / 2 - lo) * 1e3
        around = [s for s in host_spans if s[1] <= t <= s[2]]
        return min(around, key=lambda s: s[2] - s[1])[0] if around else "server"

    return {"ops": inside, "busy_s": intervals.busy(spans, lo, hi) / 1e6, "window_s": window_s,
            "breakdown": {"device_ops": [[n[:120], t / 1e6] for n, t in top],
                          "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in gaps]}}
