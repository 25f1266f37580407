"""What the end-to-end readers share: which requests count, and their
latencies from the time each was due (so a stall's wait on the requests
behind it counts)."""

from __future__ import annotations

import math


def missed_s(ctx: dict, r: dict) -> float:
    """A failed request counts as missing every latency limit: it is given
    the longest wait the run allowed it (to the drain's deadline)."""
    return ctx["t1"] + ctx["drain_s"] - r["due_abs"]


def ttfa_s(ctx: dict, r: dict) -> float:
    """First audio byte minus the time the request was due."""
    return r["t_first"] - r["due_abs"] if r["ok"] else missed_s(ctx, r)


def rtf(ctx: dict, r: dict) -> float:
    """(last byte minus due time) over the audio it asked for."""
    end = r["t_done"] - r["due_abs"] if r["ok"] else missed_s(ctx, r)
    return end / r["audio_s"]


def percentile(values: list, q: float) -> float | None:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def completed(ctx: dict) -> list:
    """Requests that completed, correct in size, inside the window."""
    return [r for r in ctx["requests"] if r["ok"] and r["t_done"] <= ctx["t1"]]
