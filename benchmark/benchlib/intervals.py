"""Kernel intervals merged into busy time, and the idle gaps between them:
the interval arithmetic of the port's `utils/trace.py::profile_request`,
kept here so that the yardstick does not move with the program."""

from __future__ import annotations


def merge(spans) -> list[tuple[float, float]]:
    """(start, end) pairs -> disjoint sorted intervals covering the same set."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(spans, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of spans, clipped to [lo, hi] where given."""
    total = 0.0
    for a, b in merge(spans):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        total += max(0.0, b - a)
    return total


def gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] that no span covers."""
    out, t = [], lo
    for a, b in merge(spans):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]
