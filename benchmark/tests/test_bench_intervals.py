"""The kernel-interval arithmetic against a brute-force sweep of unit cells."""

from __future__ import annotations

import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib import intervals  # noqa: E402


@pytest.mark.parametrize("seed", range(20))
def test_merge_busy_and_gaps_equal_a_sweep(seed):
    rng = random.Random(seed)
    spans = []
    for _ in range(rng.randrange(0, 30)):
        a = rng.randrange(0, 200)
        spans.append((a, a + rng.randrange(0, 25)))
    lo, hi = rng.randrange(0, 50), rng.randrange(150, 260)
    covered = [any(a <= t < b for a, b in spans) for t in range(0, 300)]
    merged = intervals.merge(spans)
    assert all(b1 < a2 for (_, b1), (a2, _) in zip(merged, merged[1:]))
    assert [any(a <= t < b for a, b in merged) for t in range(300)] == covered
    assert intervals.busy(spans, lo, hi) == sum(covered[lo:hi])
    gaps = intervals.gaps(spans, lo, hi)
    idle = [lo <= t < hi and not covered[t] for t in range(300)]
    assert [any(a <= t < b for a, b in gaps) for t in range(300)] == idle
