"""The median of the same time to first audio as ttfa_p90_ms: the
first-chunk path (prefill or encoder, 48 rows, the first DAC window) with
little queueing, beside the tail the end-to-end metric judges."""

from benchlib.latency import percentile, ttfa_s


def read(ctx):
    return percentile([ttfa_s(ctx, r) * 1e3 for r in ctx["requests"]], 50)
