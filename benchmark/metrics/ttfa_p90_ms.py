"""90th percentile, over every request due in the window, of its first
audio byte minus its due time (ms); a failed request counts as missing."""

from benchlib.latency import percentile, ttfa_s


def read(ctx):
    return percentile([ttfa_s(ctx, r) * 1e3 for r in ctx["requests"]], 90)
