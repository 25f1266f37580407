"""90th percentile, over every request due in the window, of (last byte
minus due time) / the request's audio seconds; below 1 is faster than real
time.  A failed request counts as missing."""

from benchlib.latency import percentile, rtf


def read(ctx):
    return percentile([rtf(ctx, r) for r in ctx["requests"]], 90)
