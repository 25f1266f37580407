"""Seconds of audio in the requests completed in the window, over the
seconds from the window's start to the last completion (the closed loop
sends its first request at the window's start)."""

from benchlib.latency import completed


def read(ctx):
    done = completed(ctx)
    if not done:
        return 0.0
    return sum(r["audio_s"] for r in done) / (max(r["t_done"] for r in done) - ctx["t0"])
