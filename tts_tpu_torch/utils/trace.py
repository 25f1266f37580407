"""Stage-trace helpers: summaries of logits that a runner records when its
`capture_trace` is set (prompt ids, step-0 logit statistics, the head of the
token stream, the first codec frames), enough to place a mismatch with a
reference in the front end, prefill, decode or codec.

The port's own copy of `tts_tpu/utils/trace.py`, plus `profile_request`:
the card's own attribution of one request (device kernels, busy time and
share) under torch.profiler, which `bench_torch.py` and `chip_smoke.py`
report; and the port's span recorder.

Spans: `enable()` starts a recording, `drain()` hands over what it holds,
`disable()` stops it (off is the default).  A span site calls
`span(name)`: with the recorder off that is one global check and the
shared `NOOP`, which reads no clock and allocates nothing.  A span is
ended once, by leaving its `with` block (which also makes it the
thread's current span, the default parent of spans opened inside it) or
by `end()`, from any thread: the server opens a request's `wait` on the
handler's thread and ends it on the worker's.  Spans are stamped with
`time.perf_counter_ns()`; `enable()` takes one (perf_counter_ns, time_ns)
pair, which places them on the Unix clock that torch.profiler's Chrome
trace uses (`baseTimeNanoseconds + ts * 1000`).  The port records:

  http     apps/server.py's handler, from the parsed body to the last byte
           written; its request id is the task id; a PCM stream's carries
           `t_first_ns` (the handler took the first chunk) and `samples`
  wait     child of http: the task put, to the runner's lock held
  service  child of http: the runner's lock held, to its release;
           `t_first_ns`: the first chunk (or the whole audio) handed over
  decode   runtime/step_graph.py::read_behind, one per decode-loop call,
           child of the thread's current span: `rows`, `attn_launches`
           (the `prefix_attention` launches of the loop's steps), and on a
           card `device_ns` (the first step's start to the last read
           step's end, on the device) and `idle_ns` (the device time
           between one step's end and the next one's start, summed)
"""

from __future__ import annotations

import itertools
import json
import math
import os
import tempfile
import threading
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


# ---- the span recorder

CAP = 1 << 16            # records kept until a drain; past it, spans are counted as dropped

_on = False
_lock = threading.Lock()
_records: list = []
_dropped = 0
_clock: dict | None = None
_ids = itertools.count(1)
_local = threading.local()


class _Noop:
    """The span every site gets while the recorder is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value: int):
        pass

    def stamp(self, key: str):
        pass

    def end(self, end_ns: int | None = None):
        pass


NOOP = _Noop()


class Span:
    """An open span.  `set` and `stamp` put integer counters on it; `end`
    records it once (a later `end` does nothing)."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "counters", "_outer")

    def __init__(self, name: str, parent, request, start_ns: int | None):
        if request is None and parent is not None:
            request = parent.request
        self.name, self.id, self.request = name, next(_ids), request
        self.parent = None if parent is None else parent.id
        self.start_ns = time.perf_counter_ns() if start_ns is None else start_ns
        self.end_ns = None
        self.counters: dict = {}

    def set(self, key: str, value: int):
        self.counters[key] = int(value)

    def stamp(self, key: str):
        """The clock now under `key`, the first time only."""
        if key not in self.counters:
            self.counters[key] = time.perf_counter_ns()

    def end(self, end_ns: int | None = None):
        global _dropped
        if self.end_ns is not None:
            return
        self.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
        rec = {"name": self.name, "id": self.id, "parent": self.parent, "request": self.request,
               "start_ns": self.start_ns, "end_ns": self.end_ns, "counters": self.counters}
        with _lock:
            if not _on:
                return
            if len(_records) < CAP:
                _records.append(rec)
            else:
                _dropped += 1

    def __enter__(self):
        self._outer = getattr(_local, "span", None)
        _local.span = self
        return self

    def __exit__(self, *exc):
        _local.span = self._outer
        self.end()
        return False


def span(name: str, parent=None, request: str | None = None, start_ns: int | None = None):
    """Open a span named `name`, from `start_ns` (perf_counter_ns; now by
    default).  `parent` defaults to the thread's current span; a parent
    that is `NOOP` (opened while the recorder was off) gives `NOOP`.
    `request` defaults to the parent's."""
    if not _on:
        return NOOP
    if parent is None:
        parent = getattr(_local, "span", None)
    elif parent is NOOP:
        return NOOP
    return Span(name, parent, request, start_ns)


def enable():
    """Start a new recording (what an earlier one held is dropped) and take
    the clock pair."""
    global _on, _records, _dropped, _clock
    with _lock:
        _records, _dropped = [], 0
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        _clock = {"perf_counter_ns": (a + b) // 2, "time_ns": unix}
        _on = True


def disable():
    """Stop recording: spans that end from now on are not kept."""
    global _on
    with _lock:
        _on = False


def drain() -> dict:
    """Hand over the spans recorded since `enable()` or the last drain and
    clear them: {"clock": {"perf_counter_ns", "time_ns"} (None if never
    enabled), "spans": [{"name", "id", "parent", "request", "start_ns",
    "end_ns", "counters"}, ...] in the order they ended, "dropped": the
    spans past CAP}."""
    global _records, _dropped
    with _lock:
        out = {"clock": _clock, "spans": _records, "dropped": _dropped}
        _records, _dropped = [], 0
    return out
