"""The port's span recorder (`tts_tpu_torch/utils/trace.py`): off by default
and free there, its spans nested across the server's handler and worker
threads, the runner lock's wait, the decode loop's rows, the first chunk of
a Parler stream, and (on a card) its clock against torch.profiler's.  The
file imports no jax; its card test runs where only the port does:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request

import pytest
import torch

from tts_tpu_torch.apps import server as srv
from tts_tpu_torch.runtime.api import GenerationConfig
from tts_tpu_torch.runtime.step_graph import CapturedStep, read_behind
from tts_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The recorder on for one test, and off (and empty) after it."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


@pytest.fixture
def serve():
    """serve(models, n_parallelism) -> (port, state) of a running server on
    the CPU; every server is stopped at the end."""
    running = []

    def start(models, n_parallelism=1):
        state = srv.ServerState(models, GenerationConfig(), n_parallelism, device="cpu")
        server = srv.make_server(state, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        running.append((server, state))
        return server.server_address[1], state

    yield start
    for server, state in running:
        server.shutdown()
        server.server_close()
        srv.stop_workers(state)


def post(port: int, body: dict) -> bytes:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/audio/speech",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def collect(n_http: int) -> list:
    """Drain until `n_http` http spans are in: a handler ends its span after
    the client has read the last byte."""
    spans: list = []
    deadline = time.monotonic() + 30
    while len(by_name(spans, "http")) < n_http and time.monotonic() < deadline:
        spans += trace.drain()["spans"]
        time.sleep(0.01)
    return spans


def by_name(spans: list, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def children(spans: list, parent: dict) -> dict:
    return {s["name"]: s for s in spans if s["parent"] == parent["id"]}


class Counter(CapturedStep):
    """A CPU step whose output slot counts its runs."""

    def __init__(self):
        super().__init__("cpu", None)
        self.buf = torch.zeros(3, dtype=torch.int32)

    def _step(self):
        self.buf += 1


def test_off_sites_return_the_shared_noop_and_record_nothing(monkeypatch):
    assert trace.span("http", request="r") is trace.NOOP
    trace.enable()
    trace.disable()
    trace.drain()

    def no_clock():
        raise AssertionError("a span site read the clock with the recorder off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    with trace.span("service") as s:
        assert s is trace.NOOP
        s.set("rows", 3)
        s.stamp("t_first_ns")
        assert trace.span("decode") is trace.NOOP
    trace.span("wait").end()
    rows = [r.clone() for r in read_behind(Counter(), 4, 1)]
    assert [int(r[0]) for r in rows] == [1, 2, 3, 4]
    out = trace.drain()
    assert out["spans"] == [] and out["dropped"] == 0


def test_spans_nest_on_one_thread_and_end_on_another(recorder):
    with trace.span("http", request="r1") as http:
        with trace.span("service") as service:
            with trace.span("decode") as decode:
                decode.set("rows", 7)
        wait = trace.span("wait", parent=http)
    assert trace.span("wait", parent=trace.NOOP) is trace.NOOP
    t = threading.Thread(target=wait.end)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    wait.end()                                  # a second end does nothing
    out = trace.drain()
    got = {s["name"]: s for s in out["spans"]}
    assert [s["name"] for s in out["spans"]] == ["decode", "service", "http", "wait"]
    assert got["http"]["parent"] is None and got["http"]["id"] == http.id
    assert got["service"]["parent"] == http.id and got["decode"]["parent"] == service.id
    assert got["wait"]["parent"] == http.id
    assert {s["request"] for s in out["spans"]} == {"r1"}
    assert got["decode"]["counters"] == {"rows": 7}
    for s in out["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert got["http"]["start_ns"] <= got["service"]["start_ns"] <= got["decode"]["start_ns"]
    assert got["decode"]["end_ns"] <= got["service"]["end_ns"] <= got["http"]["end_ns"]
    # the clock pair places perf_counter_ns on the Unix clock
    clock = out["clock"]
    offset = time.time_ns() - time.perf_counter_ns()
    assert abs(clock["time_ns"] - clock["perf_counter_ns"] - offset) < 5_000_000


def test_records_past_the_cap_are_counted_as_dropped(recorder, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    for i in range(5):
        trace.span("decode", request=str(i)).end()
    out = trace.drain()
    assert [s["request"] for s in out["spans"]] == ["0", "1", "2"] and out["dropped"] == 2
    assert trace.drain()["spans"] == []
    trace.disable()
    trace.span("decode").end()                   # off again: nothing is kept
    assert trace.drain()["spans"] == []


def test_one_request_id_spans_the_handler_and_the_worker(recorder, serve, capsys):
    port, _ = serve({"dummy": "test:dummy"})
    pcm = post(port, {"input": "hi", "response_format": "pcm"})
    wav = post(port, {"input": "hey"})
    assert len(pcm) == 2 * 2 * 44100 and wav[:4] == b"RIFF"
    spans = collect(2)
    https = by_name(spans, "http")
    assert len(https) == 2 and len({h["request"] for h in https}) == 2
    for http in https:
        assert http["parent"] is None
        kids = children(spans, http)
        assert set(kids) == {"wait", "service"}
        wait, service = kids["wait"], kids["service"]
        assert wait["request"] == service["request"] == http["request"]
        assert http["start_ns"] <= wait["start_ns"] <= wait["end_ns"] <= service["start_ns"]
        assert service["start_ns"] < service["counters"]["t_first_ns"] <= service["end_ns"]
        assert service["end_ns"] <= http["end_ns"]
    stream = next(h for h in https if "samples" in h["counters"])
    assert stream["counters"]["samples"] == 2 * 44100
    first = stream["counters"]["t_first_ns"]
    assert children(spans, stream)["service"]["counters"]["t_first_ns"] <= first
    assert first <= stream["end_ns"]
    # the ttfa= line reads the http span's own clock readings
    line = re.search(r"stream done: ttfa=([\d.]+) ms samples=(\d+) wall=([\d.]+) ms",
                     capsys.readouterr().err)
    assert float(line[1]) == round((first - stream["start_ns"]) / 1e6, 1)
    assert int(line[2]) == 2 * 44100
    assert line[3] == f"{(stream['end_ns'] - stream['start_ns']) / 1e6:.1f}"


def test_the_second_requests_wait_covers_the_runner_lock(recorder, serve):
    """Two workers, one runner: the worker that takes the second task waits
    for the runner's lock, and that wait is in its request's `wait`."""
    port, state = serve({"dummy": "test:dummy"}, n_parallelism=2)
    runner, _ = state._get_runner("dummy")
    generate = runner.generate

    def slow(text, config=None):
        time.sleep(0.3)
        return generate(text, config)

    runner.generate = slow
    threads = [threading.Thread(target=post, args=(port, {"input": "a", **fmt}))
               for fmt in ({"response_format": "pcm"}, {})]
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = collect(2)
    served = sorted((children(spans, h) for h in by_name(spans, "http")),
                    key=lambda k: k["service"]["start_ns"])
    assert len(served) == 2
    first, second = served
    assert second["wait"]["start_ns"] < first["service"]["end_ns"]
    assert second["wait"]["end_ns"] >= first["service"]["end_ns"]
    assert second["wait"]["end_ns"] - second["wait"]["start_ns"] >= 0.2e9


def test_the_decode_span_counts_rows_and_no_device_time_on_the_cpu(recorder):
    with trace.span("service", request="r") as service:
        rows = []
        for r in read_behind(Counter(), 10, 1):
            rows.append(int(r[0]))
            if len(rows) == 4:
                break
        assert rows == [1, 2, 3, 4]
        assert len(list(read_behind(Counter(), 5, 1))) == 5
    spans = trace.drain()["spans"]
    decodes = by_name(spans, "decode")
    assert [d["counters"] for d in decodes] == [{"rows": 4, "attn_launches": 0},
                                                {"rows": 5, "attn_launches": 0}]
    assert all(d["parent"] == service.id and d["request"] == "r" for d in decodes)


def test_the_decode_span_counts_the_attention_launches_of_its_runs(recorder, monkeypatch):
    """`attn_launches` is what prefix_attention.launches gained over the
    loop's runs (here a step that adds 3 a run, as a 3-layer step on a card
    would), the runs discarded after the caller stops included."""
    from tts_tpu_torch.runtime import step_graph

    class Attending(Counter):
        def _step(self):
            super()._step()
            step_graph.prefix_attention.launches += 3

    monkeypatch.setattr(step_graph.prefix_attention, "launches", 100)
    assert len(list(read_behind(Attending(), 6, 1))) == 6
    for i, _ in enumerate(read_behind(Attending(), 10, 1)):
        if i == 2:
            break
    (full, cut) = by_name(trace.drain()["spans"], "decode")
    assert full["counters"] == {"rows": 6, "attn_launches": 18}
    assert cut["counters"] == {"rows": 3, "attn_launches": 12}     # 4 runs: one ahead
    assert step_graph.prefix_attention.launches == 100 + 18 + 12


@pytest.fixture(scope="module")
def tiny_parler(tmp_path_factory):
    """A random two-layer Parler-TTS (Q4_0) and a small DAC, written by the
    port's GGUF writer (convert/builder_parler.py)."""
    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler

    dims = dict(PARLER_MINI_V1, n_layers=2, hidden=256, heads=4, ffn=512, prompt_vocab=64,
                enc_len=12, enc_hidden=64, max_ctx=512, max_gen=256)
    dac = dict(DAC_44KHZ, latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
    path = tmp_path_factory.mktemp("parler") / "parler.gguf"
    return str(write_random_parler(str(path), qtype="Q4_0", dac=dac, **dims))


def test_a_parler_stream_stamps_the_first_chunk(recorder, serve, tiny_parler):
    """110 rows stream as chunks of 48, 48 and 14: the service's first
    chunk falls between the first decode loop and the second."""
    port, _ = serve({"parler": tiny_parler})
    pcm = post(port, {"input": "hello there", "response_format": "pcm", "max_tokens": 110,
                      "top_k": 50, "seed": 3})
    assert len(pcm) > 0
    spans = collect(1)
    (http,) = by_name(spans, "http")
    service = children(spans, http)["service"]
    decodes = sorted((s for s in spans if s["parent"] == service["id"]),
                     key=lambda s: s["start_ns"])
    assert [d["name"] for d in decodes] == ["decode"] * 3
    assert [d["counters"]["rows"] for d in decodes] == [48, 48, 14]
    assert {d["request"] for d in decodes} == {http["request"]}
    t_first = service["counters"]["t_first_ns"]
    assert decodes[0]["end_ns"] < t_first < decodes[1]["start_ns"]
    assert t_first <= http["counters"]["t_first_ns"]
    assert http["counters"]["samples"] == len(pcm) // 2


@pytest.mark.cuda
def test_the_span_clock_is_the_profiler_trace_clock(tmp_path, recorder):
    """A span around a synchronized sleep kernel under torch.profiler, placed
    on the Chrome trace's clock by the recorder's clock pair and
    `baseTimeNanoseconds`: on the host clock it holds the kernel's launch
    and the synchronization, each edge within 0.2 ms; the kernel, which
    the profiler maps from the device's clock, lies between the two within
    0.5 ms (on an H100 that mapping read up to 0.1 ms early, and the host's
    launch and wake-up 0.2-1.1 ms in all)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)                        # the first launch under the profiler
        torch.cuda.synchronize()
        time.sleep(0.02)
        with trace.span("sleep"):
            torch.cuda._sleep(20_000_000)              # ~10 ms at the card's clock
            torch.cuda.synchronize()
        time.sleep(0.02)
    out = trace.drain()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    base = int(chrome["baseTimeNanoseconds"])
    events = [e for e in chrome["traceEvents"] if "dur" in e]
    # the sleep is the one kernel of milliseconds (torch names it spin_kernel)
    (kernel,) = [e for e in events if e.get("cat") == "kernel" and float(e["dur"]) > 5000]
    (launch,) = [e for e in events if e.get("cat") == "cuda_runtime"
                 and e["args"].get("correlation") == kernel["args"]["correlation"]]
    sync = min((e for e in events if e.get("cat") == "cuda_runtime"
                and "Synchronize" in e["name"] and float(e["ts"]) > float(launch["ts"])),
               key=lambda e: float(e["ts"]))             # the span's, not the profiler's
    (sp,) = out["spans"]
    clock = out["clock"]

    def on_trace_us(t_ns):
        return (t_ns - clock["perf_counter_ns"] + clock["time_ns"] - base) / 1e3

    def edges(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    a, b = on_trace_us(sp["start_ns"]), on_trace_us(sp["end_ns"])
    (l0, _), (_, s1), (k0, k1) = edges(launch), edges(sync), edges(kernel)
    print(f"span {a:.1f}-{b:.1f} us: launch {l0 - a:.1f} us in, synchronization out {b - s1:.1f}"
          f" us before its end; kernel {k0 - l0:.1f} us after the launch, {s1 - k1:.1f} us "
          f"before the synchronization's end")
    assert 0 <= l0 - a < 200 and 0 <= b - s1 < 200, (l0 - a, b - s1)
    assert k0 - l0 > -500 and s1 - k1 > -500, (k0 - l0, s1 - k1)


@pytest.mark.cuda
def test_the_decode_span_reads_the_device_gaps_on_a_card(recorder):
    """A step of ~1 ms on the device: a host that keeps up leaves the card
    all but busy; a host that takes 3 ms a row leaves it idle ~2 ms of
    every 3 (one step ahead is all `lookahead` 1 enqueues)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 1_000_000 / a.elapsed_time(b)

    class Sleep(CapturedStep):
        def __init__(self):
            super().__init__("cuda", None)
            self.buf = torch.zeros(3, dtype=torch.int32, device="cuda")

        def _step(self):
            torch.cuda._sleep(int(cycles_per_ms))
            self.buf += 1

    step = Sleep()
    assert [int(r[0]) for r in read_behind(step, 20, 1)] == list(range(1, 21))
    for _ in read_behind(step, 20, 1):
        time.sleep(0.003)
    fast, slow = by_name(trace.drain()["spans"], "decode")
    for d in (fast, slow):
        c = d["counters"]
        print(f"rows {c['rows']}, device {c['device_ns'] / 1e6:.3f} ms, "
              f"idle {c['idle_ns'] / 1e6:.3f} ms ({100 * c['idle_ns'] / c['device_ns']:.1f}%)")
        assert c["rows"] == 20 and 0 <= c["idle_ns"] < c["device_ns"]
        assert c["device_ns"] >= 19e6
    assert fast["counters"]["idle_ns"] < 0.05 * fast["counters"]["device_ns"]
    assert 0.45 < slow["counters"]["idle_ns"] / slow["counters"]["device_ns"] < 0.8
