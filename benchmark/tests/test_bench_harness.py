"""The harness on the CPU: the traffic generator, the end-to-end readers at
the window's edges, whole runs of tiny cells, a cell added by files alone,
the correctness control and the planted faults."""

from __future__ import annotations

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402
from benchlib import latency, spec, traffic  # noqa: E402

NARRATE = {"loop": "closed", "response_format": "wav", "audio_s": [10, 25], "block": 8,
           "blocks": 4}
CHAT = {"loop": "open", "response_format": "pcm", "audio_s": [1, 3], "rate_per_s": 0.8}


@pytest.mark.parametrize("tr", [NARRATE, CHAT], ids=["closed", "open"])
def test_schedule_repeats_for_a_seed_and_keeps_the_work(tr):
    model = spec.module("models", "parler")
    a = traffic.schedule(tr, model, 2**31 + 17, 50.0)
    assert a == traffic.schedule(tr, model, 2**31 + 17, 50.0)
    b = traffic.schedule(tr, model, 2**31 + 18, 50.0)
    assert a != b
    # another seed: the same sizes (and arrival gaps), in another order
    assert sorted(r["frames"] for r in a) == sorted(r["frames"] for r in b)
    if tr["loop"] == "open":
        assert len(a) == round(0.8 * 50)
        assert all(0 < r["due"] < 50 for r in a)
        def gaps(rs):
            dues = [0.0] + [r["due"] for r in rs]
            return sorted(y - x for x, y in zip(dues, dues[1:]))

        assert gaps(a) == pytest.approx(gaps(b), abs=1e-9)
    for r in a:
        lo, hi = tr["audio_s"]
        assert lo <= r["audio_s"] * 1.001 and r["audio_s"] <= hi * 1.001
        assert r["body"]["max_tokens"] == r["frames"] + 8
        assert len(r["body"]["input"]) <= round(r["audio_s"] * traffic.CHARS_PER_AUDIO_S) + 1
        assert (r["top_k"] == 1) == (r["i"] % traffic.GREEDY_EVERY == 1)


def _req(due, first, done, audio=2.0, ok=True):
    return {"due_abs": due, "t_first": first, "t_done": done, "audio_s": audio, "ok": ok}


def test_latencies_run_from_due_times():
    ctx = {"t0": 100.0, "t1": 150.0, "drain_s": 60.0,
           "requests": [_req(101.0, 103.0, 104.0), _req(102.0, 103.5, 105.0),
                        _req(140.0, None, None, ok=False)]}
    ttfa = [latency.ttfa_s(ctx, r) for r in ctx["requests"]]
    assert ttfa == [2.0, 1.5, 150.0 + 60.0 - 140.0]      # a failure counts as missing
    assert latency.rtf(ctx, ctx["requests"][0]) == pytest.approx(3.0 / 2.0)
    assert spec.module("metrics", "ttfa_p50_ms").read(ctx) == pytest.approx(2000.0)
    assert spec.module("metrics", "ttfa_p90_ms").read(ctx) == pytest.approx(70000.0)


def test_narrate_rate_at_the_window_edges():
    rate = spec.module("metrics", "audio_s_per_s")
    ctx = {"t0": 0.0, "t1": 50.0, "requests": [
        _req(0.0, 1.0, 6.0, audio=12.0), _req(6.0, 7.0, 20.0, audio=25.0),
        _req(20.0, 21.0, 49.5, audio=20.0),
        _req(49.5, 50.5, 60.0, audio=15.0),          # completes after the window: left out
        _req(10.0, None, None, audio=9.0, ok=False)]}
    assert rate.read(ctx) == pytest.approx((12.0 + 25.0 + 20.0) / 49.5)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")), loops=("closed", "open"))


@pytest.mark.parametrize("cell", ["parler-closed", "dia-open"])
def test_tiny_cell_runs_correct(checkout, cell):
    rc, result, err = tiny.run(checkout, cell)
    assert rc == 0, err
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert "setup_s" in result["metrics"]
    assert err.strip().splitlines()[-1].startswith("check: ")


def test_a_cell_added_by_files_alone_is_found_and_run(checkout, tmp_path):
    """A configuration, a model, a reference and a cell that no existing file
    names: the weight-free test:dummy runner (one second of 440 Hz a
    character)."""
    root = str(tmp_path)
    tiny.make(root, models=("parler",))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "dummy.json"), "w") as f:
        json.dump({"model": "dummy", "allow_tf32": False,
                   "correct_limits": {"audio_err": 1e-3}}, f)
    with open(os.path.join(b, "traffic", "tiny-dummy.json"), "w") as f:
        json.dump({"loop": "closed", "response_format": "wav", "audio_s": [0.1, 0.2],
                   "block": 2, "blocks": 4}, f)
    with open(os.path.join(b, "models", "dummy.py"), "w") as f:
        f.write('''
def max_tokens(frames):
    return frames


def samples(frames, text):
    return len(text) * 44100


def model_path(cfg, seed, cache_dir, device):
    return "test:dummy"


def install_hooks(rec):
    from tts_tpu_torch.models.dummy import DummyRunner
    return DummyRunner
''')
    with open(os.path.join(b, "reference", "dummy.py"), "w") as f:
        f.write('''
import torch


def load(reader, cfg, device):
    return {}


def audio(p, cfg, item, rows):
    t = torch.arange(len(item["text"]) * 44100, dtype=torch.float64) / 44100
    return (0.5 * torch.sin(2 * torch.pi * 440.0 * t)).float()
''')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy", "source": "test:dummy",
                             "file": "benchmark/configs/dummy.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "dummy-closed", "config": "dummy",
                               "traffic": "tiny-dummy", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("dummy-closed")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, result, err = tiny.run(root, "dummy-closed", seconds=2)
    assert rc == 0, err
    assert result["correct"], err
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_the_control_comes_out_not_correct(checkout):
    """The reference in the program's place, one precision down (fp8
    activations and keys/values), judged by the run's own comparison: it
    fails the logit gap's limit, so the run reports not correct."""
    rc, result, err = tiny.run(checkout, "parler-closed", seed=11, control=1)
    assert rc == 0, err
    assert result["correct"] is False, err
    gap = result["check"]["logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("fault", ["token", "state", "audio"])
@pytest.mark.parametrize("cell", ["parler-closed", "dia-closed"])
def test_a_planted_fault_comes_out_not_correct(checkout, cell, fault):
    rc, result, err = tiny.run(checkout, cell, seed=13, seconds=2,
                               env={"BENCH_TEST_FAULT": fault})
    assert rc == 0, err
    assert result["correct"] is False


def test_a_fixed_order_keeps_sizes_and_arrivals_and_draws_texts():
    model = spec.module("models", "dia")
    tr = {**CHAT, "order_seed": 1}
    a = traffic.schedule(tr, model, 101, 50.0)
    b = traffic.schedule(tr, model, 102, 50.0)
    assert [(r["frames"], r["due"], r["top_k"]) for r in a] == \
        [(r["frames"], r["due"], r["top_k"]) for r in b]
    assert [r["body"]["input"] for r in a] != [r["body"]["input"] for r in b]
    assert [r["body"]["seed"] for r in a] != [r["body"]["seed"] for r in b]


def test_step_mfu_divides_by_the_decode_loops_time():
    """The rows' least time over the server's `decode` spans alone: the
    prefill, the DAC and the gaps between requests are left out."""
    class Model:
        row_bound_s = staticmethod(lambda cfg, pos: 1e-3 * (1 + pos))
        decode_positions = staticmethod(lambda rec: range(rec["T"], rec["T"] + rec["rows"]))

    ctx = {"model": Model, "cfg": {}, "server": {
        "served": {"1": {"T": 2, "rows": 3}, "2": {"T": 0, "rows": 1}},
        "spans": [["prefill", 0, 500_000_000], ["decode", 500_000_000, 1_500_000_000],
                  ["dac", 1_500_000_000, 1_900_000_000], ["decode", 4_000_000_000,
                                                          5_000_000_000]]}}
    work = 1e-3 * (3 + 4 + 5) + 1e-3 * 1
    assert spec.module("metrics", "step_mfu").read(ctx) == pytest.approx(100 * work / 2.0)
    ctx["server"]["spans"] = [s for s in ctx["server"]["spans"] if s[0] != "decode"]
    assert spec.module("metrics", "step_mfu").read(ctx) is None


def test_the_traced_slice_starts_at_a_request_and_stops_at_a_row():
    import time

    child = spec.module(".", "server_child")
    calls = []

    class Prof:
        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

    sl = child.Slice(lambda: None)
    sl.prof, sl.start_at, sl.length, sl.state = Prof(), time.perf_counter() + 0.05, 0.1, "armed"
    sl.request()                        # before start_at
    time.sleep(0.06)
    sl.boundary()
    sl.row()                            # rows never start it
    assert sl.state == "armed" and calls == []
    sl.request()
    assert sl.state == "on" and calls == ["start"]
    sl.prefill(12)
    for _ in range(2):
        sl.boundary()
        sl.row()
    time.sleep(0.1)
    sl.boundary()                       # the first row boundary past its length
    sl.row()
    sl.request()
    assert sl.state == "done" and calls == ["start", "stop"]
    assert sl.rows == 2 and sl.prompts == [12]
    assert sl.t_off - sl.t_on >= 0.1


def test_the_sweep_finds_growth_by_the_backlogs_slope():
    sweep = spec.module(".", "sweep")
    steady = [{"due_abs": 100 + i, "t_done": 100 + i + 0.5, "ok": True} for i in range(40)]
    assert abs(sweep.slope(sweep.backlog(steady, 100.0, 40.0))) * 40 < sweep.GROWTH
    # served at 0.8 of the offered rate: the backlog grows by ~8 over 40 s
    fed = [{"due_abs": 100 + i, "t_done": 100 + 1.25 * (i + 1), "ok": True} for i in range(40)]
    assert sweep.slope(sweep.backlog(fed, 100.0, 40.0)) * 40 > sweep.GROWTH
    assert sweep.slope([0, 1, 2, 3]) == pytest.approx(1 / sweep.STEP_S)
