"""The port's perf_battery (tts_tpu_torch.apps.perf_battery) against the JAX
package's: one JSON line with the same keys on the same tiny Kokoro, the
same flags, sentences, report lines and call sequence, the torch.profiler
trace of --profile-dir, and no fallback from a missing card."""

import contextlib
import io
import json
import re

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

import torch  # noqa: E402

from tts_tpu.apps import perf_battery as jbattery  # noqa: E402
from tts_tpu.convert.builder_kokoro import KokoroDims, write_kokoro_gguf  # noqa: E402
from tts_tpu_torch.apps import perf_battery as tbattery  # noqa: E402
from tts_tpu_torch.runtime.api import TTSResponse  # noqa: E402

torch.set_num_threads(1)

KEYS = {"model", "sentences", "mean_generation_ms", "median_generation_ms", "mean_codec_ms",
        "total_audio_seconds", "real_time_factor", "p50_time_to_first_audio_ms"}


def run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def kokoro(tmp_path_factory):
    path = tmp_path_factory.mktemp("battery") / "kokoro.gguf"
    return str(write_kokoro_gguf(path, KokoroDims.tiny(), seed=0, duration_bias=-2.6))


def test_json_line_has_jax_keys_on_tiny_kokoro(kokoro):
    argv = ["--model-path", kokoro, "--n-sentences", "2", "--warmup", "0", "--json"]
    reports = {}
    for name, main, extra in (("jax", jbattery.main, []),
                              ("port", tbattery.main, ["--device", "cpu"])):
        rc, stdout, stderr = run(main, argv + extra)
        assert rc == 0
        assert len(stdout.splitlines()) == 1
        assert len(stderr.splitlines()) == 2            # one line per timed sentence
        reports[name] = json.loads(stdout)
    assert set(reports["port"]) == set(reports["jax"]) == KEYS
    port = reports["port"]
    assert port["model"] == kokoro and port["sentences"] == 2
    assert port["total_audio_seconds"] > 0 and np.isfinite(port["real_time_factor"])
    assert port["real_time_factor"] > 0 and port["mean_codec_ms"] == 0.0


def test_report_lines_match_jax_on_dummy():
    lines = {}
    for name, main, extra in (("jax", jbattery.main, []),
                              ("port", tbattery.main, ["--device", "cpu"])):
        rc, stdout, _ = run(main, ["--model-path", "test:dummy", "--n-sentences", "3",
                                   "--warmup", "0", *extra])
        assert rc == 0
        lines[name] = [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in stdout.splitlines()]
    assert lines["port"] == lines["jax"]
    assert lines["port"][1] == "=== perf battery ==="


class _Recorder:
    """A runner that records each call of the battery: generate(text) and
    the first chunk of generate_stream(text)."""

    def __init__(self, calls):
        self.calls = calls

    def generate(self, text, config=None):
        self.calls.append(("generate", text, config.voice, config.seed))
        return TTSResponse(audio=np.zeros(4410, np.float32), sample_rate=44100,
                           timings={"codec_ms": 1.5})

    def generate_stream(self, text, config=None):
        self.calls.append(("stream", text))
        yield np.zeros(441, np.float32)


@pytest.mark.parametrize("argv", [["--warmup", "1", "--n-sentences", "12"],
                                  ["--warmup", "2", "--n-sentences", "3", "--voice", "zoe"]])
def test_call_sequence_matches_jax(monkeypatch, argv):
    """Warm passes over the whole battery, the timed pass, then the stream's
    first chunk for up to 10 sentences; the same report."""
    from tts_tpu.models import registry as jregistry
    from tts_tpu_torch.models import registry as tregistry

    results = []
    for main, registry, extra in ((jbattery.main, jregistry, []),
                                  (tbattery.main, tregistry, ["--device", "cpu"])):
        calls = []
        monkeypatch.setattr(registry, "runner_from_file",
                            lambda path, config, **kw: _Recorder(calls))
        rc, stdout, _ = run(main, ["--model-path", "m.gguf", "--json", *argv, *extra])
        report = json.loads(stdout)
        for k in ("mean_generation_ms", "median_generation_ms", "real_time_factor",
                  "p50_time_to_first_audio_ms"):
            report.pop(k)
        results.append((rc, calls, report))
    assert results[1] == results[0]
    n, warm = int(argv[3]), int(argv[1])
    assert len(results[1][1]) == (warm + 1) * n + warm + min(n, 10)
    assert results[1][2]["mean_codec_ms"] == 1.5


def test_flags_and_sentences_match_jax():
    assert tbattery.HARVARD_SENTENCES == jbattery.HARVARD_SENTENCES
    assert len(tbattery.HARVARD_SENTENCES) == 30

    def flags(main):
        import argparse

        seen = {}

        def parse(self, argv=None, namespace=None):
            seen.update({a.dest: (tuple(a.option_strings), a.default)
                         for a in self._actions if a.dest != "help"})
            raise SystemExit(0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(argparse.ArgumentParser, "parse_args", parse)
            with pytest.raises(SystemExit):
                main([])
        return seen
    port = flags(tbattery.main)
    assert port.pop("device") == (("--device",), "cuda")
    assert port == flags(jbattery.main)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    rc, stdout, _ = run(tbattery.main, ["--model-path", "test:dummy", "--n-sentences", "2",
                                        "--warmup", "0", "--json", "--device", "cpu",
                                        "--profile-dir", str(tmp_path / "trace")])
    assert rc == 0 and json.loads(stdout)["sentences"] == 2
    trace = json.loads((tmp_path / "trace" / "perf_battery_trace.json").read_text())
    assert "traceEvents" in trace


@pytest.mark.parametrize("argv", [["--device", "cuda"], []], ids=["cuda", "default"])
def test_without_a_card_exits_1(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the battery runs on it")
    rc, stdout, stderr = run(tbattery.main, ["--model-path", "test:dummy", "--json", *argv])
    assert (rc, stdout) == (1, "")
    assert stderr == "error: device 'cuda' requested but no CUDA device is available\n"
