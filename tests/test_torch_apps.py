"""The port's command-line apps and their host helpers against the JAX
package's: the cli (tts_tpu_torch.apps.cli) on test:dummy and on tiny
Kokoro, Orpheus and Parler GGUFs with --device cpu (its WAV against the
port runner's own generate with the same config; flags, return codes,
messages and printed lines against JAX's cli), its --vad, --play,
--list-voices and --conditional-prompt paths and its refusal to fall back
from a missing card; trim_silence and the SDL playback binding against
JAX's on the same inputs; and the phonemize app against JAX's."""

import contextlib
import ctypes.util
import io
import re

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

import torch  # noqa: E402

from test_playback import FakeSDL  # noqa: E402
from torch_tiny import TINY, write_tiny_parler  # noqa: E402
from tts_tpu.apps import cli as jcli  # noqa: E402
from tts_tpu.apps import phonemize as jphonemize  # noqa: E402
from tts_tpu.convert.builder_kokoro import KokoroDims, write_kokoro_gguf  # noqa: E402
from tts_tpu.runtime import playback as jplayback  # noqa: E402
from tts_tpu.runtime.vad import trim_silence as jax_trim_silence  # noqa: E402
from tts_tpu_torch.apps import cli as tcli  # noqa: E402
from tts_tpu_torch.apps import phonemize as tphonemize  # noqa: E402
from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus  # noqa: E402
from tts_tpu_torch.convert.builder_t5 import write_t5_gguf  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime import playback as tplayback  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402
from tts_tpu_torch.runtime.vad import trim_silence  # noqa: E402
from tts_tpu_torch.utils.audio import encode_wav  # noqa: E402

torch.set_num_threads(1)

NO_CARD = "device 'cuda' requested but no CUDA device is available"


def run(main, argv) -> tuple[int, str, str]:
    """(return code, stdout, stderr) of an app's main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def line_keys(stdout: str) -> list[str]:
    """The printed lines with their numbers and paths taken out."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", line.split(" to ")[0]) for line in stdout.splitlines()]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """models(name) -> path of a tiny GGUF, written on first use: "kokoro"
    (KokoroDims.tiny(), the JAX builder), "orpheus" (the port's random
    writer, Q4_0 linears at torch_tiny's widths, a tiny SNAC), "parler"
    (torch_tiny's dense Parler) and "t5" (a T5 whose output width is that
    Parler's encoding width)."""
    root = tmp_path_factory.mktemp("apps")
    built = {}

    def get(name):
        if name not in built:
            if name == "kokoro":
                built[name] = str(write_kokoro_gguf(root / "kokoro.gguf", KokoroDims.tiny(),
                                                    seed=0, duration_bias=-2.6))
            elif name == "orpheus":
                built[name] = str(write_random_orpheus(
                    root / "orpheus.gguf", seed=0, qtype="Q4_0", **TINY, vocab=156940,
                    snac_embd=96, snac_channels=(48, 24, 12, 6)))
            elif name == "parler":
                built[name] = write_tiny_parler(root)
            else:
                built[name] = str(write_t5_gguf(root / "t5.gguf", seed=1, out_size=64))
        return built[name]
    return get


# ------------------------------------------------------------------- cli ---
def test_cli_dummy_matches_jax(tmp_path):
    """test:dummy: the same WAV bytes and the same printed lines."""
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        path = tmp_path / f"{name}.wav"
        extra = ["--device", "cpu"] if name == "port" else []
        rc, stdout, stderr = run(main, ["--model-path", "test:dummy", "--prompt", "abc",
                                        "--save-path", str(path), *extra])
        assert rc == 0 and stderr == ""
        outs[name] = (path.read_bytes(), line_keys(stdout))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == ["total time = # ms",
                               "rtf = # (generation seconds per audio second, incl. model load)",
                               "wrote # samples (#s)"]


@pytest.mark.parametrize("argv", [
    ["--prompt", "x", "--top-p", "1.5"],
    ["--prompt", "x", "--top-p", "0"],
    ["--prompt", "x", "-tp", "-0.25"],
    ["--prompt", "x", "--conditional-prompt", "calm voice"],
    ["--prompt", "x", "--conditional-prompt", "calm voice", "--text-encoder-path", "t5.gguf"],
    ["--prompt", ""],
    ["--prompt", "x", "--model-path", "test:nope"],
], ids=["top-p-above-1", "top-p-0", "top-p-negative", "conditional-without-encoder",
        "conditional-on-dummy", "empty-response", "unknown-test-runner"])
def test_cli_refuses_as_jax(tmp_path, argv):
    """Return code 1 and the same message as JAX's cli, and no WAV."""
    if "--model-path" not in argv:
        argv = ["--model-path", "test:dummy", *argv]
    results = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        rc, stdout, stderr = run(main, [*argv, "--save-path", str(tmp_path / "o.wav"), *extra])
        results.append((rc, stdout, stderr))
    assert results[1] == results[0]
    assert results[1][0] == 1 and results[1][2]
    assert not (tmp_path / "o.wav").exists()


@pytest.mark.parametrize("argv", [["--device", "cuda"], []], ids=["cuda", "default"])
def test_cli_without_a_card_exits_1(tmp_path, argv):
    """--device cuda, the default, never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cli runs on it")
    rc, stdout, stderr = run(tcli.main, ["--model-path", "test:dummy", "--prompt", "x",
                                         "--save-path", str(tmp_path / "o.wav"), *argv])
    assert (rc, stdout, stderr) == (1, "", f"error: {NO_CARD}\n")
    assert not (tmp_path / "o.wav").exists()


def test_cli_flags_match_jax():
    """Every JAX flag with its short name and default, plus --device."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required)
                for a in parser._actions if a.dest != "help"}
    jax_flags, port_flags = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert port_flags.pop("device") == (("--device",), "cuda", False)
    assert port_flags == jax_flags


@pytest.mark.parametrize("model,argv", [
    ("kokoro", ["--voice", "af_heart", "--seed", "3"]),
    ("orpheus", ["--max-tokens", "15", "--seed", "0"]),
    ("parler", ["--max-tokens", "15", "--seed", "0", "--topk", "20", "--temperature", "0.8"]),
])
def test_cli_writes_what_the_runner_generates(models, tmp_path, model, argv):
    """The WAV holds the port runner's own generate for the same config, and
    the cli prints one line per timing, then total time, rtf and wrote."""
    path = tmp_path / "o.wav"
    rc, stdout, _ = run(tcli.main, ["--model-path", models(model), "--prompt", "hello there",
                                    "--save-path", str(path), "--device", "cpu", *argv])
    assert rc == 0
    args = tcli.build_parser().parse_args(["-mp", "m", "-p", "x", *argv])
    config = GenerationConfig(voice=args.voice, top_k=args.topk, temperature=args.temperature,
                              max_tokens=args.max_tokens, seed=args.seed)
    resp = runner_from_file(models(model), config, device="cpu").generate("hello there", config)
    assert len(resp.audio) > 0
    assert path.read_bytes() == encode_wav(resp.audio, resp.sample_rate)
    stages = [line.split(" = ")[0] for line in stdout.splitlines()[:-3]]
    assert stages == list(resp.timings)
    assert stdout.splitlines()[-1] == (f"wrote {len(resp.audio)} samples "
                                       f"({len(resp.audio) / resp.sample_rate:.2f}s) to {path}")


def test_cli_conditional_prompt(models, tmp_path):
    """--conditional-prompt with --text-encoder-path re-encodes Parler's
    voice description (update_conditional_prompt) before generating."""
    path = tmp_path / "o.wav"
    argv = ["--max-tokens", "15", "--seed", "0"]
    rc, _, _ = run(tcli.main, ["--model-path", models("parler"), "--prompt", "hi", "--save-path",
                               str(path), "--device", "cpu", "--conditional-prompt",
                               "a calm voice", "--text-encoder-path", models("t5"), *argv])
    assert rc == 0
    config = GenerationConfig(top_k=50, max_tokens=15, seed=0)
    runner = runner_from_file(models("parler"), config, device="cpu")
    before = runner.generate("hi", config)
    runner.update_conditional_prompt(models("t5"), "a calm voice")
    after = runner.generate("hi", config)
    assert path.read_bytes() == encode_wav(after.audio, 44100)
    assert path.read_bytes() != encode_wav(before.audio, 44100)


def test_cli_vad_trims_what_the_runner_generates(models, tmp_path):
    path = tmp_path / "o.wav"
    argv = ["--max-tokens", "29", "--seed", "1"]
    rc, _, _ = run(tcli.main, ["--model-path", models("orpheus"), "--prompt", "hi", "--vad",
                               "--save-path", str(path), "--device", "cpu", *argv])
    assert rc == 0
    config = GenerationConfig(top_k=50, max_tokens=29, seed=1)
    resp = runner_from_file(models("orpheus"), config, device="cpu").generate("hi", config)
    assert path.read_bytes() == encode_wav(trim_silence(resp.audio, 24000), 24000)


@pytest.mark.parametrize("model", ["dummy", "kokoro", "orpheus"])
def test_cli_list_voices_matches_jax(models, model):
    path = "test:dummy" if model == "dummy" else models(model)
    jax_out = run(jcli.main, ["--model-path", path, "--prompt", "x", "--list-voices"])
    port_out = run(tcli.main, ["--model-path", path, "--prompt", "x", "--list-voices",
                               "--device", "cpu"])
    assert port_out == jax_out and port_out[0] == 0 and port_out[1]


@pytest.mark.parametrize("played", [True, False], ids=["sdl", "no-player"])
def test_cli_play_chain_matches_jax(tmp_path, monkeypatch, played):
    """--play: SDL2 first (nothing saved); with no SDL2 and no system player,
    the same message as JAX's cli, and the WAV is saved instead."""
    results = []
    for main, playback, extra in ((jcli.main, jplayback, []),
                                  (tcli.main, tplayback, ["--device", "cpu"])):
        calls = []
        monkeypatch.setattr(playback, "play", lambda a, sr: calls.append(sr) or played)
        monkeypatch.setattr("shutil.which", lambda name: None)
        path = tmp_path / f"{len(results)}.wav"
        rc, stdout, stderr = run(main, ["--model-path", "test:dummy", "--prompt", "ab",
                                        "--play", "--save-path", str(path), *extra])
        results.append((rc, line_keys(stdout), stderr, calls, path.exists()))
    assert results[1] == results[0]
    assert results[1][3] == [44100] and results[1][4] is not played


# ------------------------------------------------------------------- vad ---
def _vad_input(case: str) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(7)
    sr = 24000
    t = np.arange(sr, dtype=np.float32) / sr
    tone = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    if case == "noise":
        return rng.standard_normal(3 * sr).astype(np.float32) * 0.3, sr
    if case == "silent-tail":
        return np.concatenate([tone, np.zeros(sr, np.float32)]), sr
    if case == "quiet-tail":
        return np.concatenate([tone, 1e-3 * rng.standard_normal(sr).astype(np.float32)]), sr
    if case == "internal-silence":
        return np.concatenate([tone, np.zeros(4 * sr, np.float32), tone]), sr
    if case == "all-silent":
        return np.zeros(5 * sr, np.float32), sr
    if case == "short":
        return tone[:100], sr
    if case == "loud-44k":
        sr = 44100
        x = rng.standard_normal(2 * sr).astype(np.float32) * 3e4
        return np.concatenate([x, np.zeros(sr // 2, np.float32)]), sr
    raise ValueError(case)


@pytest.mark.parametrize("case", ["noise", "silent-tail", "quiet-tail", "internal-silence",
                                  "all-silent", "short", "loud-44k"])
def test_trim_silence_matches_jax(case):
    audio, sr = _vad_input(case)
    got, want = trim_silence(audio, sr), jax_trim_silence(audio, sr)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if case in ("silent-tail", "internal-silence"):
        assert len(got) < len(audio)


# -------------------------------------------------------------- playback ---
@pytest.mark.parametrize("fail_open", [False, True], ids=["drains", "no-device"])
def test_playback_calls_sdl_as_jax(monkeypatch, fail_open):
    audio = np.linspace(-1, 1, 480).astype(np.float32)
    results = []
    for playback in (jplayback, tplayback):
        fake = FakeSDL(fail_open=fail_open)
        monkeypatch.setattr(playback, "_lib", fake)
        ok = playback.play(audio, 24000, poll_ms=1)
        results.append((ok, fake.calls, getattr(fake, "spec", None)))
    assert results[1] == results[0]
    assert results[1][0] is not fail_open and results[1][1][-1] == ("quit",)


def test_playback_unavailable_without_sdl(monkeypatch):
    monkeypatch.setattr(tplayback, "_lib", None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    assert tplayback.available() is False
    assert tplayback.play(np.zeros(8, np.float32), 24000) is False


# ------------------------------------------------------------- phonemize ---
@pytest.mark.parametrize("prompt", ["Hello world.", "The birch canoe slid on the smooth planks.",
                                    "It's 42 degrees, Dr. Smith!"])
def test_phonemize_matches_jax(models, prompt):
    argv = ["--phonemizer-path", models("kokoro"), "--prompt", prompt]
    got, want = run(tphonemize.main, argv), run(jphonemize.main, argv)
    assert got == want and got[0] == 0 and got[1].strip()


@pytest.mark.parametrize("argv", [["--prompt", "hi"], ["--use-espeak", "--prompt", "hi"]],
                         ids=["no-path", "espeak"])
def test_phonemize_refuses_as_jax(argv):
    if "--use-espeak" in argv and ctypes.util.find_library("espeak-ng"):
        pytest.skip("libespeak-ng is installed")
    got, want = run(tphonemize.main, argv), run(jphonemize.main, argv)
    assert got == want and got[0] == 1 and got[2]
