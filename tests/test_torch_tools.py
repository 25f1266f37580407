"""The port's tools (tts_tpu_torch.tools: parity_report and
orpheus_step_breakdown) and `KokoroModel.predict_durations`, which the
parity report reads, against the JAX package's, on the CPU at tiny widths.

The JAX parity report is imported from tools/ as tests/test_tools.py does;
on Orpheus the JAX side is its runner's own stage trace (what its report
prints) on a 512-position cache, so its interpret-mode kernels stay fast."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from torch_tiny import CTX, GEN, orpheus_logits_along, write_tiny_orpheus  # noqa: E402
from tts_tpu.convert.builder_kokoro import KokoroDims, write_kokoro_gguf  # noqa: E402
from tts_tpu.models import kokoro as jk  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus  # noqa: E402
from tts_tpu_torch.models import orpheus as to  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import TTSError  # noqa: E402
from tts_tpu_torch.tools import orpheus_step_breakdown as sb  # noqa: E402
from tts_tpu_torch.tools import parity_report  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import parity_report as jax_parity_report  # noqa: E402

torch.set_num_threads(1)

TEXT = "parity check, on both packages."
ROUNDING_TIE = 1e-4     # a duration sum this close to x.5 may round either way
HIDDEN_TOL = 1e-4       # of the hidden states' peak
TIE = 4e-3              # a greedy token within this of the best logit is a tie


@pytest.fixture(scope="module")
def kokoro_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kokoro") / "tiny.gguf")
    write_kokoro_gguf(path, KokoroDims.tiny(), seed=0, duration_bias=-2.6)
    return path


@pytest.fixture(scope="module")
def kokoro_runners(kokoro_gguf):
    return jax_runner_from_file(kokoro_gguf), runner_from_file(kokoro_gguf, device="cpu")


# ------------------------------------------------------ predict_durations ---
@pytest.mark.parametrize("seed,n", [(21, 10), (22, 61)])
def test_predict_durations_matches_jax(kokoro_runners, seed, n):
    """The JAX model's tuple at the exact token count: durations equal over
    the valid positions but where a raw sum lies within ROUNDING_TIE of
    x.5, hidden within HIDDEN_TOL of its peak; the mask is all ones."""
    jr, tr = kokoro_runners
    rng = np.random.default_rng(seed)
    ids = [0] + [int(i) for i in rng.integers(1, tr.model.cfg.vocab_size, n)] + [0]
    T = len(ids)
    tokens, mask, durations, hidden = tr.model.predict_durations(ids, "af_heart")
    jtokens, jmask, jdur, jhidden = jr.model.predict_durations(ids, "af_heart")
    assert tokens.dtype == np.int32 and tokens.tolist() == ids == jtokens[:T].tolist()
    assert mask.dtype == np.float32 and mask.tolist() == [1.0] * T == jmask[:T].tolist()
    sums, _ = jk.duration_raw(jr.model.params, jr.model.cfg, jnp.asarray(jtokens),
                              jnp.asarray(jmask), jr.model.voice_style("af_heart", T)[1])
    sums = np.asarray(sums)[:T]
    keep = np.abs(sums - np.floor(sums) - 0.5) > ROUNDING_TIE
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(durations.numpy()[keep], np.asarray(jdur)[:T][keep])
    jhidden = np.asarray(jhidden)[:T]
    assert hidden.shape == jhidden.shape
    assert np.abs(hidden.numpy() - jhidden).max() <= HIDDEN_TOL * np.abs(jhidden).max()


def test_predict_durations_are_what_synthesize_uses(kokoro_runners):
    """The same voice row as `synthesize`: its audio is the durations' sum
    of frames."""
    _, tr = kokoro_runners
    for ids in ([0] + list(range(5, 30)) + [0], [0, 7, 9, 0]):
        _, _, durations, _ = tr.model.predict_durations(ids, "af_heart")
        audio = tr.model.synthesize(ids, "af_heart")
        assert len(audio) == int(durations.sum()) * tr.model.cfg.up_sampling_factor > 0


# ---------------------------------------------------------- parity_report ---
def test_parity_report_self_match(kokoro_gguf, tmp_path):
    """Report against a WAV the tool saved from the same checkpoint and
    text: correlation ~1, MATCH; the durations add up to the audio."""
    wav, js = str(tmp_path / "self.wav"), str(tmp_path / "report.json")
    argv = [kokoro_gguf, "--text", TEXT, "--voice", "af_heart", "--device", "cpu"]
    assert parity_report.main(argv + ["--save-wav", wav]) == 0 and os.path.exists(wav)
    assert parity_report.main(argv + ["--ref-wav", wav, "--json", js]) == 0
    with open(js) as f:
        report = json.load(f)
    vs = report["vs_reference"]
    assert vs["verdict"] == "MATCH" and vs["pcm_correlation"] > 0.999, vs
    assert abs(vs["length_ratio"] - 1.0) < 1e-6 and vs["log_spectral_distance"] < 1e-3
    assert report["stages"]["total_frames"] * 600 == report["audio"]["samples"] > 0


def test_parity_report_detects_a_mismatch(kokoro_gguf, tmp_path):
    from tts_tpu_torch.utils.audio import write_wav

    wav = str(tmp_path / "noise.wav")
    write_wav(wav, (np.random.default_rng(0).standard_normal(24000) * 0.1).astype(np.float32),
              24000)
    report, _ = parity_report.run_report(kokoro_gguf, TEXT, "af_heart", 0, ref_wav=wav,
                                         device="cpu")
    assert report["vs_reference"]["verdict"] != "MATCH"


def test_parity_report_kokoro_stages_match_jax(kokoro_gguf, kokoro_runners):
    """The checkpoint inventory, phonemes, token ids and durations of the
    port's report are the JAX report's on the same GGUF."""
    jr, tr = kokoro_runners
    report, resp = parity_report.run_report(kokoro_gguf, TEXT, "af_heart", 0, device="cpu")
    want = jax_parity_report.checkpoint_inventory(kokoro_gguf)
    want["voices"] = jr.list_voices()[:20]
    assert report["checkpoint"] == want
    assert report["stages"] == jax_parity_report.kokoro_stages(jr, TEXT, "af_heart")
    phonemes = report["stages"]["phonemes"].replace(".", "").strip()
    assert tr.tokenizer.tokenize(phonemes) == jr.tokenizer.tokenize(phonemes)
    assert len(resp.audio) == 600 * report["stages"]["total_frames"]


def test_parity_report_needs_a_card_by_default(kokoro_gguf, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TTSError, match="no CUDA device"):
        parity_report.main([kokoro_gguf])


def test_parity_report_orpheus_stages_match_jax(tmp_path):
    """Tiny Orpheus Q8_0: the prompt ids of the port's report are the JAX
    runner's trace's, and its step-0 argmax is JAX's up to a near-tie of the
    port's prefill logits."""
    path = str(write_tiny_orpheus(tmp_path / "o.gguf", head_rows=4096, qtype="Q8_0"))
    report, resp = parity_report.run_report(path, "hi", "zoe", 0, max_tokens=3, device="cpu")
    jr = jax_runner_from_file(path)
    jr.cfg = dataclasses.replace(jr.cfg, max_context_length=CTX, max_generation_size=GEN)
    jr.capture_trace = True
    jr.generate("hi", JaxGenerationConfig(voice="zoe", seed=0, sample=False, max_tokens=3))
    want = jr.last_trace
    st = report["stages"]
    assert st["prompt_ids"] == want["prompt_ids"]
    assert st["n_prompt_tokens"] == want["n_prompt_tokens"]
    got, jax_top = st["step0_logits"]["argmax"], want["step0_logits"]["argmax"]
    if got != jax_top:
        tr = runner_from_file(path, device="cpu")
        prompt = tr._prompt_ids("hi", to.GenerationConfig(voice="zoe"))
        row = orpheus_logits_along(tr.params, tr.cfg, prompt, [got])[0]
        assert row.max() - row[jax_top] < TIE, f"step 0: {got} against JAX's {jax_top}"
    assert st["n_tokens"] == 3 and len(st["head_lengths"]) == 3
    assert report["checkpoint"]["architecture"] == "orpheus"
    assert report["checkpoint"]["tensor_types"] == \
        jax_parity_report.checkpoint_inventory(path)["tensor_types"]
    json.dumps(report)
    parity_report.print_report(report)


# ------------------------------------------------------- step breakdown ---
@pytest.fixture(scope="module", params=["Q8_0", "Q4_0"])
def tiny_orpheus(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("orpheus") / f"tiny_{request.param}.gguf"
    write_random_orpheus(str(path), qtype=request.param, n_layers=2, hidden=256, heads=4,
                         kv_heads=2, head_dim=128, ffn=512, vocab=4096, snac_embd=96,
                         snac_channels=(48, 24, 12, 6))
    r = runner_from_file(str(path), device="cpu")
    r.cfg = dataclasses.replace(r.cfg, max_context_length=CTX, max_generation_size=GEN)
    return r


def test_step_parts_compose_to_the_decode_step(tiny_orpheus):
    """body then head give orpheus_decode_step's logits at the position; the
    attention and linears parts make one flash_decode per layer and the
    step's 4 GEMVs per layer plus the head's; sample draws a token."""
    r = tiny_orpheus
    cache = to.init_kv_cache(r.cfg, "cpu")
    pos = 40
    parts = sb.step_parts(r.params, r.cfg, cache, pos, torch.Generator().manual_seed(0))
    assert list(parts) == list(sb.PARTS)
    hidden = parts["body"]()
    logits = parts["head"]()
    torch.testing.assert_close(logits, to._head_logits(hidden[0], r.params, r.cfg),
                               rtol=0, atol=0)
    want = to.orpheus_decode_step(r.params, r.cfg, torch.zeros(1, dtype=torch.int32),
                                  torch.tensor([pos], dtype=torch.int32), cache)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    assert len(parts["attn"]()) == r.cfg.n_layers
    outs = parts["linears"]()
    assert len(outs) == 4 * r.cfg.n_layers + 1 and outs[-1].shape[-1] >= r.cfg.vocab_size
    token = parts["sample"]()
    assert token.shape == (1,) and 0 <= int(token) < r.cfg.vocab_size


def test_step_breakdown_needs_a_card(tiny_orpheus, monkeypatch):
    r = tiny_orpheus
    with pytest.raises(TTSError, match="CUDA graphs"):
        sb.breakdown(r.params, r.cfg, to.init_kv_cache(r.cfg, "cpu"))
    with pytest.raises(TTSError, match="not a card"):
        sb.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TTSError, match="no CUDA device"):
        sb.main(["--quant", "q8"])
