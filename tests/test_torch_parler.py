"""Parler-TTS on the port (tts_tpu_torch.models.parler and models.t5) against
the JAX package on the same GGUFs, in one process, each package reading them
with its own GGUF reader: loading, the cross-KV precompute, prefill and
decode logits, generate with its trace, the conditional prompt and T5.

The tiny model (tests/torch_tiny.py): 2 layers, hidden 256, 4 heads of 64,
FFN 512, a 512-position context and 64 decode steps, the JAX builder's DAC;
dense (f32), or quantized by the JAX package's quantize tool to Q8_0 or Q4_0
(the cross-attention k/v too).  The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.  The decode loops and
the codec: tests/test_torch_parler_decode.py."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import (PARLER_QTYPES as QTYPES, first_part, parler_models,  # noqa: E402
                        port_logits_along, staircase_inputs, write_tiny_parler)
from tts_tpu.convert.builder_t5 import write_t5_gguf  # noqa: E402
from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile  # noqa: E402
from tts_tpu.models import parler as jp  # noqa: E402
from tts_tpu.models import t5 as jt5  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu.ops import qmatmul as jq  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.codecs import dac as tdac  # noqa: E402
from tts_tpu_torch.core.gguf import GGUFFile  # noqa: E402
from tts_tpu_torch.models import parler as tp  # noqa: E402
from tts_tpu_torch.models import t5 as tt5  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops import qmatmul as tq  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

TEXT = "hello world"
# Logits against JAX, as a share of max |logit|.  Dense: f32 on both sides,
# sums in another order.  Quantized, one row per forward (the GEMV): bf16
# roundings of x that differ where an f32 sum differs in its last bit (see
# torch_tiny.PARLER_TIE), carried through 2 layers.
LOGIT_TOL = {"dense": 1e-5, "Q8_0": 2e-2, "Q4_0": 2e-2}
# Eight rows per forward (the GEMM: prefill, verify): f32 x on both sides.
GEMM_LOGIT_TOL = {"dense": 1e-5, "Q8_0": 1e-4, "Q4_0": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, models) of torch_tiny's Parler, dense, Q8_0 or
    Q4_0; each is built on first use."""
    built = {}
    root = tmp_path_factory.mktemp("parler")

    def get(qtype):
        if qtype not in built:
            path = write_tiny_parler(root, qtype)
            built[qtype] = path, parler_models(path)
        return built[qtype]
    return get


def _prompt(tokenizer):
    return tokenizer.tokenize(TEXT) + [tokenizer.eos_token]


@pytest.fixture(scope="module")
def t5_path(tmp_path_factory):
    """A tiny T5 whose output width is the tiny Parler's encoding width."""
    return str(write_t5_gguf(tmp_path_factory.mktemp("t5") / "t5.gguf", seed=1, out_size=64))


@partial(jax.jit, static_argnums=(1,))
def _jax_rows_logits(params, cfg, rows, pos, cache, cross_kv):
    """JAX's forward of input rows [T, 9] at positions pos.. (its decode and
    verify bodies): per-head logits [T, 9, vocab] and the cache."""
    T = rows.shape[0]
    embds, heads = jnp.stack(params["embds"]), jnp.stack(params["heads"])
    x = jnp.sum(embds[jnp.arange(cfg.n_output_heads)[None, :], rows], axis=1)
    x = x + jax.lax.dynamic_slice(params["positional"], (pos, 0), (T, x.shape[1]))
    x, cache = jp._transformer(params, cfg, x, cache, pos, pos + jnp.arange(T), cross_kv)
    return jnp.einsum("td,hdv->thv", x, heads), cache


def _jax_prefill(jcfg, jparams, ids, cross):
    cache = jp.init_kv_cache(jcfg)
    toks = np.zeros(16, np.int32)
    toks[:len(ids)] = ids
    return jp.parler_prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(len(ids), jnp.int32),
                             cache, cross)



# ---------------------------------------------------------------- loading ---
@pytest.mark.parametrize("qtype", QTYPES)
def test_loader_matches_jax(tiny, qtype):
    """The port's loader gives the JAX loader's tensors: int8 or packed int4
    weights and f16 scales (JAX: the scales' f16 bits) where quantized,
    f32 dense weights, the 9 embeddings and heads stacked (bf16 heads on
    quantized files), and the cache in bf16 on quantized files."""
    _, (jcfg, jparams, tcfg, tparams) = tiny(qtype)
    want = dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg) == {k: want[k] for k in dataclasses.asdict(tcfg)}
    assert tcfg.kv_dtype == ("float32" if qtype == "dense" else "bfloat16")
    for name in ("prompt_embd", "positional", "text_encoding", "norm_w", "norm_b"):
        torch.testing.assert_close(tparams[name], torch.from_numpy(np.array(jparams[name])),
                                   rtol=0, atol=0)
    np.testing.assert_array_equal(tparams["embds"].numpy(), np.stack(jparams["embds"]))
    want_heads = np.stack([np.asarray(h, np.float32) for h in jparams["heads"]])
    assert tparams["heads"].dtype == (torch.float32 if qtype == "dense" else torch.bfloat16)
    np.testing.assert_array_equal(tparams["heads"].float().numpy(), want_heads)
    key = {"dense": "w", "Q8_0": "wq", "Q4_0": "wq4"}[qtype]
    for tl, jl in zip(tparams["layers"], jparams["layers"], strict=True):
        for name, tv in tl.items():
            jv = jl[name]
            if isinstance(tv, dict):
                assert set(tv) == ({key, "scales"} if key != "w" else {"w"}), name
                if key == "w":
                    np.testing.assert_array_equal(tv["w"].numpy(), np.asarray(jv))
                else:
                    np.testing.assert_array_equal(tv[key].numpy(), np.asarray(jv[key]))
                    np.testing.assert_array_equal(
                        tv["scales"].numpy(), np.asarray(jv["scales"]).view(np.float16))
            else:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("qtype", QTYPES)
def test_cross_kv_matches_jax(tiny, qtype):
    """The cross-KV precompute (the GEMMs at M = the 12-row encoding on
    quantized files, both sides f32 x): dense within 1e-6 of the peak;
    quantized rounded to bf16 on both sides (the port keeps the rounded
    values in f32), so within one bf16 step (2^-8 of the peak) where an f32
    difference flips a rounding."""
    _, (jcfg, jparams, tcfg, tparams) = tiny(qtype)
    want = jp.precompute_cross_kv(jparams, jcfg)
    got = tp.precompute_cross_kv(tparams, tcfg)
    for k in ("k", "v"):
        w = np.asarray(want[k], np.float32)
        g = got[k].numpy()
        assert g.shape == w.shape == (2, 12, 4, 64) and got[k].dtype == torch.float32
        assert torch.equal(got[k], got[k].to(getattr(torch, tcfg.kv_dtype)).float())
        tol = 1e-6 if qtype == "dense" else 2.0 ** -8
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ---------------------------------------------------------------- forward ---
@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("width", [1, 8], ids=["step", "verify"])
def test_prefill_and_step_logits_match_jax(tiny, qtype, width):
    """Exact-length prefill (JAX: a 16-token bucket), then 16 teacher-forced
    rows, one per forward (the decode step, M = 1: the GEMV) or 8 per
    forward (the speculative verify, M = 8: the GEMM), on JAX's loop's
    greedy rows.  Logits within LOGIT_TOL (GEMV) or GEMM_LOGIT_TOL (GEMM)
    of max |logit|."""
    path, (jcfg, jparams, tcfg, tparams) = tiny(qtype)
    tok = runner_from_file(path, device="cpu").tokenizer
    ids = _prompt(tok)
    rng = np.random.default_rng(5)
    emitted = rng.integers(0, 1024, (16, 9)).astype(np.int32)
    ins = staircase_inputs(tcfg, emitted)
    jcross = jp.precompute_cross_kv(jparams, jcfg)
    cache = _jax_prefill(jcfg, jparams, ids, jcross)
    want = []
    for i in range(0, 16, width):
        lg, cache = _jax_rows_logits(jparams, jcfg, jnp.asarray(ins[i:i + width]),
                                     jnp.asarray(len(ids) + i, jnp.int32), cache, jcross)
        want.append(np.asarray(lg))
    want = np.concatenate(want)
    got = port_logits_along(tcfg, tparams, ids, ins, width).numpy()
    assert got.shape == want.shape == (16, 9, 1088)
    tol = (LOGIT_TOL if width == 1 else GEMM_LOGIT_TOL)[qtype]
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("qtype", QTYPES)
def test_generate_matches_jax(tiny, qtype, monkeypatch):
    """runner.generate, greedy (both take the speculative loop), with
    capture_trace on: the port emits JAX's rows up to the first near-tie
    (all 56 on the dense model), and, where the rows all agree, JAX's
    audio within 1e-5 on all but the last RECEPTIVE_FRAMES frames (JAX's
    DAC decodes a 64-frame bucket: test_dac_matches_jax)."""
    path, (_, _, tcfg, tparams) = tiny(qtype)
    rows = {}

    def recording(key, fn):
        return lambda out, cfg: (rows.__setitem__(key, np.array(out)), fn(out, cfg))[1]

    monkeypatch.setattr(jp, "adjust_output_tokens", recording("jax", jp.adjust_output_tokens))
    monkeypatch.setattr(tp, "adjust_output_tokens", recording("port", tp.adjust_output_tokens))
    jr, tr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    jr.capture_trace = tr.capture_trace = True
    want = jr.generate(TEXT, JaxGenerationConfig(seed=0, max_tokens=56, sample=False))
    got = tr.generate(TEXT, GenerationConfig(seed=0, max_tokens=56, sample=False))
    assert got.timings["decode_steps"] == want.timings["decode_steps"] == 56
    assert got.sample_rate == want.sample_rate == 44100
    ids = _prompt(tr.tokenizer)
    part, _ = first_part(
        port_logits_along(tcfg, tparams, ids, staircase_inputs(tcfg, rows["jax"])), rows["jax"])
    np.testing.assert_array_equal(rows["port"][:part], rows["jax"][:part])
    frames = tp.adjust_output_tokens(rows["port"], tcfg)
    assert got.audio.shape == (len(frames) * 512,) and len(frames) > 0
    # capture_trace: the same prompt ids and step count; step 0's per-head
    # argmax (parler_step0_logits) JAX's up to near-ties
    for k in ("prompt_ids", "n_prompt_tokens", "n_steps"):
        assert tr.last_trace[k] == jr.last_trace[k], k
    cache = tp.init_kv_cache(tcfg, "cpu")
    tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, tr.cross_kv)
    step0 = tp.parler_step0_logits(tparams, tcfg, len(ids), cache, tr.cross_kv)
    assert tr.last_trace["step0_logits"]["per_head_argmax"] == step0.argmax(-1).tolist()
    first_part(step0[None], [jr.last_trace["step0_logits"]["per_head_argmax"]])
    if qtype == "dense":
        assert part == 56
    if part == 56:
        keep = max(0, len(frames) - tdac.DACDecoder.RECEPTIVE_FRAMES) * 512
        assert keep > 0
        np.testing.assert_allclose(got.audio[:keep], want.audio[:keep], atol=1e-5, rtol=0)


def test_adjust_output_tokens_matches_jax():
    """Delay un-weave and invalid-frame filter, exactly, on random rows with
    ids past the audio vocabulary mixed in."""
    rng = np.random.default_rng(0)
    for steps in (0, 5, 9, 10, 40):
        out = rng.integers(0, 1100, (steps, 9)).astype(np.int32)
        out[rng.random((steps, 9)) < 0.9] %= 1024
        got = tp.adjust_output_tokens(out, tp.ParlerConfig())
        want = jp.adjust_output_tokens(out, jp.ParlerConfig())
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
@pytest.mark.parametrize("shape", [(), (1,), (3, 4)], ids=["K", "1xK", "3x4xK"])
def test_apply_linear_matches_jax(tiny, qtype, shape):
    """apply_linear flattens leading dims: one row takes the GEMV (x rounded
    to bf16), more the GEMM (f32 x), as in JAX; within 1e-5 of the peak.
    At fc2 (K = 512): at K = 256 JAX's int4 M = 1 product finds no
    block-diagonal tile and keeps x in f32."""
    _, (_, jparams, _, tparams) = tiny(qtype)
    x = np.random.default_rng(1).standard_normal(shape + (512,)).astype(np.float32)
    got = tq.apply_linear(torch.from_numpy(x), tparams["layers"][0]["fc2"]).numpy()
    want = np.asarray(jq.apply_linear(jnp.asarray(x), jparams["layers"][0]["fc2"]))
    assert got.shape == want.shape == shape + (256,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("qtype", ["dense", "Q4_0"])
def test_update_conditional_prompt_matches_jax(tiny, t5_path, qtype):
    """Swapping the conditioning prompt: the port's runner encodes it with
    the T5 GGUF (with the Parler tokenizer, as JAX does) and recomputes the
    cross-KV; both within tolerance of the JAX runner's after the same call
    (the encoding 1e-5 of its peak; the cross-KV as in
    test_cross_kv_matches_jax), and generation follows the new encoding."""
    path = tiny(qtype)[0]
    jr, tr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    before = tr.generate(TEXT, GenerationConfig(seed=0, max_tokens=20, sample=False)).audio
    jr.update_conditional_prompt(t5_path, "a calm voice")
    tr.update_conditional_prompt(t5_path, "a calm voice")
    want = np.asarray(jr.params["text_encoding"])
    got = tr.params["text_encoding"].numpy()
    assert got.shape == want.shape == (len(tr.tokenizer.tokenize("a calm voice")) + 1, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    tol = 1e-5 if qtype == "dense" else 2.0 ** -8
    for k in ("k", "v"):
        w = np.asarray(jr.cross_kv[k], np.float32)
        assert np.abs(tr.cross_kv[k].float().numpy() - w).max() <= tol * np.abs(w).max()
    after = tr.generate(TEXT, GenerationConfig(seed=0, max_tokens=20, sample=False)).audio
    assert not (before.shape == after.shape and np.array_equal(before, after))
    with pytest.raises(FileNotFoundError):
        tr.update_conditional_prompt("/nonexistent/t5.gguf", "calm")


def test_t5_encoder_matches_jax(t5_path):
    """T5Runner.encode at the exact token count against JAX's (a 32-token
    bucket with the pad keys masked): within 1e-5 of the peak; the bucket
    formula's output equal."""
    with JaxGGUFFile(t5_path) as f:
        want = jt5.T5Runner.from_gguf(f).encode("a calm female voice, close up")
    with GGUFFile(t5_path) as f:
        got = tt5.T5Runner.from_gguf(f, device="cpu").encode("a calm female voice, close up")
    assert got.shape == want.shape and got.shape[1] == 64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for n in (1, 9, 40, 300):
        np.testing.assert_array_equal(tt5.relative_position_buckets(n, device="cpu").numpy(),
                                      np.asarray(jt5.relative_position_buckets(n)))
