"""The port's Dia forward pass against the JAX package's, on tiny dense, Q8_0
and Q4_0 GGUFs (tests/torch_tiny.py's write_tiny_dia: the JAX builder and
its quantize tool), each package reading the file with its own reader and
loader: the tokenizer, the loader's packed set, the encoder, the cross K/V,
and the CFG-merged logits of sequential steps and of a T-row verify
forward along a staircase of input rows.  JAX's GEMMs run their Pallas
kernels in interpret mode, as its own tests run them."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import DIA_QTYPES as QTYPES, dia_models, write_tiny_dia  # noqa: E402
from tts_tpu.models import dia as jd  # noqa: E402
from tts_tpu.runtime.api import TTSError as JaxTTSError  # noqa: E402
from tts_tpu_torch.models import dia as td  # noqa: E402
from tts_tpu_torch.codecs.snac import params_from_jax  # noqa: E402
from tts_tpu_torch.runtime.api import TTSError  # noqa: E402

torch.set_num_threads(1)

TEXT = "[S1] Hello there. [S2] Hi!"
# f32 on both sides; the same products in another order: the encoder's
# states (about +-0.35) and the dense model's logits agree to ~1e-6
F32_TOL = 1e-5
# the CFG-merged logits (about +-0.2; ~1e-6 apart here on every file) on
# quantized files: the caches hold bf16, and an f32 value that differs in its
# last bit between the packages can round to a neighbouring bf16 (2^-8
# relative); the merge multiplies a row's difference by up to 1 + 2 x 3 = 7
MERGED_TOL = {"dense": F32_TOL, "Q8_0": 1e-4, "Q4_0": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> the models of torch_tiny's Dia (dense, Q8_0, Q4_0),
    each built on first use."""
    built = {}
    root = tmp_path_factory.mktemp("dia")

    def get(qtype):
        if qtype not in built:
            built[qtype] = dia_models(write_tiny_dia(root, qtype))
        return built[qtype]
    return get


def _tokens(cfg, text=TEXT):
    ids = jd.tokenize_dia_sentence(text, cfg)
    tokens = np.zeros((2, cfg.max_encoder_context_length), np.int32)
    tokens[0, :len(ids)] = ids
    return tokens, len(ids)


def _encoded(tiny, qtype):
    """(models, JAX encoder states, port encoder states, n_valid)."""
    jcfg, jparams, tcfg, tparams = models = tiny(qtype)
    tokens, n = _tokens(jcfg)
    je = np.asarray(jd.dia_encode(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(n)))
    te = td.dia_encode(tparams, tcfg, torch.from_numpy(tokens), n)
    return models, je, te, n


def _jax_cross_as_port(cross) -> dict:
    """JAX's cross K/V [L, 2, T, H, hs] in the port's layout (K [L, 2, H,
    hs, T], V [L, 2, H, T, hs]) and f32."""
    k = np.asarray(cross["k"].astype(jnp.float32)).transpose(0, 1, 3, 4, 2)
    v = np.asarray(cross["v"].astype(jnp.float32)).transpose(0, 1, 3, 2, 4)
    return {"k": torch.from_numpy(np.ascontiguousarray(k)),
            "v": torch.from_numpy(np.ascontiguousarray(v))}


@pytest.mark.parametrize("text", ["hello", "[S1] Hi. [S2] Hey there.", "[S2] ends with a dot.",
                                  "  café, naïve  ", "x" * 1021])
def test_tokenizer_matches_jax(text):
    """Byte tokens with [S1]/[S2] as 0x01/0x02, a leading [S1] and a final
    period added where missing (1021 bytes fill the 1024-byte context);
    too long an input raises in both."""
    cfg = td.DiaConfig()
    assert td.tokenize_dia_sentence(text, cfg) == jd.tokenize_dia_sentence(text, jd.DiaConfig())
    with pytest.raises(TTSError):
        td.tokenize_dia_sentence("x" * 1025, cfg)
    with pytest.raises(JaxTTSError):
        jd.tokenize_dia_sentence("x" * 1025, jd.DiaConfig())


def test_config_matches_jax(tiny):
    """Both packages read the same DiaConfig from the file (the port's has
    the JAX package's fields) and switch quantized files to bf16 caches."""
    for qtype in QTYPES:
        jcfg, _, tcfg, _ = tiny(qtype)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.kv_dtype == ("float32" if qtype == "dense" else "bfloat16")


@pytest.mark.parametrize("qtype", QTYPES)
def test_loader_matches_jax(tiny, qtype):
    """Both loaders quantize the same set of decoder linears, in the same
    format (int8 on Q8_0, packed int4 on Q4_0; dense on the dense file),
    and every tensor, packed or dense, equals the JAX loader's (its f16
    scales as their uint16 bits; the heads bf16 on quantized files)."""
    _, jparams, _, tparams = tiny(qtype)
    jnp_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    names = ("sa_q", "sa_k", "sa_v", "sa_o", "ca_q", "ca_k", "ca_v", "ca_o", "gate", "up", "wo")
    key = {"dense": None, "Q8_0": "wq", "Q4_0": "wq4"}[qtype]
    for jl, tl in zip(jnp_params["decoder"]["layers"], tparams["decoder"]["layers"], strict=True):
        for n in names:
            if key is None:
                assert isinstance(jl[n], torch.Tensor) and set(tl[n]) == {"w"}
                torch.testing.assert_close(tl[n]["w"], jl[n], rtol=0, atol=0)
            else:
                assert set(jl[n]) == set(tl[n]) == {key, "scales"}, n
                for part in (key, "scales"):
                    assert tl[n][part].dtype == jl[n][part].dtype
                    torch.testing.assert_close(tl[n][part], jl[n][part], rtol=0, atol=0)
    jenc, tenc = jnp_params["encoder"], tparams["encoder"]
    for jl, tl in zip(jenc["layers"], tenc["layers"], strict=True):
        for n in jl:
            torch.testing.assert_close(tl[n], jl[n], rtol=0, atol=0)
    torch.testing.assert_close(tenc["embedding"], jenc["embedding"], rtol=0, atol=0)
    jdec, tdec = jnp_params["decoder"], tparams["decoder"]
    torch.testing.assert_close(tdec["embds"], torch.stack(jdec["embds"]), rtol=0, atol=0)
    heads = torch.stack(jdec["heads"])
    assert tdec["heads"].dtype == heads.dtype == (torch.float32 if key is None
                                                  else torch.bfloat16)
    torch.testing.assert_close(tdec["heads"], heads, rtol=0, atol=0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_encoder_matches_jax(tiny, qtype):
    """The encoder at the full 128-byte context (block mask, unscaled
    softmax), cond and uncond rows, within F32_TOL (states about +-0.35)."""
    _, je, te, _ = _encoded(tiny, qtype)
    assert te.shape == je.shape == (2, 128, 256)
    np.testing.assert_allclose(te.numpy(), je, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_cross_kv_matches_jax(tiny, qtype):
    """The cross K (roped, zero past the prompt) and V (full length) from
    the same encoder states: exact up to f32 order on the dense file; on
    quantized ones both round to bf16, so a value may sit one bf16 step
    from JAX's (at most 2^-7 of the largest magnitude)."""
    (jcfg, jparams, tcfg, tparams), je, _, n = _encoded(tiny, qtype)
    want = _jax_cross_as_port(jd.dia_cross_kv(jparams, jcfg, jnp.asarray(je), jnp.asarray(n)))
    got = td.dia_cross_kv(tparams, tcfg, torch.from_numpy(je.copy()), n)
    assert not got["k"][..., n:].any() and got["v"][..., n:, :].any()
    for part in ("k", "v"):
        assert got[part].shape == want[part].shape and got[part].dtype == torch.float32
        tol = F32_TOL if qtype == "dense" else 2.0 ** -7 * float(want[part].abs().max())
        torch.testing.assert_close(got[part], want[part], atol=tol, rtol=0)


def _staircase(cfg, n: int, seed: int = 0) -> np.ndarray:
    """n sequential-loop input rows along random outputs: the all-BOS row,
    then each output through the BOS staircase."""
    rows = np.random.default_rng(seed).integers(0, cfg.audio_vocab_size, (n, 9)).astype(np.int32)
    tokens, delay, _ = td.dia_init_loop_state(cfg)
    ins = []
    for i, row in enumerate(rows):
        ins.append(tokens)
        tokens, delay = td._drain_step(cfg, row, i + 1, delay, 10_000)
    return np.stack(ins)


@partial(jax.jit, static_argnums=(1,))
def _jax_step(params, cfg, row, pos, cache, cross):
    return jd._dia_step(params, cfg, row, pos, cache, cross)


@partial(jax.jit, static_argnums=(1,))
def _jax_rows(params, cfg, rows, pos, cache, cross):
    return jd._dia_step_multi(params, cfg, rows, pos, cache, cross)


@pytest.mark.parametrize("qtype", QTYPES)
def test_step_and_rows_logits_match_jax(tiny, qtype):
    """Along a 12-row staircase from the same cross K/V: 4 sequential steps
    (M = 2 GEMMs), then one 8-row forward at positions 4..11 (M = 16), and
    step 0's probe: the CFG-merged logits (ids past EOS at -inf in both)
    within MERGED_TOL of JAX's _dia_step / _dia_step_multi."""
    (jcfg, jparams, tcfg, tparams), je, _, n = _encoded(tiny, qtype)
    jcross = jd.dia_cross_kv(jparams, jcfg, jnp.asarray(je), jnp.asarray(n))
    cross = _jax_cross_as_port(jcross)
    ins = _staircase(tcfg, 12)
    jcache = jd.init_dia_cache(jcfg)
    want = []
    for i in range(4):
        m, jcache = _jax_step(jparams, jcfg, jnp.asarray(ins[i]), jnp.asarray(i, jnp.int32),
                              jcache, jcross)
        want.append(np.asarray(m))
    m, _ = _jax_rows(jparams, jcfg, jnp.asarray(ins[4:]), jnp.asarray(4, jnp.int32), jcache,
                     jcross)
    want = np.concatenate([np.stack(want), np.asarray(m)])
    want0 = np.asarray(jd.dia_step0_logits(jparams, jcfg, jd.init_dia_cache(jcfg), jcross))

    cache = td.init_dia_cache(tcfg)
    got0 = td.dia_step0_logits(tparams, tcfg, cache, cross).numpy()
    got = torch.cat([td._dia_rows(tparams, tcfg, torch.from_numpy(ins[i:i + 1]), i, cache, cross)
                     for i in range(4)]
                    + [td._dia_rows(tparams, tcfg, torch.from_numpy(ins[4:]), 4, cache, cross)])
    got = got.numpy()
    assert got.shape == want.shape == (12, 9, 1028)
    for a, b in ((got, want), (got0, want0)):
        assert (np.isinf(a) == np.isinf(b)).all() and np.isinf(a[..., 1025:]).all()
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=MERGED_TOL[qtype], rtol=0)
    np.testing.assert_array_equal(got0, got[0])
