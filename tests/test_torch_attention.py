"""The port's flash-decode attention (tts_tpu_torch.ops.attention) against
the JAX package's Pallas kernel (interpret mode on the CPU).  The Hopper
kernel is held to its plain version in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from tts_tpu.ops import attention as ja  # noqa: E402
from tts_tpu_torch.ops import attention as ta  # noqa: E402

torch.set_num_threads(1)

HQ, HKV, S, HS = 8, 2, 1024, 128


def make_inputs(seed, quant):
    """numpy q [Hq, hs] f32 and a head-major cache: f32 values (rounded to
    bf16 on each side), or int8 with f32 per-(head, position) scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HQ, HS)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (HKV, S, HS)).astype(np.int8)
        v = rng.integers(-127, 128, (HKV, S, HS)).astype(np.int8)
        ks = (rng.random((HKV, S)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((HKV, S)) * 0.02 + 0.001).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((HKV, S, HS)).astype(np.float32)
    v = rng.standard_normal((HKV, S, HS)).astype(np.float32)
    return q, k, v, None, None


def _jax(q, k, v, ks, vs, pos):
    kv = (lambda a: jnp.asarray(a)) if ks is not None else (
        lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    out = ja.gqa_decode_attention_dyn(
        jnp.asarray(q), kv(k), kv(v), jnp.asarray(pos, jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True)
    return np.asarray(out)


def _torch(q, k, v, ks, vs):
    kv = torch.from_numpy if ks is not None else (lambda a: torch.from_numpy(a).bfloat16())
    sc = (lambda a: None if a is None else torch.from_numpy(a))
    return torch.from_numpy(q), kv(k), kv(v), sc(ks), sc(vs)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 511, 512, S - 1])
def test_flash_decode_plain_matches_jax(quant, pos):
    """Same chunked online softmax with q, k, p, v rounded to bf16 at the same
    places; only f32 summation order and exp's last ulp differ (measured
    max 1.5e-7 on outputs of magnitude 0.2-3.5), so atol = rtol = 1e-5."""
    q, k, v, ks, vs = make_inputs(pos + 7 * quant, quant)
    want = _jax(q, k, v, ks, vs, pos)
    tq, tk, tv, tks, tvs = _torch(q, k, v, ks, vs)
    got = ta.flash_decode(tq, tk, tv, torch.tensor([pos], dtype=torch.int32), tks, tvs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_decode_plain_ignores_rows_past_pos(quant):
    """The cache is reused across requests unzeroed: rows past pos (here
    NaN or inf) must not reach the output."""
    pos = 600
    q, k, v, ks, vs = make_inputs(3, quant)
    tq, tk, tv, tks, tvs = _torch(q, k, v, ks, vs)
    clean = ta.flash_decode_plain(tq, tk, tv, pos, tks, tvs)
    if quant:
        tks[:, pos + 1:] = float("nan")
        tvs[:, pos + 1:] = float("inf")
    else:
        tk[:, pos + 1:] = float("nan")
        tv[:, pos + 1:] = float("inf")
    dirty = ta.flash_decode_plain(tq, tk, tv, pos, tks, tvs)
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


def test_quantize_kv_matches_jax(rng):
    x = rng.standard_normal((5, 3, HS)).astype(np.float32)
    x[2, 1] = 0.0                                   # zero vector: scale 0
    wq, wsc = ja.quantize_kv(jnp.asarray(x))
    gq, gsc = ta.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gsc.numpy(), np.asarray(wsc))
