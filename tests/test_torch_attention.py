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


def emulate_flash_decode(q, k, v, pos, ks=None, vs=None):
    """The Hopper flash_decode's arithmetic on the CPU: chunks of
    KERNEL_CHUNK positions, each over its live slots only with its softmax
    against its own max m_c (sum l_c, acc_c of bf16(p * v_scale) v), then
    the last CTA's combine: w_c = e^(m_c - M), out = sum w_c acc_c /
    sum w_c l_c.  A single live chunk writes acc / l directly."""
    Hq, hs = q.shape
    Hkv = k.shape[0]
    chunk = ta.KERNEL_CHUNK
    qg = q.reshape(Hkv, Hq // Hkv, hs).to(torch.bfloat16).float()
    parts = []
    for c in range(pos // chunk + 1):
        sl = slice(c * chunk, min((c + 1) * chunk, pos + 1))
        logits = torch.einsum("hgd,hsd->hgs", qg, k[:, sl].float()) / hs ** 0.5
        if ks is not None:
            logits = logits * ks[:, None, sl]
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        pv = p if vs is None else p * vs[:, None, sl]
        acc = torch.einsum("hgs,hsd->hgd", pv.to(torch.bfloat16).float(), v[:, sl].float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    if len(parts) == 1:
        _, l, acc = parts[0]
        return (acc / l).reshape(Hq, hs)
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    acc = sum(wc * a for wc, (_, _, a) in zip(w, parts))
    l = sum(wc * lc for wc, (_, lc, _) in zip(w, parts))
    return (acc / l).reshape(Hq, hs)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, ta.KERNEL_CHUNK - 1, ta.KERNEL_CHUNK, 511, 3583])
def test_flash_decode_kernel_arithmetic_matches_plain(quant, pos):
    """The kernel's chunking and last-CTA combine (emulated) stay within the
    card test's 4e-3 of the plain version at the edges of its chunks and at
    a full Orpheus-3B-length cache (3 query heads per KV head, as there);
    rows past pos hold NaN and never reach the output."""
    rng = np.random.default_rng(pos + 7 * quant)
    hq, hkv, s = 6, 2, 3584
    q = torch.from_numpy(rng.standard_normal((hq, HS)).astype(np.float32))
    if quant:
        k, v = (torch.from_numpy(rng.integers(-127, 128, (hkv, s, HS)).astype(np.int8))
                for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((hkv, s)) * 0.02 + 1e-3).astype(np.float32))
                  for _ in range(2))
        ks[:, pos + 1:] = vs[:, pos + 1:] = float("nan")
    else:
        k, v = (torch.from_numpy(rng.standard_normal((hkv, s, HS)).astype(np.float32))
                .bfloat16() for _ in range(2))
        k[:, pos + 1:] = v[:, pos + 1:] = float("nan")
        ks = vs = None
    want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
    got = emulate_flash_decode(q, k, v, pos, ks, vs)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() < 4e-3


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_kv_cache_owns_zeroed_arrival_counters(kv_quant):
    """Each KV cache carries its own flash-decode arrival counters, int32
    zeros, one per KV head: two caches never share a set.  On the CPU
    flash_decode takes them and runs its plain version."""
    from tts_tpu_torch.models import orpheus as to

    cfg = to.OrpheusConfig(n_layers=1, hidden_size=256, n_attn_heads=HQ,
                           n_kv_attn_heads=HKV, head_size=HS, kv_quant=kv_quant,
                           max_context_length=64, max_generation_size=448)
    a, b = to.init_kv_cache(cfg), to.init_kv_cache(cfg)
    for cache in (a, b):
        assert cache["counters"].dtype == torch.int32
        assert cache["counters"].tolist() == [0] * HKV
    assert a["counters"].data_ptr() != b["counters"].data_ptr()
    q, k, v, ks, vs = _torch(*make_inputs(3, kv_quant))
    pos = torch.tensor([700], dtype=torch.int32)
    torch.testing.assert_close(ta.flash_decode(q, k, v, pos, ks, vs, a["counters"]),
                               ta.flash_decode_plain(q, k, v, 700, ks, vs), rtol=0, atol=0)
