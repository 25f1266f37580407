"""Parler's decode-step self-attention wrapper, `ops.attention.
prefix_attention`, on the CPU: its plain version is the masked read of the
whole cache that the JAX package's decode step makes (so every CPU parity
test of Parler against the JAX package computes what it computed before
the card got its kernel), its argument checks, the arrival counters the
Parler cache carries for the card, and the decode step's one call a layer.
The kernel itself is held to the plain version on the card, in
tests/test_torch_kernels.py."""

import dataclasses

import pytest
import torch

from tts_tpu_torch.models import parler as tp
from tts_tpu_torch.ops import attention as ta

torch.set_num_threads(1)

# Parler-TTS mini v1's self-attention: 16 heads of 64 over 4,096 slots
H, HS, S = 16, 64, 4096
GARBAGE = 1e5
POSITIONS = {"first": 0, "chunk_end": 63, "chunk_start": 64, "middle": 2047, "last": S - 1}


def _inputs(pos: int, dtype, seed: int = 0, s: int = S, hs: int = HS):
    """q [1, H, hs] f32 and a cache layer [s, H, hs] in `dtype`: random
    K/V at slots <= pos, finite garbage of size GARBAGE past it."""
    g = torch.Generator().manual_seed(seed + pos)
    q = torch.randn((1, H, hs), generator=g)
    k = torch.randn((s, H, hs), generator=g) * 0.5
    v = torch.randn((s, H, hs), generator=g)
    for t in (k, v):
        t[pos + 1:] = (torch.rand(t[pos + 1:].shape, generator=g) * 2 - 1) * GARBAGE
    return q, k.to(dtype), v.to(dtype), torch.tensor([pos], dtype=torch.int32)


def _masked_read(q, k, v, pos):
    """The decode step's read before the kernel, written out: the whole
    cache under the additive mask (0 up to pos, -1e9 past it)."""
    key_pos = torch.arange(k.shape[0])
    mask = torch.where(key_pos[None, :] <= pos[:, None], 0.0, -1e9)
    logits = torch.matmul(q.transpose(0, 1), k.float().permute(1, 2, 0)) / (q.shape[-1] ** 0.5)
    w = torch.softmax(logits + mask, dim=-1)
    return torch.matmul(w, v.float().transpose(0, 1)).transpose(0, 1).reshape(1, -1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("where", list(POSITIONS))
def test_plain_is_the_full_masked_read_bit_for_bit(where, dtype):
    """At the first slot, both edges of a 64-slot chunk, a middle slot and
    the last, with 1e5-sized finite garbage past pos: the wrapper on CPU
    tensors gives the masked read's bits, and the garbage weighs nothing
    (the live prefix alone gives the same output within f32 rounding)."""
    pos = POSITIONS[where]
    q, k, v, pos_t = _inputs(pos, dtype)
    got = ta.prefix_attention(q, k, v, pos_t)
    assert got.shape == (1, H * HS) and got.dtype == torch.float32
    assert torch.equal(got, _masked_read(q, k, v, pos_t))
    assert torch.equal(got, ta.prefix_attention_plain(q, k, v, pos_t))
    live = ta.attend(q, k[:pos + 1], v[:pos + 1], None)
    torch.testing.assert_close(got, live, rtol=1e-5, atol=1e-5)


def test_the_counters_are_ignored_on_the_cpu():
    q, k, v, pos = _inputs(100, torch.bfloat16)
    counters = ta.arrival_counters(H, "cpu")
    assert torch.equal(ta.prefix_attention(q, k, v, pos, counters),
                       ta.prefix_attention(q, k, v, pos))
    assert not counters.any()


def _bad(case: str):
    """Arguments the wrapper refuses, one fault each."""
    q, k, v, pos = _inputs(5, torch.bfloat16, s=256)
    return {
        "q_batch": (q.expand(2, H, HS).contiguous(), k, v, pos),
        "q_heads": (q[:, :8].contiguous(), k, v, pos),
        "kv_shapes": (q, k, v[:128], pos),
        "q_dtype": (q.bfloat16(), k, v, pos),
        "cache_f16": (q, k.half(), v.half(), pos),
        "kv_dtypes": (q, k, v.float(), pos),
        "head_major": (q, k.transpose(0, 1).contiguous().transpose(0, 1), v, pos),
        "pos_int64": (q, k, v, pos.long()),
        "pos_two": (q, k, v, torch.tensor([5, 6], dtype=torch.int32)),
        "pos_scalar": (q, k, v, pos.reshape(())),
    }[case]


@pytest.mark.parametrize("case", ["q_batch", "q_heads", "kv_shapes", "q_dtype", "cache_f16",
                                  "kv_dtypes", "head_major", "pos_int64", "pos_two",
                                  "pos_scalar"])
def test_the_wrapper_refuses_what_it_does_not_take(case):
    with pytest.raises(ValueError, match="prefix_attention"):
        ta.prefix_attention(*_bad(case))


@pytest.mark.parametrize("case", ["head_size", "ragged_cache", "long_cache", "no_counters",
                                  "counters_int64", "few_counters"])
def test_the_kernels_own_needs_are_refused_before_a_launch(case):
    """What only the kernel needs (head size 64, whole 64-slot chunks up to
    its limit, the cache's int32 arrival counters) is checked on the card
    before the launch; the plain version takes any head size."""
    hs = 128 if case == "head_size" else HS
    s = {"ragged_cache": 100, "long_cache": 2 * ta._PA_MAX_S}.get(case, 256)
    q, k, v, pos = _inputs(5, torch.bfloat16, s=s, hs=hs)
    counters = {"no_counters": None, "counters_int64": torch.zeros(H, dtype=torch.int64),
                "few_counters": torch.zeros(H - 1, dtype=torch.int32)}.get(
                    case, ta.arrival_counters(H, "cpu"))
    ta.prefix_attention(q, k, v, pos, counters)           # the plain version takes it
    with pytest.raises(ValueError, match="prefix_attention"):
        ta.prefix_card_checks(q, k, v, pos, counters)


def test_the_card_checks_take_parlers_cache():
    q, k, v, pos = _inputs(5, torch.bfloat16)
    ta.prefix_card_checks(q, k, v, pos, ta.arrival_counters(H, "cpu"))


def _tiny_parler(n_layers: int = 2):
    """A random dense 2-layer Parler (hidden 256, 4 heads of 64, 512
    positions) by the port's own builder, loaded on the CPU."""
    import numpy as np

    from tts_tpu_torch.convert.builder_parler import build_parler_tensors

    tensors, kv = build_parler_tensors(np.random.default_rng(0), n_layers=n_layers,
                                       hidden=256, heads=4, ffn=512)
    cfg = tp.ParlerConfig.from_gguf_kv(kv)
    assert (cfg.n_layers, cfg.head_size, cfg.max_ctx_length) == (n_layers, 64, 512)
    return cfg, tp.load_parler_params(tensors, cfg, "cpu")


def test_the_cache_carries_zeroed_arrival_counters():
    cfg = tp.ParlerConfig(n_layers=2, hidden_size=256, n_attn_heads=4, max_ctx_length=512)
    for dtype in ("float32", "bfloat16"):
        cache = tp.init_kv_cache(dataclasses.replace(cfg, kv_dtype=dtype), "cpu")
        assert cache["counters"].dtype == torch.int32
        assert cache["counters"].shape == (cfg.n_attn_heads,) and not cache["counters"].any()


def test_a_decode_step_calls_it_once_a_layer(monkeypatch):
    """A T = 1 forward at a device position takes its self-attention from
    prefix_attention, once a layer, with the cache's layer, the position
    and the cache's counters; the prefill does not call it."""
    cfg, params = _tiny_parler()
    cache = tp.init_kv_cache(cfg, "cpu")
    calls = []
    wrapped = ta.prefix_attention

    def counting(q, k, v, pos, counters=None):
        calls.append((k.data_ptr(), int(pos[0]), counters is cache["counters"]))
        return wrapped(q, k, v, pos, counters)

    monkeypatch.setattr(tp, "prefix_attention", counting)
    with torch.inference_mode():
        tp.parler_prefill(params, cfg, torch.arange(5), cache, None)
        assert not calls
        rows = torch.full((1, cfg.n_output_heads), cfg.bos_token_id, dtype=torch.int32)
        tp._rows_logits(params, cfg, rows, torch.tensor([5], dtype=torch.int32), cache, None)
    assert calls == [(cache["k"][l].data_ptr(), 5, True) for l in range(cfg.n_layers)]
