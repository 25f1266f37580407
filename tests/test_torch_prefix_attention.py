"""Parler's and Dia's decode-step self-attention wrapper, `ops.attention.
prefix_attention`, on the CPU: its plain version is the masked read of the
whole cache that the JAX package's decode steps make (so every CPU parity
test of Parler or Dia against the JAX package computes what it computed
before the card got its kernel), its argument checks, the arrival counters
the Parler and Dia caches carry for the card, and each decode step's one
call a layer.  The kernel itself is held to the plain version on the card,
in tests/test_torch_kernels.py."""

import dataclasses

import pytest
import torch

from tts_tpu_torch.models import dia as td
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


# Dia-1.6B's self-attention: the CFG pair (cond, uncond) of 16 query heads
# over 4 KV heads of 128 in a head-major 3,072-slot cache, unscaled
DIA_B, DIA_HKV, DIA_G, DIA_HS, DIA_S = 2, 4, 4, 128, 3072
DIA_POSITIONS = {"first": 0, "chunk_end": 63, "chunk_start": 64, "middle": 1023,
                 "last": DIA_S - 1}


def _dia_inputs(pos: int, dtype, seed: int = 0, s: int = DIA_S, hkv: int = DIA_HKV,
                g: int = DIA_G, hs: int = DIA_HS):
    """q [2, hkv * g, hs] f32 and a cache layer [2, hkv, s, hs] in `dtype`:
    random K/V at slots <= pos (K at about the size that makes Dia's
    unscaled logits wide), finite garbage of size GARBAGE past it."""
    gen = torch.Generator().manual_seed(seed + 7 * pos)
    q = torch.randn((DIA_B, hkv * g, hs), generator=gen)
    k = torch.randn((DIA_B, hkv, s, hs), generator=gen) * 0.3
    v = torch.randn((DIA_B, hkv, s, hs), generator=gen)
    for t in (k, v):
        t[:, :, pos + 1:] = (torch.rand(t[:, :, pos + 1:].shape, generator=gen) * 2 - 1) * GARBAGE
    return q, k.to(dtype), v.to(dtype), torch.tensor([pos], dtype=torch.int32)


def _dia_masked_read(q, k, v, pos):
    """Dia's decode-step read before the kernel, written out as the step
    made it: the query rows of a KV head g-major, the whole cache widened,
    the additive mask repeated per query row, no scale."""
    B, Hkv, S, hs = k.shape
    G = q.shape[1] // Hkv
    key_pos = torch.arange(S)
    mask = torch.where(key_pos[None, :] <= pos[:, None], 0.0, -1e9).repeat(G, 1)
    qg = q.reshape(B, 1, Hkv, G, hs).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G, hs)
    logits = torch.matmul(qg, k.float().transpose(2, 3)) + mask
    attn = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return attn.reshape(B, Hkv, G, 1, hs).permute(0, 3, 1, 2, 4).reshape(B, Hkv * G * hs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("where", list(DIA_POSITIONS))
def test_dia_plain_is_the_full_masked_read_bit_for_bit(where, dtype):
    """Dia's layout at its shapes, scale 1.0: the wrapper on CPU tensors
    gives the bits of the step's own masked read, and the garbage past pos
    weighs nothing (each query head against its KV head's live rows alone
    gives the same output within f32 rounding)."""
    pos = DIA_POSITIONS[where]
    q, k, v, pos_t = _dia_inputs(pos, dtype)
    got = ta.prefix_attention(q, k, v, pos_t, scale=1.0)
    assert got.shape == (DIA_B, DIA_HKV * DIA_G * DIA_HS) and got.dtype == torch.float32
    assert torch.equal(got, _dia_masked_read(q, k, v, pos_t))
    assert torch.equal(got, ta.prefix_attention_plain(q, k, v, pos_t, 1.0))
    kl = k[:, :, :pos + 1].float().repeat_interleave(DIA_G, dim=1)   # [2, 16, pos + 1, 128]
    vl = v[:, :, :pos + 1].float().repeat_interleave(DIA_G, dim=1)
    live = torch.softmax(q[:, :, None] @ kl.transpose(2, 3), dim=-1) @ vl
    torch.testing.assert_close(got, live.reshape(DIA_B, -1), rtol=1e-5, atol=1e-5)


def test_dia_counters_are_ignored_on_the_cpu():
    q, k, v, pos = _dia_inputs(100, torch.bfloat16, s=256)
    counters = ta.arrival_counters(DIA_B * DIA_HKV, "cpu")
    assert torch.equal(ta.prefix_attention(q, k, v, pos, counters, scale=1.0),
                       ta.prefix_attention(q, k, v, pos, scale=1.0))
    assert not counters.any()


def _dia_bad(case: str):
    """Dia-layout arguments the wrapper refuses, one fault each."""
    q, k, v, pos = _dia_inputs(5, torch.bfloat16, s=256)
    return {
        "q_batch": (q[:1].contiguous(), k, v, pos),
        "q_two_dims": (q.reshape(DIA_B, -1), k, v, pos),
        "q_head_size": (q[..., :64].contiguous(), k, v, pos),
        "q_ragged_group": (q[:, :15].contiguous(), k, v, pos),
        "q_fewer_heads": (q[:, :2].contiguous(), k, v, pos),
        "kv_shapes": (q, k, v[:, :, :128].contiguous(), pos),
        "cache_rank5": (q, k[None], v[None], pos),
        "cache_f16": (q, k.half(), v.half(), pos),
        "position_major": (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos),
        "pos_two": (q, k, v, torch.tensor([5, 6], dtype=torch.int32)),
    }[case]


@pytest.mark.parametrize("case", ["q_batch", "q_two_dims", "q_head_size", "q_ragged_group",
                                  "q_fewer_heads", "kv_shapes", "cache_rank5", "cache_f16",
                                  "position_major", "pos_two"])
def test_the_wrapper_refuses_what_neither_layout_takes(case):
    with pytest.raises(ValueError, match="prefix_attention"):
        ta.prefix_attention(*_dia_bad(case), scale=1.0)


@pytest.mark.parametrize("case", ["head_size_64", "one_query_head", "eight_query_heads",
                                  "ragged_cache", "long_cache", "no_counters", "few_counters"])
def test_the_kernel_refuses_a_head_major_layer_no_instance_takes(case):
    """The kernel's head-major instances take head size 128 with 4 (Dia-1.6B)
    or 2 (the tiny Dia) query heads per KV head, whole 64-slot chunks up to
    its limit and one counter per KV head of both rows (8); the plain
    version takes the rest."""
    hs = 64 if case == "head_size_64" else DIA_HS
    g = {"one_query_head": 1, "eight_query_heads": 8}.get(case, DIA_G)
    s = {"ragged_cache": 100, "long_cache": 2 * ta._PA_MAX_S}.get(case, 256)
    q, k, v, pos = _dia_inputs(5, torch.bfloat16, s=s, g=g, hs=hs)
    counters = {"no_counters": None,
                "few_counters": ta.arrival_counters(DIA_HKV, "cpu")}.get(
                    case, ta.arrival_counters(DIA_B * DIA_HKV, "cpu"))
    ta.prefix_attention(q, k, v, pos, counters, scale=1.0)   # the plain version takes it
    with pytest.raises(ValueError, match="prefix_attention"):
        ta.prefix_card_checks(q, k, v, pos, counters)


def _dia_cfg(**kw):
    """Dia-1.6B's decoder attention (16 query heads over 4 KV heads of 128,
    3,072 slots) in one decoder layer."""
    return td.DiaConfig(n_decoder_layers=1, **kw)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
def test_the_card_checks_take_dias_cache_layer(kv_dtype):
    """A layer of the cache `init_dia_cache` makes at Dia-1.6B's widths, with
    its own counters, passes the kernel's checks; the tiny Dia's 2 query
    heads per KV head do too."""
    cfg = _dia_cfg(kv_dtype=kv_dtype)
    cache = td.init_dia_cache(cfg, "cpu")
    assert cache["k"].shape == (1, DIA_B, DIA_HKV, DIA_S, DIA_HS)
    q = torch.zeros((DIA_B, cfg.decoder_attn_heads, cfg.head_size))
    pos = torch.tensor([7], dtype=torch.int32)
    ta.prefix_card_checks(q, cache["k"][0], cache["v"][0], pos, cache["counters"])
    q, k, v, pos = _dia_inputs(5, torch.bfloat16, s=64, hkv=2, g=2)
    ta.prefix_card_checks(q, k, v, pos, ta.arrival_counters(4, "cpu"))


def test_the_dia_cache_carries_zeroed_arrival_counters():
    for dtype in ("float32", "bfloat16"):
        cfg = _dia_cfg(kv_dtype=dtype, max_generation_size=128)
        cache = td.init_dia_cache(cfg, "cpu")
        assert cache["counters"].dtype == torch.int32
        assert cache["counters"].shape == (2 * cfg.kv_heads,) and not cache["counters"].any()


def _tiny_dia():
    """A random dense 2-layer Dia (decoder hidden 256, 8 query heads over 2
    KV heads of 128: Dia-1.6B's group of 4, 128 positions) by the port's own
    builder, loaded on the CPU, and a random cross-KV of 16 tokens."""
    import numpy as np

    from tts_tpu_torch.convert.builder_dia import build_dia_tensors

    tensors, kv = build_dia_tensors(np.random.default_rng(0), dec_hidden=256, dec_heads=8,
                                    query_heads=4, head_size=DIA_HS, max_gen=128, ffn=256)
    cfg = td.DiaConfig.from_gguf_kv(kv)
    assert (cfg.kv_heads, cfg.decoder_attn_heads, cfg.head_size) == (2, 8, DIA_HS)
    params = td.load_dia_params(tensors, cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    L, H, hs, T = cfg.n_decoder_layers, cfg.decoder_attn_heads, cfg.head_size, 16
    cross = {"k": torch.randn((L, 2, H, hs, T), generator=g) * 0.1,
             "v": torch.randn((L, 2, H, T, hs), generator=g)}
    return cfg, params, cross


def test_a_dia_decode_step_calls_it_once_a_layer(monkeypatch):
    """A T = 1 forward at a device position takes its self-attention from
    prefix_attention, once a layer, with the cache's layer, the position,
    the cache's counters and scale 1.0; a verify window does not call it."""
    cfg, params, cross = _tiny_dia()
    cache = td.init_dia_cache(cfg, "cpu")
    calls = []
    wrapped = ta.prefix_attention

    def counting(q, k, v, pos, counters=None, scale=None):
        calls.append((k.data_ptr(), int(pos[0]), counters is cache["counters"], scale))
        return wrapped(q, k, v, pos, counters, scale)

    monkeypatch.setattr(td, "prefix_attention", counting)
    rows = torch.full((1, cfg.n_output_heads), cfg.bos_token_id, dtype=torch.int32)
    with torch.inference_mode():
        td._dia_rows(params, cfg, rows.repeat(4, 1), 0, cache, cross)
        assert not calls
        td._dia_rows(params, cfg, rows, torch.tensor([4], dtype=torch.int32), cache, cross)
    assert calls == [(cache["k"][l].data_ptr(), 4, True, 1.0)
                     for l in range(cfg.n_decoder_layers)]


@pytest.mark.parametrize("pos", [0, 63, 64, 127])
def test_dias_cpu_step_keeps_the_masked_read_bit_for_bit(monkeypatch, pos):
    """The whole T = 1 step on the CPU (merged logits and the K/V it
    writes) gives the bits of the step with its self-attention written out
    as it was before the kernel: the wrapper's plain version is that read."""
    cfg, params, cross = _tiny_dia()
    gen = torch.Generator().manual_seed(pos)
    rows = torch.randint(0, cfg.audio_vocab_size, (1, cfg.n_output_heads), generator=gen,
                         dtype=torch.int32)
    start = torch.randn((2,) + td.init_dia_cache(cfg, "cpu")["k"].shape, generator=gen) * 0.3

    def step():
        cache = td.init_dia_cache(cfg, "cpu")
        cache["k"].copy_(start[0])
        cache["v"].copy_(start[1])
        with torch.inference_mode():
            out = td._dia_rows(params, cfg, rows, torch.tensor([pos], dtype=torch.int32),
                               cache, cross)
        return out, cache

    got, got_cache = step()
    monkeypatch.setattr(td, "prefix_attention",
                        lambda q, k, v, p, counters=None, scale=None:
                        _dia_masked_read(q, k, v, p))
    want, want_cache = step()
    assert torch.equal(got, want)
    assert torch.equal(got_cache["k"], want_cache["k"])
    assert torch.equal(got_cache["v"], want_cache["v"])
