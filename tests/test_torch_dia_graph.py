"""Dia's sequential CFG decode step as the port runs it: `DiaStep` (one
captured CUDA graph per KV cache, cross-KV and sampling key on the card, the
same step as plain calls here) under the sequential loop, the step's body
at a device position (RoPE from it, the whole cache read under the additive
mask), the drain evolved on the device, and the runner's one generator,
cross-KV buffer and steps.

Each is held to the JAX package on the same inputs: the step's merged
logits at the first, a middle and the last slot against JAX's `_dia_step`;
the loop's greedy rows and its loop and sampler state at a stop (head 0's
EOS, the token cap) and at the step budget against `tts_tpu.models.dia.
dia_decode_loop`.  The card's own checks (graph against eager rows, other
sampling values on one captured graph, launch counts) are in
tests/test_torch_kernels.py.

The tiny models are tests/torch_tiny.py's: 2 encoder and 2 decoder layers,
hidden 256, 4 query and 2 KV heads of 128, a 128-byte context and 64 decode
positions; dense, Q8_0 or Q4_0."""

from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import DIA_QTYPES as QTYPES, dia_models, write_tiny_dia  # noqa: E402
from tts_tpu.models import dia as jd  # noqa: E402
from tts_tpu_torch.models import dia as td  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops.sampling import init_state, sample_tokens  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

TEXT = "[S1] Hello there. [S2] Hi!"
OTHER = "[S2] Something else."
# the merged logits against JAX's (tests/test_torch_dia.py's MERGED_TOL):
# f32 on both sides on the dense file; on quantized ones the caches hold
# bf16, so an f32 value that differs in its last bit can round to a
# neighbouring bf16, and the merge multiplies a row's difference by up to 7
MERGED_TOL = {"dense": 1e-5, "Q8_0": 1e-4, "Q4_0": 1e-4}
# the K/V planted in the cache (about the model's own magnitude) and the
# finite garbage planted past the position
KV_STD, GARBAGE = 0.3, 1e5
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, models, JAX's cross-KV of TEXT, the same in
    the port's layout) of torch_tiny's Dia; each is built on first use."""
    built = {}
    root = tmp_path_factory.mktemp("dia")

    def get(qtype):
        if qtype not in built:
            path = write_tiny_dia(root, qtype)
            jcfg, jparams, tcfg, tparams = models = dia_models(path)
            ids = jd.tokenize_dia_sentence(TEXT, jcfg)
            tokens = np.zeros((2, jcfg.max_encoder_context_length), np.int32)
            tokens[0, :len(ids)] = ids
            enc = jd.dia_encode(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(len(ids)))
            jcross = jd.dia_cross_kv(jparams, jcfg, enc, jnp.asarray(len(ids)))
            built[qtype] = path, models, jcross, _cross_as_port(jcross)
        return built[qtype]
    return get


@pytest.fixture(scope="module")
def runners(tiny):
    """runners(qtype) -> a CPU runner of tiny(qtype)'s file, kept."""
    built = {}

    def get(qtype):
        if qtype not in built:
            built[qtype] = runner_from_file(tiny(qtype)[0], device="cpu")
        return built[qtype]
    return get


def _cross_as_port(cross) -> dict:
    """JAX's cross K/V [L, 2, T, H, hs] in the port's layout (K [L, 2, H,
    hs, T], V [L, 2, H, T, hs]) and f32."""
    k = np.asarray(cross["k"].astype(jnp.float32)).transpose(0, 1, 3, 4, 2)
    v = np.asarray(cross["v"].astype(jnp.float32)).transpose(0, 1, 3, 2, 4)
    return {"k": torch.from_numpy(np.ascontiguousarray(k)),
            "v": torch.from_numpy(np.ascontiguousarray(v))}


@partial(jax.jit, static_argnums=(1,))
def _jax_step(params, cfg, row, pos, cache, cross):
    return jd._dia_step(params, cfg, row, pos, cache, cross)


def _planted_cache(cfg, pos: int, seed: int, garbage: bool = False) -> np.ndarray:
    """K and V [2, L, 2, Hkv, P, hs] (the port's head-major layout) f32:
    random values of the cache's dtype before pos, zeros or large finite
    garbage from pos on."""
    rng = np.random.default_rng(seed)
    shape = (2, cfg.n_decoder_layers, 2, cfg.kv_heads, cfg.max_generation_size, cfg.head_size)
    kv = np.zeros(shape, np.float32)
    kv[..., :pos, :] = rng.standard_normal(kv[..., :pos, :].shape) * KV_STD
    if garbage:
        kv[..., pos:, :] = rng.uniform(-GARBAGE, GARBAGE, kv[..., pos:, :].shape)
    return torch.from_numpy(kv).to(getattr(torch, cfg.kv_dtype)).float().numpy()


def _port_cache(cfg, kv: np.ndarray) -> dict:
    dt = getattr(torch, cfg.kv_dtype)
    return {"k": torch.from_numpy(kv[0]).to(dt), "v": torch.from_numpy(kv[1]).to(dt)}


def _port_step(cfg, params, row, pos, cache, cross):
    """The port's step body at the device position pos: merged [9, vocab]."""
    return td._dia_rows(params, cfg, torch.from_numpy(row)[None],
                        torch.tensor([pos], dtype=torch.int32), cache, cross)[0]


def _where(cfg) -> dict:
    P = cfg.max_generation_size
    return {"first": 0, "middle": P // 2, "last": P - 1}


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_step_logits_at_a_device_position_match_jax(tiny, qtype, where):
    """The T = 1 step at a device position over a cache holding the same
    planted K/V before it (position 0, a middle one, the last slot): the
    CFG-merged logits (ids past EOS -inf in both) within MERGED_TOL of
    JAX's `_dia_step`, and the K/V it writes at that slot JAX's within
    one bf16 step of their peak."""
    _, (jcfg, jparams, tcfg, tparams), jcross, cross = tiny(qtype)
    pos = _where(tcfg)[where]
    kv = _planted_cache(tcfg, pos, seed=pos + 1)
    row = np.random.default_rng(pos).integers(0, tcfg.audio_vocab_size + 3, 9).astype(np.int32)
    jdt = jnp.dtype(jcfg.kv_dtype)
    jkv = kv.transpose(0, 1, 2, 4, 3, 5)                     # [2, L, 2, P, Hkv, hs]
    want, jcache = _jax_step(jparams, jcfg, jnp.asarray(row), jnp.asarray(pos, jnp.int32),
                             {"k": jnp.asarray(jkv[0], jdt), "v": jnp.asarray(jkv[1], jdt)}, jcross)
    want = np.asarray(want)
    cache = _port_cache(tcfg, kv)
    got = _port_step(tcfg, tparams, row, pos, cache, cross).numpy()
    assert got.shape == want.shape == (9, 1028)
    assert (np.isinf(got) == np.isinf(want)).all() and np.isinf(got[:, 1025:]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=MERGED_TOL[qtype], rtol=0)
    for k in ("k", "v"):
        w = np.asarray(jcache[k][:, :, pos], np.float32)              # [L, 2, Hkv, hs]
        g = cache[k][:, :, :, pos].float().numpy()
        tol = 1e-6 if qtype == "dense" else 2.0 ** -8
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
        np.testing.assert_array_equal(cache[k][..., pos + 1:, :].float().numpy(),
                                      kv[int(k == "v")][..., pos + 1:, :])


@pytest.mark.parametrize("qtype", QTYPES)
def test_planted_garbage_past_pos_leaves_the_logits_unchanged(tiny, qtype):
    """Slots past the position hold what earlier requests wrote; large
    finite values planted there (|K|, |V| up to 1e5) give the step the bits
    of a cache holding zeros there, at each position."""
    _, (_, _, tcfg, tparams), _, cross = tiny(qtype)
    for pos in _where(tcfg).values():
        row = np.random.default_rng(pos).integers(0, 1027, 9).astype(np.int32)
        clean = _port_cache(tcfg, _planted_cache(tcfg, pos, seed=pos + 1))
        dirty = _port_cache(tcfg, _planted_cache(tcfg, pos, seed=pos + 1, garbage=True))
        assert float(dirty["k"][..., pos:, :].abs().max()) > GARBAGE / 2
        a = _port_step(tcfg, tparams, row, pos, clean, cross)
        b = _port_step(tcfg, tparams, row, pos, dirty, cross)
        assert bool(torch.isfinite(b[:, :1025]).all())
        assert torch.equal(a, b), f"pos {pos}"


def _jax_greedy(jcfg, jparams, jcross, limit: int, budget: int):
    """JAX's dia_decode_loop, greedy, from its initial loop state: (rows,
    sampler state, loop state) as numpy."""
    out, n, _, sstate, loop, _ = jd.dia_decode_loop(
        jparams, jcfg, jnp.asarray(limit, jnp.int32), jnp.asarray(budget, jnp.int32),
        jd.init_dia_cache(jcfg), jcross, jax.random.PRNGKey(0), jd.init_state(9),
        jd.dia_init_loop_state(jcfg), do_sample=False)
    return (np.asarray(out)[:int(n)], {k: np.asarray(v) for k, v in sstate.items()},
            tuple(np.asarray(x) for x in loop))


def _port_greedy(tcfg, tparams, cross, limit: int, budget: int):
    """The port's sequential loop, greedy, on a DiaStep of the greedy key:
    (rows, sampler state, loop state) as numpy."""
    cache = td.init_dia_cache(tcfg, "cpu")
    step = td.DiaStep(tparams, tcfg, cache, cross, None, "cpu", do_sample=False)
    rows, state, loop = td.dia_decode_loop(tparams, tcfg, limit, budget, cache, cross, None,
                                           init_state(9, "cpu"), td.dia_init_loop_state(tcfg),
                                           do_sample=False, step=step)
    return rows, {k: v.numpy() for k, v in state.items()}, tuple(np.asarray(x) for x in loop)


def _swapped_head0(jparams, tparams, a: int, b: int):
    """Copies of both packages' params with head 0's output columns a and b
    swapped: the head emits b where it emitted a, and a for b."""
    perm = np.arange(tparams["decoder"]["heads"].shape[-1])
    perm[[a, b]] = [b, a]
    heads = tparams["decoder"]["heads"].clone()
    heads[0] = heads[0][:, perm]
    jheads = list(jparams["decoder"]["heads"])
    jheads[0] = jheads[0][:, perm]
    return ({**jparams, "decoder": {**jparams["decoder"], "heads": jheads}},
            {**tparams, "decoder": {**tparams["decoder"], "heads": heads}})


@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_loop_and_its_states_match_jax(tiny, qtype):
    """The sequential loop on a DiaStep, greedy, against JAX's loop: rows,
    sampler state and loop state (next row, drain counter, position) equal
    where the drain stops it at the token cap (64: the drain starts at
    position 49), where it stops after head 0's EOS (made at row k by
    swapping head 0's EOS column with that of a token it first emits at
    row k), and where the step budget (10) ends the call before any
    stop."""
    _, (jcfg, jparams, tcfg, tparams), jcross, cross = tiny(qtype)
    P = tcfg.max_generation_size
    natural = _jax_greedy(jcfg, jparams, jcross, P, P)
    head0 = natural[0][:, 0].tolist()
    assert tcfg.eos_token_id not in head0
    k = max(j for j in range(30) if head0[j] not in head0[:j])
    jswap, tswap = _swapped_head0(jparams, tparams, head0[k], tcfg.eos_token_id)
    cases = {"cap": (jparams, tparams, P, P, P - 1),
             "eos": (jswap, tswap, P, P, k + tcfg.max_delay),
             "budget": (jparams, tparams, P, 10, 10)}
    for name, (jps, tps, limit, budget, n) in cases.items():
        w_rows, w_state, w_loop = _jax_greedy(jcfg, jps, jcross, limit, budget)
        g_rows, g_state, g_loop = _port_greedy(tcfg, tps, cross, limit, budget)
        assert len(w_rows) == len(g_rows) == n, name
        np.testing.assert_array_equal(g_rows, w_rows, err_msg=name)
        for a, b in zip(g_loop, w_loop, strict=True):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert int(g_loop[1]) == (-1 if name == "budget" else 0) and int(g_loop[2]) == n
        for key in ("last", "count"):
            np.testing.assert_array_equal(g_state[key], w_state[key], err_msg=f"{name} {key}")


def _recorded_rows(monkeypatch):
    """Record each dia_decode_loop call's rows (a list of arrays)."""
    seen = []
    loop = td.dia_decode_loop

    def recording(*a, **kw):
        out = loop(*a, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(td, "dia_decode_loop", recording)
    return seen


@pytest.mark.parametrize("qtype", QTYPES)
def test_chunks_and_one_call_give_one_seeds_rows(runners, qtype, monkeypatch):
    """generate_stream's chunks (the loop resumed on the runner's step, its
    generator and the host loop state carried) emit generate's rows at one
    seed with other sampling values, a second generate at that seed the
    same rows again, another seed other rows; one DiaStep serves them all,
    and its route is named in the timings."""
    r = runners(qtype)
    seen = _recorded_rows(monkeypatch)
    config = GenerationConfig(seed=5, max_tokens=30, **SAMPLED)
    r._steps.clear()
    resp = r.generate(TEXT, config)
    whole = seen.pop()
    assert resp.timings["decode_route"] == "eager" and r.decode_route == "eager"
    assert whole.shape == (29, 9)
    list(r.generate_stream(TEXT, config, chunk_steps=7))
    assert [len(rows) for rows in seen] == [7, 7, 7, 7, 1]
    np.testing.assert_array_equal(np.concatenate(seen), whole)
    seen.clear()
    r.generate(TEXT, config)
    np.testing.assert_array_equal(seen.pop(), whole)
    r.generate(TEXT, GenerationConfig(seed=6, max_tokens=30, **SAMPLED))
    assert not np.array_equal(seen.pop(), whole)
    assert list(r._steps) == [("eager", 50, True, True)]
    step = r._steps["eager", 50, True, True]
    assert step.generator is r._generator and step.cross_kv is r._cross


def test_one_step_reads_each_requests_cross_kv(tiny, monkeypatch):
    """The runner's step reads the runner's cross-KV buffer, which each
    request's encode fills in place: a request after another prompt's, on
    the same step, decodes what it decodes on a new runner."""
    path = tiny("Q8_0")[0]
    seen = _recorded_rows(monkeypatch)
    config = GenerationConfig(seed=2, max_tokens=24, top_k=50)
    r = runner_from_file(path, device="cpu")
    r.generate(TEXT, config)
    cross = r._cross
    step = next(iter(r._steps.values()))
    r.generate(OTHER, config)
    assert r._cross is cross and next(iter(r._steps.values())) is step
    runner_from_file(path, device="cpu").generate(OTHER, config)
    np.testing.assert_array_equal(seen[1], seen[2])
    assert not np.array_equal(seen[0], seen[1])


def test_tensor_values_give_the_float_values_rows(tiny):
    """The step reads temperature, top_p and the penalty as 0-d tensors and
    evolves the drain on the device: its sampled rows are, bit for bit,
    those of the step body with float values and the drain on the host
    (`_drain_step`) at one seed, through the token-cap drain to the stop."""
    _, (_, _, tcfg, tparams), _, cross = tiny("Q8_0")
    floats = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.2)
    limit, out = 24, {}
    for kind in ("step", "floats"):
        cache = td.init_dia_cache(tcfg, "cpu")
        gen = torch.Generator().manual_seed(3)
        loop = td.dia_init_loop_state(tcfg)
        if kind == "step":
            out[kind], _, loop = td.dia_decode_loop(tparams, tcfg, limit, 64, cache, cross, gen,
                                                    init_state(9, "cpu"), loop, top_k=50,
                                                    **floats)
            assert loop[1] == 0
            continue
        state, rows, (tokens, delay, _) = init_state(9, "cpu"), [], loop
        for i in range(64):
            merged = td._dia_rows(tparams, tcfg, torch.from_numpy(tokens)[None], i, cache,
                                  cross)[0]
            row, state = sample_tokens(gen, merged, state, top_k=50, **floats)
            rows.append(row.numpy())
            tokens, delay = td._drain_step(tcfg, rows[-1], i + 1, delay, limit)
            if delay == 0:
                break
        out[kind] = np.stack(rows)
    assert len(out["step"]) == limit - 1
    np.testing.assert_array_equal(out["step"], out["floats"])


def test_step_captures_on_a_card_only():
    """A capture on the CPU is refused; the uncaptured step names its
    route "eager"."""
    cfg = td.DiaConfig()
    with pytest.raises(ValueError, match="captured on a card"):
        td.DiaStep(None, cfg, None, None, None, "cpu", capture=True)
    assert td.DiaStep(None, cfg, None, None, None, "cpu").route == "eager"


def test_loop_refuses_a_step_of_another_key():
    """A step keyed (top_k, do_sample, use_top_p) other than the call's, or
    made on another generator, cache or cross-KV, raises instead of
    decoding otherwise."""
    cfg = td.DiaConfig()
    cache, cross, gen = {"k": torch.zeros(1)}, {"k": torch.zeros(1)}, torch.Generator()
    step = td.DiaStep(None, cfg, cache, cross, gen, "cpu", top_k=50)
    loop = td.dia_init_loop_state(cfg)
    ok = dict(cache=cache, cross_kv=cross, generator=gen, top_k=50)
    for bad in (dict(top_k=40), dict(generator=torch.Generator()),
                dict(cache={"k": torch.zeros(1)}), dict(cross_kv={"k": torch.zeros(1)})):
        kw = {**ok, **bad}
        with pytest.raises(ValueError, match="keyed"):
            td.dia_decode_loop(None, cfg, 100, 4, kw["cache"], kw["cross_kv"], kw["generator"],
                               init_state(9, "cpu"), loop, top_k=kw["top_k"], step=step)


def test_a_step_at_dia_1_6bs_depth_calls_prefix_attention_18_times(monkeypatch):
    """A DiaStep at Dia-1.6B's 18 decoder layers and attention widths (16
    query heads over 4 KV heads of 128; a narrow hidden size) takes each
    step's self-attention from prefix_attention once a layer: 18 calls a
    step, each with a layer of the step's cache, the cache's counters, the
    step's device position and scale 1.0.  On a card each call is one
    kernel launch, and a replay adds the capture's launches
    (tests/test_torch_kernels.py: the tiny steps' counts per replay)."""
    from tts_tpu_torch.convert.builder_dia import build_dia_tensors
    from tts_tpu_torch.ops import attention as ta

    tensors, kv = build_dia_tensors(np.random.default_rng(0), enc_layers=1, dec_layers=18,
                                    dec_hidden=128, dec_heads=16, query_heads=4,
                                    head_size=128, max_gen=128, ffn=128)
    cfg = td.DiaConfig.from_gguf_kv(kv)
    assert (cfg.n_decoder_layers, cfg.decoder_attn_heads, cfg.kv_heads) == (18, 16, 4)
    params = td.load_dia_params(tensors, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    cross = {"k": torch.randn((18, 2, 16, 128, 8), generator=g) * 0.1,
             "v": torch.randn((18, 2, 16, 8, 128), generator=g)}
    cache = td.init_dia_cache(cfg, "cpu")
    step = td.DiaStep(params, cfg, cache, cross, torch.Generator().manual_seed(1), "cpu",
                      top_k=50)
    calls = []
    wrapped = ta.prefix_attention

    def counting(q, k, v, pos, counters=None, scale=None):
        calls.append((k.data_ptr(), int(pos[0]), counters is cache["counters"], scale))
        return wrapped(q, k, v, pos, counters, scale)

    monkeypatch.setattr(td, "prefix_attention", counting)
    step.load(td.dia_init_loop_state(cfg), 100, init_state(9, "cpu"))
    for _ in range(3):
        step.run()
    layers = [cache["k"][l].data_ptr() for l in range(18)]
    assert calls == [(ptr, p, True, 1.0) for p in range(3) for ptr in layers]
