"""Parler-TTS's sequential decode step as the port runs it: `ParlerStep` (one
captured CUDA graph per KV cache, cross-KV and sampling key on the card, the
same step as plain calls here) under the sequential loop, the step's body
at a device position (the whole cache read under the additive mask), the
runner's one generator and its steps, and the server's --warmup.

Each is held to the JAX package on the same inputs: the step's logits at
the first, a middle and the last slot against the body of JAX's
`parler_decode_step`; the loop's greedy rows and its loop and sampler
state at a stop and at `limit` against `tts_tpu.models.parler.
parler_decode_loop`.  The card's own checks (graph against eager rows,
other sampling values on one captured graph, launch counts) are in
tests/test_torch_kernels.py.

The tiny models are tests/torch_tiny.py's: 2 layers, hidden 256, 4 heads of
64, a 512-position context and 64 decode steps; dense, Q8_0 or Q4_0."""

import types
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import (PARLER_QTYPES as QTYPES, first_part, parler_models,  # noqa: E402
                        write_tiny_parler)
from tts_tpu.convert.builder_t5 import write_t5_gguf  # noqa: E402
from tts_tpu.models import parler as jp  # noqa: E402
from tts_tpu_torch.apps import server as tserver  # noqa: E402
from tts_tpu_torch.models import parler as tp  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops.sampling import init_state  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

TEXT = "hello world"
# A step's logits against JAX's, as a share of max |logit|: dense f32 on
# both sides, sums in another order; quantized, the GEMV's bf16 roundings of
# x that differ where an f32 sum differs in its last bit (as
# tests/test_torch_parler.py's LOGIT_TOL)
LOGIT_TOL = {"dense": 1e-5, "Q8_0": 2e-2, "Q4_0": 2e-2}
STEPS = 40
# the magnitude of the K/V planted in the cache (about what the model's
# own projections give) and of the finite garbage planted past the position
KV_STD, GARBAGE = 0.3, 1e5
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, models, prompt ids) of torch_tiny's Parler;
    each is built on first use."""
    built = {}
    root = tmp_path_factory.mktemp("parler")

    def get(qtype):
        if qtype not in built:
            path = write_tiny_parler(root, qtype)
            tok = runner_from_file(path, device="cpu").tokenizer
            built[qtype] = path, parler_models(path), tok.tokenize(TEXT) + [tok.eos_token]
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


@pytest.fixture(scope="module")
def t5_path(tmp_path_factory):
    """A tiny T5 whose output width is the tiny Parler's encoding width."""
    return str(write_t5_gguf(tmp_path_factory.mktemp("t5") / "t5.gguf", seed=1, out_size=64))


@partial(jax.jit, static_argnums=(1,))
def _jax_step_logits(params, cfg, row, pos, cache, cross_kv):
    """The body of JAX's parler_decode_step before its sampler: per-head
    logits [9, vocab] of input row [9] at pos, and the cache."""
    embds, heads = jnp.stack(params["embds"]), jnp.stack(params["heads"])
    x = jnp.sum(embds[jnp.arange(cfg.n_output_heads), row], axis=0) + params["positional"][pos]
    x, cache = jp._transformer(params, cfg, x[None], cache, pos, pos[None], cross_kv)
    return jnp.einsum("d,hdv->hv", x[0], heads), cache


def _planted_cache(cfg, pos: int, seed: int, garbage: bool = False) -> np.ndarray:
    """K and V [2, L, ctx, H, hs] f32: random values (of the cache's dtype)
    in the slots before pos, zeros or large finite garbage from pos on."""
    rng = np.random.default_rng(seed)
    shape = (2, cfg.n_layers, cfg.max_ctx_length, cfg.n_attn_heads, cfg.head_size)
    kv = np.zeros(shape, np.float32)
    kv[:, :, :pos] = rng.standard_normal(kv[:, :, :pos].shape) * KV_STD
    if garbage:
        kv[:, :, pos:] = rng.uniform(-GARBAGE, GARBAGE, kv[:, :, pos:].shape)
    return torch.from_numpy(kv).to(getattr(torch, cfg.kv_dtype)).float().numpy()


def _port_cache(cfg, kv: np.ndarray) -> dict:
    dt = getattr(torch, cfg.kv_dtype)
    return {"k": torch.from_numpy(kv[0]).to(dt), "v": torch.from_numpy(kv[1]).to(dt)}


def _port_step_logits(cfg, params, row, pos, cache, cross):
    """The port's step body at the device position pos."""
    return tp._rows_logits(params, cfg, torch.from_numpy(row)[None],
                           torch.tensor([pos], dtype=torch.int32), cache, cross)[0]


def _where(cfg, ids) -> dict:
    return {"first": len(ids), "middle": cfg.max_ctx_length // 2, "last": cfg.max_ctx_length - 1}


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_step_logits_at_a_device_position_match_jax(tiny, qtype, where):
    """The T = 1 step at a device position over a cache holding the same
    planted K/V before it (the first decode slot after the prompt, a middle
    one, the last one): per-head logits within LOGIT_TOL of max |logit| of
    JAX's step, and the K/V it writes at that slot JAX's within the same
    tolerance (they come out of the same GEMVs: on Q4_0 at K = 256 JAX's
    int4 product keeps x in f32 where the port's rounds it to bf16)."""
    _, (jcfg, jparams, tcfg, tparams), ids = tiny(qtype)
    pos = _where(tcfg, ids)[where]
    kv = _planted_cache(tcfg, pos, seed=pos)
    row = np.random.default_rng(pos).integers(0, tcfg.audio_vocab_size + 2, 9).astype(np.int32)
    jdt = jnp.dtype(jcfg.kv_dtype)
    want, jcache = _jax_step_logits(jparams, jcfg, jnp.asarray(row), jnp.asarray(pos, jnp.int32),
                                    {"k": jnp.asarray(kv[0], jdt), "v": jnp.asarray(kv[1], jdt)},
                                    jp.precompute_cross_kv(jparams, jcfg))
    want = np.asarray(want)
    cache = _port_cache(tcfg, kv)
    got = _port_step_logits(tcfg, tparams, row, pos, cache, tp.precompute_cross_kv(tparams, tcfg))
    assert got.shape == want.shape == (9, 1088)
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL[qtype] * np.abs(want).max()
    for k in ("k", "v"):
        w = np.asarray(jcache[k][:, pos], np.float32)
        g = cache[k][:, pos].float().numpy()
        assert np.abs(g - w).max() <= LOGIT_TOL[qtype] * np.abs(w).max()
        np.testing.assert_array_equal(cache[k][:, pos + 1:].float().numpy(), kv[int(k == "v"),
                                                                              :, pos + 1:])


@pytest.mark.parametrize("qtype", QTYPES)
def test_planted_garbage_past_pos_leaves_the_logits_unchanged(tiny, qtype):
    """Slots past the position hold what earlier requests wrote; large
    finite values planted there (|K|, |V| up to 1e5) give the step the bits
    of a cache holding zeros there, at each position."""
    _, (_, _, tcfg, tparams), ids = tiny(qtype)
    cross = tp.precompute_cross_kv(tparams, tcfg)
    for pos in _where(tcfg, ids).values():
        row = np.random.default_rng(pos).integers(0, 1026, 9).astype(np.int32)
        clean = _port_cache(tcfg, _planted_cache(tcfg, pos, seed=pos))
        dirty = _port_cache(tcfg, _planted_cache(tcfg, pos, seed=pos, garbage=True))
        assert float(dirty["k"][:, pos:].abs().max()) > GARBAGE / 2
        a = _port_step_logits(tcfg, tparams, row, pos, clean, cross)
        b = _port_step_logits(tcfg, tparams, row, pos, dirty, cross)
        assert bool(torch.isfinite(b).all())
        assert torch.equal(a, b), f"pos {pos}"


def _jax_prefilled(jcfg, jparams, ids):
    jcross = jp.precompute_cross_kv(jparams, jcfg)
    toks = np.zeros(16, np.int32)
    toks[:len(ids)] = ids
    cache = jp.parler_prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(len(ids), jnp.int32),
                              jp.init_kv_cache(jcfg), jcross)
    return cache, jcross


def _jax_greedy(jcfg, jparams, ids, limit: int, eos0: np.ndarray):
    """JAX's parler_decode_loop, greedy, from the all-BOS row with EOS flags
    eos0: (rows, sampler state, loop state) as numpy."""
    cache, jcross = _jax_prefilled(jcfg, jparams, ids)
    loop0 = (jnp.full((9,), jcfg.bos_token_id, jnp.int32), jnp.asarray(eos0),
             jnp.asarray(0, jnp.int32))
    out, n, _, sstate, loop, _ = jp.parler_decode_loop(
        jparams, jcfg, jnp.asarray(len(ids), jnp.int32), jnp.asarray(limit, jnp.int32), cache,
        jcross, jax.random.PRNGKey(0), jp.init_state(9), loop0,
        max_steps=jcfg.max_generation_size, do_sample=False)
    return (np.asarray(out)[:int(n)], {k: np.asarray(v) for k, v in sstate.items()},
            tuple(np.asarray(x) for x in loop))


def _port_greedy(tcfg, tparams, ids, limit: int, eos0: np.ndarray):
    """The port's sequential loop, greedy, on a ParlerStep of the greedy
    key: (rows, sampler state, loop state) as numpy."""
    cache = tp.init_kv_cache(tcfg, "cpu")
    cross = tp.precompute_cross_kv(tparams, tcfg)
    tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, cross)
    step = tp.ParlerStep(tparams, tcfg, cache, cross, None, "cpu", do_sample=False)
    loop0 = (np.full(9, tcfg.bos_token_id, np.int32), eos0.copy(), 0)
    rows, state, loop = tp.parler_decode_loop(tparams, tcfg, len(ids), limit, cache, cross, None,
                                              init_state(9, "cpu"), loop0, do_sample=False,
                                              step=step)
    return rows, {k: v.numpy() for k, v in state.items()}, tuple(np.asarray(x) for x in loop)


def _logits_along(tcfg, tparams, ids, rows, eos0):
    """Port logits [n, 9, vocab] teacher-forced along the sequential loop's
    inputs for `rows` from EOS flags eos0, one row per step."""
    loop = (np.full(9, tcfg.bos_token_id, np.int32), eos0.copy(), 0)
    ins = []
    for i, row in enumerate(rows):
        ins.append(loop[0])
        eos = loop[1] | (row == tcfg.eos_token_id)
        loop = (tp._next_row(tcfg, row, eos, i + 1), eos, i + 1)
    cache = tp.init_kv_cache(tcfg, "cpu")
    cross = tp.precompute_cross_kv(tparams, tcfg)
    tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, cross)
    return torch.cat([tp._rows_logits(tparams, tcfg, torch.from_numpy(r)[None], len(ids) + i,
                                      cache, cross) for i, r in enumerate(ins)])


NO_EOS = np.zeros(9, bool)


@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_loop_matches_jax(tiny, qtype):
    """The sequential loop on a ParlerStep, greedy, 40 rows after the same
    prefill: JAX's rows up to the first near-tie (all 40 on the dense
    model), every difference along JAX's rows a near-tie."""
    _, (jcfg, jparams, tcfg, tparams), ids = tiny(qtype)
    want, _, _ = _jax_greedy(jcfg, jparams, ids, STEPS, NO_EOS)
    got, _, loop = _port_greedy(tcfg, tparams, ids, STEPS, NO_EOS)
    part, _ = first_part(_logits_along(tcfg, tparams, ids, want, NO_EOS), want)
    assert want.shape == got.shape == (STEPS, 9) and loop[2] == STEPS
    np.testing.assert_array_equal(got[:part], want[:part])
    if qtype == "dense":
        assert part == STEPS


def _swapped_head(jparams, tparams, head: int, a: int, b: int):
    """Copies of both packages' params with head `head`'s output columns a
    and b swapped: the head emits b where it emitted a, and a for b."""
    perm = np.arange(tparams["heads"].shape[-1])
    perm[[a, b]] = [b, a]
    heads = tparams["heads"].clone()
    heads[head] = heads[head][:, perm]
    jheads = list(jparams["heads"])
    jheads[head] = jheads[head][:, perm]
    return {**jparams, "heads": jheads}, {**tparams, "heads": heads}


@pytest.mark.parametrize("qtype", QTYPES)
def test_stop_and_limit_state_match_jax(tiny, qtype):
    """With heads 0-7 already past EOS (a resumed loop state), the loop
    stops after the row in which head 8 emits EOS: its greedy rows (which
    emit EOS at row k by swapping head 8's EOS column with that of a token
    it first emits at row k, inside the agreeing prefix), the sampler
    state and the loop state (next row, EOS flags, global step) equal
    JAX's; and so do they at `limit`, before any stop."""
    _, (jcfg, jparams, tcfg, tparams), ids = tiny(qtype)
    eos0 = np.array([True] * 8 + [False])
    want, _, _ = _jax_greedy(jcfg, jparams, ids, STEPS, eos0)
    part, _ = first_part(_logits_along(tcfg, tparams, ids, want, eos0), want)
    head8 = want[:, 8].tolist()
    assert tcfg.eos_token_id not in head8
    k = max(j for j in range(min(part, STEPS)) if head8[j] not in head8[:j])
    jswap, tswap = _swapped_head(jparams, tparams, 8, head8[k], tcfg.eos_token_id)
    cases = {"stop": (jswap, tswap, STEPS), "limit": (jparams, tparams, min(part, 12))}
    for name, (jps, tps, limit) in cases.items():
        w_rows, w_state, w_loop = _jax_greedy(jcfg, jps, ids, limit, eos0)
        g_rows, g_state, g_loop = _port_greedy(tcfg, tps, ids, limit, eos0)
        n = k + 1 if name == "stop" else limit
        assert len(w_rows) == len(g_rows) == n, name
        np.testing.assert_array_equal(g_rows, w_rows)
        for a, b in zip(g_loop, w_loop, strict=True):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert bool(g_loop[1].all()) == (name == "stop")
        for key in ("last", "count"):
            np.testing.assert_array_equal(g_state[key], w_state[key], err_msg=f"{name} {key}")


def _recorded_rows(monkeypatch):
    """Record each parler_decode_loop call's rows (a list of arrays)."""
    seen = []
    loop = tp.parler_decode_loop

    def recording(*a, **kw):
        out = loop(*a, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tp, "parler_decode_loop", recording)
    return seen


@pytest.mark.parametrize("qtype", QTYPES)
def test_chunks_and_one_call_give_one_seeds_rows(runners, qtype, monkeypatch):
    """generate_stream's chunks (the loop resumed on the runner's step, its
    generator and the host loop state carried) emit generate's rows at one
    seed with other sampling values, a second generate at that seed the
    same rows again, another seed other rows; one ParlerStep serves them
    all, and its route is named in the timings."""
    r = runners(qtype)
    seen = _recorded_rows(monkeypatch)
    config = GenerationConfig(seed=5, max_tokens=30, **SAMPLED)
    r._steps.clear()
    resp = r.generate(TEXT, config)
    whole = seen.pop()
    assert resp.timings["decode_route"] == "eager" and r.decode_route == "eager"
    assert whole.shape == (30, 9)
    list(r.generate_stream(TEXT, config, chunk_steps=7))
    assert [len(rows) for rows in seen] == [7, 7, 7, 7, 2]
    np.testing.assert_array_equal(np.concatenate(seen), whole)
    seen.clear()
    r.generate(TEXT, config)
    np.testing.assert_array_equal(seen.pop(), whole)
    r.generate(TEXT, GenerationConfig(seed=6, max_tokens=30, **SAMPLED))
    assert not np.array_equal(seen.pop(), whole)
    assert list(r._steps) == [("eager", 50, True, True, False)]
    assert r._steps["eager", 50, True, True, False].generator is r._generator


def test_tensor_values_give_the_float_values_rows(tiny):
    """The step reads temperature, top_p and the penalty as 0-d tensors:
    its sampled rows are, bit for bit, those of the JAX-shaped step with
    float values (`parler_decode_step`, the staircase on the host) at one
    seed."""
    _, (_, _, tcfg, tparams), ids = tiny("Q8_0")
    floats = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.2)
    out = {}
    for kind in ("step", "floats"):
        cache = tp.init_kv_cache(tcfg, "cpu")
        cross = tp.precompute_cross_kv(tparams, tcfg)
        tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, cross)
        gen = torch.Generator().manual_seed(3)
        loop = tp.init_loop_state(tcfg)
        if kind == "step":
            out[kind], _, _ = tp.parler_decode_loop(tparams, tcfg, len(ids), 20, cache, cross,
                                                    gen, init_state(9, "cpu"), loop, top_k=50,
                                                    **floats)
            continue
        state, rows = init_state(9, "cpu"), []
        for i in range(20):
            row, state = tp.parler_decode_step(tparams, tcfg, torch.from_numpy(loop[0]),
                                               len(ids) + i, cache, cross, gen, state, top_k=50,
                                               **floats)
            rows.append(row.numpy())
            eos = loop[1] | (rows[-1] == tcfg.eos_token_id)
            loop = (tp._next_row(tcfg, rows[-1], eos, i + 1), eos, i + 1)
        out[kind] = np.stack(rows)
    np.testing.assert_array_equal(out["step"], out["floats"])


def test_step_captures_on_a_card_only():
    """A capture on the CPU is refused; the uncaptured step names its
    route "eager"."""
    cfg = tp.ParlerConfig()
    with pytest.raises(ValueError, match="captured on a card"):
        tp.ParlerStep(None, cfg, None, None, None, "cpu", capture=True)
    assert tp.ParlerStep(None, cfg, None, None, None, "cpu").route == "eager"


def test_loop_refuses_a_step_of_another_key():
    """A step keyed (top_k, do_sample, use_top_p) other than the call's, or
    made on another generator, cache or cross-KV, raises instead of
    decoding otherwise."""
    cfg = tp.ParlerConfig()
    cache, cross, gen = {"k": torch.zeros(1)}, {"k": torch.zeros(1)}, torch.Generator()
    step = tp.ParlerStep(None, cfg, cache, cross, gen, "cpu", top_k=50)
    loop = tp.init_loop_state(cfg)
    ok = dict(cache=cache, cross_kv=cross, generator=gen, top_k=50)
    for bad in (dict(top_k=40), dict(generator=torch.Generator()),
                dict(cache={"k": torch.zeros(1)}), dict(cross_kv=None)):
        kw = {**ok, **bad}
        with pytest.raises(ValueError, match="keyed"):
            tp.parler_decode_loop(None, cfg, 10, 4, kw["cache"], kw["cross_kv"], kw["generator"],
                                  init_state(9, "cpu"), loop, top_k=kw["top_k"], step=step)


def test_update_conditional_prompt_drops_the_old_steps(tiny, t5_path):
    """A new conditioning prompt replaces the cross-KV: the runner keeps no
    step made on the old one (on a card its graph would read freed
    memory), keeps the step without cross-attention, and the next request
    makes its step on the new cross-KV."""
    r = runner_from_file(tiny("Q4_0")[0], device="cpu")
    config = GenerationConfig(seed=1, max_tokens=12, top_k=50)
    r.generate(TEXT, config)
    r.generate(TEXT, GenerationConfig(seed=1, max_tokens=12, top_k=50, use_cross_attn=False))
    old = r.cross_kv
    assert {s.cross_kv is old for s in r._steps.values()} == {True, False}
    r.update_conditional_prompt(t5_path, "a calm voice")
    assert r.cross_kv is not old
    assert [s.cross_kv for s in r._steps.values()] == [None]
    r.generate(TEXT, config)
    assert {s.cross_kv is r.cross_kv for s in r._steps.values()} == {True, False}
    assert not any(s.cross_kv is old for s in r._steps.values())


def test_server_warmup_on_tiny_parler(tiny, monkeypatch, capsys):
    """--warmup on a tiny Parler GGUF with --device cpu: the three prompts
    and the first streamed chunk run on the default sampling key's step
    (the runner's eager route here; on a card that is the capture), then
    `warmup ok` before the server listens."""
    path = tiny("Q8_0")[0]
    runs = []
    generate = tp.ParlerRunner.generate
    monkeypatch.setattr(tp.ParlerRunner, "generate",
                        lambda self, *a, **kw: runs.append(self) or generate(self, *a, **kw))

    def interrupt():
        raise KeyboardInterrupt

    monkeypatch.setattr(tserver, "make_server", lambda state, host, port:
                        types.SimpleNamespace(serve_forever=interrupt))
    tserver.main(["--model-path", path, "--device", "cpu", "--warmup"])
    lines = capsys.readouterr().err.splitlines()
    assert "warmup ok" in lines and not any("FAILED" in s for s in lines)
    assert lines.index("warmup ok") < next(i for i, s in enumerate(lines) if "listening" in s)
    assert len(runs) == 3
    assert list(runs[0]._steps) == [("eager", 50, True, False, False)]
