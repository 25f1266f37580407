"""Orpheus's decode step as the port runs it: `DecodeGraph` (one captured
CUDA graph per KV cache and sampling key on the card, the same step as
plain calls here) under the sequential loop, the sampler's tensor-valued
temperature, top_p and repetition penalty, and the server's --warmup.

Each is held to the JAX package on the same inputs: the sampler with
tensor values against its float values (bit for bit) and against JAX's
`filtered_probs` with traced values; the loop's greedy tokens and the
sampler state at a stop or at `limit` against
`tts_tpu.models.orpheus.orpheus_decode_loop`; the server's flags against
the JAX server's.  The card's own checks (graph against eager tokens,
other sampling values on one captured graph, launch counts) are in
tests/test_torch_kernels.py."""

import argparse
import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import CTX, GEN, QTYPES, orpheus_logits_along, write_tiny_orpheus  # noqa: E402
from tts_tpu.apps import server as jserver  # noqa: E402
from tts_tpu.models import orpheus as jo  # noqa: E402
from tts_tpu.ops import sampling as js  # noqa: E402
from tts_tpu_torch.apps import server as tserver  # noqa: E402
from tts_tpu_torch.models import orpheus as to  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops import sampling as ts  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

PROMPT = [128259, 128000, 72, 105, 128009, 128260, 128261, 128257]
# tests/test_torch_orpheus.py's near-tie: logits of the two packages differ
# by up to ~1e-3 (bf16 activations), so where JAX's greedy token lies within
# TIE of the port's best logit either token is right
TIE = 4e-3
# (temperature, top_p, repetition_penalty)
VALUES = [(1.0, 1.0, 1.0), (0.7, 0.9, 1.3), (1.3, 0.5, 1.1), (0.4, 0.95, 2.0)]
STEPS = 40


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _sampler_inputs(seed: int):
    """logits [3, 4096] and a state whose heads repeat 3, 0 and 1 times."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 4096)) * 3).astype(np.float32)
    last = np.array([5, -1, int(np.argmax(logits[2]))], np.int32)
    count = np.array([3, 0, 1], np.int32)
    return logits, last, count


@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("temperature,top_p,repetition_penalty", VALUES)
def test_tensor_values_give_the_float_bits_and_jax_probs(temperature, top_p,
                                                         repetition_penalty, top_k):
    """filtered_probs and sample_tokens with 0-d tensor values give the
    float values' bits (probabilities, draws and state), and the
    probabilities are within 1e-6 of JAX's with traced values."""
    logits, last, count = _sampler_inputs(top_k + int(10 * temperature))
    state = {"last": torch.from_numpy(last), "count": torch.from_numpy(count)}
    floats = dict(temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty)
    tensors = {k: _f32(v) for k, v in floats.items()}
    want = ts.filtered_probs(torch.from_numpy(logits), state, top_k=top_k, **floats)
    got = ts.filtered_probs(torch.from_numpy(logits), state, top_k=top_k, **tensors)
    assert torch.equal(got, want)
    for do_sample in (True, False):
        draws = [ts.sample_tokens(torch.Generator().manual_seed(9), torch.from_numpy(logits),
                                  state, top_k=top_k, do_sample=do_sample, **vals)
                 for vals in (floats, tensors)]
        assert torch.equal(draws[0][0], draws[1][0])
        assert all(torch.equal(draws[0][1][k], draws[1][1][k]) for k in ("last", "count"))

    jstate = {"last": jnp.asarray(last), "count": jnp.asarray(count)}
    jprobs = js.filtered_probs(jnp.asarray(logits), jstate, top_k=top_k,
                               **{k: jnp.asarray(v, jnp.float32) for k, v in floats.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, CPU runner) on torch_tiny's Orpheus (4096-row
    head), its cache cut to 64 + 448 = 512 positions."""
    built = {}

    def get(qtype):
        if qtype not in built:
            path = tmp_path_factory.mktemp("orpheus") / f"tiny_{qtype}.gguf"
            path = str(write_tiny_orpheus(path, head_rows=4096, qtype=qtype))
            r = runner_from_file(path, device="cpu")
            r.cfg = dataclasses.replace(r.cfg, max_context_length=CTX, max_generation_size=GEN)
            built[qtype] = path, r
        return built[qtype]
    return get


@pytest.fixture(scope="module")
def jax_models(tiny):
    """jax_models(qtype) -> (jax cfg, jax params) of tiny(qtype)'s file."""
    from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile

    built = {}

    def get(qtype):
        if qtype not in built:
            with JaxGGUFFile(tiny(qtype)[0]) as f:
                jcfg = dataclasses.replace(jo.OrpheusConfig.from_gguf_kv(f.kv),
                                           max_context_length=CTX, max_generation_size=GEN)
                built[qtype] = jcfg, jo.load_orpheus_params(dict(f.tensors), jcfg)
        return built[qtype]
    return get


def _jax_greedy(jcfg, jparams, limit: int):
    """JAX: PROMPT's prefill, its argmax, then orpheus_decode_loop greedy:
    (first token, tokens after it, sampler state)."""
    T = len(PROMPT)
    cache = jo.init_kv_cache(jcfg)
    logits, cache = jo.orpheus_prefill(jparams, jcfg, jnp.asarray(PROMPT, jnp.int32),
                                       jnp.asarray(T, jnp.int32), cache)
    first = jnp.argmax(logits).astype(jnp.int32)
    state = {"last": first[None], "count": jnp.ones((1,), jnp.int32)}
    out, n, _, sstate, _ = jo.orpheus_decode_loop(
        jparams, jcfg, first, jnp.asarray(T, jnp.int32), jnp.asarray(limit, jnp.int32), cache,
        jax.random.PRNGKey(0), state, max_steps=STEPS, do_sample=False)
    return int(first), np.asarray(out)[: int(n)].tolist(), {k: np.asarray(v).tolist()
                                                          for k, v in sstate.items()}


def _port_greedy(r, cfg, limit: int):
    """The port: the same prefill and first token, then the sequential loop
    through the runner's DecodeGraph of the greedy key."""
    cache = to.init_kv_cache(cfg, "cpu")
    logits = to.orpheus_prefill(r.params, cfg, torch.tensor(PROMPT), cache)
    first = torch.argmax(logits).to(torch.int32).reshape(1)
    state = {"last": first.clone(), "count": torch.ones(1, dtype=torch.int32)}
    step = to.DecodeGraph(r.params, cfg, cache, None, "cpu", do_sample=False)
    out, state = to.orpheus_decode_loop(r.params, cfg, first, len(PROMPT), limit, cache, None,
                                        state, do_sample=False, step=step)
    return int(first), out, {k: v.tolist() for k, v in state.items()}


def _agreeing_prefix(r, cfg, first: int, want: list) -> int:
    """How many of JAX's tokens [first] + want are the port's own argmax
    along them, up to the first that is not (tests/test_torch_orpheus.py's
    rule: each that is not is a near-tie, within TIE of the port's max)."""
    want = torch.tensor([first] + want)
    logits = orpheus_logits_along(r.params, cfg, PROMPT, want.tolist())
    agree = logits.argmax(-1) == want
    gap = logits.max(-1).values - logits.gather(1, want[:, None])[:, 0]
    assert bool((agree | (gap < TIE)).all()), f"non-tie disagreement, gaps {gap[~agree]}"
    differ = (~agree).nonzero()
    return int(differ[0]) if len(differ) else len(want)


@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_loop_matches_jax(tiny, jax_models, qtype):
    """The runner's step under the sequential loop, greedy: JAX's tokens up
    to the first near-tie along them, where the port's argmax differs."""
    _, r = tiny(qtype)
    jcfg, jparams = jax_models(qtype)
    jfirst, want, _ = _jax_greedy(jcfg, jparams, STEPS)
    first, got, _ = _port_greedy(r, r.cfg, STEPS)
    agree = _agreeing_prefix(r, r.cfg, jfirst, want)
    print(f"{qtype}: the port chooses {agree} of JAX's {STEPS + 1} tokens outright")
    assert agree > 8
    assert len(got) == len(want) == STEPS
    assert ([first] + got)[:agree] == ([jfirst] + want)[:agree]


def test_stop_and_limit_match_jax(tiny, jax_models):
    """A stop in mid-run (the stop id set to a token greedy decode emits
    before the first near-tie) and `limit` reached: the port returns JAX's
    tokens and JAX's sampler state (last token, repeat count)."""
    _, r = tiny("Q8_0")
    jcfg, jparams = jax_models("Q8_0")
    jfirst, tokens, _ = _jax_greedy(jcfg, jparams, STEPS)
    agree = _agreeing_prefix(r, r.cfg, jfirst, tokens)
    k = next(i for i in range(3, agree - 1) if tokens[i] not in [jfirst] + tokens[:i])
    stop = tokens[k]
    for limit, cfgs in ((STEPS, (dataclasses.replace(jcfg, stopping_token_id=stop),
                                 dataclasses.replace(r.cfg, stopping_token_id=stop))),
                        (min(12, agree - 2), (jcfg, r.cfg))):
        want = _jax_greedy(cfgs[0], jparams, limit)
        got = _port_greedy(r, cfgs[1], limit)
        assert got == want
    assert want[1] == tokens[:min(12, agree - 2)]


@pytest.mark.parametrize("qtype", QTYPES)
def test_stream_and_generate_give_one_seeds_tokens(tiny, monkeypatch, qtype):
    """generate_stream's chunks (the sequential loop resumed on the
    runner's step, its generator and sampler state carried) emit
    generate's tokens at one seed, with other sampling values; one
    DecodeGraph serves both, and its route is named in the timings."""
    _, r = tiny(qtype)
    seen = []
    loop = to.orpheus_decode_loop

    def recording(*a, **kw):
        out = loop(*a, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(to, "orpheus_decode_loop", recording)
    cfg = GenerationConfig(seed=5, max_tokens=60, top_k=50, temperature=0.8, top_p=0.9,
                           repetition_penalty=1.2)
    r._steps.clear()
    resp = r.generate("stream me", cfg)
    whole = seen.pop()
    assert resp.timings["decode_route"] == "eager" and r.decode_route == "eager"
    assert len(whole) == 59
    chunks = list(r.generate_stream("stream me", cfg, chunk_tokens=14))
    assert len(chunks) > 1
    assert [t for part in seen for t in part] == whole
    assert list(r._steps) == [("eager", 50, True, True)]


def test_one_step_serves_other_sampling_values(tiny):
    """A second request with other temperature, top_p and penalty on the
    runner's DecodeGraph of the key equals that request on a new runner
    (the values are the buffers' at each load, not the first request's)."""
    path, r = tiny("Q4_0")
    a = GenerationConfig(seed=3, max_tokens=30, top_k=50, top_p=0.95)
    b = GenerationConfig(seed=3, max_tokens=30, top_k=50, top_p=0.6, temperature=0.5,
                         repetition_penalty=1.5)
    r._steps.clear()
    first = r.generate("values", a).audio
    second = r.generate("values", b).audio
    assert len(r._steps) == 1
    fresh = runner_from_file(path, device="cpu")
    fresh.cfg = r.cfg
    np.testing.assert_array_equal(fresh.generate("values", b).audio, second)
    assert not np.array_equal(first, second)


def test_decode_graph_captures_on_a_card_only():
    """A capture on the CPU is refused; the uncaptured step names its
    route "eager"."""
    cfg = to.OrpheusConfig(vocab_size=16)
    with pytest.raises(ValueError, match="captured on a card"):
        to.DecodeGraph(None, cfg, None, None, "cpu", capture=True)
    assert to.DecodeGraph(None, cfg, None, None, "cpu").route == "eager"


def test_loop_refuses_a_step_of_another_key():
    """A step keyed (top_k, do_sample, use_top_p) other than the call's, or
    on another generator, raises instead of sampling otherwise."""
    cfg = to.OrpheusConfig(vocab_size=16)
    step = to.DecodeGraph(None, cfg, None, None, "cpu", top_k=50)
    with pytest.raises(ValueError, match="keyed"):
        to.orpheus_decode_loop(None, cfg, torch.tensor([1], dtype=torch.int32), 10, 4, None,
                               None, ts.init_state(1, "cpu"), top_k=40, step=step)
    with pytest.raises(ValueError, match="keyed"):
        to.orpheus_decode_loop(None, cfg, torch.tensor([1], dtype=torch.int32), 10, 4, None,
                               torch.Generator(), ts.init_state(1, "cpu"), top_k=50, step=step)


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.help)
            for a in parser._actions if a.dest != "help"}


def test_server_flags_match_jax(monkeypatch):
    """Every JAX server flag with its short name and default (and --warmup's
    help), plus --device."""
    captured = []

    def capture(parser, argv=None, namespace=None):
        captured.append(parser)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jserver.main([])
    monkeypatch.undo()
    want, got = _flags(captured[0]), _flags(tserver.build_parser())
    assert got.pop("device")[:3] == (("--device",), "cuda", False)
    assert got["warmup"] == want["warmup"]
    assert {k: v[:3] for k, v in got.items()} == {k: v[:3] for k, v in want.items()}


def _serve_once(monkeypatch, capsys, argv) -> str:
    """tserver.main(argv) up to its serve_forever, which returns at once:
    its stderr."""
    def interrupt():
        raise KeyboardInterrupt

    monkeypatch.setattr(tserver, "make_server", lambda state, host, port:
                        types.SimpleNamespace(serve_forever=interrupt))
    tserver.main(argv)
    return capsys.readouterr().err


def test_server_warmup_on_dummy(monkeypatch, capsys):
    """--warmup on test:dummy: three warm requests, then `warmup ok`, then
    the listening line (as the JAX server prints them)."""
    err = _serve_once(monkeypatch, capsys, ["--model-path", "test:dummy", "--warmup",
                                            "--device", "cpu"])
    lines = err.splitlines()
    assert lines[0].startswith("warming up")
    assert "warmup ok" in lines and "warmup FAILED" not in err
    assert lines.index("warmup ok") < next(i for i, s in enumerate(lines) if "listening" in s)


def test_server_warmup_on_tiny_orpheus(tiny, monkeypatch, capsys):
    """--warmup on a tiny Orpheus GGUF with --device cpu: the three prompts
    and the first streamed chunk run on the default sampling key's step
    (its context cut to 256 tokens and its cap to 24: random weights
    never stop), then `warmup ok`; without --warmup nothing is generated before serving."""
    path, _ = tiny("Q8_0")
    from_kv = to.OrpheusConfig.from_gguf_kv
    monkeypatch.setattr(to.OrpheusConfig, "from_gguf_kv", staticmethod(
        lambda kv: dataclasses.replace(from_kv(kv), max_context_length=256,
                                       max_generation_size=24)))
    runs = []
    generate = to.OrpheusRunner.generate
    monkeypatch.setattr(to.OrpheusRunner, "generate",
                        lambda self, *a, **kw: runs.append(self) or generate(self, *a, **kw))
    err = _serve_once(monkeypatch, capsys, ["--model-path", path, "--device", "cpu"])
    assert "warm" not in err and not runs
    err = _serve_once(monkeypatch, capsys, ["--model-path", path, "--device", "cpu",
                                            "--warmup"])
    assert "warmup ok" in err.splitlines() and "FAILED" not in err
    assert len(runs) == 3
    assert list(runs[0]._steps) == [("eager", 50, True, False)]
