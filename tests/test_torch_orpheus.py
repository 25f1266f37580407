"""The slice end to end: the port's Orpheus (tts_tpu_torch.models.orpheus) on
a tiny Q8_0 or Q4_0 GGUF against the JAX package on the same file, in one
process, each package reading it with its own GGUF reader.  The JAX side runs
its Pallas kernels in interpret mode (head size 128 and a 512-position cache
put decode on its flash kernel)."""

import dataclasses
import io
import json
import threading
import urllib.request
import wave
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import (  # noqa: E402
    CTX, GEN, QTYPES, orpheus_logits_along, orpheus_verify_logits_along, write_tiny_orpheus,
)
from tts_tpu.codecs import snac as jsnac  # noqa: E402
from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile  # noqa: E402
from tts_tpu.models import orpheus as jo  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu_torch.codecs import snac as tsnac  # noqa: E402
from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus  # noqa: E402
from tts_tpu_torch.core.gguf import GGUFFile  # noqa: E402
from tts_tpu_torch.models import orpheus as to  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402

torch.set_num_threads(1)

PROMPT = [128259, 128000, 72, 105, 128009, 128260, 128261, 128257]
FORCED = [1100 + 97 * i for i in range(8)]        # teacher-forced decode tokens
# Greedy choices are compared up to numerical ties: logits of the two
# packages differ by up to ~1e-3 here (bf16 activations: an f32 sum that
# differs in its last bit flips a bf16 rounding), so when JAX's token is
# within TIE of the port's best logit, rounding decides and either is right.
TIE = 4e-3


def _models(path):
    """(jax cfg, jax params, port cfg, port params) from one GGUF by each
    package's own reader and loader; the cache is cut to 64 + 448 = 512."""
    with JaxGGUFFile(path) as f:
        jcfg = dataclasses.replace(jo.OrpheusConfig.from_gguf_kv(f.kv),
                                   max_context_length=CTX, max_generation_size=GEN)
        jparams = jo.load_orpheus_params(dict(f.tensors), jcfg)
    with GGUFFile(path) as f:
        tcfg = dataclasses.replace(to.OrpheusConfig.from_gguf_kv(f.kv),
                                   max_context_length=CTX, max_generation_size=GEN)
        tparams = to.load_orpheus_params(dict(f.tensors), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype, head) -> (path, models) of the tiny model with Q8_0 or
    Q4_0 linears and a 4096-row head (fast JAX decode) or the real 156,940
    rows (head="full", padded to 157,696); each is built on first use."""
    built = {}

    def get(qtype, head="4096"):
        if (qtype, head) not in built:
            path = tmp_path_factory.mktemp("orpheus") / f"tiny_{qtype}_{head}.gguf"
            path = str(write_tiny_orpheus(path, head_rows=None if head == "full" else 4096,
                                          qtype=qtype))
            built[qtype, head] = path, _models(path)
        return built[qtype, head]
    return get


@pytest.fixture(scope="module")
def gguf(tiny):
    """The tiny Q8_0 model with a 4096-row head."""
    return tiny("Q8_0")[0]


@partial(jax.jit, static_argnums=(1,))
def _jax_step(params, cfg, token, pos, cache):
    x, cache = jo._orpheus_body(params, cfg, token[None], pos[None], pos, cache)
    return jo._head_logits(x[0], params, cfg), cache


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _assert_greedy_equal(logits, want) -> int:
    """At every step the port's argmax is JAX's token, or JAX's token is a
    numerical tie (within TIE of the port's max); nine in ten steps agree
    outright.  Returns the first step where the two differ."""
    want = torch.tensor(want)
    agree = logits.argmax(-1) == want
    gap = logits.max(-1).values - logits.gather(1, want[:, None])[:, 0]
    assert bool((agree | (gap < TIE)).all()), f"non-tie disagreement, gaps {gap[~agree]}"
    assert agree.float().mean().item() >= 0.9
    differ = (~agree).nonzero()
    return int(differ[0]) if len(differ) else len(want)


@pytest.mark.parametrize("qtype", QTYPES)
def test_loader_matches_params_from_jax(tiny, qtype):
    """The port's GGUF loader gives exactly the tensors that params_from_jax
    makes of the JAX loader's output (int8 or packed int4 weights, f16
    scales from the uint16 bits, bf16 embedding, f32 norms; fused
    qkv/gateup, the lm_head padded to a multiple of 1024)."""
    _, jparams, _, tparams = tiny(qtype, "full")[1]
    from_jax = to.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert set(tparams["layers"][0]) == {"in_norm", "qkv", "o", "post_norm", "gateup", "down"}
    if qtype == "Q4_0":
        assert tparams["head"]["wq4"].shape == (128, 157696)
    else:
        assert tparams["head"]["wq"].shape == (256, 157696)
    a, b = _flatten(tparams, []), _flatten(from_jax, [])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("head,kv", [("full", "bf16"), ("4096", "bf16"), ("4096", "int8")])
def test_prefill_and_decode_logits_match_jax(tiny, qtype, head, kv):
    """Exact-length prefill, then 8 teacher-forced decode steps (the port's
    flash-decode vs JAX's flash kernel), bf16 or int8 KV cache in both.
    Activations are bf16 on both sides, so a last-bit f32 difference can flip
    a bf16 rounding and carry through the layers: logits (spanning about
    +-0.2) agree to atol 2e-3."""
    jcfg, jparams, tcfg, tparams = tiny(qtype, head)[1]
    jcfg = dataclasses.replace(jcfg, kv_quant=kv == "int8")
    tcfg = dataclasses.replace(tcfg, kv_quant=kv == "int8")
    T = len(PROMPT)
    jcache = jo.init_kv_cache(jcfg)
    jl, jcache = jo.orpheus_prefill(jparams, jcfg, jnp.asarray(PROMPT, jnp.int32),
                                    jnp.asarray(T, jnp.int32), jcache)
    want = [np.asarray(jl)]
    for i, tok in enumerate(FORCED):
        jl, jcache = _jax_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(T + i, jnp.int32), jcache)
        want.append(np.asarray(jl))
    want = np.stack(want)
    got = orpheus_logits_along(tparams, tcfg, PROMPT, FORCED + [0]).numpy()
    assert got.shape == want.shape == (9, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_decode_loop_matches_jax(tiny, qtype):
    """Sequential greedy decode after the same prefill: the port's loop emits
    JAX's tokens, up to the first numerical tie."""
    jcfg, jparams, tcfg, tparams = tiny(qtype)[1]
    T = len(PROMPT)
    jcache = jo.init_kv_cache(jcfg)
    jl, jcache = jo.orpheus_prefill(jparams, jcfg, jnp.asarray(PROMPT, jnp.int32),
                                    jnp.asarray(T, jnp.int32), jcache)
    first = jnp.argmax(jl).astype(jnp.int32)
    out, n, *_ = jo.orpheus_decode_loop(
        jparams, jcfg, first, jnp.asarray(T, jnp.int32), jnp.asarray(40, jnp.int32), jcache,
        jax.random.PRNGKey(0), jo.init_state(1), max_steps=64, do_sample=False)
    want = [int(first)] + np.asarray(out)[: int(n)].tolist()
    assert len(want) == 41
    agree = _assert_greedy_equal(orpheus_logits_along(tparams, tcfg, PROMPT, want), want)

    tcache = to.init_kv_cache(tcfg, "cpu")
    tl = to.orpheus_prefill(tparams, tcfg, torch.tensor(PROMPT), tcache)
    tfirst = torch.argmax(tl).to(torch.int32).reshape(1)
    rest, _ = to.orpheus_decode_loop(tparams, tcfg, tfirst, T, 40, tcache, None,
                                     to.init_state(1, "cpu"), do_sample=False)
    got = [int(tfirst[0])] + rest
    assert len(got) == 41 and got[:agree] == want[:agree]


@pytest.mark.parametrize("lookahead,limit", [(0, 9), (1, 9), (4, 9), (1, 2)])
def test_decode_loop_stops_at_the_stop_token(monkeypatch, lookahead, limit):
    """The loop returns the tokens up to and including the stop token (or
    `limit` tokens), with the sampler state after its last token, and runs at
    most `_LOOKAHEAD` steps past the stop (their tokens are discarded)."""
    cfg = to.OrpheusConfig(vocab_size=16, stopping_token_id=7)
    script = [3, 5, 9, 7, 2, 2, 2, 2, 2, 2]
    positions = []

    def step(params, cfg, token, pos, cache):
        positions.append(int(pos[0]))
        return torch.nn.functional.one_hot(torch.tensor(script[len(positions) - 1]), 16).float()

    monkeypatch.setattr(to, "orpheus_decode_step", step)
    monkeypatch.setattr(to, "_LOOKAHEAD", lookahead)
    out, state = to.orpheus_decode_loop(None, cfg, torch.tensor([1], dtype=torch.int32), 10,
                                        limit, None, None, to.init_state(1, "cpu"), do_sample=False)
    assert out == script[:min(4, limit)]
    assert positions == list(range(10, 10 + min(4 + lookahead, limit)))
    assert state["last"].tolist() == [out[-1]]


def test_loader_packs_q4_0_to_int4(tmp_path):
    """A Q4_0 GGUF with Orpheus-3B's heads (24 query / 8 KV of 128) through
    load_orpheus_params: every linear is packed int4 [in/2, out] with f16
    scales [in/32, out], q/k/v and gate/up fuse along the output dim, the
    65,536-plus-row lm_head pads to a multiple of 1024 with zero columns,
    every tensor equals the JAX loader's (the scales as f16 bits), and the
    upload and unpacking seconds are recorded."""
    hidden, heads, kv_heads, hd, ffn, vocab = 128, 24, 8, 128, 256, 70000
    path = write_random_orpheus(tmp_path / "q4.gguf", qtype="Q4_0", n_layers=1, hidden=hidden,
                                heads=heads, kv_heads=kv_heads, head_dim=hd, ffn=ffn,
                                vocab=vocab, snac_embd=96, snac_channels=(48, 24, 12, 6))
    cfg = to.OrpheusConfig(n_layers=1, hidden_size=hidden, n_attn_heads=heads,
                           n_kv_attn_heads=kv_heads, head_size=hd, vocab_size=vocab)
    timings = {}
    with GGUFFile(path) as f:
        p = to.load_orpheus_params(dict(f.tensors), cfg, "cpu", timings=timings)
    assert set(timings) == {"pack_s", "upload_s"} and min(timings.values()) > 0
    layer = p["layers"][0]
    shapes = {"qkv": (hidden // 2, (heads + 2 * kv_heads) * hd), "o": (heads * hd // 2, hidden),
              "gateup": (hidden // 2, 2 * ffn), "down": (ffn // 2, hidden)}
    for name, (rows, cols) in shapes.items():
        assert set(layer[name]) == {"wq4", "scales"}
        assert layer[name]["wq4"].dtype == torch.int8
        assert tuple(layer[name]["wq4"].shape) == (rows, cols)
        assert layer[name]["scales"].dtype == torch.float16
        assert tuple(layer[name]["scales"].shape) == (rows * 2 // 32, cols)
    head = p["head"]
    assert tuple(head["wq4"].shape) == (hidden // 2, 70656)
    assert not head["wq4"][:, vocab:].any() and not head["scales"][:, vocab:].any()

    with JaxGGUFFile(path) as f:
        jcfg = jo.OrpheusConfig(n_layers=1, hidden_size=hidden, n_attn_heads=heads,
                                n_kv_attn_heads=kv_heads, head_size=hd, vocab_size=vocab)
        from_jax = to.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jo.load_orpheus_params(dict(f.tensors), jcfg)), "cpu")
    for x, y in zip(_flatten(p, []), _flatten(from_jax, []), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_generate_matches_jax(tiny, qtype, monkeypatch):
    """runner.generate, greedy, against the JAX runner: both take their
    speculative loop, so ties are read on the port's verify path (8-token
    forwards, the lm_head a GEMM on f32 x, as JAX's verify runs it): the
    same token ids up to the first numerical tie, and the port's audio
    equals the JAX decoder's on the port's tokens once the port's SNAC
    draws the JAX package's noise.
    113 tokens = 16 frames = 64 SNAC frames, one of JAX's frame buckets, so
    its decoder runs unpadded like the port's."""
    gguf = tiny(qtype)[0]
    cfg = GenerationConfig(seed=3, sample=False, max_tokens=113, voice="zoe")
    streams = {}

    def recording(key, fn):
        def wrapped(toks, c):
            streams[key] = list(toks)
            return fn(toks, c)
        return wrapped

    redistribute = jo.redistribute_output_tokens
    monkeypatch.setattr(jo, "redistribute_output_tokens", recording("jax", redistribute))
    monkeypatch.setattr(to, "redistribute_output_tokens",
                        recording("port", to.redistribute_output_tokens))
    monkeypatch.setattr(tsnac, "position_noise", lambda seed, layer, start, length, device: (
        torch.from_numpy(np.array(jsnac._position_noise(jax.random.PRNGKey(seed), layer,
                                                         start, length)))))
    jr = jax_runner_from_file(gguf)
    jr.cfg = dataclasses.replace(jr.cfg, max_context_length=CTX, max_generation_size=GEN)
    want = jr.generate("hi there", cfg)
    tr = runner_from_file(gguf, device="cpu")
    tr.cfg = dataclasses.replace(tr.cfg, max_context_length=CTX, max_generation_size=GEN)
    got = tr.generate("hi there", cfg)

    jax_toks, port_toks = streams["jax"], streams["port"]
    assert len(jax_toks) == len(port_toks) == got.timings["decode_steps"] == 113
    prompt = (list(to.PREPENDED_TOKENS) + tr.tokenizer.tokenize("zoe: hi there")
              + list(to.APPENDED_TOKENS))
    assert got.timings["prompt_tokens"] == len(prompt)
    agree = _assert_greedy_equal(orpheus_verify_logits_along(tr.params, tr.cfg, prompt, jax_toks),
                                 jax_toks)
    assert port_toks[:agree] == jax_toks[:agree]
    assert got.audio.shape == want.audio.shape == (64 * 512,)
    on_port_tokens = jr.snac.decode(redistribute(port_toks, jr.cfg), seed=3)
    np.testing.assert_allclose(got.audio, on_port_tokens, atol=1e-4, rtol=0)
    if agree == len(jax_toks):
        np.testing.assert_allclose(got.audio, want.audio, atol=1e-4, rtol=0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_sampled_generate_is_seeded_and_finite(tiny, qtype):
    """Sampled draws come from a torch.Generator: the same seed repeats, and
    the audio length follows the token count (lenient codes keep every frame)."""
    tr = runner_from_file(tiny(qtype)[0], device="cpu")
    tr.cfg = dataclasses.replace(tr.cfg, max_context_length=CTX, max_generation_size=GEN)
    cfg = GenerationConfig(seed=11, max_tokens=30, top_k=50, top_p=0.9, temperature=0.8,
                           repetition_penalty=1.2)
    a, b = tr.generate("hello", cfg), tr.generate("hello", cfg)
    np.testing.assert_array_equal(a.audio, b.audio)
    assert np.isfinite(a.audio).all()
    assert len(a.audio) == (a.timings["decode_steps"] // 7) * 4 * 512 > 0


def test_runner_errors(gguf):
    dummy = runner_from_file("test:dummy", device="cpu")
    assert len(dummy.generate("hi").audio) == 2 * dummy.sample_rate
    with pytest.raises(TTSError):
        runner_from_file("test:nonexistent", device="cpu")
    tr = runner_from_file(gguf, device="cpu")
    assert "zoe" in tr.list_voices()
    with pytest.raises(TTSError):
        tr.generate("hi", GenerationConfig(voice="nonexistent"))
    with pytest.raises(TTSError):
        tr.generate("a " * 2000, GenerationConfig())


@pytest.mark.parametrize("qtype", QTYPES)
def test_runner_takes_its_device_from_its_params(tiny, qtype):
    """A runner built from CPU params without device= runs on the CPU (the
    default follows the params; with none to follow it is the card)."""
    tr = runner_from_file(tiny(qtype)[0], device="cpu")
    runner = to.OrpheusRunner(tr.cfg, tr.params, tr.tokenizer, tr.snac)
    assert runner.device == torch.device("cpu")
    runner.cfg = dataclasses.replace(runner.cfg, max_context_length=CTX, max_generation_size=GEN)
    out = runner.generate("hi", GenerationConfig(seed=1, max_tokens=8, top_k=50))
    assert runner._cache["k"].device.type == "cpu"
    assert out.timings["decode_steps"] > 0
    assert to.OrpheusRunner(tr.cfg, {}, tr.tokenizer, tr.snac).device == torch.device("cuda")


def test_cuda_without_a_card_raises(gguf):
    """No silent CPU fallback: device='cuda' on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(TTSError):
        runner_from_file(gguf, device="cuda")


@pytest.mark.parametrize("qtype", QTYPES)
def test_server_answers_speech(tiny, qtype, monkeypatch):
    """The port's server on port 0, device='cpu': one POST -> a WAV of the
    right length.  Data parallelism with no visible card raises (replicas
    go on cards; nothing falls back to the CPU)."""
    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.parallel import serving

    gguf = tiny(qtype)[0]

    monkeypatch.setattr(serving, "serving_devices", lambda n=None: [])
    with pytest.raises(ValueError, match="0 visible"):
        ServerState({"m": gguf}, GenerationConfig(), data_parallel=True, device="cpu")
    state = ServerState({"tiny": gguf}, GenerationConfig(top_k=50), 1, device="cpu")
    runner, _ = state._get_runner("tiny")
    runner.cfg = dataclasses.replace(runner.cfg, max_context_length=CTX,
                                     max_generation_size=GEN)
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/speech",
            data=json.dumps({"input": "hi", "max_tokens": 15, "seed": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200 and r.headers.get("Content-Type") == "audio/wav"
            body = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    assert not any(w.is_alive() for w in state.workers)
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 24000
        assert w.getnframes() == (15 // 7) * 4 * 512
