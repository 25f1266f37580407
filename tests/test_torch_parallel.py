"""The port's parallel layer (tts_tpu_torch.parallel, Orpheus's tensor
parallelism, the registry's mesh= and the server's data and tensor
parallelism) against the JAX package's (tests/test_parallel.py), in one
process: JAX on its 8 virtual CPU devices, the port on meshes of `cpu`
entries, from the same GGUFs and the same numpy batches.  A device may
repeat in a port mesh; where a test needs distinct devices (replicas,
the server), it lists torch.device("cpu", i), which torch keeps apart as
devices and computes on the CPU."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from torch_tiny import orpheus_verify_logits_along  # noqa: E402
from tts_tpu.apps.quantize import main as jax_quantize_main  # noqa: E402
from tts_tpu.codecs import snac as jsnac  # noqa: E402
from tts_tpu.convert.builder_kokoro import KokoroDims, build_kokoro_tensors  # noqa: E402
from tts_tpu.models import kokoro as jk  # noqa: E402
from tts_tpu.models import orpheus as jo  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tts_tpu.parallel.training import DurationTrainer as JaxDurationTrainer  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.apps.server import ServerState, stop_workers  # noqa: E402
from tts_tpu_torch.codecs import snac as tsnac  # noqa: E402
from tts_tpu_torch.convert.builder_kokoro import write_kokoro_gguf  # noqa: E402
from tts_tpu_torch.convert.builder_orpheus import (  # noqa: E402
    build_orpheus_tensors, write_orpheus_gguf,
)
from tts_tpu_torch.models import kokoro as tk  # noqa: E402
from tts_tpu_torch.models import orpheus as to  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.parallel import serving  # noqa: E402
from tts_tpu_torch.parallel.mesh import Mesh, Shards, make_mesh  # noqa: E402
from tts_tpu_torch.parallel.training import (  # noqa: E402
    DurationTrainer, kokoro_param_specs, shard_params,
)
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# Greedy tokens are compared up to numerical ties, as in test_torch_orpheus:
# a token within TIE of the best logit may win either way.
TIE = 4e-3
GRAD_FLOOR = 1e-9


def _cpus(n):
    """n devices that torch tells apart, all computing on the CPU."""
    return [torch.device("cpu", i) for i in range(n)]


def _tp_mesh(tp):
    return Mesh([torch.device("cpu")] * tp, ("tp",))


# ------------------------------------------------------------------ meshes ---
def test_mesh_shape():
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.shape["tp"] == 2 and mesh.shape["dp"] == 4
    assert make_mesh(3, devices=CPU8).devices.shape == (3, 1)
    assert jax_make_mesh(8).devices.shape == mesh.devices.shape


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No visible CUDA device: make_mesh raises, never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# ----------------------------------------------------------------- trainer ---
@pytest.fixture(scope="module")
def kokoro():
    """KokoroDims.tiny() by the JAX builder, loaded by both packages:
    (dims, jax cfg, jax params, port cfg, port params)."""
    dims = KokoroDims.tiny()
    tensors, kv = build_kokoro_tensors(dims, np.random.default_rng(0))
    jcfg = dataclasses.replace(jk.KokoroConfig.from_gguf_kv(kv), style_half_size=dims.style // 2)
    tcfg = dataclasses.replace(tk.KokoroConfig.from_gguf_kv(kv), style_half_size=dims.style // 2)
    return (dims, jcfg, jk.load_kokoro_params(tensors, kv, jcfg), tcfg,
            tk.load_kokoro_params(tensors, kv, tcfg, "cpu"))


def _batch(dims, B=8, T=64):
    """tests/test_parallel.py's batch: positions 48..63 padded."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, dims.vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[:, 48:] = 0.0
    style = rng.standard_normal((B, dims.style // 2)).astype(np.float32) * 0.05
    target = np.full((B, T), 5.0, np.float32)
    return tokens, mask, style, target


def _port_losses(kokoro, mesh, steps=3):
    dims, _, _, tcfg, tparams = kokoro
    trainer = DurationTrainer(tcfg, mesh, learning_rate=1e-2)
    params, opt = trainer.init(tparams)
    losses = []
    for _ in range(steps):
        params, opt, loss = trainer.train_step(params, opt, *_batch(dims))
        losses.append(float(loss))
    return losses, params


def test_duration_train_step_matches_jax(kokoro):
    """3 steps at lr 1e-2 on the (4, 2) mesh: the port's losses are JAX's
    within rtol 1e-4, and the loss falls."""
    dims, jcfg, jparams, _, _ = kokoro
    trainer = JaxDurationTrainer(jcfg, jax_make_mesh(8), learning_rate=1e-2)
    # the JAX step donates its params: give it copies of the shared ones
    params, opt_state = trainer.init(jax.tree_util.tree_map(jnp.copy, jparams))
    want = []
    for _ in range(3):
        params, opt_state, loss = trainer.train_step(params, opt_state, *_batch(dims))
        want.append(float(loss))
    got, _ = _port_losses(kokoro, make_mesh(8, devices=CPU8))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got).all() and got[-1] < got[0]


def _jax_layout(grads):
    """The port's gradient tree in the JAX params' layout: shards joined,
    each LSTM direction's w_ih/w_hh transposed and b_ih as JAX's b; a leaf
    the loss never reached is zeros."""
    if isinstance(grads, dict) and "w_hh" in grads:
        return {"w_ih": grads["w_ih"].T, "w_hh": grads["w_hh"].T, "b": grads["b_ih"]}
    if isinstance(grads, dict):
        return {k: _jax_layout(v) for k, v in grads.items()}
    if isinstance(grads, list):
        return [_jax_layout(v) for v in grads]
    return grads


def test_duration_step_gradients_match_jax(kokoro):
    """The step-1 gradients on the (4, 2) mesh, dp rows summed and tp shards
    joined, are JAX's (the JAX trainer's loss, unsharded) within 1e-3 of
    each tensor's peak; a tensor off the duration path gets none.
    GRAD_FLOOR covers gradients that are zero in exact arithmetic (k_b: a
    key bias shifts every logit of a query alike), whose f32 rounding
    noise (~1e-11) has no peak to scale with."""
    dims, jcfg, jparams, _, _ = kokoro
    tokens, mask, style, target = (jnp.asarray(a) for a in _batch(dims))

    def loss_fn(params):
        def one(tok, m, st, tgt):
            sums, _ = jk.duration_raw(params, jcfg, tok, m, st)
            return jnp.sum(jnp.square((sums - tgt) * m)) / jnp.maximum(jnp.sum(m), 1.0)
        return jnp.mean(jax.vmap(one)(tokens, mask, style, target))

    want = jax.grad(loss_fn)(jparams)
    _, params = _port_losses(kokoro, make_mesh(8, devices=CPU8), steps=1)
    specs = kokoro_param_specs(params)

    def grad(leaf, spec):
        if isinstance(leaf, Shards):
            return torch.cat([grad(x, ()) for x in leaf], dim=spec.index("tp"))
        return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad

    got = _jax_layout(_grad_tree(params, specs, grad))
    for part in ("albert", "dp"):
        flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want[part])
        flat_g = tree_w.flatten_up_to(got[part])
        for g, (path, w) in zip(flat_g, flat_w):
            w = np.asarray(w)
            g = g.detach().numpy()
            assert g.shape == w.shape
            floor = GRAD_FLOOR if jax.tree_util.keystr(path).endswith("['k_b']") else 0.0
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + floor, \
                jax.tree_util.keystr(path)


def _grad_tree(params, specs, grad):
    if isinstance(params, dict):
        return {k: _grad_tree(v, specs[k], grad) for k, v in params.items()}
    if isinstance(params, list) and not isinstance(params, Shards):
        return [_grad_tree(v, s, grad) for v, s in zip(params, specs)]
    return grad(params, specs)


@pytest.fixture(scope="module")
def losses_1x1(kokoro):
    return _port_losses(kokoro, make_mesh(1, devices=CPU8))[0]


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2), (4, 2)])
def test_duration_losses_across_meshes(kokoro, losses_1x1, dp, tp):
    """Any (dp, tp) mesh gives the (1, 1) mesh's losses within rtol 1e-5."""
    got, _ = _port_losses(kokoro, make_mesh(dp * tp, tp=tp, devices=CPU8))
    np.testing.assert_allclose(got, losses_1x1, rtol=1e-5)


def test_param_sharding_is_applied(kokoro):
    """tp = 2: each shard of q_w holds half the output features, of o_w
    half the input features; a replicated leaf is one tensor."""
    *_, tparams = kokoro
    placed, specs = shard_params(tparams, make_mesh(8, devices=CPU8))
    L = placed["albert"]["layers"][0]
    q_w = tparams["albert"]["layers"][0]["q_w"]
    assert isinstance(L["q_w"], Shards) and len(L["q_w"]) == 2
    assert {tuple(s.shape) for s in L["q_w"]} == {(q_w.shape[0], q_w.shape[1] // 2)}
    assert {tuple(s.shape) for s in L["o_w"]} == {(q_w.shape[1] // 2, q_w.shape[1])}
    torch.testing.assert_close(torch.cat(list(L["q_w"]), dim=1), q_w, rtol=0, atol=0)
    assert isinstance(L["o_b"], torch.Tensor) and specs["albert"]["layers"][0]["o_b"] == ()


def test_trainer_rejects_a_batch_dp_does_not_split(kokoro):
    dims, _, _, tcfg, tparams = kokoro
    trainer = DurationTrainer(tcfg, make_mesh(8, devices=CPU8), learning_rate=1e-2)
    params, opt = trainer.init(tparams)
    with pytest.raises(ValueError, match="dp=4"):
        trainer.train_step(params, opt, *_batch(dims, B=6))


# ------------------------------------------------------ masked durations ---
def test_masked_batched_duration_raw_matches_unpadded(kokoro):
    """A batch padded at the tail: every valid position equals the unpadded
    single-example call, and JAX's masked duration_raw on the padded row."""
    dims, jcfg, jparams, tcfg, tparams = kokoro
    rng = np.random.default_rng(5)
    lengths, T = (20, 13, 7), 24
    tokens = rng.integers(1, dims.vocab, (3, T)).astype(np.int64)
    mask = (np.arange(T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    style = rng.standard_normal((3, dims.style // 2)).astype(np.float32) * 0.05
    sums, hidden = tk.duration_raw(tparams, tcfg, torch.from_numpy(tokens),
                                   torch.from_numpy(style), torch.from_numpy(mask))
    assert sums.shape == (3, T) and hidden.shape[:2] == (3, T)
    for b, n in enumerate(lengths):
        one_s, one_h = tk.duration_raw(tparams, tcfg, torch.from_numpy(tokens[b, :n]),
                                       torch.from_numpy(style[b]))
        torch.testing.assert_close(sums[b, :n], one_s, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(hidden[b, :n], one_h, rtol=1e-5, atol=1e-5)
        js, jh = jk.duration_raw(jparams, jcfg, jnp.asarray(tokens[b], jnp.int32),
                                 jnp.asarray(mask[b]), jnp.asarray(style[b]))
        np.testing.assert_allclose(sums[b, :n].numpy(), np.asarray(js)[:n], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(hidden[b, :n].numpy(), np.asarray(jh)[:n], rtol=1e-4,
                                   atol=1e-5)


def test_duration_raw_rejects_a_mask_that_is_not_a_trailing_pad(kokoro):
    dims, _, _, tcfg, tparams = kokoro
    tokens = torch.ones(2, 8, dtype=torch.long)
    mask = torch.ones(2, 8)
    mask[1, 3] = 0.0
    with pytest.raises(ValueError, match="trailing pad"):
        tk.duration_raw(tparams, tcfg, tokens, torch.zeros(2, dims.style // 2), mask)


# ------------------------------------------------------- Orpheus TP forward ---
def test_orpheus_tensor_parallel_forward():
    """A dense tiny Orpheus cut over the (4, 2) mesh's tp axis: its prefill
    logits equal the unsharded port's, and JAX's sharded prefill's, within
    the port's ~1e-3."""
    rng = np.random.default_rng(0)
    tensors, kv = build_orpheus_tensors(rng, vocab=1024, hidden=64, heads=4, kv_heads=2,
                                        head_dim=16)
    tensors = {k: v for k, v in tensors.items() if k.startswith("orpheus.")}
    tokens = rng.integers(0, 1024, 32).astype(np.int32)

    jcfg = dataclasses.replace(jo.OrpheusConfig.from_gguf_kv(kv), vocab_size=1024,
                               max_context_length=64, max_generation_size=32)
    jparams, jcache, jcfg = jo.make_tp_context(jo.load_orpheus_params(tensors, jcfg), jcfg,
                                               jax_make_mesh(8))
    want, _ = jo.orpheus_prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(32, jnp.int32),
                                 jcache)
    cfg = dataclasses.replace(to.OrpheusConfig.from_gguf_kv(kv), vocab_size=1024,
                              max_context_length=64, max_generation_size=32)
    params = to.load_orpheus_params(tensors, cfg, "cpu")
    base = to.orpheus_prefill(params, cfg, torch.from_numpy(tokens), to.init_kv_cache(cfg, "cpu"))
    sparams, cache, scfg = to.make_tp_context(params, cfg, make_mesh(8, devices=CPU8))
    assert scfg.tp == 2 and isinstance(cache, Shards)
    assert isinstance(sparams["layers"][0]["q"], Shards)
    got = to.orpheus_prefill(sparams, scfg, torch.from_numpy(tokens), cache)
    assert got.shape == (1024,) and torch.isfinite(got).all()
    torch.testing.assert_close(got, base, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


# -------------------------------------------------------- Orpheus TP runs ---
def _recording(monkeypatch, module, key, streams):
    fn = module.redistribute_output_tokens

    def wrapped(toks, c):
        streams[key] = list(toks)
        return fn(toks, c)
    monkeypatch.setattr(module, "redistribute_output_tokens", wrapped)


def _agree_up_to_ties(runner, text, voice, want, got) -> int:
    """got's tokens are want's up to the first step where want's token is a
    tie (within TIE of the best logit, on the unsharded runner's verify
    path) and the two part; returns that step (len(want): all agree)."""
    prompt = runner._prompt_ids(text, GenerationConfig(voice=voice))
    logits = orpheus_verify_logits_along(runner.params, runner.cfg, prompt, want)
    part = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), len(want))
    if part < len(want):
        row = logits[part]
        assert row.max() - row[got[part]] < TIE, f"step {part}: not a tie"
    else:
        assert len(got) == len(want)
    return part


def _short(runner):
    runner.cfg = dataclasses.replace(runner.cfg, max_context_length=64, max_generation_size=448)
    return runner


def _jax_noise(monkeypatch):
    monkeypatch.setattr(tsnac, "position_noise", lambda seed, layer, start, length, device: (
        torch.from_numpy(np.array(jsnac._position_noise(jax.random.PRNGKey(seed), layer,
                                                         start, length)))))


def test_orpheus_tp_e2e_matches_unsharded_and_jax(tmp_path, monkeypatch):
    """Greedy generation through the runner on a tp = 2 mesh: the unsharded
    runner's tokens up to near-ties, and the same audio where they agree;
    and JAX's TP runner on the same file, the same way (its SNAC noise
    injected).  113 tokens = 64 SNAC frames, one of JAX's frame buckets."""
    path = str(tmp_path / "orpheus.gguf")
    write_orpheus_gguf(path, seed=0)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=113, voice="zoe")
    streams = {}
    _recording(monkeypatch, to, "port", streams)
    _recording(monkeypatch, jo, "jax", streams)
    _jax_noise(monkeypatch)

    r0 = _short(runner_from_file(path, device="cpu"))
    a0 = r0.generate("hello world", cfg)
    base = streams["port"]
    mesh = _tp_mesh(2)
    r1 = _short(runner_from_file(path, mesh=mesh))
    assert r1.mesh is mesh and r1.cfg.tp == 2 and r1.device == mesh.lead
    assert isinstance(r1.params["layers"][0]["q"], Shards)
    a1 = r1.generate("hello world", cfg)
    if _agree_up_to_ties(r0, "hello world", "zoe", base, streams["port"]) == len(base):
        np.testing.assert_allclose(a1.audio, a0.audio, atol=1e-5, rtol=0)
    assert len(a1.audio) == len(a0.audio) > 0

    jr = jax_runner_from_file(path, JaxGenerationConfig(), mesh=JaxMesh(
        np.array(jax.devices()[:2]), axis_names=("tp",)))
    jr.cfg = dataclasses.replace(jr.cfg, max_context_length=64, max_generation_size=448)
    ja = jr.generate("hello world", JaxGenerationConfig(sample=False, seed=0, max_tokens=113,
                                                        voice="zoe"))
    if _agree_up_to_ties(r0, "hello world", "zoe", streams["jax"], streams["port"]) == 113:
        np.testing.assert_allclose(a1.audio, ja.audio, atol=1e-4, rtol=0)


def test_orpheus_tp_speculative_decode_matches_sequential(tmp_path, monkeypatch):
    """Under TP the speculative route (generate and generate_stream) and the
    sequential one (TTS_TPU_NO_SPEC) give the same tokens up to near-ties,
    the same audio where they agree, and the stream equals generate."""
    path = str(tmp_path / "orpheus.gguf")
    write_orpheus_gguf(path, seed=0)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=30, voice="zoe")
    streams = {}
    _recording(monkeypatch, to, "port", streams)
    r1 = _short(runner_from_file(path, mesh=_tp_mesh(2)))
    a_spec = r1.generate("hello world", cfg)
    spec = streams["port"]
    s_spec = np.concatenate(list(r1.generate_stream("hello world", cfg)))
    monkeypatch.setenv("TTS_TPU_NO_SPEC", "1")
    a_seq = r1.generate("hello world", cfg)
    np.testing.assert_allclose(s_spec, a_spec.audio, atol=2e-5, rtol=0)
    r0 = _short(runner_from_file(path, device="cpu"))
    if _agree_up_to_ties(r0, "hello world", "zoe", spec, streams["port"]) == len(spec):
        np.testing.assert_allclose(a_spec.audio, a_seq.audio, atol=1e-5, rtol=0)
    assert len(a_spec.audio) == len(a_seq.audio) > 0


def _quantized(tmp_path, qtype="Q8_0", **dims):
    f32 = str(tmp_path / "orpheus_f32.gguf")
    out = str(tmp_path / f"orpheus_{qtype}.gguf")
    write_orpheus_gguf(f32, seed=0, **dims)
    assert jax_quantize_main(["--model-path", f32, "--quantized-model-path", out,
                              "--quantized-type", qtype, "--quantize-output-heads"]) == 0
    return out


def _counting_flash(monkeypatch):
    """Count flash_decode calls by the KV heads of the cache each got."""
    calls = []
    fn = to.flash_decode

    def wrapped(q, k_cache, *args, **kw):
        calls.append(k_cache.shape[0])
        return fn(q, k_cache, *args, **kw)
    monkeypatch.setattr(to, "flash_decode", wrapped)
    return calls


@pytest.mark.parametrize("tp", [2, 4])
def test_orpheus_tp_shards_quantized_weights(tmp_path, monkeypatch, tp):
    """A Q8_0 Orpheus (head size 128, 4 KV heads) cut over tp: q's wq and
    scales split by columns, o's by rows, cfg.tp == tp, and decode takes
    flash_decode on every shard's KV heads (the JAX package turns flash off
    at tp = 4, where a shard holds one KV head: a Mosaic limit the card's
    kernel does not share).  Greedy tokens equal the unsharded runner's up
    to near-ties."""
    q8 = _quantized(tmp_path, hidden=128, heads=4, kv_heads=4, head_dim=128, ffn=256)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=24, voice="zoe")
    streams = {}
    _recording(monkeypatch, to, "port", streams)
    r0 = _short(runner_from_file(q8, device="cpu"))
    assert "wq" in r0.params["layers"][0]["qkv"]
    a0 = r0.generate("hello world", cfg)
    base = streams["port"]

    r1 = _short(runner_from_file(q8, mesh=_tp_mesh(tp)))
    assert r1.cfg.tp == tp
    L = r1.params["layers"][0]
    wq, sc, o = r0.params["layers"][0]["qkv"]["wq"], r0.params["layers"][0]["qkv"]["scales"], \
        r0.params["layers"][0]["o"]["wq"]
    n_q = 4 * 128
    assert [tuple(s["wq"].shape) for s in L["q"]] == [(wq.shape[0], n_q // tp)] * tp
    assert [tuple(s["scales"].shape) for s in L["q"]] == [(sc.shape[0], n_q // tp)] * tp
    torch.testing.assert_close(torch.cat([s["wq"] for s in L["q"]], dim=1), wq[:, :n_q])
    assert [tuple(s["wq"].shape) for s in L["o"]] == [(o.shape[0] // tp, o.shape[1])] * tp
    assert isinstance(r1._cache, Shards) and len(r1._cache) == tp
    flash = _counting_flash(monkeypatch)
    monkeypatch.setenv("TTS_TPU_NO_SPEC", "1")      # decode steps: the flash path
    a1 = r1.generate("hello world", cfg)
    assert flash and set(flash) == {4 // tp}
    assert len(flash) == tp * 2 * (a1.timings["decode_steps"] - 1)
    if _agree_up_to_ties(r0, "hello world", "zoe", base, streams["port"]) == len(base):
        np.testing.assert_allclose(a1.audio, a0.audio, atol=1e-5, rtol=0)
    assert len(a1.audio) == len(a0.audio) > 0


def test_orpheus_tp_uneven_heads_falls_back(tmp_path, monkeypatch):
    """2 KV heads over tp = 4: the KV cache stays whole on the lead device
    (flash on it), the quantized linears still shard, and generation equals
    the unsharded runner's up to near-ties."""
    q8 = _quantized(tmp_path, hidden=128, heads=4, kv_heads=2, head_dim=128, ffn=256)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=24, voice="zoe")
    streams = {}
    _recording(monkeypatch, to, "port", streams)
    r0 = _short(runner_from_file(q8, device="cpu"))
    a0 = r0.generate("hello world", cfg)
    base = streams["port"]
    r1 = _short(runner_from_file(q8, mesh=_tp_mesh(4)))
    assert r1.cfg.tp == 4 and isinstance(r1.params["layers"][0]["q"], Shards)
    assert not isinstance(r1._cache, Shards) and r1._cache["k"].shape[1] == 2
    flash = _counting_flash(monkeypatch)
    a1 = r1.generate("hello world", cfg)
    assert set(flash) <= {2}
    if _agree_up_to_ties(r0, "hello world", "zoe", base, streams["port"]) == len(base):
        np.testing.assert_allclose(a1.audio, a0.audio, atol=1e-5, rtol=0)
    assert len(a1.audio) == len(a0.audio) > 0


def test_orpheus_q4_stays_replicated(tmp_path, caplog):
    """Q4_0's row-parallel o/down cannot split (an int4 byte packs rows k and
    k + K/2): the model stays whole and fused on the lead device with
    cfg.tp == 1, a warning says so, and the audio is the unsharded one."""
    q4 = _quantized(tmp_path, "Q4_0", hidden=128, heads=4, kv_heads=4, head_dim=128, ffn=256)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=24, voice="zoe")
    with caplog.at_level(logging.WARNING, logger="tts_tpu_torch"):
        r1 = _short(runner_from_file(q4, mesh=_tp_mesh(2)))
    assert r1.cfg.tp == 1 and "does not split" in caplog.text
    assert "wq4" in r1.params["layers"][0]["qkv"] and not isinstance(r1._cache, Shards)
    r0 = _short(runner_from_file(q4, device="cpu"))
    np.testing.assert_array_equal(r1.generate("hi", cfg).audio, r0.generate("hi", cfg).audio)


def test_mesh_rejected_for_non_tp_architecture(tmp_path):
    mesh = make_mesh(8, devices=CPU8)
    with pytest.raises(TTSError, match="tensor-parallel"):
        runner_from_file("test:dummy", mesh=mesh)
    path = str(write_kokoro_gguf(tmp_path / "k.gguf", KokoroDims.tiny(), seed=0))
    with pytest.raises(TTSError, match="tensor-parallel"):
        runner_from_file(path, mesh=mesh)


# --------------------------------------------------------- data parallel ---
@pytest.fixture
def kokoro_path(tmp_path):
    return str(write_kokoro_gguf(tmp_path / "k.gguf", KokoroDims.tiny(), seed=0))


def test_data_parallel_replica_placement(kokoro_path):
    """load_replica commits a replica to each device; replicas hold their
    own weights and give the same audio."""
    cfg = GenerationConfig(voice="af_heart", seed=0)
    d0, d1 = _cpus(2)
    r0 = serving.load_replica(kokoro_path, cfg, d0)
    r1 = serving.load_replica(kokoro_path, cfg, d1)
    assert r0.model.device == d0 and r1.model.device == d1
    e0, e1 = (r.model.params["albert"]["token_embd"] for r in (r0, r1))
    assert e0.data_ptr() != e1.data_ptr()
    a0, a1 = r0.generate("hello world", cfg), r1.generate("hello world", cfg)
    np.testing.assert_array_equal(a0.audio, a1.audio)
    assert len(a0.audio) > 0


def test_move_to_device_rejects_undeclared_tensors(kokoro_path):
    """move_to_device moves the declared state (the model's params and
    window, and its device) and raises on an undeclared tensor attribute."""
    runner = runner_from_file(kokoro_path, GenerationConfig(voice="af_heart"), device="cpu")
    target = _cpus(2)[1]
    serving.move_to_device(runner, target)
    assert runner.model.device == target
    runner.surprise = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="surprise"):
        serving.move_to_device(runner, _cpus(1)[0])


def test_server_data_parallel_routing(kokoro_path, monkeypatch):
    """ServerState(data_parallel=True) loads one replica per (model, device)
    and serves requests from replicas on different devices."""
    monkeypatch.setattr(serving, "serving_devices", lambda n=None: _cpus(2))
    cfg = GenerationConfig(voice="af_heart", seed=0)
    state = ServerState({"k": kokoro_path}, cfg, n_parallelism=2, data_parallel=True,
                        device="cpu")
    try:
        results = [state.submit({"kind": "tts", "model": "k", "prompt": "hi there",
                                 "config": cfg}) for _ in range(4)]
    finally:
        stop_workers(state)
    assert all(r["success"] for r in results), [r.get("message") for r in results]
    lens = {len(r["audio"]) for r in results}
    assert len(lens) == 1 and lens.pop() > 0
    assert all(isinstance(key, tuple) for key in state._runners)
    assert {runner.model.device for runner in state._runners.values()} == set(_cpus(2))


def test_server_dp_tp_composed(tmp_path, monkeypatch):
    """DP x TP: ServerState(data_parallel=True, tensor_parallel=2) places its
    replicas on disjoint 2-device tp meshes and serves the same audio from
    each."""
    monkeypatch.setattr(serving, "serving_devices", lambda n=None: _cpus(4))
    path = str(tmp_path / "o.gguf")
    write_orpheus_gguf(path, seed=0, hidden=128, heads=4, kv_heads=4, head_dim=32, ffn=256)
    cfg = GenerationConfig(sample=False, seed=0, max_tokens=22, voice="zoe")
    state = ServerState({"o": path}, cfg, n_parallelism=2, data_parallel=True,
                        tensor_parallel=2, device="cpu")
    try:
        results = [state.submit({"kind": "tts", "model": "o", "prompt": "hi", "config": cfg})
                   for _ in range(4)]
    finally:
        stop_workers(state)
    assert all(r["success"] for r in results), [r.get("message") for r in results]
    lens = {len(r["audio"]) for r in results}
    assert len(lens) == 1 and lens.pop() > 0
    groups = [frozenset(runner.mesh.devices.flat) for runner in state._runners.values()]
    assert len(groups) == 2 and all(len(g) == 2 for g in groups)
    assert len(frozenset.union(*groups)) == 4
    assert all(runner.cfg.tp == 2 for runner in state._runners.values())


def test_replica_meshes_raise_on_too_few_distinct_devices(monkeypatch):
    monkeypatch.setattr(serving, "serving_devices", lambda n=None: _cpus(1))
    with pytest.raises(ValueError, match="tensor_parallel=2 needs at least 2 devices; 1 visible"):
        serving.replica_meshes(2)
    with pytest.raises(ValueError, match="1 visible"):
        ServerState({"d": "test:dummy"}, GenerationConfig(), tensor_parallel=2, device="cpu")
    monkeypatch.setattr(serving, "serving_devices", lambda n=None: [])
    with pytest.raises(ValueError, match="0 visible"):
        ServerState({"d": "test:dummy"}, GenerationConfig(), data_parallel=True, device="cpu")
