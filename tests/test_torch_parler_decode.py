"""Parler-TTS decoding on the port: its sequential loop against the JAX
package's, its speculative loop against its sequential loop (with and
without force_miss), generate_stream against generate, the row drafter, the
DAC against the JAX package's, the runner's entry points and the server.

The tiny models are tests/torch_tiny.py's (tests/test_torch_parler.py holds
the forward pass to JAX)."""

import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tiny import (PARLER_QTYPES as QTYPES, first_part, parler_models,  # noqa: E402
                        port_logits_along, staircase_inputs, write_tiny_parler)
from tts_tpu.codecs import dac as jdac  # noqa: E402
from tts_tpu.convert.builder_codecs import build_dac_tensors as jax_build_dac  # noqa: E402
from tts_tpu.convert.builder_t5 import write_t5_gguf  # noqa: E402
from tts_tpu.models import parler as jp  # noqa: E402
from tts_tpu.ops import spec as jspec  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.codecs import dac as tdac  # noqa: E402
from tts_tpu_torch.models import parler as tp  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops import spec as tspec  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402

torch.set_num_threads(1)

TEXT = "hello world"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, models) of torch_tiny's Parler, dense, Q8_0 or
    Q4_0; each is built on first use."""
    built = {}
    root = tmp_path_factory.mktemp("parler")

    def get(qtype):
        if qtype not in built:
            path = write_tiny_parler(root, qtype)
            built[qtype] = path, parler_models(path)
        return built[qtype]
    return get


def _prompt(tokenizer):
    return tokenizer.tokenize(TEXT) + [tokenizer.eos_token]


@pytest.fixture(scope="module")
def t5_path(tmp_path_factory):
    """A tiny T5 whose output width is the tiny Parler's encoding width."""
    return str(write_t5_gguf(tmp_path_factory.mktemp("t5") / "t5.gguf", seed=1, out_size=64))


def _jax_prefill(jcfg, jparams, ids, cross):
    cache = jp.init_kv_cache(jcfg)
    toks = np.zeros(16, np.int32)
    toks[:len(ids)] = ids
    return jp.parler_prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(len(ids), jnp.int32),
                             cache, cross)



@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_decode_loop_matches_jax(tiny, qtype):
    """The sequential greedy loop (40 steps after the same prefill): the
    port emits JAX's rows up to the first near-tie, and every difference
    along JAX's rows is a near-tie."""
    path, (jcfg, jparams, tcfg, tparams) = tiny(qtype)
    ids = _prompt(runner_from_file(path, device="cpu").tokenizer)
    jcross = jp.precompute_cross_kv(jparams, jcfg)
    out, n, *_ = jp.parler_decode_loop(
        jparams, jcfg, jnp.asarray(len(ids), jnp.int32), jnp.asarray(40, jnp.int32),
        _jax_prefill(jcfg, jparams, ids, jcross), jcross, jax.random.PRNGKey(0),
        jp.init_state(9), jp.init_loop_state(jcfg), max_steps=jcfg.max_generation_size,
        do_sample=False)
    want = np.asarray(out)[:int(n)]
    assert want.shape == (40, 9)
    part, _ = first_part(port_logits_along(tcfg, tparams, ids, staircase_inputs(tcfg, want)),
                          want)
    cache = tp.init_kv_cache(tcfg, "cpu")
    cross = tp.precompute_cross_kv(tparams, tcfg)
    tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, cross)
    got, _, state = tp.parler_decode_loop(tparams, tcfg, len(ids), 40, cache, cross, None,
                                          tp.init_state(9, "cpu"), tp.init_loop_state(tcfg),
                                          do_sample=False)
    assert got.shape == (40, 9) and state[2] == 40
    np.testing.assert_array_equal(got[:part], want[:part])
    if qtype == "dense":
        assert part == 40


# --------------------------------------------------------------- spec ops ---
@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_rows_match_jax(seed):
    """The row drafter on emitted rows with repeats (found and not found,
    at the buffer's start and end), against JAX's on the same buffer."""
    rng = np.random.default_rng(seed)
    n, k = 40 + 8, 7
    out = np.full((n, 9), 1024, np.int32)
    rows = rng.integers(0, 4, (40, 9)).astype(np.int32)
    rows[:, 1:] = 0
    out[:40] = rows
    for i in (0, 1, 2, 3, 10, 39, 40):
        got = tspec.ngram_draft_rows(out, i, k)
        want = np.asarray(jspec.ngram_draft_rows(jnp.asarray(out), jnp.asarray(i), k))
        np.testing.assert_array_equal(got, want, err_msg=f"i={i}")


def test_spec_enabled_reads_the_same_variable(monkeypatch):
    monkeypatch.delenv("TTS_TPU_NO_SPEC", raising=False)
    for sample in (False, True):
        assert (tspec.spec_enabled(GenerationConfig(sample=sample))
                == jspec.spec_enabled(JaxGenerationConfig(sample=sample)) == (not sample))
    monkeypatch.setenv("TTS_TPU_NO_SPEC", "1")
    assert not tspec.spec_enabled(GenerationConfig(sample=False))
    assert not jspec.spec_enabled(JaxGenerationConfig(sample=False))
    assert tspec.SPEC_K == jspec.SPEC_K == 7


# ------------------------------------------------------------- spec loop ---
@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("force_miss", [False, True], ids=["drafts", "force_miss"])
def test_spec_loop_matches_sequential_loop(tiny, qtype, force_miss):
    """The port's speculative greedy loop emits its sequential loop's rows:
    exactly on the dense model; on Q8_0 and Q4_0 up to the first near-tie
    (the verify's GEMM takes f32 x where the step's GEMV rounds it to
    bf16), and every difference along the spec rows is a near-tie of the
    sequential path.  force_miss (every draft rejected) emits the same rows
    one per forward."""
    path, (_, _, tcfg, tparams) = tiny(qtype)
    ids = _prompt(runner_from_file(path, device="cpu").tokenizer)
    cross = tp.precompute_cross_kv(tparams, tcfg)

    def prefilled():
        cache = tp.init_kv_cache(tcfg, "cpu")
        tp.parler_prefill(tparams, tcfg, torch.tensor(ids), cache, cross)
        return cache

    seq, _, seq_state = tp.parler_decode_loop(tparams, tcfg, len(ids), 48, prefilled(), cross,
                                              None, tp.init_state(9, "cpu"),
                                              tp.init_loop_state(tcfg), do_sample=False)
    out = np.full((tcfg.max_generation_size + 8, 9), tcfg.eos_token_id, np.int32)
    out, state, pos = tp.parler_decode_loop_spec_resume(
        tparams, tcfg, len(ids), 48, prefilled(), cross, tp.init_loop_state(tcfg), out,
        force_miss=force_miss)
    spec = out[:state[2]]
    assert spec.shape == seq.shape == (48, 9) and pos == len(ids) + 48
    assert (out[48:] == tcfg.eos_token_id).all()
    part, gap = first_part(port_logits_along(tcfg, tparams, ids, staircase_inputs(tcfg, spec)),
                            spec)
    print(f"{qtype} force_miss={force_miss}: spec and sequential rows agree on {part} of 48"
          + (f"; the first part has top-2 gap {gap:.2e}" if part < 48 else ""))
    if qtype == "dense":
        np.testing.assert_array_equal(spec, seq)
        for a, b in zip(state, seq_state):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(spec[:part], seq[:part])


# --------------------------------------------------------------- runner ---
@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "greedy"])
def test_generate_stream_matches_generate(tiny, qtype, sample):
    """Chunked streaming (the host loop state resumed per 13-row chunk, the
    DAC in windows held RECEPTIVE_FRAMES behind) equals one generate within
    2e-5, sampled (sequential loop, the generator carried) and greedy
    (speculative loop, the row buffer carried)."""
    r = runner_from_file(tiny(qtype)[0], device="cpu")
    cfg = GenerationConfig(seed=3, max_tokens=56, sample=sample, top_k=50)
    full = r.generate("stream me", cfg)
    chunks = list(r.generate_stream("stream me", cfg, chunk_steps=13))
    assert len(chunks) > 1
    stream = np.concatenate(chunks)
    assert stream.shape == full.audio.shape and len(stream) > 0
    np.testing.assert_allclose(stream, full.audio, atol=2e-5, rtol=0)


def _jax_dac_exact(dac, frames):
    """JAX's dac_decode at the exact frame count (its DACDecoder pads to a
    frame bucket: the pad frames' latents are zeroed, but the in-conv's
    bias still lights them, so the last few valid frames differ from an
    exact-shape decode)."""
    codes = jnp.asarray(np.asarray(frames, np.int32))
    return np.asarray(jdac.dac_decode(dac.params, dac.cfg, codes, jnp.asarray(len(frames))))


@pytest.mark.parametrize("frames", [50, 64])
def test_dac_matches_jax(frames):
    """DAC decode of random codes at the exact frame count against JAX's
    dac_decode at the same count within 1e-5 (tanh output in [-1, 1]), and
    against JAX's bucketed DACDecoder (64 frames, pad latents zeroed) on
    all but the last RECEPTIVE_FRAMES frames, which the pad frames reach."""
    tensors, kv = jax_build_dac(np.random.default_rng(2))
    codes = np.random.default_rng(3).integers(0, 1024, (frames, 9)).astype(np.int32)
    jax_dac = jdac.DACDecoder.from_tensors(tensors, kv)
    got = tdac.DACDecoder.from_tensors(tensors, kv, device="cpu").decode(codes)
    assert got.shape == (frames * 512,)
    np.testing.assert_allclose(got, _jax_dac_exact(jax_dac, codes), atol=1e-5, rtol=0)
    keep = max(0, frames - tdac.DACDecoder.RECEPTIVE_FRAMES) * 512
    bucketed = jax_dac.decode(codes)
    assert bucketed.shape == got.shape
    np.testing.assert_allclose(got[:keep], bucketed[:keep], atol=1e-5, rtol=0)


def test_dac_window_matches_full_decode():
    """decode_window with RECEPTIVE_FRAMES of context, in chunks of 7
    frames, concatenates to the full decode within 2e-5."""
    tensors, kv = jax_build_dac(np.random.default_rng(2))
    dac = tdac.DACDecoder.from_tensors(tensors, kv, device="cpu")
    codes = np.random.default_rng(4).integers(0, 1024, (60, 9)).astype(np.int32)
    pieces = [dac.decode_window(codes, s, s + 7) for s in range(0, 60, 7)]
    np.testing.assert_allclose(np.concatenate(pieces), dac.decode(codes), atol=2e-5, rtol=0)
    assert len(dac.decode_window(codes, 10, 10)) == 0 and len(dac.decode(codes[:0])) == 0


def test_runner_entry_points(tiny):
    """runner_from_file returns a ParlerRunner; its device follows its
    params; 'cuda' without a card raises (no CPU fallback); an over-long
    prompt raises TTSError."""
    path = tiny("Q8_0")[0]
    r = runner_from_file(path, device="cpu")
    assert isinstance(r, tp.ParlerRunner) and r.architecture == "parler-tts"
    assert r.device == torch.device("cpu") and r.list_voices() == []
    again = tp.ParlerRunner(r.cfg, r.params, r.tokenizer, r.dac)
    assert again.device == torch.device("cpu")
    with pytest.raises(TTSError):
        r.generate("a" * 600, GenerationConfig(max_tokens=4))
    if not torch.cuda.is_available():
        with pytest.raises(TTSError):
            runner_from_file(path)


def test_server_serves_parler(tiny, t5_path):
    """The port's server on a tiny Q4_0 Parler, device='cpu': a WAV, a PCM
    stream of the stream's length, and /v1/audio/conditional-prompt."""
    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers

    state = ServerState({"parler": tiny("Q4_0")[0]}, GenerationConfig(top_k=50), 1,
                        device="cpu")
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    try:
        status, ctype, body = post("/v1/audio/conditional-prompt",
                                   {"prompt": "a calm voice", "text_encoder_path": t5_path})
        assert (status, json.loads(body)) == (200, {"status": "ok"})
        status, ctype, body = post("/v1/audio/speech", {"input": TEXT, "max_tokens": 24,
                                                        "seed": 1})
        assert status == 200 and ctype == "audio/wav"
        status, ctype, pcm = post("/v1/audio/speech", {"input": TEXT, "max_tokens": 24,
                                                       "seed": 1, "response_format": "pcm"})
        assert status == 200 and ctype == "audio/pcm"
    finally:
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 44100
        assert w.getnframes() == len(pcm) // 2 > 0
