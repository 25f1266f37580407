"""Orpheus's speculative greedy and streaming routes on the port: the token
drafter against the JAX package's, the speculative loop against the port's
sequential loop (with and without force_miss) and resumed across chunk
boundaries, generate's routes, generate_stream against generate, SNAC's
decode_window against a full decode, and the stage trace.

The port's greedy generate against the JAX runner's (whose greedy route is
its speculative loop too) is tests/test_torch_orpheus.py's
test_generate_matches_jax.  The tiny models are tests/torch_tiny.py's."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from torch_tiny import CTX, GEN, QTYPES, orpheus_logits_along, write_tiny_orpheus  # noqa: E402
from tts_tpu.convert.builder_codecs import build_snac_tensors  # noqa: E402
from tts_tpu.models import orpheus as jo  # noqa: E402
from tts_tpu_torch.codecs import snac as tsnac  # noqa: E402
from tts_tpu_torch.models import orpheus as to  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops import spec as tspec  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

PROMPT = [128259, 128000, 72, 105, 128009, 128260, 128261, 128257]
# the sequential step's lm_head is a GEMV, which rounds its f32 x to bf16;
# the verify's is a GEMM, which keeps f32 accuracy (hi + lo): where the top
# two logits (spanning about +-0.2) lie within TIE, that rounding decides,
# and either token is right (tests/test_torch_orpheus.py's TIE)
TIE = 4e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> a CPU runner on torch_tiny's Orpheus (4096-row head),
    its cache cut to 64 + 448 = 512 positions."""
    built = {}

    def get(qtype):
        if qtype not in built:
            path = tmp_path_factory.mktemp("orpheus") / f"tiny_{qtype}.gguf"
            r = runner_from_file(str(write_tiny_orpheus(path, head_rows=4096, qtype=qtype)),
                                 device="cpu")
            r.cfg = dataclasses.replace(r.cfg, max_context_length=CTX, max_generation_size=GEN)
            built[qtype] = r
        return built[qtype]
    return get


def _prefilled(r):
    """(cache, first greedy token) after PROMPT's prefill."""
    cache = to.init_kv_cache(r.cfg)
    logits = to.orpheus_prefill(r.params, r.cfg, torch.tensor(PROMPT), cache)
    return cache, int(logits.argmax())


def _first_part(logits, want) -> int:
    """The first step where the argmax of `logits` differs from `want`
    (len(want) if none); asserts every difference is a near-tie (TIE)."""
    want = torch.tensor(want)
    agree = logits.argmax(-1) == want
    gap = logits.max(-1).values - logits.gather(1, want[:, None])[:, 0]
    assert bool((agree | (gap < TIE)).all()), f"non-tie disagreement, gaps {gap[~agree]}"
    differ = (~agree).nonzero()
    return int(differ[0]) if len(differ) else len(want)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafts_match_jax(seed):
    """The token drafter on histories with repeated 2-grams (found, the
    previous-frame fallback from 7 tokens on, the last-token repeat before)
    at the buffer's start and end, against JAX's _ngram_drafts on the same
    buffer."""
    rng = np.random.default_rng(seed)
    n, k, emitted = 48 + 8, 7, 48
    out = np.full(n, 128258, np.int32)
    out[:emitted] = rng.integers(0, 5 if seed % 2 else 40, emitted)
    for i in (0, 1, 2, 3, 6, 7, 8, 20, 47, 48):
        token = int(out[i - 1]) if i else 1234
        got = tspec.ngram_drafts(out, token, i, k)
        want = np.asarray(jo._ngram_drafts(jnp.asarray(out), jnp.asarray(token, jnp.int32),
                                           jnp.asarray(i, jnp.int32), k))
        np.testing.assert_array_equal(got, want, err_msg=f"i={i}")


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("force_miss", [False, True], ids=["drafts", "force_miss"])
def test_spec_loop_matches_sequential_loop(tiny, qtype, force_miss):
    """The speculative greedy loop (48 tokens after the prefill's) emits the
    sequential loop's tokens up to the first near-tie, and every difference
    along its tokens is a near-tie of the sequential path (TIE); force_miss
    emits the same tokens one per 8-token forward."""
    r = tiny(qtype)
    cache, first = _prefilled(r)
    seq, _ = to.orpheus_decode_loop(r.params, r.cfg, torch.tensor([first], dtype=torch.int32),
                                    len(PROMPT), 48, cache, None, to.init_state(1),
                                    do_sample=False)
    cache, _ = _prefilled(r)
    spec = to.orpheus_decode_loop_spec(r.params, r.cfg, first, len(PROMPT), 48, cache,
                                       force_miss=force_miss)
    assert len(spec) == len(seq) == 48
    part = _first_part(orpheus_logits_along(r.params, r.cfg, PROMPT, [first] + spec),
                       [first] + spec) - 1
    print(f"{qtype} force_miss={force_miss}: spec and sequential agree on {part} of 48")
    assert spec[:part] == seq[:part]


@pytest.mark.parametrize("qtype", QTYPES)
def test_spec_resume_across_chunks_matches_one_call(tiny, qtype):
    """The resumable core run in 5-token chunks (the token buffer, position
    and last token carried) emits what one call emits, and honours each
    chunk's bound."""
    r = tiny(qtype)
    cache, first = _prefilled(r)
    whole = to.orpheus_decode_loop_spec(r.params, r.cfg, first, len(PROMPT), 40, cache)
    cache, _ = _prefilled(r)
    out = to.spec_out_buffer(r.cfg)
    token, i, pos = first, 0, len(PROMPT)
    while i < 40:
        out, i_new, pos_new = to.orpheus_decode_loop_spec_resume(
            r.params, r.cfg, token, pos, i, min(i + 5, 40), cache, out)
        assert i_new - i == min(5, 40 - i) and pos_new - pos == i_new - i
        token, i, pos = int(out[i_new - 1]), i_new, pos_new
    assert out[:40].tolist() == whole
    assert (out[40:] == r.cfg.stopping_token_id).all()


def test_spec_loop_stops_at_the_stop_token(monkeypatch):
    """A verify window whose accepted drafts run past the stop token emits
    up to and including it (here the fifth window accepts 3, 5 and the
    buffer's stop fill, then rejects); a stop token as the carried token
    emits nothing."""
    cfg = to.OrpheusConfig(vocab_size=16, stopping_token_id=7, max_generation_size=32)
    script = [3, 5, 3, 5, 3, 5, 7] + [2] * 20

    def body(params, cfg, tokens, positions, cache, start=0):
        window = script[start - 10:start - 10 + len(tokens)]
        return torch.nn.functional.one_hot(torch.tensor(window), 16).float()

    monkeypatch.setattr(to, "_orpheus_body", body)
    monkeypatch.setattr(to, "_head_logits", lambda x, params, cfg: x)
    params = {"embd": torch.zeros(16, 4)}
    cache = {"k": torch.zeros(1, 1, 64, 4)}
    got = to.orpheus_decode_loop_spec(params, cfg, 1, 10, 20, cache)
    assert got == script[:7]
    assert to.orpheus_decode_loop_spec(params, cfg, 7, 10, 20, cache) == []


def test_generate_routes(tiny, monkeypatch):
    """Greedy requests take the speculative loop unless TTS_TPU_NO_SPEC is
    set; sampled requests take the sequential loop."""
    r = tiny("Q8_0")
    calls = []
    spec, seq = to.orpheus_decode_loop_spec, to.orpheus_decode_loop
    monkeypatch.setattr(to, "orpheus_decode_loop_spec",
                        lambda *a, **kw: calls.append("spec") or spec(*a, **kw))
    monkeypatch.setattr(to, "orpheus_decode_loop",
                        lambda *a, **kw: calls.append("seq") or seq(*a, **kw))
    monkeypatch.delenv("TTS_TPU_NO_SPEC", raising=False)
    r.generate("hi", GenerationConfig(max_tokens=8, sample=False))
    r.generate("hi", GenerationConfig(max_tokens=8, seed=1, top_k=50))
    monkeypatch.setenv("TTS_TPU_NO_SPEC", "1")
    r.generate("hi", GenerationConfig(max_tokens=8, sample=False))
    assert calls == ["spec", "seq", "seq"]


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "greedy"])
def test_generate_stream_matches_generate(tiny, qtype, sample):
    """Chunked streaming (14-token chunks; SNAC windows held
    RECEPTIVE_FRAMES behind, then the final flush) equals one generate
    within 2e-5, sampled (the sequential loop, generator and sampler state
    carried) and greedy (the speculative loop, its token buffer carried)."""
    r = tiny(qtype)
    cfg = GenerationConfig(seed=3, max_tokens=90, sample=sample, top_k=50)
    full = r.generate("stream me", cfg)
    chunks = list(r.generate_stream("stream me", cfg, chunk_tokens=14))
    assert len(chunks) > 1
    stream = np.concatenate(chunks)
    assert stream.shape == full.audio.shape == ((90 // 7) * 4 * 512,)
    np.testing.assert_allclose(stream, full.audio, atol=2e-5, rtol=0)


def test_decode_window_matches_full_decode():
    """decode_window in 7-frame pieces (window starts aligned to the x4
    head, RECEPTIVE_FRAMES of context each side) concatenates to the full
    decode within 2e-5; an empty range is empty."""
    tensors, kv = build_snac_tensors(np.random.default_rng(2), embd=96,
                                     channels=(48, 24, 12, 6))
    snac = tsnac.SNACDecoder.from_tensors(tensors, kv)
    rng = np.random.default_rng(5)
    t = 60
    heads = [rng.integers(0, 4096, t // rep) for rep in (4, 2, 1)]
    full = snac.decode(heads, seed=9)
    pieces = [snac.decode_window(heads, s, s + 7, seed=9) for s in range(0, t, 7)]
    np.testing.assert_allclose(np.concatenate(pieces), full, atol=2e-5, rtol=0)
    assert len(snac.decode_window(heads, 10, 10)) == 0 and snac.RECEPTIVE_FRAMES == 16


def test_capture_trace_keys(tiny):
    """capture_trace fills last_trace with the JAX runner's keys: the
    prompt, the prefill's logit statistics, the token stream's head and
    the SNAC streams."""
    r = tiny("Q4_0")
    r.capture_trace = True
    try:
        resp = r.generate("hi", GenerationConfig(max_tokens=21, sample=False))
    finally:
        r.capture_trace = False
    t = r.last_trace
    assert set(t) == {"prompt_ids", "n_prompt_tokens", "step0_logits", "first_token",
                      "tokens_first", "n_tokens", "eos_step", "head_lengths", "head_streams"}
    assert t["n_tokens"] == resp.timings["decode_steps"] == 21
    assert t["step0_logits"]["argmax"] == t["first_token"] == t["tokens_first"][0]
    assert t["head_lengths"] == [3, 6, 12] and t["eos_step"] == -1
    assert t["n_prompt_tokens"] == resp.timings["prompt_tokens"]
