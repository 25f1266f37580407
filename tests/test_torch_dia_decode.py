"""Dia decoding on the port: its greedy generate against the JAX runner's,
its speculative loop against its sequential loop (with and without
force_miss), the drain evolution and the delay un-weave against the JAX
package's, generate_stream against generate, the stage trace, the
max_tokens guard and the runner's entry points.

The tiny models are tests/torch_tiny.py's (tests/test_torch_dia.py holds
the forward pass to JAX)."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from torch_tiny import DIA_QTYPES as QTYPES, first_part, write_tiny_dia  # noqa: E402
from tts_tpu.codecs import dac as jdac  # noqa: E402
from tts_tpu.models import dia as jd  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.models import dia as td  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402

torch.set_num_threads(1)

TEXT = "[S1] Hello there. [S2] Hi!"
# Greedy rows are compared up to numerical ties: on quantized files the
# caches hold bf16, and an f32 value differing in its last bit between two
# paths (the packages, or the step's M = 2 GEMM and the verify's M = 16 one)
# can round to a neighbouring bf16; the merged logits (about +-0.2) then
# differ by up to ~1e-4.  Where the other side's id is within DIA_TIE of the
# best merged logit, rounding decides and either is right.
DIA_TIE = 1e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny(qtype) -> (path, CPU runner) of torch_tiny's Dia."""
    built = {}
    root = tmp_path_factory.mktemp("dia")

    def get(qtype):
        if qtype not in built:
            path = write_tiny_dia(root, qtype)
            built[qtype] = path, runner_from_file(path, device="cpu")
        return built[qtype]
    return get


def _logits_along(r, rows, limit: int, width: int = 1):
    """The port's merged logits [n, 9, vocab] teacher-forced along the
    sequential loop's inputs for `rows` [n, 9] under max_tokens `limit`
    (which starts the drain), `width` rows per forward."""
    cfg = r.cfg
    tokens, delay, _ = td.dia_init_loop_state(cfg)
    ins = []
    for i, row in enumerate(rows):
        ins.append(tokens)
        tokens, delay = td._drain_step(cfg, row, i + 1, delay, limit)
    ins = torch.from_numpy(np.stack(ins))
    with torch.inference_mode():
        cross, _, _ = r._encode(td.tokenize_dia_sentence(TEXT, cfg), GenerationConfig())
        return torch.cat([td._dia_rows(r.params, cfg, ins[i:i + width], i, r._cache, cross)
                          for i in range(0, len(ins), width)])


# ------------------------------------------------------------ host pieces ---
@pytest.mark.parametrize("seed", range(3))
def test_drain_step_matches_jax(seed):
    """The next-input and drain evolution on random rows (EOS in head 0 at
    times), across the BOS staircase, the limit trigger and the drain."""
    cfg, jcfg = td.DiaConfig(), jd.DiaConfig()
    rng = np.random.default_rng(seed)
    delays, heads = jnp.asarray(jcfg.delay_pattern), jnp.arange(9)
    dcur = jdcur = -1
    for pos_after in range(1, 60):
        row = rng.integers(0, 1025, 9).astype(np.int32)
        if rng.random() < 0.05:
            row[0] = 1024
        got, dcur = td._drain_step(cfg, row, pos_after, dcur, 50)
        want, jdcur = jd._drain_step(jcfg, delays, heads, jnp.asarray(row),
                                     jnp.asarray(pos_after), jnp.asarray(jdcur), 50)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert dcur == int(jdcur)


@pytest.mark.parametrize("seed", range(3))
def test_adjust_output_tokens_matches_jax(seed):
    """The delay un-weave with invalid frames dropped, on random outputs
    holding EOS and PAD, short and long."""
    rng = np.random.default_rng(seed)
    for steps in (0, 10, 15, 16, 40):
        out = rng.integers(0, 1026 if seed else 1024, (steps, 9)).astype(np.int32)
        got = td.adjust_output_tokens(out, td.DiaConfig())
        want = jd.adjust_output_tokens(out, jd.DiaConfig())
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


# ------------------------------------------------------------------ loops ---
@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_generate_matches_jax(tiny, qtype, monkeypatch):
    """runner.generate, greedy (the speculative loop in both packages):
    the same rows as the JAX runner up to the first near-tie, and every
    difference along JAX's rows a near-tie (DIA_TIE); all 39 rows on the
    dense file.  Where the rows agree, the audio equals JAX's dac_decode
    at the exact frame count within 1e-5."""
    path, r = tiny(qtype)
    rows = {}

    def recording(key, fn):
        def wrapped(out, cfg):
            rows[key] = np.asarray(out).copy()
            return fn(out, cfg)
        return wrapped

    monkeypatch.setattr(jd, "adjust_output_tokens", recording("jax", jd.adjust_output_tokens))
    monkeypatch.setattr(td, "adjust_output_tokens", recording("port", td.adjust_output_tokens))
    jr = jax_runner_from_file(path)
    jr.generate(TEXT, JaxGenerationConfig(seed=1, max_tokens=40, sample=False))
    got = r.generate(TEXT, GenerationConfig(seed=1, max_tokens=40, sample=False))
    want, port = rows["jax"], rows["port"]
    assert want.shape == port.shape == (39, 9) and got.timings["decode_steps"] == 39
    part, _ = first_part(_logits_along(r, want, 40, width=8), want, DIA_TIE)
    np.testing.assert_array_equal(port[:part], want[:part])
    if qtype == "dense":
        assert part == len(want)
    if part == len(want):
        frames = jd.adjust_output_tokens(want, jr.cfg)
        audio = np.asarray(jdac.dac_decode(jr.dac.params, jr.dac.cfg, jnp.asarray(frames),
                                           jnp.asarray(len(frames))))
        np.testing.assert_allclose(got.audio, audio, atol=1e-5, rtol=0)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("force_miss", [False, True], ids=["drafts", "force_miss"])
def test_spec_loop_matches_sequential_loop(tiny, qtype, force_miss):
    """The speculative greedy loop emits the sequential greedy loop's rows
    with its drain schedule and stop (max_tokens 48: 47 rows): exactly on
    the dense file; on Q8_0 and Q4_0 up to the first near-tie of the
    sequential path (the step's M = 2 GEMMs and the verify's M = 16 ones
    split the work differently), and exactly where nothing parts.
    force_miss emits the same rows one per 8-row forward."""
    _, r = tiny(qtype)
    cfg = r.cfg
    with torch.inference_mode():
        cross, _, state = r._encode(td.tokenize_dia_sentence(TEXT, cfg), GenerationConfig())
        seq, _, seq_state = td.dia_decode_loop(r.params, cfg, 48, cfg.max_generation_size,
                                               r._cache, cross, None, state,
                                               td.dia_init_loop_state(cfg), do_sample=False)
        out, spec_state = td.dia_decode_loop_spec_resume(
            r.params, cfg, 48, cfg.max_generation_size, r._cache, cross,
            td.dia_init_loop_state(cfg), r._out_buffer(), force_miss=force_miss)
    spec = out[:spec_state[2]]
    assert seq.shape == (47, 9) and seq_state[1] == 0
    part, _ = first_part(_logits_along(r, spec, 48), spec, DIA_TIE)
    print(f"{qtype} force_miss={force_miss}: spec and sequential rows agree on {part} of 47")
    np.testing.assert_array_equal(spec[:part], seq[:part])
    if qtype == "dense" or part == len(spec):
        np.testing.assert_array_equal(spec, seq)
        np.testing.assert_array_equal(spec_state[0], seq_state[0])
        assert spec_state[1:] == seq_state[1:] == (0, 47)
    assert (out[spec_state[2]:] == cfg.pad_token_id).all()


@pytest.mark.parametrize("lookahead", [0, 1, 3])
def test_sequential_loop_resumes_in_chunks(tiny, lookahead, monkeypatch):
    """The sequential loop run in 7-step chunks (the host loop state and the
    generator carried) emits what one call emits, sampled, whatever the
    read-behind depth."""
    _, r = tiny("dense")
    cfg = r.cfg
    monkeypatch.setattr(td, "_LOOKAHEAD", lookahead)
    kw = dict(top_k=50, do_sample=True)
    runs = []
    for chunk in (64, 7):
        gen = torch.Generator().manual_seed(5)
        with torch.inference_mode():
            cross, _, state = r._encode(td.tokenize_dia_sentence(TEXT, cfg), GenerationConfig())
            loop, rows = td.dia_init_loop_state(cfg), []
            while loop[1] != 0 and loop[2] < 64:
                new, state, loop = td.dia_decode_loop(r.params, cfg, 30, chunk, r._cache, cross,
                                                      gen, state, loop, **kw)
                rows.append(new)
        runs.append((np.concatenate(rows), loop))
    (a, la), (b, lb) = runs
    assert a.shape == (29, 9) and la[1:] == (0, 29)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la[0], lb[0])
    assert la[1:] == lb[1:]


# ----------------------------------------------------------------- runner ---
@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "greedy"])
def test_generate_stream_matches_generate(tiny, qtype, sample):
    """Chunked streaming (11-step chunks; the DAC in windows held
    RECEPTIVE_FRAMES behind the frame head) equals one generate within
    2e-5, sampled (the sequential loop, the generator carried) and greedy
    (the speculative loop, the row buffer carried)."""
    _, r = tiny(qtype)
    cfg = GenerationConfig(seed=3, max_tokens=56, sample=sample, top_k=50)
    full = r.generate(TEXT, cfg)
    chunks = list(r.generate_stream(TEXT, cfg, chunk_steps=11))
    assert len(chunks) > 1
    stream = np.concatenate(chunks)
    assert stream.shape == full.audio.shape == (512 * full.timings["frames"],)
    assert len(stream) > 0
    np.testing.assert_allclose(stream, full.audio, atol=2e-5, rtol=0)


def test_sampled_generate_is_seeded(tiny):
    """Sampled draws come from a torch.Generator: a seed repeats its audio,
    another seed changes it."""
    _, r = tiny("Q8_0")
    cfg = GenerationConfig(seed=7, max_tokens=30, top_k=50, top_p=0.9, temperature=0.8)
    a, b = r.generate(TEXT, cfg), r.generate(TEXT, cfg)
    c = r.generate(TEXT, GenerationConfig(seed=8, max_tokens=30, top_k=50))
    np.testing.assert_array_equal(a.audio, b.audio)
    assert np.isfinite(a.audio).all() and a.timings["decode_steps"] == 29
    assert not (a.audio.shape == c.audio.shape and np.array_equal(a.audio, c.audio))


def test_capture_trace_keys(tiny):
    """capture_trace fills last_trace with the JAX runner's keys; step 0's
    per-head argmax is the greedy first row."""
    _, r = tiny("Q4_0")
    r.capture_trace = True
    try:
        resp = r.generate(TEXT, GenerationConfig(max_tokens=24, sample=False))
    finally:
        r.capture_trace = False
    t = r.last_trace
    assert set(t) == {"prompt_ids", "n_prompt_tokens", "step0_logits", "n_steps",
                      "eos_step_head0", "tokens_first_steps", "n_frames", "codes_first_frames"}
    assert t["n_steps"] == resp.timings["decode_steps"] == 23
    assert t["n_frames"] == resp.timings["frames"] == 8
    assert t["step0_logits"]["per_head_argmax"] == t["tokens_first_steps"][0]
    assert t["n_prompt_tokens"] == len(td.tokenize_dia_sentence(TEXT, r.cfg))


def test_max_tokens_guard(tiny):
    """max_tokens must exceed the 15-step delay window, in generate and in
    generate_stream; 16 gives one row's drain and no frame."""
    _, r = tiny("Q8_0")
    for n in (1, 15):
        with pytest.raises(TTSError):
            r.generate(TEXT, GenerationConfig(max_tokens=n))
        with pytest.raises(TTSError):
            list(r.generate_stream(TEXT, GenerationConfig(max_tokens=n)))
    resp = r.generate(TEXT, GenerationConfig(max_tokens=16, seed=0))
    assert resp.timings["decode_steps"] == 15 and len(resp.audio) == 0


def test_runner_entry_points(tiny):
    """runner_from_file returns a DiaRunner on the CPU when asked; 'cuda'
    without a card raises (no CPU fallback); an over-long prompt raises."""
    path, r = tiny("Q4_0")
    assert isinstance(r, td.DiaRunner) and r.architecture == "dia"
    assert r.device == torch.device("cpu") and r.sample_rate == 44100
    assert td.DiaRunner(r.cfg, r.params, r.dac).device == torch.device("cpu")
    assert "wq4" in r.params["decoder"]["layers"][0]["gate"]
    with pytest.raises(TTSError):
        r.generate("a" * 1100, GenerationConfig(max_tokens=20))
    if not torch.cuda.is_available():
        with pytest.raises(TTSError):
            runner_from_file(path)
