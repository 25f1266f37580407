"""The port's Kokoro-82M (tts_tpu_torch.models.kokoro and kokoro_runner, and
the ops under them) against the JAX package's, on KokoroDims.tiny() GGUFs
written by the JAX package's builder.

Both packages load the same file; JAX params also reach the port through
params_from_jax.  Model comparisons run in f32 (compute_dtype="float32").
JAX pads to buckets with masks that make padding invisible; the port runs
exact shapes, so the JAX side here gets all-ones masks at the exact shapes.
The JAX source noise (jax.random) is injected into the port.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tts_tpu.convert.builder_kokoro import KokoroDims, write_kokoro_gguf  # noqa: E402
from tts_tpu.models import kokoro as jk  # noqa: E402
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu_torch.models import kokoro as tk  # noqa: E402
from tts_tpu_torch.models.kokoro_runner import KokoroRunner  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.ops import basic as tbasic  # noqa: E402
from tts_tpu_torch.ops import conv as tconv  # noqa: E402
from tts_tpu_torch.ops import lstm as tlstm  # noqa: E402
from tts_tpu_torch.ops import resample as tresample  # noqa: E402
from tts_tpu_torch.ops import stft as tstft  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402

# tts_tpu.ops re-exports functions under its modules' names (stft, ...)
jbasic, jconv, jlstm, jresample, jstft = (
    importlib.import_module(f"tts_tpu.ops.{m}")
    for m in ("basic", "conv", "lstm", "resample", "stft"))

torch.set_num_threads(1)

# Harvard sentences, list 1 (bench.py's battery)
HARVARD = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
]
# tests/test_phonemizer.py's inputs
PHONEMIZER_INPUTS = [
    "hello world", "hello, world!", "zyzzyva", "the cat 42", "3.14", "32,000", "the HTML",
    "U.S.", "HELLO WORLD", "chapter XIV", "dog's", "they're", "cat + dog", "twenty-one",
    "café", "dr. who", "", "   ",
]
TIE = 1e-4           # a duration sum this close to x.5 may round either way


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX model, port model), both f32, loaded from one tiny GGUF."""
    path = tmp_path_factory.mktemp("kokoro") / "tiny.gguf"
    write_kokoro_gguf(path, KokoroDims.tiny(), seed=0)
    jm = jax_runner_from_file(str(path)).model
    jm.cfg = dataclasses.replace(jm.cfg, compute_dtype="float32")
    tm = runner_from_file(str(path), device="cpu").model
    tm.cfg = dataclasses.replace(tm.cfg, compute_dtype="float32")
    return jm, tm


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(JAX runner, port runner) on a tiny GGUF with the bench's duration
    bias (~3.5 frames per token), each at its package's default dtype."""
    path = tmp_path_factory.mktemp("kokoro") / "tiny_bias.gguf"
    write_kokoro_gguf(path, KokoroDims.tiny(), seed=0, duration_bias=-2.6)
    return jax_runner_from_file(str(path)), runner_from_file(str(path), device="cpu")


def _tokens(jm, seed, n):
    rng = np.random.default_rng(seed)
    return np.array([0] + list(rng.integers(1, jm.cfg.vocab_size, n)) + [0], np.int32)


# ------------------------------------------------------------------- ops ---

@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_matches_jax(eps):
    x = np.random.default_rng(0).standard_normal((9, 24)).astype(np.float32) * 3 + 1
    _close(tbasic.layer_norm(_t(x), eps=eps), jbasic.layer_norm(jnp.asarray(x), eps=eps),
           rtol=1e-5, atol=1e-5)


def test_ada_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x, g, b = (rng.standard_normal(s).astype(np.float32) for s in ((9, 24), 24, 24))
    _close(tbasic.ada_layer_norm(_t(x), _t(g), _t(b)),
           jbasic.ada_layer_norm(*map(jnp.asarray, (x, g, b))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_time_matches_jax(dtype):
    """Statistics in f32 either way; a bf16 result may differ by one bf16
    rounding (2^-8 relative) where the f32 values straddle a boundary."""
    x = np.random.default_rng(2).standard_normal((40, 12)).astype(np.float32) * 2 + 0.5
    got = tbasic.instance_norm_time(_t(x).to(getattr(torch, dtype)))
    want = jbasic.instance_norm_time(jnp.asarray(x).astype(dtype))
    assert str(got.dtype)[6:] == str(want.dtype) == dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    _close(got.float(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_ada_instance_norm_matches_jax():
    rng = np.random.default_rng(3)
    x, g, b = (rng.standard_normal(s).astype(np.float32) for s in ((40, 12), 12, 12))
    _close(tbasic.ada_instance_norm(_t(x), _t(g), _t(b)),
           jbasic.ada_instance_norm(*map(jnp.asarray, (x, g, b))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slope", [0.01, 0.1, 0.2])
def test_leaky_relu_matches_jax(slope):
    x = np.random.default_rng(4).standard_normal((30, 5)).astype(np.float32)
    x[0, 0] = 0.0
    np.testing.assert_array_equal(_np(tbasic.leaky_relu(_t(x), slope)),
                                  np.asarray(jbasic.leaky_relu(jnp.asarray(x), slope)))


@pytest.mark.parametrize("n", [1, 3])
def test_reflect_pad_front_matches_jax(n):
    x = np.random.default_rng(5).standard_normal((8, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tconv.reflect_pad_front(_t(x), n)),
                                  np.asarray(jconv.reflect_pad_front(jnp.asarray(x), n)))


@pytest.mark.parametrize("factor", [2, 300])
def test_upsample_matches_jax(factor):
    """Linear upsampling at its clipped edges (the first and last half
    factor of outputs) and in between; nearest is a plain repeat."""
    x = np.random.default_rng(6).standard_normal((7, 3)).astype(np.float32)
    got = _np(tresample.upsample_linear(_t(x), factor))
    want = np.asarray(jresample.upsample_linear(jnp.asarray(x), factor))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[: factor // 2], np.broadcast_to(x[0], got[: factor // 2].shape))
    np.testing.assert_allclose(got[-(factor // 2):], np.broadcast_to(x[-1], got[: factor // 2].shape))
    np.testing.assert_array_equal(_np(tresample.upsample_nearest(_t(x), factor, axis=1)),
                                  np.asarray(jresample.upsample_nearest(jnp.asarray(x), factor,
                                                                        axis=1)))


def _lstm_tensors(rng, c, h):
    return {f"p.0.{rev}{kind}.{i}": (rng.standard_normal(
                (h, c if i % 2 == 0 else h) if kind == "weights" else h) * 0.3).astype(np.float32)
            for rev in ("", "reverse_") for kind in ("weights", "biases") for i in range(8)}


def test_bilstm_matches_jax():
    """Forward and backward halves separately; the port's packed layout is
    the transpose of the JAX package's, with the summed bias in b_ih."""
    rng = np.random.default_rng(7)
    T, C, H = 13, 10, 6
    tens = _lstm_tensors(rng, C, H)
    x = rng.standard_normal((T, C)).astype(np.float32)
    jt = {k: jnp.asarray(v) for k, v in tens.items()}
    jf, jb = jlstm.pack_lstm_params(jt, "p.0"), jlstm.pack_lstm_params(jt, "p.0", reverse=True)
    tf, tb = tlstm.pack_lstm_params(tens, "p.0"), tlstm.pack_lstm_params(tens, "p.0", reverse=True)
    for j, t in ((jf, tf), (jb, tb)):
        np.testing.assert_array_equal(_np(t["w_ih"]), np.asarray(j["w_ih"]).T)
        np.testing.assert_array_equal(_np(t["w_hh"]), np.asarray(j["w_hh"]).T)
        np.testing.assert_array_equal(_np(t["b_ih"]), np.asarray(j["b"]))
        assert not t["b_hh"].any()
    got, want = _np(tlstm.bilstm(_t(x), tf, tb)), np.asarray(jlstm.bilstm(jnp.asarray(x), jf, jb))
    assert got.shape == want.shape == (T, 2 * H)
    np.testing.assert_allclose(got[:, :H], want[:, :H], rtol=1e-5, atol=1e-6, err_msg="forward")
    np.testing.assert_allclose(got[:, H:], want[:, H:], rtol=1e-5, atol=1e-6, err_msg="backward")


def test_stft_matches_jax():
    """Magnitude strictly; phase modulo 2 pi (atan2's +/-pi branch at
    im ~ +/-0 flips between any two float implementations)."""
    x = np.random.default_rng(8).standard_normal(6000).astype(np.float32) * 0.1
    w = jstft.hann_window(20)
    np.testing.assert_array_equal(tstft.hann_window(20), w)
    mj, pj = jstft.stft(jnp.asarray(x), jnp.asarray(w), 20, 5)
    mt, pt = tstft.stft(_t(x), _t(w), 20, 5)
    assert mt.shape == mj.shape == (6000 // 5 + 1, 11)
    _close(mt, mj, rtol=2e-4, atol=2e-5, what="stft magnitude")
    wrapped = np.abs((_np(pt) - np.asarray(pj) + np.pi) % (2 * np.pi) - np.pi)
    assert wrapped.max() < 1e-3, f"stft phase (wrapped) max diff {wrapped.max()}"


def test_istft_and_window_sums_match_jax():
    """The iSTFT of one spectrum, normalised by the device window^2 sum;
    that sum against JAX's and against the numpy one."""
    rng = np.random.default_rng(9)
    F, bins = 301, 11
    mag = np.exp(rng.standard_normal((F, bins)).astype(np.float32) * 0.3)
    ph = rng.uniform(-np.pi, np.pi, (F, bins)).astype(np.float32)
    w = jstft.hann_window(20)
    wss = jstft.window_squared_sum(w, 20, 5, F)
    np.testing.assert_array_equal(tstft.window_squared_sum(w, 20, 5, F), wss)
    np.testing.assert_array_equal(tstft.window_squared_sum(w, 20, 5, F, out_len=1600),
                                  jstft.window_squared_sum(w, 20, 5, F, out_len=1600))
    S = (F - 1) * 5
    dev_t = tk._device_window_sq_sum(_t(w), 20, 5, S, S // 5)
    dev_j = jk._device_window_sq_sum(jnp.asarray(w), 20, 5, S, S // 5)
    _close(dev_t, dev_j, rtol=1e-6, atol=0)      # sums of n_fft/hop taps, any order
    _close(dev_t, wss, rtol=1e-6, atol=1e-6)
    got = tstft.istft(_t(mag), _t(ph), _t(w), dev_t, 20, 5)
    want = jstft.istft(*map(jnp.asarray, (mag, ph, w, dev_j)), 20, 5)
    assert got.shape == want.shape == (S,)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_sine_source_matches_jax(model):
    """The harmonic source on an F0 curve with voiced, unvoiced and negative
    frames, JAX's noise injected.  The phase is a cumulative sum over 2F
    frames scaled by 300 * 2 pi; the two packages sum in different orders,
    so it differs by a few f32 steps of its magnitude: |phase| <= 1885 *
    2F, here 1885 * 24 ~ 4.5e4, an f32 step there ~ 4e-3, times sin_amp
    0.1 -> the 2e-3 bound (several steps)."""
    jm, tm = model
    rng = np.random.default_rng(10)
    F2 = 24
    f0 = rng.uniform(-150, 300, F2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jk._sine_source(jm.cfg, jnp.asarray(f0), jnp.ones(F2), key)
    noise = jax.random.normal(key, want.shape, jnp.float32)
    got = tk._sine_source(tm.cfg, _t(f0), _t(noise))
    assert got.shape == want.shape == (F2 * 300, 9)
    _close(got, want, rtol=0, atol=2e-3)
    voiced = np.repeat(f0 > 10, 300)
    assert voiced.any() and not voiced.all()
    _close(_np(got)[~voiced], np.asarray(want)[~voiced], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- model ---

def test_loader_matches_params_from_jax(model):
    """The port's GGUF loader gives exactly the tensors params_from_jax
    makes of the JAX package's params."""
    jm, tm = model
    want = tk.params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    flat_t, tree_t = jax.tree_util.tree_flatten(tm.params)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_t == tree_w
    for a, b in zip(flat_t, flat_w):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("seed,n", [(11, 12), (12, 40)])
def test_durations_match_jax(model, seed, n):
    """Pre-round sums and hidden states closely, rounded durations exactly
    except where a sum lies within TIE of x.5."""
    jm, tm = model
    tokens = _tokens(jm, seed, n)
    T = len(tokens)
    _, style_j = jm.voice_style("af_heart", T)
    sums_j, hidden_j = jk.duration_raw(jm.params, jm.cfg, jnp.asarray(tokens), jnp.ones(T),
                                       style_j)
    dur_j, _ = jk.duration_forward(jm.params, jm.cfg, jnp.asarray(tokens), jnp.ones(T), style_j)
    _, style_t = tm.voice_style("af_heart", T)
    sums_t, hidden_t = tk.duration_raw(tm.params, tm.cfg, _t(tokens).long(), style_t)
    dur_t, _ = tk.duration_forward(tm.params, tm.cfg, _t(tokens).long(), style_t)
    _close(sums_t, sums_j, rtol=1e-5, atol=1e-4, what="duration sums")
    _close(hidden_t, hidden_j, rtol=1e-4, atol=1e-5, what="duration hidden")
    sums_j = np.asarray(sums_j)
    keep = np.abs(sums_j - np.floor(sums_j) - 0.5) > TIE
    np.testing.assert_array_equal(_np(dur_t)[keep], np.asarray(dur_j)[keep])
    assert (_np(dur_t) >= 1).all() and (_np(dur_t) <= 50).all()


def _jax_decode(params, cfg, F, tokens, durations, hidden, style_gen, style_pros):
    """JAX's _generation_body up to the decoder output, at exact shapes
    (all-ones masks), written out as tests/test_parity_numpy.py does."""
    dp, dec = params["dp"], params["decoder"]
    T = tokens.shape[0]
    ones_f, ones_t = jnp.ones(F), jnp.ones(T)
    ends = jnp.cumsum(durations)
    fidx = jnp.arange(F, dtype=jnp.float32)[:, None]
    align = ((fidx >= (ends - durations)[None, :]) & (fidx < ends[None, :])).astype(jnp.float32)
    x = jlstm.bilstm(align @ hidden, dp["shared_lstm"]["fwd"], dp["shared_lstm"]["bwd"],
                     mask=ones_f)
    curves = []
    for blocks, proj in (("f0_blocks", "f0_proj"), ("n_blocks", "n_proj")):
        y, m = x, ones_f
        for blk in dp[blocks]:
            y, m = jk._ada_res_block(y, blk, style_pros, mask=m)
        curves.append(y @ dp[f"{proj}_w"] + dp[f"{proj}_b"])
    te = params["text_encoder"]
    t = te["embd"][tokens]
    for conv in te["convs"]:
        t = jconv.conv1d(t, conv["w"], conv["b"], padding=2)
        t = jbasic.leaky_relu(jbasic.layer_norm(t, eps=1e-5) * conv["gamma"] + conv["beta"], 0.2)
    t = jlstm.bilstm(t, te["lstm"]["fwd"], te["lstm"]["bwd"], mask=ones_t)
    asr = align @ t
    f0d, nd = (jconv.conv1d(c[:, None], dec[f"{k}_conv_w"], dec[f"{k}_conv_b"], stride=2,
                            padding=1) for c, k in zip(curves, ("f0", "n")))
    cur, m = jk._ada_res_block(jnp.concatenate([asr, f0d, nd], -1), dec["encoder_block"],
                               style_gen, mask=ones_f)
    asr_res = asr @ dec["asr_w"] + dec["asr_b"]
    for blk in dec["blocks"]:
        cur, m = jk._ada_res_block(jnp.concatenate([cur, asr_res, f0d, nd], -1), blk,
                                   style_gen, mask=m)
    return curves[0], curves[1], cur


def test_generation_prefix_matches_jax(model):
    """Alignment (durations 1..6, not the model's near-constant ones), the
    F0/N branches, the text encoder and the decoder blocks; then the
    harmonic spectrum each package makes of its own F0 curve with JAX's
    noise: magnitude strictly, phase modulo 2 pi."""
    jm, tm = model
    rng = np.random.default_rng(13)
    tokens = _tokens(jm, 13, 10)
    T = len(tokens)
    dur = rng.integers(1, 7, T).astype(np.float32)
    F = int(dur.sum())
    hidden = rng.standard_normal((T, tm.cfg.duration_hidden_size + tm.cfg.style_half_size)
                                 ).astype(np.float32) * 0.3
    sg_j, sp_j = jm.voice_style("af_heart", T)
    f0_j, n_j, cur_j = jax.jit(_jax_decode, static_argnums=(1, 2))(
        jm.params, jm.cfg, F, jnp.asarray(tokens), jnp.asarray(dur), jnp.asarray(hidden),
        sg_j, sp_j)
    sg_t, sp_t = tm.voice_style("af_heart", T)
    f0_t, n_t, cur_t = tk.decode(tm.params, tm.cfg, _t(tokens).long(), _t(dur), _t(hidden),
                                 sg_t, sp_t, F)
    assert cur_t.shape == cur_j.shape == (2 * F, KokoroDims.tiny().gen_ch)
    _close(f0_t, f0_j, rtol=2e-4, atol=2e-5, what="f0 curve")
    _close(n_t, n_j, rtol=2e-4, atol=2e-5, what="n curve")
    # a deep chain of instance norms, as in tests/test_parity_numpy.py
    _close(cur_t, cur_j, rtol=1e-3, atol=5e-4, what="decoder blocks")

    key = jax.random.PRNGKey(5)
    gen_j, gen_t = jm.params["decoder"]["generator"], tm.params["decoder"]["generator"]
    src_j = jk._sine_source(jm.cfg, f0_j, jnp.ones(2 * F), key)
    noise = _t(jax.random.normal(key, src_j.shape, jnp.float32))
    har_j = jnp.tanh(src_j @ gen_j["m_source_w"] + gen_j["m_source_b"])[:, 0]
    har_t = torch.tanh(tk._sine_source(tm.cfg, f0_t, noise) @ gen_t["m_source_w"]
                       + gen_t["m_source_b"])[:, 0]
    mag_j, ph_j = jstft.stft(har_j, jm.window, 20, 5)
    mag_t, ph_t = tstft.stft(har_t, tm.window, 20, 5)
    _close(mag_t, mag_j, rtol=2e-4, atol=2e-5, what="har_spec magnitude")
    wrapped = np.abs((_np(ph_t) - np.asarray(ph_j) + np.pi) % (2 * np.pi) - np.pi)
    assert wrapped.max() < 1e-3, f"har_spec phase (wrapped) max diff {wrapped.max()}"


def test_generator_tail_matches_jax(model):
    """Upsamples, noise blocks, residual blocks, output conv and iSTFT on
    one shared spectrum and decoder output (tests/test_parity_numpy.py's
    bounds)."""
    jm, tm = model
    rng = np.random.default_rng(14)
    F = 24
    S = F * 600
    cur = (rng.standard_normal((2 * F, KokoroDims.tiny().gen_ch)) * 0.1).astype(np.float32)
    har_spec = (rng.standard_normal((S // 5 + 1, 22)) * 0.3).astype(np.float32)
    style = (rng.standard_normal(tm.cfg.style_half_size) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jk.generator_tail, static_argnames=("cfg", "S"))(
        jm.params["decoder"]["generator"], jm.cfg, jnp.asarray(cur), jnp.ones(2 * F),
        jnp.asarray(har_spec), jnp.asarray(style), jnp.asarray(float(F)), jm.window, S))
    got = _np(tk.generator_tail(tm.params["decoder"]["generator"], tm.cfg, _t(cur),
                                _t(har_spec), _t(style), tm.window, S))
    assert got.shape == want.shape == (S,)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=0)
    assert np.corrcoef(got, want)[0, 1] > 0.99999


def test_synthesize_matches_jax_fused_forward(model):
    """End to end: the port's synthesize against JAX's kokoro_fused_forward
    at F = total exactly (so JAX draws its noise at the same shape), with
    that noise and JAX's durations injected.  JAX returns int16 against its
    peak: the bound is 1e-3 of the peak plus one int16 step."""
    jm, tm = model
    tokens = _tokens(jm, 15, 12)
    T = len(tokens)
    sg, sp = jm.voice_style("af_heart", T)
    dur_j, _ = jk.duration_forward(jm.params, jm.cfg, jnp.asarray(tokens), jnp.ones(T), sp)
    F = int(np.asarray(dur_j).sum())
    key = jax.random.PRNGKey(6)
    packed = np.asarray(jk.kokoro_fused_forward(jm.params, jm.cfg, F, jnp.asarray(tokens),
                                                jnp.ones(T), sg, sp, key, jm.window))
    assert int(packed[-4:-2].copy().view(np.int32)[0]) == F
    peak = float(packed[-2:].copy().view(np.float32)[0])
    want = packed[:-4].astype(np.float32) * (peak / 32767.0)
    noise = _t(jax.random.normal(key, (F * 600, 9), jnp.float32))
    got = tm.synthesize(tokens.tolist(), "af_heart", noise=noise, durations=np.asarray(dur_j))
    assert got.dtype == np.float32 and got.shape == want.shape == (F * 600,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * peak + peak / 32767)
    # with its own durations the port lands on the same frame count, and
    # its seeded noise is reproducible
    own = tm.synthesize(tokens.tolist(), "af_heart", seed=3)
    assert own.shape == want.shape
    np.testing.assert_array_equal(own, tm.synthesize(tokens.tolist(), "af_heart", seed=3))


# ---------------------------------------------------------------- runner ---

def _jax_chunks(jr, text, stream=False):
    """The token chunks JAX's runner synthesizes for `text`, and its audio
    length for each (the JAX model's durations at the chunk's bucket),
    recorded by a stand-in for JAX's synthesize; returns (chunks, lengths,
    what generate or generate_stream returned)."""
    chunks, lengths = [], []
    model = jr.model

    def record(token_ids, voice, seed=0):
        _, _, dur, _ = model.predict_durations(token_ids, voice)
        chunks.append(list(token_ids))
        lengths.append(int(np.asarray(dur).sum()) * 600)
        return np.zeros(lengths[-1], np.float32)

    model.synthesize = record
    try:
        cfg = JaxGenerationConfig(voice="af_heart")
        out = list(jr.generate_stream(text, cfg)) if stream else jr.generate(text, cfg)
    finally:
        del model.synthesize
    return chunks, lengths, out


@pytest.mark.parametrize("text", HARVARD + PHONEMIZER_INPUTS + [" ".join(HARVARD * 2)])
def test_runner_phonemes_and_chunks_match_jax(runners, text):
    """The port's phoneme string and token chunks equal JAX's (the joined
    battery, ~1200 phonemes, takes tokenize_chunks' path)."""
    jr, tr = runners
    assert tr.phonemizer.text_to_phonemes(text) == jr.phonemizer.text_to_phonemes(text)
    chunks = []
    tr.model.synthesize = lambda token_ids, voice, seed=0: chunks.append(list(token_ids)) or \
        np.zeros(0, np.float32)
    try:
        tr.generate(text, GenerationConfig(voice="af_heart"))
    finally:
        del tr.model.synthesize
    assert chunks == _jax_chunks(jr, text)[0]


@pytest.mark.parametrize("text", [HARVARD[0], HARVARD[8], "hello, world! " * 60])
def test_runner_generate_length_matches_jax(runners, text):
    """generate's audio: JAX's length (its chunks, its durations), finite."""
    jr, tr = runners
    _, lengths, jresp = _jax_chunks(jr, text)
    resp = tr.generate(text, GenerationConfig(voice="af_heart", seed=1))
    assert resp.sample_rate == jresp.sample_rate == 24000
    assert resp.audio.dtype == np.float32 and len(resp.audio) == sum(lengths) > 0
    assert np.isfinite(resp.audio).all() and np.abs(resp.audio).max() > 0
    assert resp.timings["chunks"] == len(lengths)


def test_runner_chunks_a_short_input_that_tokenizes_past_the_context(runners):
    """"hɛlo wɝld! " * 45 is 495 phonemes, under the 510 that send an input
    to tokenize_chunks, but the tiny vocabulary lacks 'ɛ' and 'ɝ', and an
    unknown phoneme becomes one id per byte: 541 ids, past the 512-token
    context.  The JAX runner fails on it; the port chunks it as it chunks
    a long input."""
    jr, tr = runners
    text = "hello, world! " * 45
    with pytest.raises(ValueError):
        jr.generate(text, JaxGenerationConfig(voice="af_heart"))
    phonemes = tr.phonemizer.text_to_phonemes(text.replace(",", "--"))
    assert len(phonemes) < 510
    want = tr.tokenize_chunks(phonemes.split("!"))
    chunks = []
    tr.model.synthesize = lambda token_ids, voice, seed=0: chunks.append(list(token_ids)) or \
        np.zeros(600, np.float32)
    try:
        resp = tr.generate(text, GenerationConfig(voice="af_heart"))
    finally:
        del tr.model.synthesize
    assert chunks == want and len(chunks) == 45 and len(resp.audio) == 45 * 600


def test_runner_generate_stream_matches_jax_chunking(runners):
    jr, tr = runners
    text = "hello. world, this is a longer second clause to split! and a third"
    _, lengths, jchunks = _jax_chunks(jr, text, stream=True)
    got = list(tr.generate_stream(text, GenerationConfig(voice="af_heart")))
    assert [len(c) for c in got] == [len(c) for c in jchunks] == lengths
    assert len(got) >= 3 and all(np.isfinite(c).all() for c in got)


def test_runner_from_file_gives_kokoro_runner(runners):
    _, tr = runners
    assert isinstance(tr, KokoroRunner) and tr.model.device.type == "cpu"
    assert tr.list_voices() == ["af_heart"] and tr.model.cfg.compute_dtype == "bfloat16"
    assert tr.model.params["dp"]["shared_lstm"]["fwd"]["w_ih"].device.type == "cpu"
    with pytest.raises(TTSError, match="unknown Kokoro voice"):
        tr.generate("hi", GenerationConfig(voice="nope"))
    assert len(tr.generate("...", GenerationConfig(voice="af_heart")).audio) == 0


def test_runner_from_file_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No CPU fallback: asking for the card where there is none is an error."""
    path = write_kokoro_gguf(tmp_path / "k.gguf", KokoroDims.tiny(), seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TTSError, match="no CUDA device"):
        runner_from_file(str(path), device="cuda")
