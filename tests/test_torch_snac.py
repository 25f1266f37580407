"""The port's SNAC decoder and its ops (snake, conv1d, conv_transpose1d)
against the JAX package's, on build_snac_tensors' tiny SNAC, with the JAX
package's position-keyed noise injected into the port."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tts_tpu.codecs import snac as jsnac  # noqa: E402
from tts_tpu.convert.builder_codecs import build_snac_tensors  # noqa: E402
from tts_tpu.ops import basic as jbasic  # noqa: E402
from tts_tpu.ops import conv as jconv  # noqa: E402
from tts_tpu_torch.codecs import snac as tsnac  # noqa: E402
from tts_tpu_torch.ops import basic as tbasic  # noqa: E402
from tts_tpu_torch.ops import conv as tconv  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tensors():
    return build_snac_tensors(np.random.default_rng(0))


def _heads(t, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4096, t // rep).astype(np.int32) for rep in (4, 2, 1)]


def _jax_noise(cfg, seed, t, start_frame=0):
    """The JAX decoder's per-layer noise for a t-frame decode."""
    out, rate, length = [], 1, t
    for i, s in enumerate(cfg.strides):
        rate, length = rate * s, length * s
        n = jsnac._position_noise(jax.random.PRNGKey(seed), i, start_frame * rate, length)
        out.append(torch.from_numpy(np.array(n)))
    return out


def test_snake_matches_jax(rng):
    x = (rng.standard_normal((50, 16)) * 20).astype(np.float32)
    alpha = (rng.random(16) + 0.2).astype(np.float32)
    want = np.asarray(jbasic.snake(jnp.asarray(x), jnp.asarray(alpha)))
    got = tbasic.snake(torch.from_numpy(x), torch.from_numpy(alpha)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("groups,dilation,stride", [(1, 1, 1), (1, 3, 1), (8, 1, 1), (1, 1, 2)])
def test_conv1d_matches_jax(rng, groups, dilation, stride):
    x = rng.standard_normal((40, 8)).astype(np.float32)
    w = rng.standard_normal((8, 8 // groups, 7)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    kw = dict(stride=stride, padding=3 * dilation, dilation=dilation, groups=groups)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_conv_transpose1d_matches_jax(rng):
    x = rng.standard_normal((12, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4, 16)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                             stride=8, padding=4))
    got = tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 stride=8, padding=4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_snac_loader_matches_params_from_jax(tensors):
    """The port's loader gives exactly the tensors params_from_jax carries."""
    tens, kv = tensors
    cfg = jsnac.SNACConfig.from_gguf_kv(kv)
    from_jax = tsnac.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsnac.load_snac_params(tens, cfg)), "cpu")
    own = tsnac.load_snac_params(tens, tsnac.SNACConfig.from_gguf_kv(kv), "cpu")
    flat_a, flat_b = [], []
    for tree, flat in ((from_jax, flat_a), (own, flat_b)):
        stack = [tree]
        while stack:
            v = stack.pop()
            if isinstance(v, dict):
                stack.extend(v[k] for k in sorted(v))
            elif isinstance(v, list):
                stack.extend(v)
            else:
                flat.append(v)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("t", [64, 128])
def test_snac_decode_matches_jax(tensors, t):
    """t is one of the JAX decoder's frame buckets, so it runs unpadded like
    the port.  Same f32 weights and noise; the convolutions sum in another
    order (JAX: shifted matmuls; torch: its conv kernels): atol 1e-4 on
    audio in [-1, 1]."""
    tens, kv = tensors
    jdec = jsnac.SNACDecoder.from_tensors(tens, kv)
    tdec = tsnac.SNACDecoder.from_tensors(tens, kv, device="cpu")
    heads = _heads(t, t)
    want = jdec.decode(heads, seed=5)
    got = tdec.decode(heads, seed=5, noise=_jax_noise(jdec.cfg, 5, t))
    assert got.shape == want.shape == (t * 512,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_position_noise_is_window_invariant():
    """The value at absolute position p depends only on (seed, layer, p), and
    the values are standard normal."""
    full = tsnac.position_noise(7, 2, 0, 100_000, "cpu")
    torch.testing.assert_close(tsnac.position_noise(7, 2, 4096, 1000, "cpu"), full[4096:5096],
                               rtol=0, atol=0)
    assert not torch.equal(tsnac.position_noise(7, 3, 0, 1000, "cpu"), full[:1000])
    assert abs(full.mean().item()) < 0.02 and abs(full.std().item() - 1) < 0.02
