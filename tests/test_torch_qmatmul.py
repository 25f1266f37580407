"""The port's quantized matmul (tts_tpu_torch.ops.qmatmul) against the JAX
package's Pallas kernels (interpret mode on the CPU).  The Hopper kernels
are held to their plain versions in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from tts_tpu.core import quant  # noqa: E402
from tts_tpu.core.gguf import GGMLType, GGUFFile, GGUFWriter  # noqa: E402
from tts_tpu.ops import qmatmul as jq  # noqa: E402
from tts_tpu_torch.ops import qmatmul as tq  # noqa: E402

torch.set_num_threads(1)


def make_q8(rng, K, N):
    """Q8_0 round trip of a random [N, K] (out, in) weight -> int8 [K, N],
    f32 scales [K/32, N]."""
    w = rng.standard_normal((N, K)).astype(np.float32)
    raw = np.frombuffer(quant.quantize_q8_0(w), np.uint8)
    values, scales = quant.q8_0_to_int8_scales(raw, w.size)
    return (np.ascontiguousarray(values.reshape(N, K).T),
            np.ascontiguousarray(scales.reshape(N, K // 32).T))


@pytest.mark.parametrize("N", [1024, 1280])
@pytest.mark.parametrize("K", [512, 1024])
@pytest.mark.parametrize("M", [1, 2, 8, 32])
def test_quantized_matmul_matches_jax(M, K, N):
    """M > 1: the f32 whole-K path, atol = rtol = 1e-4 (as the JAX package's
    own Q8 test).  M == 1: both sides round x to bf16 and sum exact bf16 x
    int8 products in f32, so only the summation order differs: rtol 1e-5."""
    rng = np.random.default_rng(M * 10007 + K + N)
    wq, sc = make_q8(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), jnp.asarray(wq),
                                          jnp.asarray(sc.astype(np.float16).view(np.uint16))))
    got = tq.quantized_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                              torch.from_numpy(sc.astype(np.float16))).numpy()
    if M == 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        # without the bf16 rounding of x the port would miss by far more
        exact = x @ (wq.astype(np.float32) * np.repeat(sc, 32, axis=0))
        assert np.abs(exact - want).max() > 10 * np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vector_input_and_dense_linear(rng):
    wq, sc = make_q8(rng, 64, 256)
    p = {"wq": torch.from_numpy(wq), "scales": torch.from_numpy(sc.astype(np.float16))}
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    assert tq.quantized_matmul(x, p["wq"], p["scales"]).shape == (256,)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    torch.testing.assert_close(tq.linear(x[None], {"w": w}), x[None] @ w)


@pytest.mark.parametrize("qtype", ["Q8_0", "Q5_0", "Q4_0"])
@pytest.mark.parametrize("pad_n", [False, True])
def test_pack_q8_weight_matches_jax(tmp_path, rng, qtype, pad_n):
    """Identical int8 values; the f16 scales are bit-equal to the JAX
    package's uint16 scale bits; the lm_head padding rule (pad_n) agrees."""
    w = GGUFWriter(tmp_path / "w.gguf")
    w.add_tensor("w", rng.standard_normal((300, 128)).astype(np.float32),
                 getattr(GGMLType, qtype))
    w.write()
    with GGUFFile(tmp_path / "w.gguf") as f:
        t = f.tensors["w"]
        want = jq.pack_q8_weight(t, pad_n=pad_n, tile_n=256)
        got = tq.pack_q8_weight(t, pad_n=pad_n, tile_n=256)
        np.testing.assert_array_equal(got["wq"], np.asarray(want["wq"]))
        assert got["scales"].dtype == np.float16
        np.testing.assert_array_equal(got["scales"].view(np.uint16), np.asarray(want["scales"]))
        assert got["wq"].shape == ((128, 512) if pad_n else (128, 300))


def test_cpu_wrappers_launch_nothing(rng):
    """On CPU tensors the wrappers run the plain versions and count no launch."""
    wq, sc = make_q8(rng, 64, 256)
    before = (tq.qgemv_int8.launches, tq.qgemm_int8.launches)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    args = (torch.from_numpy(wq), torch.from_numpy(sc.astype(np.float16)))
    torch.testing.assert_close(tq.qgemv_int8(x[:1], *args), tq.qgemv_int8_plain(x[:1], *args))
    torch.testing.assert_close(tq.qgemm_int8(x, *args), tq.qgemm_int8_plain(x, *args))
    assert (tq.qgemv_int8.launches, tq.qgemm_int8.launches) == before
