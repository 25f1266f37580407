"""The port's quantized matmul (tts_tpu_torch.ops.qmatmul), int8 and packed
int4, against the JAX package's Pallas kernels (interpret mode on the CPU).
The Hopper kernels are held to their plain versions in test_torch_kernels.py."""

import contextlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax.numpy as jnp  # noqa: E402

from tts_tpu.core import quant  # noqa: E402
from tts_tpu.core.gguf import GGMLType, GGUFWriter  # noqa: E402
from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile  # noqa: E402
from tts_tpu.ops import qmatmul as jq  # noqa: E402
from tts_tpu_torch.core.gguf import GGUFFile  # noqa: E402
from tts_tpu_torch.ops import _ext  # noqa: E402
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


def make_q4(rng, K, N, n_pad=0):
    """Q4_0 round trip of a random [N, K] (out, in) weight -> packed int4
    [K/2, N + n_pad] (the JAX package's packing), f32 scales [K/32, N + n_pad];
    the n_pad extra columns are zero, as a tile-padded lm_head's are."""
    w = rng.standard_normal((N, K)).astype(np.float32)
    raw = np.frombuffer(quant.quantize_q4_0(w), np.uint8)
    values, scales = quant.q4_0_to_int8_scales(raw, w.size)
    wq4 = jq.pack_q4_nibbles(np.ascontiguousarray(values.reshape(N, K).T))
    sc = np.ascontiguousarray(scales.reshape(N, K // 32).T)
    pad = [(0, 0), (0, n_pad)]
    return np.pad(wq4, pad), np.pad(sc, pad)


@contextlib.contextmanager
def _tensor(path, name):
    """The same GGUF tensor as each package's reader sees it."""
    with JaxGGUFFile(path) as jf, GGUFFile(path) as f:
        yield jf.tensors[name], f.tensors[name]


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
    with _tensor(tmp_path / "w.gguf", "w") as (jt, t):
        want = jq.pack_q8_weight(jt, pad_n=pad_n, tile_n=256)
        got = tq.pack_q8_weight(t, pad_n=pad_n, tile_n=256)
    np.testing.assert_array_equal(got["wq"], np.asarray(want["wq"]))
    assert got["scales"].dtype == np.float16
    np.testing.assert_array_equal(got["scales"].view(np.uint16), np.asarray(want["scales"]))
    assert got["wq"].shape == ((128, 512) if pad_n else (128, 300))


@pytest.mark.parametrize("pad_n", [False, True])
@pytest.mark.parametrize("in_dim", [128, 320])
def test_pack_q4_weight_matches_jax(tmp_path, rng, in_dim, pad_n):
    """The port packs Q4_0 from the raw blocks with torch ops (on the device
    in the loader): the nibbles are bit-identical to the JAX package's, the
    f16 scales bit-equal to its uint16 scale bits, with its padding rule."""
    w = GGUFWriter(tmp_path / "w.gguf")
    w.add_tensor("w", rng.standard_normal((300, in_dim)).astype(np.float32), GGMLType.Q4_0)
    w.write()
    with _tensor(tmp_path / "w.gguf", "w") as (jt, t):
        want = jq.pack_q4_weight(jt, pad_n=pad_n, tile_n=256)
        got = tq.pack_q4_weight(t, pad_n=pad_n, tile_n=256)
    assert got["wq4"].dtype == torch.int8 and got["scales"].dtype == torch.float16
    assert tuple(got["wq4"].shape) == (in_dim // 2, 512 if pad_n else 300)
    np.testing.assert_array_equal(got["wq4"].numpy(), np.asarray(want["wq4"]))
    np.testing.assert_array_equal(got["scales"].numpy().view(np.uint16),
                                  np.asarray(want["scales"]))


def test_pack_q4_nibbles_matches_jax(rng):
    values = rng.integers(-8, 8, (64, 48)).astype(np.int8)
    np.testing.assert_array_equal(tq.pack_q4_nibbles(torch.from_numpy(values)).numpy(),
                                  jq.pack_q4_nibbles(values))


@pytest.mark.parametrize("qtype,in_dim,fmt", [
    ("Q4_0", 128, "wq4"), ("Q4_0", 96, "wq"), ("Q8_0", 128, "wq"), ("Q5_0", 128, "wq"),
    ("F16", 128, None)])
def test_linear_format_is_jax_pack_linear(tmp_path, rng, qtype, in_dim, fmt):
    """Eligibility: Q4_0 packs to int4 only when in % 64 == 0 (the nibble
    split), any other Q4_0 and Q8_0/Q5_0 to int8, the rest stays dense, as
    the JAX package's pack_linear decides."""
    w = GGUFWriter(tmp_path / "w.gguf")
    w.add_tensor("w", rng.standard_normal((256, in_dim)).astype(np.float32),
                 getattr(GGMLType, qtype))
    w.write()
    with _tensor(tmp_path / "w.gguf", "w") as (jt, t):
        assert tq.linear_format(t) == fmt
        packed = jq.pack_linear(jt)
    assert (None if packed is None else next(k for k in packed if k != "scales")) == fmt


@pytest.mark.parametrize("N", [256, 512, 300])
@pytest.mark.parametrize("K", [256, 512])
@pytest.mark.parametrize("M", [1, 2, 3, 8])
def test_quantized_matmul_q4_matches_jax(M, K, N):
    """The plain int4 versions against quantized_matmul_q4: N = 300 is padded
    to 512 with zero columns.  M > 1: both are f32 x @ dequant in f32.
    M == 1: x is rounded to bf16 on both sides (JAX's block-diagonal kernel
    does so itself; at K = 256 its whole-K kernel is given rounded x).  The
    same exact products summed in another order: rtol 1e-5 of max|out|."""
    rng = np.random.default_rng(M * 10007 + K + N)
    wq4, sc = make_q4(rng, K, N, n_pad=(-N) % 256)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xj = x if M > 1 else np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jq.quantized_matmul_q4(jnp.asarray(xj), jnp.asarray(wq4),
                                             jnp.asarray(sc.astype(np.float16).view(np.uint16))))
    plain = tq.qgemv_int4_plain if M == 1 else tq.qgemm_int4_plain
    args = (torch.from_numpy(x), torch.from_numpy(wq4), torch.from_numpy(sc.astype(np.float16)))
    got = plain(*args).numpy()
    np.testing.assert_array_equal(tq.quantized_matmul_q4(*args).numpy(), got)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    if M == 1:
        # without the bf16 rounding of x the port would miss by far more
        values = np.concatenate([(wq4.astype(np.int16) << 12) >> 12, wq4.astype(np.int16) >> 4])
        exact = x @ (values.astype(np.float32) * np.repeat(sc, 32, axis=0))
        assert np.abs(exact - want).max() > 10 * np.abs(got - want).max()


def test_cpu_wrappers_launch_nothing(rng):
    """On CPU tensors the wrappers run the plain versions and count no launch."""
    kernels = (tq.qgemv_int8, tq.qgemm_int8, tq.qgemv_int4, tq.qgemm_int4)
    before = [k.launches for k in kernels]
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    wq, sc = make_q8(rng, 64, 256)
    args = (torch.from_numpy(wq), torch.from_numpy(sc.astype(np.float16)))
    torch.testing.assert_close(tq.qgemv_int8(x[:1], *args), tq.qgemv_int8_plain(x[:1], *args))
    torch.testing.assert_close(tq.qgemm_int8(x, *args), tq.qgemm_int8_plain(x, *args))
    wq4, sc4 = make_q4(rng, 64, 256)
    args = (torch.from_numpy(wq4), torch.from_numpy(sc4.astype(np.float16)))
    torch.testing.assert_close(tq.qgemv_int4(x[:1], *args), tq.qgemv_int4_plain(x[:1], *args))
    torch.testing.assert_close(tq.qgemm_int4(x, *args), tq.qgemm_int4_plain(x, *args))
    assert [k.launches for k in kernels] == before


# Orpheus-3B's linears at M > 1 (K, N): qkv, o, gateup, down
ORPHEUS_GEMMS = {"qkv": (3072, 5120), "o": (3072, 3072), "gateup": (3072, 16384),
                 "down": (8192, 3072)}
SMS = 132      # streaming multiprocessors of an H100 SXM


def test_kernel_geometry_is_one_source():
    """The launch geometry that the plans read is what nvcc compiles the
    kernels with: every entry of _ext.GEOMETRY is a -D define of the build,
    and the split plan keeps each split at least the ring's depth."""
    flags = set(_ext.NVCC_FLAGS)
    assert all(f"-DTTS_{k}={v}" in flags for k, v in _ext.GEOMETRY.items())
    stages = _ext.GEOMETRY["G4_STAGES"]
    for K in (3072, 8192):
        _, _, splits, per = tq.gemm4_plan(8, K, 3072, SMS)
        assert splits > 1 and per >= stages


def split_blocks(M, K, N):
    """The packed blocks each split of gemm4_plan(M, K, N) takes, in order."""
    _, _, splits, per = tq.gemm4_plan(M, K, N, SMS)
    nblk = K // 64
    return [list(range(s * per, min((s + 1) * per, nblk))) for s in range(splits)]


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("name", list(ORPHEUS_GEMMS))
def test_gemm4_plan_fills_the_card_at_orpheus_shapes(name, M):
    """At every Orpheus-3B shape of the prefill (M = 64) and of an 8-token
    verify step, the split-K plan launches at least one CTA per SM, and its
    M tile holds the M rows in one tile."""
    K, N = ORPHEUS_GEMMS[name]
    m_tile, tile_n, splits, _ = tq.gemm4_plan(M, K, N, SMS)
    assert m_tile == M
    assert -(-N // tile_n) * -(-M // m_tile) * splits >= SMS
    assert sum(split_blocks(M, K, N), []) == list(range(K // 64))


@pytest.mark.parametrize("M", [2, 9, 17, 33, 77, 1024, 2048])
def test_gemm4_plan_covers_every_packed_block_once(M):
    """Any M up to 2048 and any K % 64 == 0: the splits take every packed
    block exactly once, in order, none is empty, and the M tile is the
    smallest of 8-64 tokens that holds M (64 past that)."""
    for K in (64, 128, 512, 3072, 8192):
        for N in (256, 3072, 157696):
            m_tile = tq.gemm4_plan(M, K, N, SMS)[0]
            parts = split_blocks(M, K, N)
            assert sum(parts, []) == list(range(K // 64)) and all(parts)
            assert m_tile == min(t for t in (8, 16, 32, 64) if t >= min(M, 64))


def int4_planes_as_the_kernel_unpacks(wq4: torch.Tensor) -> list[torch.Tensor]:
    """The low and high nibble planes of packed int4 [K/2, N] as f32, the
    Hopper kernel's way: bf16 bits 0x4300 | (u ^ 8) are 136 + q, less 136."""
    u = wq4.to(torch.int16) & 0xFF
    return [(((u >> shift) & 0xF) ^ 0x8 | 0x4300).view(torch.bfloat16).float() - 136
            for shift in (0, 4)]


def emulate_qgemm_int4(x: torch.Tensor, wq4: torch.Tensor, scales: torch.Tensor,
                       split_x: bool = True) -> torch.Tensor:
    """The Hopper qgemm_int4's arithmetic on the CPU: x split into bf16 hi
    and lo (exact bf16 x integer products, summed in f32 by the tensor
    cores), each 32-row block's f32 partial sum times its f16 scale, the
    splits of gemm4_plan added in split order.  split_x=False drops lo."""
    M, K = x.shape
    half, N = K // 2, wq4.shape[1]
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float() if split_x else torch.zeros_like(x)
    planes = int4_planes_as_the_kernel_unpacks(wq4)
    out = torch.zeros((M, N))
    for blocks in split_blocks(M, K, N):
        acc = torch.zeros((M, N))
        for b in blocks:
            rows = slice(b * 32, (b + 1) * 32)
            for p, w in enumerate(planes):
                cols = slice(p * half + b * 32, p * half + (b + 1) * 32)
                part = hi[:, cols] @ w[rows] + lo[:, cols] @ w[rows]
                acc += part * scales[b + p * (half // 32)].float()
        out += acc
    return out


def test_int4_unpack_gives_the_exact_integers(rng):
    """Every byte value: the magic-bias unpack gives the signed nibbles
    exactly (the low one sign-extended, the high one an arithmetic shift)."""
    wq4 = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    lo, hi = int4_planes_as_the_kernel_unpacks(wq4)
    w = wq4.to(torch.int16)
    assert torch.equal(lo, ((w << 12) >> 12).float())
    assert torch.equal(hi, (w >> 4).float())


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("M", [2, 8, 64])
def test_qgemm_int4_arithmetic_matches_plain(M, wide):
    """The kernel's arithmetic (emulated) is within the card test's 1e-4 of
    the f32 plain version, also for x spanning 1e-3 to 1e3 in magnitude;
    bf16(x) alone (no lo term) would miss 1e-4 by far.  K = 1024 splits in
    four, so the split order is exercised too."""
    K, N = 1024, 256
    rng = np.random.default_rng(M + 100 * wide)
    wq4, sc = make_q4(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if wide:
        x = np.sign(x) * 10.0 ** rng.uniform(-3, 3, (M, K)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(wq4), torch.from_numpy(sc.astype(np.float16)))
    assert len(split_blocks(M, K, N)) > 1
    want = tq.qgemm_int4_plain(*args)

    def rel(got):
        return ((got - want).abs().max() / want.abs().max()).item()

    assert rel(emulate_qgemm_int4(*args)) < 1e-4
    assert rel(emulate_qgemm_int4(*args, split_x=False)) > 1e-4
