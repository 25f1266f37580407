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
    own Q8 test), on f32 x and on bf16 x as the prefill passes it (both
    sides then sum the bf16 values exactly in f32).  M == 1: both sides
    round x to bf16 and sum exact bf16 x int8 products in f32, so only the
    summation order differs: rtol 1e-5."""
    rng = np.random.default_rng(M * 10007 + K + N)
    wq, sc = make_q8(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    sj = jnp.asarray(sc.astype(np.float16).view(np.uint16))
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), jnp.asarray(wq), sj))
    got = tq.quantized_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                              torch.from_numpy(sc.astype(np.float16))).numpy()
    if M == 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        # without the bf16 rounding of x the port would miss by far more
        exact = x @ (wq.astype(np.float32) * np.repeat(sc, 32, axis=0))
        assert np.abs(exact - want).max() > 10 * np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        xb = torch.from_numpy(x).bfloat16()
        want_b = np.asarray(jq.quantized_matmul(jnp.asarray(xb.float().numpy()).astype(
            jnp.bfloat16), jnp.asarray(wq), sj))
        got_b = tq.quantized_matmul(xb, torch.from_numpy(wq),
                                    torch.from_numpy(sc.astype(np.float16))).numpy()
        assert got_b.dtype == np.float32
        np.testing.assert_allclose(got_b, want_b, rtol=1e-4, atol=1e-4)


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
        got = tq.pack_q4_weight(t, pad_n=pad_n, tile_n=256, device="cpu")
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
# Orpheus-3B's linears at M == 1 (K, N): the four above and the padded lm_head
ORPHEUS_GEMVS = {**ORPHEUS_GEMMS, "lm_head": (3072, 157696)}
# the shards of a tp = 2 Orpheus-3B (Q8_0; chip_smoke.py TP2_SHAPES), and
# gemv_plan's cluster geometry at each that is not a small call:
# (tile_n, splits, per) for int8 and int4
TP2_GEMVS = {"tp2 q": (3072, 1536), "tp2 k/v": (3072, 512), "tp2 gate/up": (3072, 4096),
             "tp2 o": (1536, 3072), "tp2 down": (4096, 3072), "tp2 lm_head": (3072, 78848)}
CLUSTER_PLANS = {
    "qkv": ((256, 4, 24), (256, 4, 12)), "o": ((256, 8, 12), (256, 8, 6)),
    "gateup": ((256, 2, 48), (256, 2, 24)), "down": ((256, 8, 32), (256, 8, 16)),
    "lm_head": ((256, 2, 48), (256, 1, 48)), "tp2 q": ((256, 8, 12), (256, 8, 6)),
    "tp2 gate/up": ((256, 8, 12), (256, 8, 6)), "tp2 o": ((256, 8, 6), (256, 8, 3)),
    "tp2 down": ((256, 8, 16), (256, 8, 8)), "tp2 lm_head": ((256, 2, 48), (256, 1, 48))}
# Parler-TTS mini v1's decoder linears (K, N): q/k/v/o and the
# cross-attention's q/o (hidden 1024), fc1, fc2
PARLER_GEMVS = {"parler-attn": (1024, 1024), "parler-fc1": (1024, 4096),
                "parler-fc2": (4096, 1024)}


def gemv_smem_bytes(packed: bool, tile_n: int, per: int, splits: int) -> int:
    """Shared memory of one GEMV CTA (csrc/qmatmul.cuh GemvSmem): each
    warp's ring of 32-row blocks of its 128 columns with their scales, the
    CTA's x slice in bf16, and the [splits][tile_n] f32 sums its cluster
    pushes."""
    g = _ext.GEOMETRY
    planes = 2 if packed else 1
    slot = 32 * 128 + planes * 128 * 2
    pushed = splits * tile_n * 4 if splits > 1 else 0
    return g["GEMV_WARPS"] * g["GEMV_RING"] * slot + per * 32 * planes * 2 + pushed


def gemm_smem_bytes(packed: bool, x_f32: bool, m_tile: int, tile_n: int) -> int:
    """Shared memory of one GEMM CTA (csrc/qmatmul.cuh GemmSmem): the
    format's ring of stages, each one 32-row weight block (padded rows),
    its scales per nibble plane, and the x columns it meets (f32 or bf16,
    padded rows), then for f32 x the stage's bf16 hi and lo terms."""
    planes = 2 if packed else 1
    xk = planes * 32
    brow = (xk + 8) * 2
    xrow = xk * 4 + 16 if x_f32 else brow
    stage = 32 * (tile_n + 16) + planes * tile_n * 2 + m_tile * xrow
    stages = _ext.GEOMETRY["G4_STAGES" if packed else "G8_STAGES"]
    return stages * stage + (2 * m_tile * brow if x_f32 else 0)


def test_kernel_geometry_is_one_source():
    """The launch geometry that the plans read is what nvcc compiles the
    kernels with: every entry of _ext.GEOMETRY is a -D define of the build;
    the GEMM split plan keeps each split at least the format's ring depth;
    every GEMM tile the plan can pick (both formats, bf16 and f32 x) fits
    its CTAs per SM in the H100's 228 KB of shared memory per SM, with the
    1 KB the card reserves per CTA; and at every Orpheus-3B shape
    GEMV_CTAS_PER_SM GEMV CTAs fit too."""
    flags = set(_ext.NVCC_FLAGS)
    g = _ext.GEOMETRY
    assert all(f"-DTTS_{k}={v}" in flags for k, v in g.items())
    assert {"G8_STAGES", "G8_CTAS_PER_SM_8", "G8_CTAS_PER_SM", "G8_WIDE_TOKENS"} <= set(g)
    for packed, fmt in ((False, "G8"), (True, "G4")):
        for K in (3072, 8192):
            _, _, splits, per = tq.gemm_plan(8, K, 3072, SMS, packed)
            assert splits > 1 and per >= g[f"{fmt}_STAGES"]
        for m_tile in (8, 16, 32, 64):
            per_sm = g[f"{fmt}_CTAS_PER_SM_8" if m_tile == 8 else f"{fmt}_CTAS_PER_SM"]
            for tile_n in (128, 256) if m_tile <= g[f"{fmt}_WIDE_TOKENS"] else (128,):
                for x_f32 in (False, True):
                    smem = gemm_smem_bytes(packed, x_f32, m_tile, tile_n)
                    assert per_sm * (smem + 1024) <= 228 * 1024, (fmt, m_tile, tile_n, x_f32)
    for packed in (False, True):
        for K, N in ORPHEUS_GEMVS.values():
            tile_n, splits, per = tq.gemv_plan(K, N, SMS, packed)[:3]
            smem = gemv_smem_bytes(packed, tile_n, per, splits)
            assert g["GEMV_CTAS_PER_SM"] * (smem + 1024) <= 228 * 1024, (K, N, packed, smem)
        for K in (3072, 8192, 65536):
            _, splits, per = tq.gemv_plan(K, 3072, SMS, packed)[:3]
            assert splits <= g["GEMV_MAX_CLUSTER"]
            assert per * (64 if packed else 32) <= g["GEMV_MAX_X"]


def split_blocks(M, K, N, packed):
    """The weight blocks (packed blocks for int4) each split of
    gemm_plan(M, K, N) takes, in order."""
    _, _, splits, per = tq.gemm_plan(M, K, N, SMS, packed)
    nblk = K // (64 if packed else 32)
    return [list(range(s * per, min((s + 1) * per, nblk))) for s in range(splits)]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("name", list(ORPHEUS_GEMMS))
def test_gemm_plan_fills_the_card_at_orpheus_shapes(name, M, packed):
    """At every Orpheus-3B shape of the prefill (M = 64) and of an 8-token
    verify step, the split-K plan launches at least one CTA per SM, and its
    M tile holds the M rows in one tile."""
    K, N = ORPHEUS_GEMMS[name]
    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, SMS, packed)
    assert m_tile == M
    assert -(-N // tile_n) * -(-M // m_tile) * splits >= SMS
    assert sum(split_blocks(M, K, N, packed), []) == list(range(K // (64 if packed else 32)))


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [2, 9, 17, 33, 77, 1024, 2048])
def test_gemm_plan_covers_every_block_once(M, packed):
    """Any M up to 2048 and any K % 64 == 0: the splits take every weight
    block exactly once, in order, none is empty, and the M tile is the
    smallest of 8-64 tokens that holds M (64 past that)."""
    for K in (64, 128, 512, 3072, 8192):
        for N in (256, 3072, 157696):
            m_tile = tq.gemm_plan(M, K, N, SMS, packed)[0]
            parts = split_blocks(M, K, N, packed)
            assert sum(parts, []) == list(range(K // (64 if packed else 32))) and all(parts)
            assert m_tile == min(t for t in (8, 16, 32, 64) if t >= min(M, 64))


def int4_planes_as_the_kernel_unpacks(wq4: torch.Tensor) -> list[torch.Tensor]:
    """The low and high nibble planes of packed int4 [K/2, N] as f32, the
    Hopper kernel's way: bf16 bits 0x4300 | (u ^ 8) are 136 + q, less 136."""
    u = wq4.to(torch.int16) & 0xFF
    return [(((u >> shift) & 0xF) ^ 0x8 | 0x4300).view(torch.bfloat16).float() - 136
            for shift in (0, 4)]


def int8_as_the_kernel_unpacks(wq: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] as f32, the Hopper GEMM's way: the f32 bits 0x4B0000uu
    (u = byte ^ 0x80) are 2^23 + u, less 2^23 + 128 (one FADD), and the
    bf16 the MMA reads is the upper half of that float's bits."""
    u = (wq.to(torch.int32) ^ 0x80) & 0xFF
    f = (u | 0x4B000000).view(torch.float32) - (2.0 ** 23 + 128)
    return ((f.view(torch.int32) >> 16).to(torch.int16)).view(torch.bfloat16).float()


def emulate_qgemm(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, packed: bool,
                  split_x: bool = True) -> torch.Tensor:
    """The Hopper GEMM's arithmetic (qgemm_int8, or qgemm_int4 when packed)
    on the CPU: x split into bf16 hi and lo (exact bf16 x integer products,
    summed in f32 by the tensor cores), each 32-row block's (and nibble
    plane's) f32 partial sum times its f16 scale, the splits of gemm_plan
    added in split order.  split_x=False drops lo, as the kernel does for
    bf16 x."""
    x = x.float()
    M, K = x.shape
    N = w.shape[1]
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float() if split_x else torch.zeros_like(x)
    if packed:
        planes, half = int4_planes_as_the_kernel_unpacks(w), K // 2
    else:
        planes, half = [int8_as_the_kernel_unpacks(w)], 0
    nblk = w.shape[0] // 32
    out = torch.zeros((M, N))
    for blocks in split_blocks(M, K, N, packed):
        acc = torch.zeros((M, N))
        for b in blocks:
            rows = slice(b * 32, (b + 1) * 32)
            for p, wp in enumerate(planes):
                cols = slice(p * half + b * 32, p * half + (b + 1) * 32)
                part = hi[:, cols] @ wp[rows] + lo[:, cols] @ wp[rows]
                acc += part * scales[b + p * nblk].float()
        out += acc
    return out


def test_int8_unpack_gives_the_exact_integers():
    """Every byte value -128..127 goes through the kernel's int8 -> f32 ->
    bf16 route exactly (bf16 has 8 significant bits: no bias alone could
    give all 256 values)."""
    wq = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    assert torch.equal(int8_as_the_kernel_unpacks(wq), wq.float())


def test_int4_unpack_gives_the_exact_integers(rng):
    """Every byte value: the magic-bias unpack gives the signed nibbles
    exactly (the low one sign-extended, the high one an arithmetic shift)."""
    wq4 = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    lo, hi = int4_planes_as_the_kernel_unpacks(wq4)
    w = wq4.to(torch.int16)
    assert torch.equal(lo, ((w << 12) >> 12).float())
    assert torch.equal(hi, (w >> 4).float())


def gemm_case(M, packed, wide, seed):
    """x [M, 1024] f32 (wide: magnitudes 1e-3..1e3) and a Q8_0 or Q4_0
    weight [1024, 256] with its f16 scales, as torch tensors."""
    K, N = 1024, 256
    rng = np.random.default_rng(seed)
    w, sc = make_q4(rng, K, N) if packed else make_q8(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if wide:
        x = np.sign(x) * 10.0 ** rng.uniform(-3, 3, (M, K)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sc.astype(np.float16))


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("M", [2, 8, 64])
def test_qgemm_int4_arithmetic_matches_plain(M, wide):
    """The kernel's arithmetic (emulated) on f32 x is within the card
    test's 1e-4 of the f32 plain version, also for x spanning 1e-3 to 1e3
    in magnitude; bf16(x) alone (no lo term) would miss 1e-4 by far.
    K = 1024 splits in four, so the split order is exercised too."""
    args = gemm_case(M, True, wide, M + 100 * wide)
    assert len(split_blocks(M, 1024, 256, True)) > 1
    want = tq.qgemm_int4_plain(*args)
    assert rel_err(emulate_qgemm(*args, packed=True), want) < 1e-4
    assert rel_err(emulate_qgemm(*args, packed=True, split_x=False), want) > 1e-4


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("M", [2, 8, 64])
def test_qgemm_int8_arithmetic_matches_plain(M, wide):
    """The same for the int8 instance: on f32 x within 1e-4 of the plain
    version (x from 1e-3 to 1e3 too), and not without the lo term; K =
    1024 splits (32 blocks), so the split order is exercised."""
    args = gemm_case(M, False, wide, 7 + M + 100 * wide)
    assert len(split_blocks(M, 1024, 256, False)) > 1
    want = tq.qgemm_int8_plain(*args)
    assert rel_err(emulate_qgemm(*args, packed=False), want) < 1e-4
    assert rel_err(emulate_qgemm(*args, packed=False, split_x=False), want) > 1e-4


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [2, 64])
def test_qgemm_on_bf16_x_needs_no_lo_term(M, packed):
    """On bf16 x (the prefill's activations) lo = bf16(x - hi) is zero, so
    the kernel's one product gives the same bits as two, and it is within
    1e-4 of the plain version, which sums those bf16 values exactly in f32:
    the kernel needs no cast of x and runs half the products."""
    x, w, sc = gemm_case(M, packed, False, 11 + M + packed)
    xb = x.bfloat16()
    one = emulate_qgemm(xb, w, sc, packed=packed, split_x=False)
    assert torch.equal(one, emulate_qgemm(xb, w, sc, packed=packed))
    plain = tq.qgemm_int4_plain if packed else tq.qgemm_int8_plain
    assert rel_err(one, plain(xb, w, sc)) < 1e-4


def gemv_split_blocks(K, N, packed, sms=SMS):
    """The weight blocks (packed blocks for int4) each split of
    gemv_plan(K, N) takes, in order."""
    _, splits, per = tq.gemv_plan(K, N, sms, packed)[:3]
    nblk = K // (64 if packed else 32)
    return [list(range(s * per, min((s + 1) * per, nblk))) for s in range(splits)]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("name", list(ORPHEUS_GEMVS))
def test_gemv_plan_fills_the_card_at_orpheus_shapes(name, packed):
    """At every Orpheus-3B linear the GEMV launches one wave with at most
    one CTA per SM and no SM idle that a power-of-two split could have
    used: qkv 80 CTAs, o and down 96, gateup 128.  The lm_head's column
    tiles alone fill the card: it splits only to keep a CTA at 48 weight
    blocks at most (int8: two splits; int4: none)."""
    K, N = ORPHEUS_GEMVS[name]
    g = _ext.GEOMETRY
    tile_n, splits, per = tq.gemv_plan(K, N, SMS, packed)[:3]
    assert tile_n == g["GEMV_TILE_N"]
    tiles = -(-N // tile_n)
    assert splits & (splits - 1) == 0 and splits <= g["GEMV_MAX_CLUSTER"]
    if tiles < SMS:
        assert tiles * splits <= SMS < 2 * tiles * splits
    else:
        assert per <= 48 and splits == (1 if packed else 2)
    assert tiles * splits == {"qkv": 80, "o": 96, "gateup": 128, "down": 96,
                              "lm_head": 616 if packed else 1232}[name]


def small_rule(K, N, sms, packed):
    """(tile_n, rows) of the small-call instance by its rule, or None where
    the call takes the cluster instance: at most 4,194,304 weights and x
    within GEMV_MAX_X; the narrowest tile of 16-128 whose tiles fit in one
    wave (the widest where none does), narrowed while 32 rows a thread would
    pass GEMV_SMALL_MAX_THREADS; rows halved from 32 while the CTA has fewer
    than 512 threads or not whole warps, and never past the most threads;
    None where that leaves no whole warps within the most."""
    g = _ext.GEOMETRY
    most = g["GEMV_SMALL_MAX_THREADS"]
    if K * N > 1 << 22 or K > g["GEMV_MAX_X"]:
        return None
    nblk = K // (64 if packed else 32)
    tile = next((t for t in (16, 32, 64, 128) if -(-N // t) <= sms), 128)
    while tile > 16 and tile // 4 * nblk > most:
        tile //= 2
    for rows in (32, 16, 8, 4, 2, 1):
        threads = tile // 4 * nblk * 32 // rows
        if threads > most:
            return None
        if threads % 32 == 0 and (threads >= 512 or rows == 1 or 2 * threads > most):
            return tile, rows
    return None


def small_geometry_holds(K, N, plan, packed, sms):
    """The small-call instance's rule for its plan: the narrowest column
    tile of 16-128 whose tiles fit in one wave (the widest where none
    does), narrowed while a thread per 32 rows and 4 columns would pass
    GEMV_SMALL_MAX_THREADS; one CTA per column tile (no split across CTAs);
    every thread 4 columns and `rows` rows of one weight block, so the
    threads cover the tile's rows exactly once, in whole warps, 512 of
    them where K has rows enough (fewer rows a thread would pass the
    512); shared memory under the 48 KB a launch may take without asking."""
    g = _ext.GEOMETRY
    most = g["GEMV_SMALL_MAX_THREADS"]
    rows = K // (2 if packed else 1)
    tile = next((t for t in (16, 32, 64, 128) if -(-N // t) <= sms), 128)
    while tile > 16 and tile // 4 * rows // 32 > most:
        tile //= 2
    assert plan.tile_n == tile
    assert plan.splits == 1 and plan.per * 32 == rows
    assert plan.rows in (1, 2, 4, 8, 16, 32)
    threads = plan.tile_n // 4 * rows // plan.rows     # as csrc/qmatmul.cuh launch_qgemv
    assert threads % 32 == 0 and threads <= most
    assert threads == 512 or plan.rows == 1 or 2 * threads > most
    assert K * N <= 1 << 22 and K <= g["GEMV_MAX_X"]
    smem = ((K + K // 32 + 3) // 4 * 4 + (threads // 32 * plan.tile_n if threads > 32 else 0)) * 4
    assert smem <= 48 * 1024
    return threads


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_gemv_plan_covers_every_block_once(sms, packed):
    """Ragged K and N (K % 64 == 0, N % 16 == 0): the splits take every
    weight block exactly once, in order, none is empty; the column tiles
    cover N; each CTA's x slice fits the kernel's bound.  Each instance
    keeps its rule: the cluster instance's CTAs take GEMV_TILE_N columns
    and split K within a cluster; the small-call instance's (calls of at
    most 4,194,304 weights) take all of K (small_geometry_holds)."""
    g = _ext.GEOMETRY
    for K in (64, 192, 3072, 8192, 8256, 40960):
        for N in (16, 144, 3088, 157696):
            plan = tq.gemv_plan(K, N, sms, packed)
            tile_n, splits, per = plan[:3]
            parts = gemv_split_blocks(K, N, packed, sms)
            assert sum(parts, []) == list(range(K // (64 if packed else 32))) and all(parts)
            assert (small_rule(K, N, sms, packed) or (g["GEMV_TILE_N"], 0)) == (tile_n, plan.rows)
            if plan.rows:
                small_geometry_holds(K, N, plan, packed, sms)
            assert len(parts) == splits <= g["GEMV_MAX_CLUSTER"]
            assert per * (64 if packed else 32) <= g["GEMV_MAX_X"]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("name", [*PARLER_GEMVS, "tp2 k/v"])
def test_gemv_plan_takes_the_small_instance_at_parler_shapes(name, packed):
    """Every Parler-TTS mini v1 linear, and the tp = 2 shard's k/v, takes
    the small-call instance: one CTA per column tile, no cluster (attn and
    fc2: 64 tiles of 16 columns; fc1: 128 of 32; the k/v shard: 32 of
    16), 512 threads a CTA (the k/v shard: 384), and every warp it
    launches holds at least a whole weight block's rows (its 32 / (tile /
    4) slices of `rows` rows each)."""
    K, N = {**PARLER_GEMVS, **TP2_GEMVS}[name]
    plan = tq.gemv_plan(K, N, SMS, packed)
    assert plan.rows > 0
    threads = small_geometry_holds(K, N, plan, packed, SMS)
    assert -(-N // plan.tile_n) == {"parler-fc1": 128, "tp2 k/v": 32}.get(name, 64)
    assert threads == (384 if name == "tp2 k/v" else 512)
    assert 32 // (plan.tile_n // 4) * plan.rows >= 32


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("name", list(CLUSTER_PLANS))
def test_gemv_plan_keeps_the_cluster_instance_at_orpheus_shapes(name, packed):
    """Every single-card Orpheus-3B linear (the smallest, o, holds 9.4 M
    weights) and every tp = 2 shard above 4,194,304 weights keeps the
    cluster instance with the (tile_n, splits, per) it had before the
    small-call instance existed."""
    K, N = {**ORPHEUS_GEMVS, **TP2_GEMVS}[name]
    assert tq.gemv_plan(K, N, SMS, packed) == (*CLUSTER_PLANS[name][packed], 0)


def emulate_qgemv(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, packed: bool,
                  sms: int = SMS, plan=None) -> torch.Tensor:
    """The Hopper GEMV's arithmetic on the CPU, in its order, for the
    instance of `plan` (gemv_plan's on `sms` SMs by default): x rounded to
    bf16; per weight block (and nibble plane) the exact products summed in
    f32, then the block's f16 scale on that sum, low plane first.  The
    cluster instance: each warp sums its blocks in order (a warp takes 128
    columns: a CTA of CW warps side by side gives warp w the range's blocks
    w / CW, w / CW + GEMV_WARPS / CW, ...), a column's warps are added in
    warp order, and the cluster adds its splits in order.  The small-call
    instance: per thread the `rows` rows of its slice (a part of one block)
    and its planes' scales, then per column a pairwise tree over the slices
    of a warp (32 / (tile_n / 4) in a row) and the warps in order."""
    plan = plan or tq.gemv_plan(x.shape[-1], w.shape[1], sms, packed)
    xb = x.to(torch.bfloat16).float()[0]
    K, N = xb.shape[0], w.shape[1]
    if packed:
        planes = int4_planes_as_the_kernel_unpacks(w)
        rows, half = K // 2, K // 2
    else:
        planes, rows, half = [w.float()], K, 0
    nblk = rows // 32
    if plan.rows:
        r = plan.rows
        acc = torch.zeros((rows // r, N))
        for p, wp in enumerate(planes):
            part = torch.einsum("sr,srn->sn", xb[p * half: p * half + rows].view(-1, r),
                                wp.view(-1, r, N))
            acc = acc + part * scales[p * nblk:(p + 1) * nblk].float().repeat_interleave(32 // r, 0)
        per_warp = 32 // (plan.tile_n // 4)
        acc = acc.view(-1, per_warp, N)
        while acc.shape[1] > 1:                  # the warp's xor shuffles: pairs of slices
            acc = acc[:, 0::2] + acc[:, 1::2]
        out = torch.zeros(N)
        for warp_sum in acc[:, 0]:
            out = out + warp_sum
        return out[None]
    kw = _ext.GEOMETRY["GEMV_WARPS"] * 128 // _ext.GEOMETRY["GEMV_TILE_N"]   # warps per column
    out = torch.zeros(N)
    for s in range(plan.splits):
        blocks = list(range(s * plan.per, min((s + 1) * plan.per, nblk)))
        cta = torch.zeros(N)
        for k in range(kw):
            acc = torch.zeros(N)
            for b in blocks[k::kw]:
                for p, wp in enumerate(planes):
                    xs = xb[p * half + b * 32: p * half + (b + 1) * 32]
                    acc = acc + (xs @ wp[b * 32:(b + 1) * 32]) * scales[b + p * nblk].float()
            cta = cta + acc
        out = out + cta
    return out[None]


@pytest.mark.parametrize("case", [1, 132, *PARLER_GEMVS])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_qgemv_arithmetic_matches_plain_and_jax(packed, xdtype, case):
    """The kernel's arithmetic (emulated) within 1e-4 of the plain version
    (the card test's bound) and within the plain version's own tolerance
    of tts_tpu's quantized_matmul / quantized_matmul_q4 at M = 1.  Cases 1
    and 132: the cluster instance at K = 1024, N = 256 on a card of that
    many SMs: K splits 8 ways at 132 SMs (one block per warp at most); at 1
    SM it does not split and each warp sums 4 (int4) or 8 (int8) blocks.
    The Parler-TTS mini v1 cases: gemv_plan's small-call instance on 132
    SMs, K split among a CTA's threads (2-32 rows each)."""
    sms = case if isinstance(case, int) else SMS
    K, N = (1024, 256) if isinstance(case, int) else PARLER_GEMVS[case]
    rng = np.random.default_rng(7 + packed + 10 * (sms if isinstance(case, int) else K + N))
    w, sc = make_q4(rng, K, N) if packed else make_q8(rng, K, N)
    x = rng.standard_normal((1, K)).astype(np.float32)
    xt = torch.from_numpy(x).to(xdtype)
    args = (xt, torch.from_numpy(w), torch.from_numpy(sc.astype(np.float16)))
    if isinstance(case, int):
        plan = tq._gemv_cluster_plan(K, N, sms, packed)
        assert (plan.splits > 1) == (sms > 1)
    else:
        plan = tq.gemv_plan(K, N, sms, packed)
        assert plan.rows > 0 and plan.splits == 1
    got = emulate_qgemv(*args, packed=packed, plan=plan)
    want = (tq.qgemv_int4_plain if packed else tq.qgemv_int8_plain)(*args)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4
    xj = np.asarray(jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16).astype(jnp.float32))
    sj = jnp.asarray(sc.astype(np.float16).view(np.uint16))
    jax_fn = jq.quantized_matmul_q4 if packed else jq.quantized_matmul
    ref = np.asarray(jax_fn(jnp.asarray(xj), jnp.asarray(w), sj))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
