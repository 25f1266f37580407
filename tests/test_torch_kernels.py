"""The port's Hopper kernels against their plain PyTorch versions, on the card,
at the Orpheus-3B shapes.  Every test here needs a CUDA device and skips
without one; the file imports no jax, so it runs where only the port does:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(tests/conftest.py pins JAX to the CPU, hence --noconftest there.)"""

import pytest
import torch

from tts_tpu_torch.ops import attention as ta
from tts_tpu_torch.ops import qmatmul as tq

# Orpheus-3B linears (K, N): qkv, o, gateup, down, padded lm_head
ORPHEUS_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072), (3072, 157696)]
# Orpheus-3B attention: Hq, Hkv, padded cache length
HQ, HKV, S, HS = 24, 8, 3584, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")


def rand_q8(K, N, device, seed):
    """int8 weights [K, N] and f16 block scales [K/32, N] of a Q8_0 linear."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    wq = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(device)
    sc = (torch.rand((K // 32, N), generator=g) * 2e-3 + 1e-4).half().to(device)
    return wq, sc


def rand_attention(pos, quant, device):
    """q [24, 128] f32 and a [8, 3584, 128] cache (bf16, or int8 + scales)
    whose rows past pos hold NaN, as a reused cache may."""
    g = torch.Generator(device="cpu").manual_seed(pos + 7 * quant)
    q = torch.randn((HQ, HS), generator=g)
    if quant:
        k = torch.randint(-127, 128, (HKV, S, HS), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (HKV, S, HS), generator=g, dtype=torch.int8)
        ks = torch.rand((HKV, S), generator=g) * 0.02 + 1e-3
        vs = torch.rand((HKV, S), generator=g) * 0.02 + 1e-3
        ks[:, pos + 1:] = float("nan")
        vs[:, pos + 1:] = float("nan")
    else:
        k = torch.randn((HKV, S, HS), generator=g).bfloat16()
        v = torch.randn((HKV, S, HS), generator=g).bfloat16()
        k[:, pos + 1:] = float("nan")
        v[:, pos + 1:] = float("nan")
        ks = vs = None
    move = (lambda t: None if t is None else t.to(device))
    return move(q), move(k), move(v), move(ks), move(vs)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemv_int8_matches_plain(cuda, K, N):
    """Both sum the same exact bf16(x) * int8 products in f32, in another
    order (split-K, per-block scaling): relative error bound 1e-4."""
    wq, sc = rand_q8(K, N, cuda, K + N)
    x = torch.randn((1, K), device=cuda)
    n = tq.qgemv_int8.launches
    got = tq.qgemv_int8(x, wq, sc)
    torch.cuda.synchronize()
    assert tq.qgemv_int8.launches == n + 1
    assert rel_err(got, tq.qgemv_int8_plain(x, wq, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 8, 32, 77, 1024])
@pytest.mark.parametrize("K,N", [ORPHEUS_SHAPES[i] for i in (0, 2, 3, 4)])
def test_qgemm_int8_matches_plain(cuda, M, K, N):
    """f32 FMA over exactly dequantized weights, another summation order:
    relative error bound 1e-4.  M = 77 leaves a ragged M tile; 1024 is the
    longest prompt (max_context_length)."""
    wq, sc = rand_q8(K, N, cuda, K + N + M)
    x = torch.randn((M, K), device=cuda)
    got = tq.qgemm_int8(x, wq, sc)
    torch.cuda.synchronize()
    assert rel_err(got, tq.qgemm_int8_plain(x, wq, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 511, 512, 2047, 3583])
def test_flash_decode_matches_plain(cuda, quant, pos):
    """The kernel takes each chunk's p against that chunk's max, the plain
    version against the running max, so bf16(p) rounds differently past the
    first chunk: each term moves by at most 2^-9 of itself, the output by at
    most 2^-9 max|v|; stated bound 4e-3 of max|out|.  NaN rows past pos must
    not reach the kernel's output (the plain version masks them too)."""
    q, k, v, ks, vs = rand_attention(pos, quant, cuda)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    got = ta.flash_decode(q, k, v, pos_t, ks, vs)
    torch.cuda.synchronize()
    want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
    assert torch.isfinite(got).all()
    assert rel_err(got, want) < 4e-3


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take(cuda):
    """Misaligned or mis-shaped inputs raise before any launch."""
    K, N = 256, 512
    wq, sc = rand_q8(K, N, cuda, 0)
    x = torch.randn((1, K), device=cuda)
    shifted = torch.empty(K * N + 1, dtype=torch.int8, device=cuda)[1:].view(K, N)
    n = tq.qgemv_int8.launches
    with pytest.raises(ValueError):
        tq.qgemv_int8(x, shifted, sc)
    with pytest.raises(ValueError):
        tq.qgemm_int8(x.repeat(2, 1), wq[:, :500].contiguous(), sc[:, :500].contiguous())
    assert tq.qgemv_int8.launches == n
    q, k, v, _, _ = rand_attention(5, False, cuda)
    with pytest.raises(ValueError):
        ta.flash_decode(q, k, v, torch.tensor([5], device=cuda))      # pos must be int32
