"""The chip's peaks and the least time a piece of work could take on it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 989 TFLOP/s in bf16/fp16 on the tensor cores, 3.35 TB/s of HBM3.
A bound is the larger of operations over the peak rate and bytes over the
memory rate, with each input read once and each output written once: the
arithmetic of the port's gemv_timing.py / gemm_timing.py / chip_smoke.py
`bound`, kept here so that the yardstick does not move with the program."""

from __future__ import annotations

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Q4_0: a block of 32 weights is 16 bytes of nibbles and an f16 scale
Q4_0_BYTES_PER_WEIGHT = 18 / 32
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """Seconds: the larger of flops / peak and bytes / memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def q4_matmul(M: int, K: int, N: int) -> tuple[float, float]:
    """(flops, bytes) of x [M, K] (bf16) times a Q4_0 weight [K, N] into
    [M, N] (bf16): each byte once."""
    return 2.0 * M * K * N, K * N * Q4_0_BYTES_PER_WEIGHT + (M * K + M * N) * BF16


def q4_matmul_bound_s(M: int, K: int, N: int) -> float:
    return bound_s(*q4_matmul(M, K, N))
