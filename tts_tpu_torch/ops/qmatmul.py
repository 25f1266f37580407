"""Weights-quantized matmul: activations x int8 block-quantized weights.

Counterpart of `tts_tpu/ops/qmatmul.py`.  Layout at the public functions is
the JAX package's: `wq` int8 [K, N] and one scale per 32-row block and
column, `scales` [K/32, N], here stored as float16 (the GGUF block `d` is
f16, so this is exact).

Two hand-written Hopper kernels (csrc/qmatmul.cu) replace the TPU's Pallas
kernels: `qgemv_int8` (M == 1, every decode step; was `_qmv_kernel`) and
`qgemm_int8` (M > 1, prefill; was `_qmm_kernel`).  Each wrapper runs its
plain PyTorch version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.

Not ported, because each exists only for the TPU: the uint16 f16-bit scale
trick (`_f16_bits_to_f32`; Mosaic rejects f16 operands), the block-diagonal
activation expansion (`_block_diag_x`; feeds the MXU), and the VMEM tile
policy (`_pick_tiles`, `_auto_tile_n`, the `TTS_TPU_BLOCKDIAG_*` knobs).
"""

from __future__ import annotations

import numpy as np
import torch

from tts_tpu_torch.ops import _ext

QBLOCK = 32
# qgemv_int8: CTAs to aim for (4 per SM of the H100's 132) and the warps that
# share one CTA's k-range (csrc/qmatmul.cu GEMV_WARPS / GEMV_TILE_N)
_GEMV_TARGET_CTAS = 4 * 132
_GEMV_WARPS = 4
_GEMV_TILE_N = 512


def _pad_n(arr: np.ndarray, tile: int) -> np.ndarray:
    """Zero-pad the output (last) dim to a multiple of `tile`; padded columns
    dequantize to 0 and the caller slices them off."""
    pad = (-arr.shape[-1]) % tile
    if pad == 0:
        return arr
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, pad)])


def pack_q8_weight(tensor, pad_n: bool = False, tile_n: int = 256) -> dict:
    """GGUFTensor (Q8_0/Q4_0/Q5_0, shape [out, in]) -> numpy {"wq": int8
    [in, out], "scales": float16 [in/32, out]}.  `pad_n` zero-pads the output
    dim to a multiple of `tile_n` (the Orpheus lm_head: 1024).  Q4_0 is
    accepted as the JAX function accepts it; the Orpheus loader refuses Q4_0
    until its int4 kernels are ported."""
    values, scales = tensor.to_int8_scales()
    out_dim, in_dim = values.shape
    wq = np.ascontiguousarray(values.T)
    sc = np.ascontiguousarray(scales.reshape(out_dim, in_dim // QBLOCK).T).astype(np.float16)
    if pad_n:
        wq, sc = _pad_n(wq, tile_n), _pad_n(sc, tile_n)
    return {"wq": wq, "scales": sc}


def _dequant_matmul(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 x @ (wq * scale), dequantizing 2048 columns at a time so the
    temporaries stay small at the 157k-wide lm_head."""
    K, N = wq.shape
    out = torch.empty((x.shape[0], N), dtype=torch.float32, device=x.device)
    for n0 in range(0, N, 2048):
        sl = slice(n0, n0 + 2048)
        s = scales[:, sl].float()
        w = wq[:, sl].float() * s[:, None, :].expand(-1, QBLOCK, -1).reshape(K, -1)
        out[:, sl] = x @ w
    return out


def qgemv_int8_plain(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] -> [1, N] f32.  x is rounded to bf16 first, as the TPU
    kernel rounds its block-diagonal activations."""
    return _dequant_matmul(x.to(torch.bfloat16).float(), wq, scales)


def qgemm_int8_plain(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] -> [M, N] f32, all in f32."""
    return _dequant_matmul(x.float(), wq, scales)


def _check_cuda(name: str, x, wq, scales) -> tuple[int, int]:
    K, N = wq.shape
    if not (wq.is_cuda and scales.is_cuda and x.device == wq.device == scales.device):
        raise ValueError(f"{name}: x, wq and scales must be on one CUDA device")
    if wq.dtype != torch.int8 or scales.dtype != torch.float16:
        raise ValueError(f"{name}: wq must be int8 and scales float16")
    if not (wq.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: wq and scales must be contiguous")
    if wq.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError(f"{name}: wq and scales must start 16-byte aligned (vector loads)")
    if K % QBLOCK or N % 16 or tuple(scales.shape) != (K // QBLOCK, N):
        raise ValueError(f"{name}: needs K % 32 == 0, N % 16 == 0, scales "
                         f"[K/32, N]; got wq {tuple(wq.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if x.shape[-1] != K:
        raise ValueError(f"{name}: x has K={x.shape[-1]}, wq has K={K}")
    return K, N


def _gemv_splits(K: int, N: int) -> tuple[int, int]:
    """(splits, scale blocks per split): enough CTAs to fill the card, at
    least one scale block per warp of a CTA."""
    nblk = K // QBLOCK
    n_col = -(-N // _GEMV_TILE_N)
    splits = max(1, min(-(-_GEMV_TARGET_CTAS // n_col), nblk // _GEMV_WARPS))
    per = -(-nblk // splits)
    return -(-nblk // per), per


def qgemv_int8(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] @ dequant(wq, scales) -> [1, N] f32 (M == 1)."""
    if not x.is_cuda:
        return qgemv_int8_plain(x, wq, scales)
    K, N = _check_cuda("qgemv_int8", x, wq, scales)
    if x.shape[0] != 1:
        raise ValueError(f"qgemv_int8: M must be 1, got {x.shape[0]}")
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((1, N), device=x.device, dtype=torch.float32)
    splits, per = _gemv_splits(K, N)
    partial = (torch.empty((splits, N), device=x.device, dtype=torch.float32)
               if splits > 1 else out)
    err = _ext.load().qgemv_int8(xb.data_ptr(), wq.data_ptr(), scales.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(), K, N, splits,
                                 per, _ext.stream_ptr(x))
    qgemv_int8.launches += 1
    _ext.check("qgemv_int8", err)
    return out


def qgemm_int8(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq, scales) -> [M, N] f32 (M > 1)."""
    if not x.is_cuda:
        return qgemm_int8_plain(x, wq, scales)
    K, N = _check_cuda("qgemm_int8", x, wq, scales)
    M = x.shape[0]
    xf = x.float().contiguous()
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    err = _ext.load().qgemm_int8(xf.data_ptr(), wq.data_ptr(), scales.data_ptr(),
                                 out.data_ptr(), M, K, N, _ext.stream_ptr(x))
    qgemm_int8.launches += 1
    _ext.check("qgemm_int8", err)
    return out


qgemv_int8.launches = 0
qgemm_int8.launches = 0


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (or [K]) @ dequant(wq [K, N], scales [K/32, N]) -> f32.
    M == 1 takes the GEMV (x rounded to bf16, as on the TPU); M > 1 the
    f32 GEMM."""
    if x.ndim == 1:
        return quantized_matmul(x[None], wq, scales)[0]
    if x.shape[0] == 1:
        return qgemv_int8(x, wq, scales)
    return qgemm_int8(x, wq, scales)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Dense-or-quantized linear: p is {"w": [K, N]} or {"wq", "scales"}.
    A tile-padded weight returns its padded columns; the caller slices."""
    if "wq" in p:
        return quantized_matmul(x, p["wq"], p["scales"])
    return x @ p["w"].to(x.dtype)
