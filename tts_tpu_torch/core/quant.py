"""GGML quantization block codecs (Q4_0 / Q5_0 / Q8_0), vectorized in numpy.

The port's own copy of `tts_tpu/core/quant.py` (same functions, same
results).  The loaders turn these blocks into `(int8 values, f32 scales)`
pairs or packed int4 nibbles that feed the quantized matmul kernels (see
tts_tpu_torch/ops/qmatmul.py); the GGUF writer encodes with them.

Block layouts (little-endian), 32 elements per block:
  Q4_0: [f16 d][16B qs]          elem j       = ((qs[j%16] >> 4*(j//16)) & 0xF) - 8, scaled by d
  Q5_0: [f16 d][u32 qh][16B qs]  adds a 5th (high) bit per element from qh
  Q8_0: [f16 d][32 x i8 qs]      elem j       = qs[j] * d
"""

from __future__ import annotations

import numpy as np

QK = 32  # block size for all *_0 formats

# bytes per block
Q4_0_BLOCK_BYTES = 2 + 16
Q5_0_BLOCK_BYTES = 2 + 4 + 16
Q8_0_BLOCK_BYTES = 2 + 32


# ---------------------------------------------------------------------------
# Dequantization (raw bytes -> float32), fully vectorized.
# ---------------------------------------------------------------------------

def dequantize_q4_0(raw: bytes | np.ndarray, n_elements: int) -> np.ndarray:
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q4_0_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    qs = blocks[:, 2:]                                            # [nb,16]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)[:n_elements]


def dequantize_q5_0(raw: bytes | np.ndarray, n_elements: int) -> np.ndarray:
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q5_0_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)       # [nb,1]
    qh = blocks[:, 2:6].copy().view(np.uint32)                         # [nb,1]
    qs = blocks[:, 6:]                                                 # [nb,16]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts) & 1).astype(np.uint8)                      # [nb,32]
    lo = (qs & 0x0F) | (hbits[:, :16] << 4)
    hi = (qs >> 4) | (hbits[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.int16) - 16
    out = q.astype(np.float32) * d
    return out.reshape(-1)[:n_elements]


def dequantize_q8_0(raw: bytes | np.ndarray, n_elements: int) -> np.ndarray:
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q8_0_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)[:n_elements]


# ---------------------------------------------------------------------------
# Quantization (float32 -> raw bytes).  Matches ggml's reference quantizers:
# scale d = absmax / clip, symmetric round-to-nearest.
# ---------------------------------------------------------------------------

def _pad_to_blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK:
        x = np.pad(x, (0, QK - x.size % QK))
    return x.reshape(-1, QK)


def quantize_q4_0(x: np.ndarray) -> bytes:
    xb = _pad_to_blocks(x)
    amax_idx = np.argmax(np.abs(xb), axis=1)
    maxv = xb[np.arange(len(xb)), amax_idx]            # signed max (ggml keeps sign)
    d = maxv / -8.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip((xb * inv_d[:, None]) + 8.5, 0, 15).astype(np.uint8)
    qs = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    d16 = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return np.concatenate([d16, qs], axis=1).tobytes()


def quantize_q5_0(x: np.ndarray) -> bytes:
    xb = _pad_to_blocks(x)
    amax_idx = np.argmax(np.abs(xb), axis=1)
    maxv = xb[np.arange(len(xb)), amax_idx]
    d = maxv / -16.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip((xb * inv_d[:, None]) + 16.5, 0, 31).astype(np.uint8)
    qs = ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(np.uint8)
    hbits = (q >> 4).astype(np.uint32)                  # [nb,32]
    qh = np.zeros(len(xb), dtype=np.uint32)
    for j in range(32):                                 # 32 fixed iterations, vectorized over blocks
        qh |= hbits[:, j] << np.uint32(j)
    d16 = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return np.concatenate([d16, qh.view(np.uint8).reshape(-1, 4), qs], axis=1).tobytes()


def quantize_q8_0(x: np.ndarray) -> bytes:
    xb = _pad_to_blocks(x)
    amax = np.max(np.abs(xb), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.rint(xb * inv_d[:, None]), -127, 127).astype(np.int8)
    d16 = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return np.concatenate([d16, q.view(np.uint8)], axis=1).tobytes()


# ---------------------------------------------------------------------------
# int8-block views for quantized matmuls: returns (values int8 [n], scales
# f32 [n/QK]) without expanding to float, so weights stay 8-bit on the device.
# ---------------------------------------------------------------------------

def q8_0_to_int8_scales(raw: bytes | np.ndarray, n_elements: int):
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q8_0_BLOCK_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    values = blocks[:, 2:].copy().view(np.int8).reshape(-1)[:n_elements]
    return values, scales


def q4_0_to_int8_scales(raw: bytes | np.ndarray, n_elements: int):
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q4_0_BLOCK_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    values = np.concatenate([lo, hi], axis=1).reshape(-1)[:n_elements]
    return values, scales


def q5_0_to_int8_scales(raw: bytes | np.ndarray, n_elements: int):
    """Q5_0 values span [-16, 15] — exactly int8-representable, so Q5 weights
    stay 8-bit on the device like Q8."""
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, Q5_0_BLOCK_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    qh = blocks[:, 2:6].copy().view(np.uint32)                        # [nb,1]
    qs = blocks[:, 6:]                                                # [nb,16]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts) & 1).astype(np.uint8)                     # [nb,32]
    lo = ((qs & 0x0F) | (hbits[:, :16] << 4)).astype(np.int16) - 16
    hi = ((qs >> 4) | (hbits[:, 16:] << 4)).astype(np.int16) - 16
    values = np.concatenate([lo, hi], axis=1).astype(np.int8).reshape(-1)[:n_elements]
    return values, scales
