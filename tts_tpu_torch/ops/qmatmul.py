"""Weights-quantized matmul: activations x int8 or packed int4 block-quantized
weights.

Counterpart of `tts_tpu/ops/qmatmul.py`.  Layouts at the public functions are
the JAX package's, with one scale per 32-row block and column, `scales`
[K/32, N], stored here as float16 (the GGUF block `d` is f16, so this is
exact):
  int8 (Q8_0, Q5_0, and Q4_0 that cannot pack):  `wq` int8 [K, N]
  int4 (Q4_0 with K % 64 == 0):  `wq4` int8 [K/2, N]; packed[i, n] holds
      row i in the low nibble and row i + K/2 in the high nibble, both
      signed 4-bit, so unpacking is a concatenation, not an interleave.
`linear_format` is the one home of that eligibility rule.

Four hand-written Hopper kernels replace the TPU's Pallas kernels:
`qgemv_int8` / `qgemm_int8` (csrc/qmatmul.cu; were `_qmv_kernel` /
`_qmm_kernel`) and `qgemv_int4` / `qgemm_int4` (csrc/qmatmul4.cu; were
`_qmv4_kernel` / `_qmm4_kernel`).  The GEMVs serve M == 1 (every decode
step) with x rounded to bf16, as the TPU kernels feed bf16 activations to
the MXU, in one launch whose geometry `gemv_plan` sets; the GEMMs serve
M > 1 (prefill), both on the tensor cores in one kernel whose geometry
`gemm_plan` sets: bf16 x as it is (one product), f32 x to f32 accuracy
(split into two bf16 terms).  Each wrapper runs its
plain PyTorch version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.

Not ported, because each exists only for the TPU: the uint16 f16-bit scale
trick (`_f16_bits_to_f32`; Mosaic rejects f16 operands), the block-diagonal
activation expansion (`_block_diag_x`; feeds the MXU), and the VMEM tile
policy (`_pick_tiles`, `_auto_tile_n`, the `TTS_TPU_BLOCKDIAG_*` knobs).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tts_tpu_torch.core.gguf import GGMLType, GGUFTensor
from tts_tpu_torch.core.quant import Q4_0_BLOCK_BYTES
from tts_tpu_torch.ops import _ext

QBLOCK = 32
_GEOMETRY = _ext.GEOMETRY   # the kernels' launch geometry (nvcc gets it as -D defines)
# the GEMVs: weight blocks a CTA takes at most where the column tiles alone
# fill the card (gemv_plan)
_GEMV_WAVE_BLOCKS = 48
# the GEMMs' M tiles (csrc/qmatmul.cuh launch_qgemm)
_GEMM_M_TILES = (8, 16, 32, 64)
# output columns dequantized at a time by the plain versions: the
# temporaries stay small at the 157k-wide lm_head
_PLAIN_COLS = 2048


def linear_format(tensor) -> str | None:
    """How a GGUF linear [out, in] is stored on the device: "wq4" (packed
    int4: Q4_0 with in % 64 == 0, the nibble split needs it), "wq" (int8:
    Q8_0, Q5_0 and any other Q4_0 with in % 32 == 0), or None (dense)."""
    if not isinstance(tensor, GGUFTensor) or tensor.shape[1] % QBLOCK:
        return None
    if tensor.ggml_type == GGMLType.Q4_0 and tensor.shape[1] % (2 * QBLOCK) == 0:
        return "wq4"
    if tensor.ggml_type in (GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_0):
        return "wq"
    return None


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
    dim to a multiple of `tile_n` (the Orpheus lm_head: 1024).  Which Q4_0
    tensors take this layout rather than int4 is `linear_format`'s rule."""
    values, scales = tensor.to_int8_scales()
    out_dim, in_dim = values.shape
    wq = np.ascontiguousarray(values.T)
    sc = np.ascontiguousarray(scales.reshape(out_dim, in_dim // QBLOCK).T).astype(np.float16)
    if pad_n:
        wq, sc = _pad_n(wq, tile_n), _pad_n(sc, tile_n)
    return {"wq": wq, "scales": sc}


def pack_q4_nibbles(values: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], shape [K, N] (K even) -> packed int8 [K/2, N]:
    row i in the low nibble, row i + K/2 in the high nibble."""
    K = values.shape[0]
    if K % 2:
        raise ValueError(f"pack_q4_nibbles: K must be even, got {K}")
    u = values.view(torch.uint8) & 0xF
    return (u[: K // 2] | (u[K // 2:] << 4)).view(torch.int8)


def pack_q4_weight(tensor, pad_n: bool = False, tile_n: int = 256, device="cpu",
                   timings: dict | None = None) -> dict:
    """GGUFTensor (Q4_0, [out, in], in % 64 == 0) -> {"wq4": int8 [in/2,
    out], "scales": float16 [in/32, out]} on `device`: the raw blocks (0.5625
    bytes per weight) are uploaded and unpacked there with torch ops only.
    `pad_n` as in `pack_q8_weight`.  `timings`, if given, adds the seconds
    of the upload to "upload_s" and of the unpacking to "pack_s"."""
    timings = {} if timings is None else timings
    out_dim, in_dim = tensor.shape
    t0 = time.perf_counter()
    raw = torch.from_numpy(tensor.raw().copy()).to(device)
    t1 = time.perf_counter()
    blocks = raw.view(-1, Q4_0_BLOCK_BYTES)
    d = blocks[:, :2].contiguous().view(torch.float16).view(out_dim, in_dim // QBLOCK)
    qs = blocks[:, 2:].view(out_dim, in_dim // QBLOCK, 16)
    # element j of a block is nibble q of qs[j % 16] (low, then high): q - 8
    values = torch.cat([qs & 0xF, qs >> 4], dim=-1).view(torch.int8).view(out_dim, in_dim) - 8
    wq4 = pack_q4_nibbles(values.t()).contiguous()
    scales = d.t().contiguous()
    pad = (-out_dim) % tile_n if pad_n else 0
    if pad:
        wq4 = torch.nn.functional.pad(wq4, (0, pad))
        scales = torch.nn.functional.pad(scales, (0, pad))
    if wq4.is_cuda:
        torch.cuda.synchronize(wq4.device)
    timings["upload_s"] = timings.get("upload_s", 0.0) + t1 - t0
    timings["pack_s"] = timings.get("pack_s", 0.0) + time.perf_counter() - t1
    return {"wq4": wq4, "scales": scales}


def load_linear(tensor, device="cpu", timings: dict | None = None) -> dict | None:
    """A GGUF linear [out, in] as `linear_format` stores it on `device`:
    {"wq", "scales"} (int8, packed on the host) or {"wq4", "scales"}
    (packed int4, unpacked on `device`); None for a dense one, which the
    caller loads.  `timings`, if given, adds packing and upload seconds
    to "pack_s" and "upload_s"."""
    timings = {} if timings is None else timings
    fmt = linear_format(tensor)
    if fmt == "wq4":
        return pack_q4_weight(tensor, device=device, timings=timings)
    if fmt != "wq":
        return None
    t0 = time.perf_counter()
    p = pack_q8_weight(tensor)
    t1 = time.perf_counter()
    out = {k: torch.from_numpy(v).to(device) for k, v in p.items()}
    timings["pack_s"] = timings.get("pack_s", 0.0) + t1 - t0
    timings["upload_s"] = timings.get("upload_s", 0.0) + time.perf_counter() - t1
    return out


# ---------------------------------------------------------- plain versions ---
def _expand_scales(scales: torch.Tensor) -> torch.Tensor:
    return scales.float().repeat_interleave(QBLOCK, dim=0)


def _dequant_int8(wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return wq.float() * _expand_scales(scales)


def _dequant_int4(wq4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """packed [K/2, n] -> f32 [K, n]: the int16 widening sign-extends each
    byte, so an arithmetic >> 4 gives the signed high nibble."""
    p = wq4.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    return torch.cat([lo, p >> 4]).float() * _expand_scales(scales)


def _dequant_matmul(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                    dequant) -> torch.Tensor:
    """f32 x @ dequant(w, scales), `_PLAIN_COLS` output columns at a time."""
    N = w.shape[1]
    out = torch.empty((x.shape[0], N), dtype=torch.float32, device=x.device)
    for n0 in range(0, N, _PLAIN_COLS):
        sl = slice(n0, n0 + _PLAIN_COLS)
        out[:, sl] = x @ dequant(w[:, sl], scales[:, sl])
    return out


def qgemv_int8_plain(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] -> [1, N] f32.  x is rounded to bf16 first, as the TPU
    kernel rounds its block-diagonal activations."""
    return _dequant_matmul(x.to(torch.bfloat16).float(), wq, scales, _dequant_int8)


def qgemm_int8_plain(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] -> [M, N] f32, all in f32 (bf16 x converts exactly)."""
    return _dequant_matmul(x.float(), wq, scales, _dequant_int8)


def qgemv_int4_plain(x: torch.Tensor, wq4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] @ dequant(wq4 [K/2, N]) -> [1, N] f32, x rounded to bf16."""
    return _dequant_matmul(x.to(torch.bfloat16).float(), wq4, scales, _dequant_int4)


def qgemm_int4_plain(x: torch.Tensor, wq4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq4 [K/2, N]) -> [M, N] f32, all in f32."""
    return _dequant_matmul(x.float(), wq4, scales, _dequant_int4)


# ------------------------------------------------------------------ kernels ---
def _check_cuda(name: str, x, w, scales, packed: bool) -> tuple[int, int]:
    """(K, N) of a kernel call, or ValueError for anything the kernel does
    not take.  `packed`: w is int4 [K/2, N] (needs K % 64 == 0)."""
    rows, N = w.shape
    K = 2 * rows if packed else rows
    kblock = 2 * QBLOCK if packed else QBLOCK
    if not (w.is_cuda and scales.is_cuda and x.device == w.device == scales.device):
        raise ValueError(f"{name}: x, weights and scales must be on one CUDA device")
    if w.dtype != torch.int8 or scales.dtype != torch.float16:
        raise ValueError(f"{name}: weights must be int8 and scales float16")
    if not (w.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: weights and scales must be contiguous")
    if w.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError(f"{name}: weights and scales must start 16-byte aligned "
                         "(vector loads)")
    if K % kblock or N % 16 or tuple(scales.shape) != (K // QBLOCK, N):
        raise ValueError(f"{name}: needs K % {kblock} == 0, N % 16 == 0, scales "
                         f"[K/32, N]; got weights {tuple(w.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if x.shape[-1] != K:
        raise ValueError(f"{name}: x has K={x.shape[-1]}, weights have K={K}")
    return K, N


def gemv_plan(K: int, N: int, sms: int, packed: bool) -> tuple[int, int, int]:
    """(tile_n, splits, weight blocks per split) of one GEMV call
    (`qgemv_int8`, or `qgemv_int4` when `packed`) at x [1, K] on a card of
    `sms` SMs; the kernel's grid is (splits, N / tile_n column tiles), and
    the splits of a column tile are one thread-block cluster.  A CTA takes
    GEMV_TILE_N columns, and K splits into ranges of whole 32-row weight
    blocks (packed blocks for int4: a packed row pairs x columns k and
    K/2 + k), a power of two of them up to a cluster's worth:
      - where the column tiles alone fill the card, only as far as keeps a
        CTA at `_GEMV_WAVE_BLOCKS` blocks at most (a long CTA leaves a long
        tail in the last wave);
      - else as far as leaves at most one CTA per SM: the busiest SM sets
        the time, and two CTAs on one SM take as long as one with twice
        the blocks;
    and at least as far as keeps each CTA's slice of x within GEMV_MAX_X
    elements.  On the H100 this ran faster at every Orpheus-3B shape than
    splitting to at least one CTA per SM, and clusters of 3, 5, 6 or 7
    CTAs ran slower than of 2, 4 or 8 (PERF.md, PR 4; gemv_timing.py)."""
    rows = 2 * QBLOCK if packed else QBLOCK          # x elements per weight block
    nblk = K // rows
    tile_n = _GEOMETRY["GEMV_TILE_N"]
    tiles = -(-N // tile_n)
    most = min(_GEOMETRY["GEMV_MAX_CLUSTER"], nblk)
    splits = 1
    while 2 * splits <= most and (-(-nblk // splits) > _GEMV_WAVE_BLOCKS if tiles >= sms
                                  else 2 * splits * tiles <= sms):
        splits *= 2
    splits = max(splits, -(-K // _GEOMETRY["GEMV_MAX_X"]))
    if splits > _GEOMETRY["GEMV_MAX_CLUSTER"]:
        raise ValueError(f"GEMV: K={K} needs {splits} splits of x, a cluster holds "
                         f"{_GEOMETRY['GEMV_MAX_CLUSTER']}")
    per = -(-nblk // splits)
    return tile_n, -(-nblk // per), per


def gemm_plan(M: int, K: int, N: int, sms: int, packed: bool) -> tuple[int, int, int, int]:
    """(m_tile, tile_n, splits, weight blocks per split) of one GEMM call
    (`qgemm_int8`, or `qgemm_int4` when `packed`) at x [M, K] on a card of
    `sms` SMs; the kernel's grid is (N / tile_n, M / m_tile, splits).  The
    M tile is the smallest of 8-64 tokens that holds M.  K splits into
    ranges of whole 32-row weight blocks (packed blocks for int4: a packed
    row pairs x columns k and K/2 + k), as many as one wave of resident
    CTAs holds (then at least `sms` CTAs, where K allows), each range at
    least the format's ring depth.  The narrow M tiles take 256 weight
    columns per CTA (each weight row read in 256-byte runs) where that
    still gives 1.5 CTAs per SM, else 128.  The depth, the CTAs per SM and
    the wide-tile limit are each format's own (`_ext.GEOMETRY` G8_* and
    G4_*): an int8 block meets 32 x columns, a packed one 64."""
    fmt = "G4" if packed else "G8"
    m_tile = next((t for t in _GEMM_M_TILES if M <= t), _GEMM_M_TILES[-1])
    nblk = K // (2 * QBLOCK if packed else QBLOCK)
    per_sm = _GEOMETRY[f"{fmt}_CTAS_PER_SM_8" if m_tile == 8 else f"{fmt}_CTAS_PER_SM"]
    tiles_n = (256, 128) if m_tile <= _GEOMETRY[f"{fmt}_WIDE_TOKENS"] else (128,)
    for tile_n in tiles_n:
        ctas = -(-N // tile_n) * -(-M // m_tile)
        per = -(-nblk // max(1, min(per_sm * sms // ctas, nblk // _GEOMETRY[f"{fmt}_STAGES"])))
        splits = -(-nblk // per)
        if 2 * ctas * splits >= 3 * sms:
            break
    return m_tile, tile_n, splits, per


def _gemv(name: str, x, w, scales, packed: bool) -> torch.Tensor:
    """One launch: the kernel reads x in bf16 or f32 (rounding it to bf16)
    and adds the K splits inside the launch."""
    K, N = _check_cuda(name, x, w, scales, packed)
    if x.shape[0] != 1:
        raise ValueError(f"{name}: M must be 1, got {x.shape[0]}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start 16-byte aligned (vector loads)")
    _, splits, per = gemv_plan(K, N, _ext.sm_count(x.device.index), packed)
    out = torch.empty((1, N), device=x.device, dtype=torch.float32)
    err = getattr(_ext.load(), name)(x.data_ptr(), x.dtype == torch.float32, w.data_ptr(),
                                     scales.data_ptr(), out.data_ptr(), K, N, splits, per,
                                     _ext.stream_ptr(x))
    _ext.check(name, err)
    return out


def _gemm(name: str, x, w, scales, packed: bool) -> torch.Tensor:
    """One kernel, plus the split-K pass where K splits: the kernel reads x
    in bf16 (one product) or f32 (split into bf16 hi + lo, two products)."""
    K, N = _check_cuda(name, x, w, scales, packed)
    M = x.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start 16-byte aligned (asynchronous copies)")
    m_tile, tile_n, splits, per = gemm_plan(M, K, N, _ext.sm_count(x.device.index), packed)
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    partial = (torch.empty((splits, M, N), device=x.device, dtype=torch.float32)
               if splits > 1 else out)
    err = getattr(_ext.load(), name)(x.data_ptr(), x.dtype == torch.float32, w.data_ptr(),
                                     scales.data_ptr(), partial.data_ptr(), out.data_ptr(), M, K,
                                     N, m_tile, tile_n, splits, per, _ext.stream_ptr(x))
    _ext.check(name, err)
    return out


def qgemv_int8(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] @ dequant(wq, scales) -> [1, N] f32 (M == 1)."""
    if not x.is_cuda:
        return qgemv_int8_plain(x, wq, scales)
    out = _gemv("qgemv_int8", x, wq, scales, packed=False)
    qgemv_int8.launches += 1
    return out


def qgemm_int8(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq, scales) -> [M, N] f32 (M > 1)."""
    if not x.is_cuda:
        return qgemm_int8_plain(x, wq, scales)
    out = _gemm("qgemm_int8", x, wq, scales, packed=False)
    qgemm_int8.launches += 1
    return out


def qgemv_int4(x: torch.Tensor, wq4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [1, K] @ dequant(wq4 [K/2, N], scales) -> [1, N] f32 (M == 1)."""
    if not x.is_cuda:
        return qgemv_int4_plain(x, wq4, scales)
    out = _gemv("qgemv_int4", x, wq4, scales, packed=True)
    qgemv_int4.launches += 1
    return out


def qgemm_int4(x: torch.Tensor, wq4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq4 [K/2, N], scales) -> [M, N] f32 (M > 1)."""
    if not x.is_cuda:
        return qgemm_int4_plain(x, wq4, scales)
    out = _gemm("qgemm_int4", x, wq4, scales, packed=True)
    qgemm_int4.launches += 1
    return out


qgemv_int8.launches = 0
qgemm_int8.launches = 0
qgemv_int4.launches = 0
qgemm_int4.launches = 0


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (or [K]) @ dequant(wq [K, N], scales [K/32, N]) -> f32.
    M == 1 takes the GEMV (x rounded to bf16, as on the TPU); M > 1 the
    GEMM (f32 sums of x as given, bf16 or f32)."""
    if x.ndim == 1:
        return quantized_matmul(x[None], wq, scales)[0]
    if x.shape[0] == 1:
        return qgemv_int8(x, wq, scales)
    return qgemm_int8(x, wq, scales)


def quantized_matmul_q4(x: torch.Tensor, wq4: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (or [K]) @ dequant(packed wq4 [K/2, N], scales [K/32, N]) ->
    f32, routed as `quantized_matmul` routes the int8 layout."""
    if x.ndim == 1:
        return quantized_matmul_q4(x[None], wq4, scales)[0]
    if x.shape[0] == 1:
        return qgemv_int4(x, wq4, scales)
    return qgemm_int4(x, wq4, scales)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Dense-or-quantized linear: p is {"w": [K, N]}, {"wq", "scales"} (int8)
    or {"wq4", "scales"} (packed int4).  A tile-padded weight returns its
    padded columns; the caller slices."""
    if "wq4" in p:
        return quantized_matmul_q4(x, p["wq4"], p["scales"])
    if "wq" in p:
        return quantized_matmul(x, p["wq"], p["scales"])
    return x @ p["w"].to(x.dtype)


def apply_linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x [..., K] through a loader-made linear (`linear`'s dicts), leading
    dims flattened: M == 1 rows take the GEMV, M > 1 the GEMM.  Returns
    x's dtype, as the JAX package's `apply_linear` does."""
    lead = x.shape[:-1]
    out = linear(x.reshape(-1, x.shape[-1]), p)
    return out.reshape(*lead, out.shape[-1]).to(x.dtype)
