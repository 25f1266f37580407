"""Single-token GQA decode attention (flash-decode) and int8 KV quantization.

Counterpart of `tts_tpu/ops/attention.py`.  `flash_decode` is the wrapper of
the hand-written Hopper kernel (csrc/attention.cu), which replaces the TPU's
`_decode_attn_dyn_kernel`; `flash_decode_plain` is its plain PyTorch version,
the same chunked online softmax with bf16 rounding in the same places, and
runs only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from tts_tpu_torch.ops import _ext

S_CHUNK = 512
_MASKED = -1e30


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def flash_decode_plain(q, k_cache, v_cache, pos, k_scale=None, v_scale=None):
    """q [Hq, hs] x head-major cache [Hkv, S, hs] -> [Hq, hs] f32 over
    positions <= pos, walking ceil((pos+1)/512) chunks with an online softmax
    (as the TPU kernel does).  Rows past pos are masked out of both dots."""
    Hq, hs = q.shape
    Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    pos = int(pos)
    scale = 1.0 / (hs ** 0.5)
    qg = _bf16(q.reshape(Hkv, G, hs))
    m = torch.full((Hkv, G, 1), _MASKED, device=q.device)
    l = torch.zeros((Hkv, G, 1), device=q.device)
    acc = torch.zeros((Hkv, G, hs), device=q.device)
    for c in range(pos // S_CHUNK + 1):
        sl = slice(c * S_CHUNK, (c + 1) * S_CHUNK)
        valid = (torch.arange(c * S_CHUNK, (c + 1) * S_CHUNK, device=q.device) <= pos)
        k = k_cache[:, sl].float()
        v = torch.where(valid[None, :, None], v_cache[:, sl].float(), 0.0)
        logits = torch.einsum("hgd,hsd->hgs", qg, k) * scale
        if k_scale is not None:
            logits = logits * k_scale[:, None, sl].float()
        logits = torch.where(valid, logits, _MASKED)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        p_v = p if v_scale is None else torch.where(valid, p * v_scale[:, None, sl].float(), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.einsum("hgs,hsd->hgd", _bf16(p_v), v)
    return (acc / l).reshape(Hq, hs)


def flash_decode(q, k_cache, v_cache, pos, k_scale=None, v_scale=None):
    """q [Hq, hs] f32, cache [Hkv, S, hs] bf16 (or int8 with f32 scales
    [Hkv, S]), pos an int32 device tensor -> [Hq, hs] f32.  The kernel reads
    pos on the device and never reads cache rows past it."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, pos, k_scale, v_scale)
    Hq, hs = q.shape
    Hkv, S, hs_k = k_cache.shape
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    tensors = [q, k_cache, v_cache, pos] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CUDA device")
    if hs != 128 or hs_k != 128 or S % S_CHUNK or Hq % Hkv or Hq // Hkv > 4:
        raise ValueError(f"flash_decode: needs head size 128, S % 512 == 0 and "
                         f"1-4 query heads per KV head; got q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    if (q.dtype != torch.float32 or k_cache.dtype != kv_dtype or v_cache.dtype != kv_dtype
            or pos.dtype != torch.int32 or pos.numel() != 1):
        raise ValueError("flash_decode: q f32, cache bf16 (int8 with scales), pos int32 [1]")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (Hkv, S) or tuple(v_scale.shape) != (Hkv, S)):
        raise ValueError("flash_decode: k_scale/v_scale must be f32 [Hkv, S]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: tensors must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: k/v cache must start 16-byte aligned (vector loads)")
    G, nchunks = Hq // Hkv, S // S_CHUNK
    part_m = torch.empty((Hkv, nchunks, G), device=q.device)
    part_l = torch.empty((Hkv, nchunks, G), device=q.device)
    part_acc = torch.empty((Hkv, nchunks, G, hs), device=q.device)
    out = torch.empty((Hq, hs), device=q.device)
    err = _ext.load().flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        pos.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), Hq, Hkv, S, int(quant), 1.0 / (hs ** 0.5), _ext.stream_ptr(q))
    flash_decode.launches += 1
    _ext.check("flash_decode", err)
    return out


flash_decode.launches = 0


def quantize_kv(x: torch.Tensor):
    """[T, H, hs] -> (int8 values, per-(T, H) f32 scales): absmax/127 per
    head vector; zero vectors get scale 0 (dequantize to exact zeros)."""
    xf = x.float()
    sc = xf.abs().amax(-1) / 127.0
    inv = torch.where(sc > 0, 1.0 / torch.clamp(sc, min=1e-30), 0.0)
    return torch.round(xf * inv[..., None]).to(torch.int8), sc
