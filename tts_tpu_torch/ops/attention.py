"""Single-token decode attention (Orpheus's GQA flash-decode, Parler's
prefix read) and int8 KV quantization.

Counterpart of `tts_tpu/ops/attention.py`.  `flash_decode` is the wrapper of
the hand-written Hopper kernel (csrc/attention.cu), which replaces the TPU's
`_decode_attn_dyn_kernel`; `flash_decode_plain` is its plain PyTorch version,
the same chunked online softmax with bf16 rounding in the same places, and
runs only for tensors on the CPU.  `prefix_attention` is the wrapper of
csrc/prefix_attention.cu, Parler's and Dia's decode-step self-attention in
f32 over the live prefix of the cache (Parler's position-major, Dia's
head-major GQA; no TPU kernel: the JAX package reads the whole cache under a
mask there); its plain version, `prefix_attention_plain`, is that masked
read.  `attend` is the plain attention Parler runs everywhere else.
"""

from __future__ import annotations

import math

import torch

from tts_tpu_torch.ops import _ext

S_CHUNK = 512                                 # the plain version's (and the TPU kernel's) chunk
KERNEL_CHUNK = _ext.GEOMETRY["FD_CHUNK"]      # positions per CTA of the Hopper kernel
_MAX_G = _ext.GEOMETRY["FD_MAX_G"]            # query heads per KV head, at most
_MAX_S = _ext.GEOMETRY["FD_MAX_S"]            # cache positions, at most
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


def arrival_counters(n_kv_heads: int, device) -> torch.Tensor:
    """The zeroed int32 [n_kv_heads] arrival counters that `flash_decode`
    needs on the card: one set per KV cache, allocated with it and so
    outside any CUDA-graph capture.  Every launch leaves them at zero; the
    launches that share a set must run in one stream's order."""
    return torch.zeros(n_kv_heads, dtype=torch.int32, device=device)


def flash_decode(q, k_cache, v_cache, pos, k_scale=None, v_scale=None, counters=None):
    """q [Hq, hs] f32, cache [Hkv, S, hs] bf16 (or int8 with f32 scales
    [Hkv, S]), pos an int32 device tensor -> [Hq, hs] f32.  The kernel reads
    pos on the device and never reads cache rows past it.  On the card it
    needs the cache's `arrival_counters` (the last CTA of each head to
    finish combines the head's chunks); the CPU ignores them."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, pos, k_scale, v_scale)
    Hq, hs = q.shape
    Hkv, S, hs_k = k_cache.shape
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    if counters is None:
        raise ValueError("flash_decode: on the card it needs the KV cache's arrival "
                         "counters (arrival_counters(Hkv, device))")
    tensors = [q, k_cache, v_cache, pos, counters] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CUDA device")
    if (hs != 128 or hs_k != 128 or S % S_CHUNK or S > _MAX_S or Hq % Hkv
            or Hq // Hkv > _MAX_G):
        raise ValueError(f"flash_decode: needs head size 128, S % 512 == 0, S <= {_MAX_S} "
                         f"and 1-{_MAX_G} query heads per KV head; got q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    if (q.dtype != torch.float32 or k_cache.dtype != kv_dtype or v_cache.dtype != kv_dtype
            or pos.dtype != torch.int32 or pos.numel() != 1):
        raise ValueError("flash_decode: q f32, cache bf16 (int8 with scales), pos int32 [1]")
    if counters.dtype != torch.int32 or counters.numel() < Hkv:
        raise ValueError(f"flash_decode: counters must be int32 [>= {Hkv}]")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (Hkv, S) or tuple(v_scale.shape) != (Hkv, S)):
        raise ValueError("flash_decode: k_scale/v_scale must be f32 [Hkv, S]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[1:3] + tensors[5:]):
        raise ValueError("flash_decode: cache and scales must start 16-byte aligned "
                         "(asynchronous copies)")
    G, nchunks = Hq // Hkv, S // KERNEL_CHUNK
    part_m = torch.empty((Hkv, nchunks, G), device=q.device)
    part_l = torch.empty((Hkv, nchunks, G), device=q.device)
    part_acc = torch.empty((Hkv, nchunks, G, hs), device=q.device)
    out = torch.empty((Hq, hs), device=q.device)
    err = _ext.load().flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        pos.data_ptr(), counters.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), Hq, Hkv, S, int(quant),
        1.0 / (hs ** 0.5), _ext.stream_ptr(q))
    flash_decode.launches += 1
    _ext.check("flash_decode", err)
    return out


flash_decode.launches = 0


def attend(q, k, v, mask):
    """q [T, H, hs] f32 against k/v [n, H, hs] (any float dtype, read as
    f32) under an additive mask [T, n] (or None) -> [T, H * hs] f32, as
    batched products over the heads (fewer host ops than einsum's)."""
    logits = torch.matmul(q.transpose(0, 1), k.float().permute(1, 2, 0)) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)                              # [H, T, n]
    return torch.matmul(w, v.float().transpose(0, 1)).transpose(0, 1).reshape(q.shape[0], -1)


def prefix_attention_plain(q, k_cache, v_cache, pos, scale=None):
    """The read the kernel replaces, as the JAX package's decode steps make
    it: q against every slot of one cache layer under the additive mask, 0
    where key_pos <= pos and -1e9 past it, the logits times `scale` (None:
    divided by sqrt(hs), as `attend` does).  Two layouts: position-major
    (Parler) q [1, H, hs] and cache [S, H, hs] -> [1, H * hs]; head-major
    GQA (Dia) q [B, Hq, hs] and cache [B, Hkv, S, hs] -> [B, Hq * hs],
    query head h of row b reading KV head h // (Hq / Hkv) of row b.  A
    masked key weighs exactly 0 in f32 while its logit is finite."""
    hs = q.shape[-1]
    if k_cache.dim() == 3:                          # [S, H, hs]: one row of H heads
        qg, k = q.transpose(0, 1), k_cache.float().permute(1, 2, 0)
        v = v_cache.float().transpose(0, 1)
    else:                                           # [B, Hkv, S, hs]
        B, Hkv = k_cache.shape[:2]
        qg, k, v = q.reshape(B, Hkv, -1, hs), k_cache.float().transpose(2, 3), v_cache.float()
    key_pos = torch.arange(k.shape[-1], device=q.device)
    mask = torch.where(key_pos[None, :] <= pos[:, None], 0.0, -1e9)
    logits = torch.matmul(qg, k)
    logits = logits / math.sqrt(hs) if scale is None else logits * scale
    w = torch.softmax(logits + mask, dim=-1)
    return torch.matmul(w, v).reshape(q.shape[0], -1)


PA_CHUNK = _ext.GEOMETRY["PA_CHUNK"]          # positions per CTA of the prefix kernel
_PA_MAX_S = _ext.GEOMETRY["PA_MAX_S"]         # cache positions, at most
# the kernel's instances by the cache layer's rank: (head size, query heads
# per KV head); rank 3 is Parler's position-major layer, rank 4 Dia's
# head-major GQA layer (4 query heads per KV head in Dia-1.6B, 2 in the
# tests' tiny Dia)
PA_INSTANCES = {3: ((64, 1),), 4: ((128, 4), (128, 2))}
_PA_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def _prefix_checks(q, k_cache, v_cache, pos):
    """What both routes need: one layer of the cache in bf16 or f32 twice,
    position-major [S, H, hs] with q [1, H, hs] or head-major [B, Hkv, S,
    hs] with q [B, Hq, hs] (Hq a multiple of Hkv), q f32, pos int32 [1],
    all contiguous."""
    if k_cache.dim() == 3:
        fits = q.dim() == 3 and q.shape[0] == 1 and k_cache.shape[1:] == q.shape[1:]
    elif k_cache.dim() == 4:
        B, Hkv, _, hs = k_cache.shape
        fits = (q.dim() == 3 and q.shape[0] == B and q.shape[2] == hs
                and q.shape[1] % Hkv == 0 and q.shape[1] >= Hkv)
    else:
        fits = False
    if not fits or k_cache.shape != v_cache.shape:
        raise ValueError(f"prefix_attention: needs q [1, H, hs] with a cache layer [S, H, hs], "
                         f"or q [B, Hq, hs] with [B, Hkv, S, hs]; got q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if (q.dtype != torch.float32 or k_cache.dtype not in _PA_DTYPES
            or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"prefix_attention: q f32 and a bf16 or f32 cache; got q {q.dtype}, "
                         f"k {k_cache.dtype}, v {v_cache.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (1,):
        raise ValueError(f"prefix_attention: pos must be an int32 tensor [1]; got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache)):
        raise ValueError("prefix_attention: q and the cache layer must be contiguous")


def _prefix_geometry(q, k_cache):
    """(KV heads a launch covers, S, head size, query heads per KV head,
    head-major) of arguments that passed `_prefix_checks`."""
    if k_cache.dim() == 3:
        S, H, hs = k_cache.shape
        return H, S, hs, 1, False
    B, Hkv, S, hs = k_cache.shape
    return B * Hkv, S, hs, q.shape[1] // Hkv, True


def prefix_card_checks(q, k_cache, v_cache, pos, counters):
    """What the kernel needs beyond `_prefix_checks`: one of its instances
    (head size 64 and one query head per KV head position-major, head size
    128 and four or two head-major), S a multiple of its chunk up to its limit, the
    cache's arrival counters (int32, one per KV head of the layer, B * Hkv
    head-major), one device, 16-byte aligned cache rows (asynchronous
    copies)."""
    nkv, S, hs, G, _ = _prefix_geometry(q, k_cache)
    if (hs, G) not in PA_INSTANCES[k_cache.dim()] or S % PA_CHUNK or S > _PA_MAX_S:
        want = " or ".join(f"head size {h} with {g} query head(s) per KV head at rank {r}"
                           for r, inst in PA_INSTANCES.items() for h, g in inst)
        raise ValueError(f"prefix_attention: needs {want}, S % {PA_CHUNK} == 0 and S <= "
                         f"{_PA_MAX_S}; got q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if counters is None:
        raise ValueError("prefix_attention: on the card it needs the KV cache's arrival "
                         f"counters (arrival_counters({nkv}, device))")
    if counters.dtype != torch.int32 or counters.numel() < nkv or not counters.is_contiguous():
        raise ValueError(f"prefix_attention: counters must be int32 [>= {nkv}], contiguous")
    if any(t.device != q.device for t in (k_cache, v_cache, pos, counters)):
        raise ValueError("prefix_attention: all tensors must be on one device")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("prefix_attention: the cache must start 16-byte aligned "
                         "(asynchronous copies)")


def prefix_attention(q, k_cache, v_cache, pos, counters=None, scale=None):
    """A decode step's self-attention over the positions <= pos of one
    cache layer (bf16, or f32 for a dense checkpoint), pos an int32 tensor
    [1] on q's device, the logits times `scale` (None: 1/sqrt(hs)).
    Parler: q [1, H, hs] f32 against its position-major [S, H, hs] ->
    [1, H * hs]; Dia: q [B, Hq, hs] f32 against its head-major [B, Hkv, S,
    hs] -> [B, Hq * hs], query head h of row b reading KV head
    h // (Hq / Hkv) of row b.  On the card one launch reads pos on the
    device and only the live rows, each KV head's once for all its query
    heads, in f32 throughout; it needs the cache's arrival counters (the
    last CTA of each KV head to finish combines the head's chunks).  CPU
    tensors take the plain masked read and ignore the counters."""
    _prefix_checks(q, k_cache, v_cache, pos)
    if not q.is_cuda:
        return prefix_attention_plain(q, k_cache, v_cache, pos, scale)
    prefix_card_checks(q, k_cache, v_cache, pos, counters)
    nkv, S, hs, G, head_major = _prefix_geometry(q, k_cache)
    nchunks = S // PA_CHUNK
    part_m = torch.empty((nkv, nchunks, G), device=q.device)
    part_l = torch.empty((nkv, nchunks, G), device=q.device)
    part_acc = torch.empty((nkv, nchunks, G, hs), device=q.device)
    out = torch.empty((q.shape[0], q.shape[1] * hs), device=q.device)
    err = _ext.load().prefix_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        counters.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), nkv, S, hs, G, int(head_major), _PA_DTYPES[k_cache.dtype],
        1.0 / math.sqrt(hs) if scale is None else float(scale), _ext.stream_ptr(q))
    prefix_attention.launches += 1
    _ext.check("prefix_attention", err)
    return out


prefix_attention.launches = 0


def quantize_kv(x: torch.Tensor):
    """[T, H, hs] -> (int8 values, per-(T, H) f32 scales): absmax/127 per
    head vector; zero vectors get scale 0 (dequantize to exact zeros)."""
    xf = x.float()
    sc = xf.abs().amax(-1) / 127.0
    inv = torch.where(sc > 0, 1.0 / torch.clamp(sc, min=1e-30), 0.0)
    return torch.round(xf * inv[..., None]).to(torch.int8), sc
