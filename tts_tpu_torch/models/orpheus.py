"""Orpheus-3B: a Llama-3.2-3B backbone generating SNAC audio tokens.

Counterpart of `tts_tpu/models/orpheus.py`: 28 layers, GQA (24 query / 8 KV
heads), RMS norms, SiLU-gated MLP, llama-3 scaled RoPE, the voice prompt
frame, and the 7-token frame -> 3 SNAC codebook redistribution.  Quantized
linears stay on the device with f16 block scales, as int8 (Q8_0 / Q5_0) or
packed int4 (Q4_0), by `ops.qmatmul.linear_format`'s rule, and run through
the hand-written kernels of `ops/qmatmul.py`; single-token attention runs
the flash-decode kernel of `ops/attention.py` over a head-major bf16 (or
int8) KV cache.

Decode has the JAX runner's routes: sampled requests take the sequential
loop, greedy ones the speculative loop.  A sequential step is one
`DecodeGraph`, the counterpart of the JAX package's jitted
`orpheus_decode_step`: the body at T = 1, the head and the sampler over
static device buffers (the token, the int32 position advanced in place,
the sampler state, the sampling values as 0-d tensors), captured on the
card as one CUDA graph per KV cache and static (top_k, do_sample,
use_top_p) and replayed once per step, as JAX dispatches its compiled
step; the host reads each token back one step behind.  The speculative
loop drafts by prompt lookup on the host (`ops.spec.ngram_drafts`),
verifies 8 tokens in one forward at the live position and accepts the
agreeing prefix, with one read of the window's argmaxes per forward.
`generate_stream` resumes either loop in 70-token chunks and decodes SNAC
windows held RECEPTIVE_FRAMES behind the head.  The cache is reused
unzeroed: a forward reads only the slots it or an earlier one of its
request wrote.  Eager steps, not captured, remain for the tensor-parallel
runner (its step spans shards), for a runner whose `decode_route` a
caller sets to "eager", and on the CPU, where the same step runs as plain
calls.

Tensor parallelism (`make_tp_context`, the runner's `mesh=`) cuts the
linears over a ("tp",) mesh (`parallel/mesh.py`), as the JAX package's
shard_map islands do: q/k/v/gate/up/head by output columns, o/down by input
rows (their partial products added on the lead device), and the KV cache
by KV heads, each shard running the same kernels on its slice
(`_tp_qlinear`, `_attend_cache`).

Not ported: the prompt buckets (prefill runs the exact prompt length, and
eagerly), the AOT export cache, the JAX loop's on-device `lax.while_loop`
(the host replays one step per token and checks the stop token), and, of
tensor parallelism, the `_TP_MESHES` registry with its `jax.clear_caches`
(the params carry their shards here) and the rule that turns flash and
kv_quant off when a shard holds fewer than 2 KV heads (single-row DMA
stripes are illegal in Mosaic, the TPU kernel compiler; `flash_decode` has
no such limit).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tts_tpu_torch.codecs.snac import SNACDecoder, params_from_jax  # noqa: F401
from tts_tpu_torch.core.gguf import GGMLType, GGUFTensor
from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.ops.attention import S_CHUNK, arrival_counters, flash_decode, quantize_kv
from tts_tpu_torch.ops.qmatmul import linear, linear_format, pack_q4_weight, pack_q8_weight
from tts_tpu_torch.ops.sampling import init_state, sample_tokens
from tts_tpu_torch.ops.spec import SPEC_K, ngram_drafts, spec_enabled
from tts_tpu_torch.parallel.mesh import Shards, named, place, replicated, tree_map
from tts_tpu_torch.runtime.api import (GenerationConfig, TTSError, TTSResponse, TTSRunner,
                                       card_device)
from tts_tpu_torch.runtime.step_graph import CapturedStep, read_behind
from tts_tpu_torch.text.tokenizers import BPETokenizer

ORPHEUS_VOICES = ("zoe", "zac", "jess", "leo", "mia", "julia", "leah")
PREPENDED_TOKENS = (128259, 128000)
APPENDED_TOKENS = (128009, 128260, 128261, 128257)
FRAME_HEAD_MAP = (0, 1, 2, 2, 1, 2, 2)
AUDIO_TOKEN_OFFSET = 128266
# decode steps the host keeps enqueued past the newest token it has read (the
# stop check): at most this many steps run, and are discarded, after a stop
_LOOKAHEAD = 1


@dataclass(frozen=True)
class OrpheusConfig:
    """The JAX package's config without use_flash_attn (decode here always
    takes the flash kernel, under tensor parallelism too: the JAX package
    turns it off where a shard would hold fewer than 2 KV heads, a Mosaic
    limit `flash_decode` does not have) and the BOS/EOS ids, which only the
    tokenizer reads.  `tp` is the tensor-parallel degree that
    `make_tp_context` set: > 1 when the linears are cut into shards."""
    n_layers: int = 28
    hidden_size: int = 3072
    n_attn_heads: int = 24
    n_kv_attn_heads: int = 8
    head_size: int = 128
    vocab_size: int = 156940
    max_context_length: int = 1024
    max_generation_size: int = 2100
    stopping_token_id: int = 128258
    rope_theta: float = 500000.0
    kv_quant: bool = False          # int8 KV cache with per-(head, position) scales
    tp: int = 1
    lenient_codes: bool = False     # random-weight test GGUFs only

    @property
    def cache_length(self) -> int:
        return self.max_context_length + self.max_generation_size

    @staticmethod
    def from_gguf_kv(kv: dict) -> "OrpheusConfig":
        g = lambda k, d: int(kv.get(k, d))
        hidden = g("orpheus.hidden_size", 3072)
        heads = g("orpheus.attn_heads", 24)
        return OrpheusConfig(
            n_layers=g("orpheus.layers", 28),
            hidden_size=hidden,
            n_attn_heads=heads,
            n_kv_attn_heads=g("orpheus.kv_attn_heads", 8),
            head_size=g("orpheus.head_dim", hidden // heads if hidden // heads else 128),
            vocab_size=g("orpheus.vocab_size", 156940),
            stopping_token_id=g("orpheus.stopping_token_id", 128258),
            lenient_codes=bool(g("orpheus.lenient_audio_codes", 0)),
        )


def load_orpheus_params(tensors: dict, cfg: OrpheusConfig, device=None,
                        timings: dict | None = None) -> dict:
    """tensors: name -> GGUFTensor (or numpy array).  Quantized linears
    become, by `linear_format`, {"wq": int8 [in, out], "scales": f16
    [in/32, out]} (Q8_0 / Q5_0, packed on the host) or {"wq4": int8
    [in/2, out], "scales"} (Q4_0: the raw blocks are uploaded and unpacked
    on `device`); q/k/v and gate/up of one layout fuse along the output dim;
    the lm_head pads to 1024 columns.  `timings`, if given, collects packing
    and upload seconds."""
    device = card_device(device)
    timings = {} if timings is None else timings
    timings.setdefault("pack_s", 0.0)
    timings.setdefault("upload_s", 0.0)

    def raw(name):
        t = tensors.get(name)
        if t is None:
            raise KeyError(f"orpheus: missing tensor {name}")
        return t

    def upload(arr, dtype=None):
        t0 = time.perf_counter()
        t = torch.from_numpy(arr).to(device)
        t = t if dtype is None else t.to(dtype)
        timings["upload_s"] += time.perf_counter() - t0
        return t

    def get(name, dtype=torch.float32):
        t = raw(name)
        if isinstance(t, GGUFTensor):
            t = t.to_numpy(np.float16 if t.ggml_type == GGMLType.F16 else np.float32)
        return upload(np.array(t), dtype)

    def lin(name):
        t = raw(name)
        pad_n = name.endswith("lm_head")
        tile = 1024 if pad_n and t.shape[0] >= 65536 else 256
        fmt = linear_format(t)
        if fmt == "wq4":
            return pack_q4_weight(t, pad_n=pad_n, tile_n=tile, device=device, timings=timings)
        if fmt == "wq":
            t0 = time.perf_counter()
            p = pack_q8_weight(t, pad_n=pad_n, tile_n=tile)
            timings["pack_s"] += time.perf_counter() - t0
            return {"wq": upload(p["wq"]), "scales": upload(p["scales"])}
        return {"w": get(name, torch.bfloat16).t().contiguous()}

    def fuse(parts):
        for key in ("wq", "wq4"):
            if all(key in part for part in parts):
                return {k: torch.cat([part[k] for part in parts], dim=1) for k in (key, "scales")}
        return None

    p = {"embd": get("orpheus.embed_tokens", torch.bfloat16),
         "head": lin("orpheus.lm_head"),
         "out_norm": get("orpheus.norm"),
         "rope_factors": get("orpheus.rope_frequencies"),
         "layers": []}
    for l in range(cfg.n_layers):
        L = f"orpheus.layers.{l}"
        layer = {"in_norm": get(f"{L}.input_layernorm"),
                 "q": lin(f"{L}.self_attn.q_proj"), "k": lin(f"{L}.self_attn.k_proj"),
                 "v": lin(f"{L}.self_attn.v_proj"), "o": lin(f"{L}.self_attn.o_proj"),
                 "post_norm": get(f"{L}.post_attention_layernorm"),
                 "gate": lin(f"{L}.mlp.gate_proj"), "up": lin(f"{L}.mlp.up_proj"),
                 "down": lin(f"{L}.mlp.down_proj")}
        qkv = fuse([layer["q"], layer["k"], layer["v"]])
        if qkv is not None:
            layer["qkv"] = qkv
            del layer["q"], layer["k"], layer["v"]
        gateup = fuse([layer["gate"], layer["up"]])
        if gateup is not None:
            layer["gateup"] = gateup
            del layer["gate"], layer["up"]
        p["layers"].append(layer)
    return p


def _qlin_shardable(p: dict, tp: int, out_sharded: bool) -> bool:
    """True if a quantized linear's shards stay kernel-legal under a
    degree-`tp` split: column-parallel cuts N (the scales [K/32, N] the same
    way); row-parallel cuts K, which must keep whole 32-row scale blocks
    per shard, and int4 not at all: its rows pack (k, k + K/2) pairs into
    one byte, which a K split would tear apart."""
    K32, N = p["scales"].shape
    if out_sharded:
        return N % tp == 0
    return K32 % tp == 0 and "wq4" not in p


def orpheus_param_specs(params: dict, tp: int = 1) -> dict:
    """The spec tree (see `parallel.mesh.Sharding`) of tensor parallelism:
    q/k/v/gate/up (fused or not) and the head split by output columns, o
    and down by input rows, dense linears always, quantized ones where
    `_qlin_shardable`; the rest replicated."""
    def lin_spec(p, out_sharded):
        if "w" not in p and not _qlin_shardable(p, max(tp, 1), out_sharded):
            return {k: () for k in p}
        spec = (None, "tp") if out_sharded else ("tp", None)
        return {k: spec for k in p}

    specs = tree_map(lambda _: (), params)
    for L, Ls in zip(params["layers"], specs["layers"]):
        for n in ("q", "k", "v", "gate", "up", "qkv", "gateup"):
            if n in L:
                Ls[n] = lin_spec(L[n], True)
        for n in ("o", "down"):
            Ls[n] = lin_spec(L[n], False)
    specs["head"] = lin_spec(params["head"], True)
    return specs


def _pad_cols(p: dict, mult: int) -> dict:
    """Zero-pad a linear's output columns (and scales) to a multiple of `mult`."""
    pad = (-next(iter(p.values())).shape[1]) % mult
    return p if pad == 0 else {k: torch.nn.functional.pad(t, (0, pad)) for k, t in p.items()}


def _unfuse_for_tp(params: dict, cfg: OrpheusConfig) -> dict:
    """Split the loader's fused qkv and gateup back into their projections:
    a column shard of the fused matrix would cross projection boundaries
    (one shard all of gate, the other all of up).  One device keeps the
    fusion (one launch instead of three)."""
    def split_lin(p, sizes):
        parts = {k: torch.split(t, sizes, dim=1) for k, t in p.items()}
        return [{k: parts[k][i] for k in p} for i in range(len(sizes))]

    Hq, Hkv, hs = cfg.n_attn_heads, cfg.n_kv_attn_heads, cfg.head_size
    layers = []
    for L in params["layers"]:
        L = dict(L)
        if "qkv" in L:
            L["q"], L["k"], L["v"] = split_lin(L.pop("qkv"), [Hq * hs, Hkv * hs, Hkv * hs])
        if "gateup" in L:
            n = L["gateup"]["scales"].shape[1] // 2
            L["gate"], L["up"] = split_lin(L.pop("gateup"), [n, n])
        layers.append(L)
    return {**params, "layers": layers}


def _all_quant_shardable(params: dict, tp: int) -> bool:
    """Every quantized linear must shard for cfg.tp to be set: one that
    cannot keeps the whole model replicated (so Q4_0's row-parallel o and
    down keep a Q4_0 Orpheus at tp = 1, and Q8_0 shards)."""
    for L in params["layers"]:
        for n in ("q", "k", "v", "gate", "up", "qkv", "gateup"):
            if n in L and "w" not in L[n] and not _qlin_shardable(L[n], tp, True):
                return False
        for n in ("o", "down"):
            if "w" not in L[n] and not _qlin_shardable(L[n], tp, False):
                return False
    return "w" in params["head"] or _qlin_shardable(params["head"], tp, True)


def make_tp_context(params: dict, cfg: OrpheusConfig, mesh):
    """Tensor-parallel placement over `mesh` (axis "tp"): returns (params,
    cache, cfg).  Each linear splits per `orpheus_param_specs` into a
    `Shards` of linear dicts, shard j on the mesh's j-th device (the head
    padded to 256 * tp columns first, so every shard stays kernel-legal);
    the KV cache splits by KV heads into a `Shards` of caches, each with
    its own flash-decode counters, when both head counts divide tp, and is
    replicated on the lead device otherwise.  The returned cfg carries tp.

    Where a quantized linear cannot split (`_all_quant_shardable`, as in
    the JAX package) the model stays whole on the lead device, fused, with
    cfg.tp = 1, and a warning says so.  A dense linear whose dims tp does
    not divide raises."""
    tp = mesh.shape["tp"]
    lead = mesh.lead
    split = None
    if tp > 1:
        split = _unfuse_for_tp(params, cfg)
        split = {**split, "head": _pad_cols(split["head"], 256 * tp)}
        if not _all_quant_shardable(split, tp):
            logging.getLogger("tts_tpu_torch").warning(
                "orpheus: a quantized linear does not split over tp=%d (an int4 row-parallel "
                "linear, or a width tp does not divide): the model stays whole on %s", tp, lead)
            split = None
    if split is None:
        params = tree_map(lambda t: place(t, replicated(mesh)), params)
        return params, init_kv_cache(cfg, lead), dataclasses.replace(cfg, tp=1)

    def shard(p, spec):
        placed = {k: place(t, named(mesh, *spec[k])) for k, t in p.items()}
        return Shards({k: v[j] for k, v in placed.items()} for j in range(tp))

    specs = orpheus_param_specs(split, tp)
    layers = []
    for L, Ls in zip(split["layers"], specs["layers"]):
        layers.append({n: shard(v, Ls[n]) if isinstance(v, dict) else place(v, replicated(mesh))
                       for n, v in L.items()})
    params = {**{k: place(v, replicated(mesh)) for k, v in split.items()
                 if k not in ("layers", "head")},
              "head": shard(split["head"], specs["head"]), "layers": layers}
    cfg = dataclasses.replace(cfg, tp=tp)
    Hq, Hkv = cfg.n_attn_heads, cfg.n_kv_attn_heads
    if Hkv % tp or Hq % tp:
        return params, init_kv_cache(cfg, lead), cfg
    local = dataclasses.replace(cfg, n_attn_heads=Hq // tp, n_kv_attn_heads=Hkv // tp)
    return params, Shards(init_kv_cache(local, d) for d in mesh.axis_devices("tp")), cfg


def _device(p: dict) -> torch.device:
    return next(iter(p.values())).device


def _tp_qlinear(x: torch.Tensor, shards: Shards, *, col: bool) -> torch.Tensor:
    """A linear cut into shards, on x [T, K] on the lead device.  Column-
    parallel: each shard's kernel makes its output columns, which are
    concatenated; row-parallel: shard j takes x's j-th K slice, and the
    partial products are added in shard order."""
    if col:
        return torch.cat([linear(x.to(_device(s)), s).to(x.device) for s in shards], dim=-1)
    k = x.shape[-1] // len(shards)
    out = None
    for j, s in enumerate(shards):
        part = linear(x[:, j * k:(j + 1) * k].to(_device(s)).contiguous(), s).to(x.device)
        out = part if out is None else out + part
    return out


def _lin(x: torch.Tensor, p, *, col: bool) -> torch.Tensor:
    """`linear`, or `_tp_qlinear` for a linear that make_tp_context cut."""
    if isinstance(p, Shards):
        return _tp_qlinear(x, p, col=col)
    return linear(x, p)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    n = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (n * w).to(x.dtype)


def _rope_tables(positions, rope_factors, theta: float, hs: int):
    """cos/sin [T, 1, hs/2] of llama-3 scaled RoPE (the GGUF stores the
    per-dim frequency divisors), shared by every layer of one forward."""
    freqs = 1.0 / (theta ** (torch.arange(0, hs, 2, dtype=torch.float32,
                                          device=positions.device) / hs))
    ang = positions[:, None].float() * (freqs / rope_factors)[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [T, H, hs]; NEOX convention: rotate (x[i], x[i + hs/2]) pairs."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h].float(), x[..., h:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _head_logits(x: torch.Tensor, params: dict, cfg: OrpheusConfig) -> torch.Tensor:
    """lm_head on one row [H] -> [vocab] (the GEMV), or on the rows [T, H]
    of a verify forward -> [T, vocab] (the GEMM); slices off the tile
    padding."""
    if x.ndim == 1:
        return _lin(x.float()[None], params["head"], col=True)[0, : cfg.vocab_size]
    return _lin(x.float(), params["head"], col=True)[:, : cfg.vocab_size]


def padded_cache_length(cfg: OrpheusConfig) -> int:
    return -(-cfg.cache_length // S_CHUNK) * S_CHUNK


def init_kv_cache(cfg: OrpheusConfig, device=None) -> dict:
    """Head-major cache [L, Hkv, S, hs], S padded to the kernel's 512 chunk;
    with cfg.kv_quant int8 k/v plus f32 scales ks/vs [L, Hkv, S]; and the
    flash-decode arrival counters of this cache, which every layer's launch
    leaves at zero.  Entries past a request's position are never read, so
    it is reused unzeroed."""
    device = card_device(device)
    shape = (cfg.n_layers, cfg.n_kv_attn_heads, padded_cache_length(cfg), cfg.head_size)
    counters = arrival_counters(cfg.n_kv_attn_heads, device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:3], device=device),
                "vs": torch.zeros(shape[:3], device=device), "counters": counters}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device), "counters": counters}


def _gqa_attention(q, k, v, mask):
    """q [T, Hq, hs] against head-major k/v [Hkv, Tk, hs], in f32, without
    repeating KV heads (the prefill path; no kernel served it on the TPU)."""
    T, Hq, hs = q.shape
    Hkv = k.shape[0]
    qg = q.reshape(T, Hkv, Hq // Hkv, hs).float()
    logits = torch.einsum("qhgd,hkd->hgqk", qg, k.float()) / math.sqrt(hs)
    w = torch.softmax(logits + mask, dim=-1)
    attn = torch.einsum("hgqk,hkd->qhgd", w, v.float())
    return attn.reshape(T, Hq * hs)


def _cache_shards(cache) -> tuple:
    """The KV cache as its shards: one, or make_tp_context's split by KV heads."""
    return tuple(cache) if isinstance(cache, Shards) else (cache,)


def _attend_cache(q, k, v, l: int, caches: tuple, where: list, end: int) -> torch.Tensor:
    """Write K/V of this forward into layer l of the cache and attend: q
    [T, Hq, hs], k/v [T, Hkv, hs] -> [T, Hq * hs] f32 on q's device.  Cache
    shard j holds KV heads j * Hkv / n onwards and takes the matching query
    heads, on its own device; `where[j]` is (positions, slots, mask) there.
    T == 1 runs flash_decode on each shard with the shard's own arrival
    counters (the JAX package's `_flash_decode_tp`); T > 1 attends
    causally over the live slots [0, end)."""
    n = len(caches)
    T, Hq, hs = q.shape
    hq, hkv = Hq // n, k.shape[1] // n
    parts = []
    for j, (c, (positions, slots, mask)) in enumerate(zip(caches, where)):
        d = c["k"].device
        qj, kj, vj = ((q, k, v) if n == 1 else
                      (t[:, j * h:(j + 1) * h].to(d) for t, h in ((q, hq), (k, hkv), (v, hkv))))
        ck, cv = c["k"][l], c["v"][l]
        quant = "ks" in c
        if quant:
            kq, ksc = quantize_kv(kj)
            vq, vsc = quantize_kv(vj)
            cks, cvs = c["ks"][l], c["vs"][l]
            ck.index_copy_(1, slots, kq.transpose(0, 1))
            cv.index_copy_(1, slots, vq.transpose(0, 1))
            cks.index_copy_(1, slots, ksc.t())
            cvs.index_copy_(1, slots, vsc.t())
        else:
            ck.index_copy_(1, slots, kj.transpose(0, 1).to(ck.dtype))
            cv.index_copy_(1, slots, vj.transpose(0, 1).to(cv.dtype))
        if T == 1:
            attn = flash_decode(qj[0].float(), ck, cv, positions, cks if quant else None,
                                cvs if quant else None, c["counters"])
        elif quant:
            attn = _gqa_attention(qj, ck[:, :end].float() * cks[:, :end, None],
                                  cv[:, :end].float() * cvs[:, :end, None], mask)
        else:
            attn = _gqa_attention(qj, ck[:, :end], cv[:, :end], mask)
        parts.append(attn.reshape(T, hq * hs).to(q.device))
    return parts[0] if n == 1 else torch.cat(parts, dim=-1)


def _orpheus_body(params: dict, cfg: OrpheusConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache, start: int = 0) -> torch.Tensor:
    """tokens/positions [T] -> final-normed hidden [T, H] (bf16), writing K/V
    at `positions` into `cache` in place.  T == 1 is a decode step (flash
    kernel; positions is the device int32 position); T > 1 runs at the
    positions start..start+T-1 (the prefill from 0, a verify window) and
    attends causally over the live slots [0, start + T) alone: slots past
    them may hold a rejected draft's K/V and are never read.  Under tensor
    parallelism (params and cache from make_tp_context) the linears and
    the cache are cut into shards and x stays on the lead device."""
    T = tokens.shape[0]
    x = params["embd"][tokens.long()]
    Hq, Hkv, hs = cfg.n_attn_heads, cfg.n_kv_attn_heads, cfg.head_size
    cos, sin = _rope_tables(positions, params["rope_factors"], cfg.rope_theta, hs)
    end = start + T
    mask = None
    if T > 1:
        key_pos = torch.arange(end, device=x.device)
        mask = torch.where(key_pos[None, :] <= positions[:, None], 0.0, -1e9)
    caches = _cache_shards(cache)
    slots = positions.long()
    where = [(positions.to(d), slots.to(d), None if mask is None else mask.to(d))
             for d in (c["k"].device for c in caches)]

    for l, L in enumerate(params["layers"]):
        res = x
        h = _rms(x, L["in_norm"])
        if "qkv" in L:
            qkv = linear(h, L["qkv"]).to(x.dtype)
            q, k, v = torch.split(qkv, [Hq * hs, Hkv * hs, Hkv * hs], dim=-1)
        else:
            q, k, v = (_lin(h, L[n], col=True).to(x.dtype) for n in ("q", "k", "v"))
        q = _rope(q.reshape(T, Hq, hs), cos, sin)
        k = _rope(k.reshape(T, Hkv, hs), cos, sin)
        attn = _attend_cache(q, k, v.reshape(T, Hkv, hs), l, caches, where, end)
        x = res + _lin(attn.to(x.dtype), L["o"], col=False).to(x.dtype)
        res = x
        h = _rms(x, L["post_norm"])
        if "gateup" in L:
            gate, up = linear(h, L["gateup"]).chunk(2, dim=-1)
        else:
            gate, up = _lin(h, L["gate"], col=True), _lin(h, L["up"], col=True)
        h = _lin((torch.nn.functional.silu(gate) * up).to(x.dtype), L["down"], col=False)
        x = res + h.to(x.dtype)
    return _rms(x, params["out_norm"])


def orpheus_prefill(params: dict, cfg: OrpheusConfig, tokens: torch.Tensor,
                    cache: dict) -> torch.Tensor:
    """The exact-length prompt [T] -> logits [vocab] at its last position."""
    positions = torch.arange(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    x = _orpheus_body(params, cfg, tokens, positions, cache)
    return _head_logits(x[-1], params, cfg)


def orpheus_decode_step(params: dict, cfg: OrpheusConfig, token: torch.Tensor,
                        pos: torch.Tensor, cache: dict) -> torch.Tensor:
    """token [1] at device int32 position pos [1] -> logits [vocab]."""
    x = _orpheus_body(params, cfg, token, pos, cache)
    return _head_logits(x[0], params, cfg)


class DecodeGraph(CapturedStep):
    """One sequential decode step over static device buffers: the
    counterpart of the JAX package's jitted `orpheus_decode_step` (body at
    T = 1, head and `sample_tokens`), and keyed as its jit is: one per KV
    cache and static (top_k, do_sample, use_top_p).  `load` fills the
    buffers in place before a request or a chunk: `token` [1], `pos` [1]
    (each step advances it in place), the sampler state `last` / `count`
    [1] and the 0-d f32 temperature, top_p and repetition penalty, which
    the sampler reads as tensors, so a later request's values are the ones
    a replay uses.  `buf` is [token, last, count] after the latest step.

    With `capture` (a card only) the step is captured at its first `run`
    and replayed by every later one (`runtime/step_graph.py`: one host call
    for 28 layers of kernels, the head and the sampler, the generator
    registered with the graph, launch counts kept, TTSError on a failed
    capture); without it `run` calls the same step."""

    label = "orpheus"

    def __init__(self, params: dict, cfg: OrpheusConfig, cache, generator: torch.Generator | None,
                 device, *, top_k: int = 0, do_sample: bool = True, use_top_p: bool = True,
                 capture: bool = False):
        super().__init__(device, generator, top_k=top_k, do_sample=do_sample,
                         use_top_p=use_top_p, capture=capture)
        self.params, self.cfg, self.cache = params, cfg, cache
        with torch.inference_mode():
            self.buf = torch.zeros(3, dtype=torch.int32, device=self.device)
            self.pos = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.token = self.buf[0:1]
        self.state = {"last": self.buf[1:2], "count": self.buf[2:3]}

    def load(self, token: torch.Tensor, pos: int, state: dict, *, temperature: float = 1.0,
             top_p: float = 1.0, repetition_penalty: float = 1.0):
        """Set the buffers for the next step: device copies and fills, no
        host synchronization."""
        with torch.inference_mode():
            self.token.copy_(token.reshape(1))
            self.pos.fill_(pos)
        self._load_sampler(state, temperature, top_p, repetition_penalty)

    def _step(self):
        logits = orpheus_decode_step(self.params, self.cfg, self.token, self.pos, self.cache)
        token, state = self._sample(logits[None])
        self.pos += 1       # in place: the next step reads it in stream order
        self.buf.copy_(torch.cat([token, state["last"], state["count"]]))


def orpheus_decode_loop(params: dict, cfg: OrpheusConfig, first_token: torch.Tensor,
                        start_pos: int, limit: int, cache: dict,
                        generator: torch.Generator | None, sampler_state: dict, *,
                        temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                        repetition_penalty: float = 1.0, do_sample: bool = True,
                        use_top_p: bool = True, step: DecodeGraph | None = None):
    """Sequential decode of up to `limit` tokens after `first_token` [1],
    stopping at (and including) the stop token, as the JAX loop does.
    Returns (tokens list[int], sampler_state after the last token).

    `step` makes each step (`step.run()`): a runner's `DecodeGraph` of this
    key, whose `generator` this is; None makes an uncaptured one for this
    call (eager steps).  The host reads each step's [token, last, count]
    `_LOOKAHEAD` steps behind (`read_behind`) while it checks for the stop
    token."""
    out: list[int] = []
    if limit <= 0 or int(first_token[0]) == cfg.stopping_token_id:
        return out, sampler_state
    device = first_token.device
    if step is None:
        step = DecodeGraph(params, cfg, cache, generator, device, top_k=top_k,
                           do_sample=do_sample, use_top_p=use_top_p)
    elif step.key != (top_k, do_sample, use_top_p) or step.generator is not generator:
        raise ValueError(f"orpheus_decode_loop: the step is keyed {step.key} on its own "
                         f"generator, not {(top_k, do_sample, use_top_p)} on this one")
    step.load(first_token, start_pos, sampler_state, temperature=temperature, top_p=top_p,
              repetition_penalty=repetition_penalty)
    for row in read_behind(step, limit, _LOOKAHEAD):
        out.append(int(row[0]))
        if out[-1] == cfg.stopping_token_id:
            break
    last, count = row[1:].tolist()
    return out, {"last": torch.tensor([last], dtype=torch.int32, device=device),
                 "count": torch.tensor([count], dtype=torch.int32, device=device)}


def orpheus_decode_loop_spec_resume(params: dict, cfg: OrpheusConfig, token: int,
                                    start_pos: int, i0: int, limit: int, cache: dict,
                                    out: np.ndarray, *, k: int = SPEC_K,
                                    force_miss: bool = False):
    """The resumable greedy speculative loop: from emission index `i0`
    (`token` the last token out, whose K/V the first window writes at
    position start_pos) until index `limit` or the stop token.  Each iteration drafts k tokens
    (`ngram_drafts` over `out`), verifies [token, drafts] in one forward at
    positions pos..pos+k, and accepts the longest draft prefix that the
    argmaxes agree with, plus the model's own next token, truncated at the
    first stop token and at `limit`: the tokens are the model's greedy
    outputs, the sequential loop's.  `force_miss` rejects every draft (id
    -1 never equals an argmax; its embedding row wraps to the last, as
    jax's gather does): one token per forward, the floor.

    `out` [max_gen + k + 1] (numpy, stop-filled past the emitted tokens)
    holds every token emitted after the prefill's and takes the new ones in
    place, so the drafter keeps its history across chunks.  A `token` that
    is the stop token emits nothing, as in the sequential loop.  K/V written
    for rejected drafts sit past the accepted position and are written again
    before a query reads them.  Returns (out, index after the last token,
    position after it)."""
    i, pos = i0, start_pos
    device = params["embd"].device
    rows = params["embd"].shape[0]
    S = _cache_shards(cache)[0]["k"].shape[2]
    stop = cfg.stopping_token_id
    while i < limit and token != stop:
        drafts = (np.full(k, -1, np.int32) if force_miss
                  else ngram_drafts(out, token, i, k))
        w = min(k + 1, S - pos)          # a window never runs past the cache
        toks = np.concatenate([[token], drafts])[:w] % rows
        positions = torch.arange(pos, pos + w, dtype=torch.int32, device=device)
        x = _orpheus_body(params, cfg, torch.from_numpy(toks).to(device), positions, cache,
                          start=pos)
        g = _head_logits(x, params, cfg).argmax(-1).to(torch.int32).cpu().numpy()
        n_acc = int(np.cumprod(drafts[:w - 1] == g[:-1]).sum())
        stops = np.nonzero(g[:n_acc + 1] == stop)[0]
        n_emit = int(stops[0]) + 1 if len(stops) else n_acc + 1
        n_emit = min(n_emit, limit - i)
        out[i:i + n_emit] = g[:n_emit]
        token = int(g[n_emit - 1])
        i += n_emit
        pos += n_emit
    return out, i, pos


def spec_out_buffer(cfg: OrpheusConfig, k: int = SPEC_K) -> np.ndarray:
    """The speculative loop's token buffer: max_gen + k + 1 stop tokens."""
    return np.full(cfg.max_generation_size + k + 1, cfg.stopping_token_id, np.int32)


def orpheus_decode_loop_spec(params: dict, cfg: OrpheusConfig, first_token: int,
                             start_pos: int, limit: int, cache: dict, *, k: int = SPEC_K,
                             force_miss: bool = False) -> list[int]:
    """Greedy speculative decode of up to `limit` tokens after `first_token`
    (the prefill's), stopping at (and including) the stop token: the
    sequential greedy loop's tokens."""
    out, i, _ = orpheus_decode_loop_spec_resume(params, cfg, first_token, start_pos, 0, limit,
                                                cache, spec_out_buffer(cfg, k), k=k,
                                                force_miss=force_miss)
    return out[:i].tolist()


def redistribute_output_tokens(tokens: list[int], cfg: OrpheusConfig):
    """7-token frames -> 3 SNAC head streams; frames with out-of-range codes
    are dropped whole (cfg.lenient_codes folds them into range instead)."""
    heads: list[list[int]] = [[], [], []]
    dropped = 0
    for i in range(len(tokens) // 7):
        frame = [int(tokens[i * 7 + ii]) - AUDIO_TOKEN_OFFSET - (ii % 7) * 4096
                 for ii in range(7)]
        if cfg.lenient_codes:
            frame = [t % 4096 for t in frame]
        elif any(t < 0 or t >= 4096 for t in frame):
            dropped += 1
            continue
        for ii, t in enumerate(frame):
            heads[FRAME_HEAD_MAP[ii]].append(t)
    if dropped:
        logging.getLogger("tts_tpu_torch").warning(
            "orpheus: dropped %d frame(s) with out-of-range SNAC codes", dropped)
    return [np.asarray(h, np.int32) for h in heads]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class OrpheusRunner(TTSRunner):
    sample_rate = 24000
    architecture = "orpheus"
    device_arrays = ("params", "_cache")
    device_components = ("snac",)

    def __init__(self, cfg: OrpheusConfig, params: dict, tokenizer: BPETokenizer,
                 snac: SNACDecoder, device=None, mesh=None):
        """`device` defaults to the device the params live on (the card,
        where the loader's default put them).  With a ("tp",) `mesh` the
        runner is tensor-parallel over it (`make_tp_context`, whose cfg it
        keeps) and lives on the mesh's lead device.

        `decode_route` is how sequential steps run: "graph" (a captured
        `DecodeGraph` per key, replayed) for an unsharded runner on a card,
        "eager" for the tensor-parallel runner and on the CPU; a caller may
        set "eager" on the card to compare the two.  The runner owns one
        generator on its device, reseeded per request, which its graphs
        register."""
        self.mesh = mesh
        self._cache = None
        if mesh is not None:
            params, self._cache, cfg = make_tp_context(params, cfg, mesh)
            device = mesh.lead
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.snac = snac
        embd = params.get("embd")
        self.device = torch.device(device if device is not None
                                   else embd.device if embd is not None else "cuda")
        self.capture_trace = False
        self.last_trace: dict = {}
        self.load_timings: dict = {}
        self.decode_route = "graph" if self.device.type == "cuda" and mesh is None else "eager"
        self._generator: torch.Generator | None = None     # made at the first request
        self._steps: dict = {}

    def list_voices(self):
        return list(ORPHEUS_VOICES)

    def _prompt_ids(self, text: str, config: GenerationConfig) -> list[int]:
        if config.voice and config.voice not in ORPHEUS_VOICES:
            raise TTSError(f"Voice '{config.voice}' is not a valid voice for Orpheus.")
        sentence = f"{config.voice}: {text}" if config.voice else text
        ids = (list(PREPENDED_TOKENS) + self.tokenizer.tokenize(sentence)
               + list(APPENDED_TOKENS))
        if len(ids) > self.cfg.max_context_length:
            raise TTSError("The prompt was too large for the default context "
                           "window. Try splitting up or shortening the prompt.")
        return ids

    def _sample_kw(self, config: GenerationConfig) -> dict:
        return dict(temperature=config.temperature, top_k=config.top_k, top_p=config.top_p,
                    repetition_penalty=config.repetition_penalty, do_sample=config.sample,
                    use_top_p=config.top_p < 1.0)

    def _prefill(self, ids: list[int], config: GenerationConfig):
        """Prompt prefill and the first token, drawn from the runner's
        generator reseeded for this request; returns (prefill logits, first
        token [1], generator, sampler state, max_steps)."""
        cfg = self.cfg
        if self._cache is None:
            self._cache = init_kv_cache(cfg, self.device)
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        logits = orpheus_prefill(self.params, cfg, torch.tensor(ids, device=self.device),
                                 self._cache)
        generator = self._generator
        generator.manual_seed(config.seed if config.seed is not None
                              else np.random.randint(0, 2**31 - 1))
        first, state = sample_tokens(generator, logits[None], init_state(1, self.device),
                                     **self._sample_kw(config))
        max_steps = min(config.max_tokens or cfg.max_generation_size, cfg.max_generation_size)
        return logits, first, generator, state, max_steps

    def _decode_step(self, config: GenerationConfig) -> DecodeGraph:
        """The `DecodeGraph` of this request's key on `decode_route`, made
        (and on the "graph" route captured at its first step) once per
        KV cache and params."""
        kw = self._sample_kw(config)
        key = (self.decode_route, kw["top_k"], kw["do_sample"], kw["use_top_p"])
        step = self._steps.get(key)
        if step is None or step.cache is not self._cache or step.params is not self.params:
            step = self._steps[key] = DecodeGraph(
                self.params, self.cfg, self._cache, self._generator, self.device,
                top_k=key[1], do_sample=key[2], use_top_p=key[3],
                capture=self.decode_route == "graph")
        return step

    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        chunk_tokens: int = 70):
        """Yield audio as it is made: the loop runs `chunk_tokens` tokens at
        a time (10 SNAC frames, ~0.85 s of audio) and the SNAC decodes
        bounded windows held RECEPTIVE_FRAMES behind the frame head, with a
        final flush, so the chunks concatenate to generate()'s audio for the
        same tokens.  Greedy requests take the speculative loop chunk by
        chunk (the carried token buffer keeps the drafter's history);
        sampled ones the sequential loop, whose generator and sampler state
        carry across chunks."""
        config = config or GenerationConfig()
        cfg = self.cfg
        ids = self._prompt_ids(text, config)
        stop = cfg.stopping_token_id
        with torch.inference_mode():
            _, first, generator, state, max_steps = self._prefill(ids, config)
        outputs = [int(first[0])]
        pos = len(ids)
        spec = spec_enabled(config)
        out_buf = spec_out_buffer(cfg) if spec else None
        i_cum = 0
        emitted = 0
        seed = config.seed or 0
        while outputs[-1] != stop and len(outputs) < max_steps:
            budget = min(chunk_tokens, max_steps - len(outputs))
            with torch.inference_mode():
                if spec:
                    out_buf, i_new, _ = orpheus_decode_loop_spec_resume(
                        self.params, cfg, outputs[-1], pos, i_cum, i_cum + budget, self._cache,
                        out_buf)
                    new = out_buf[i_cum:i_new].tolist()
                    i_cum = i_new
                else:
                    token = torch.tensor([outputs[-1]], dtype=torch.int32, device=self.device)
                    new, state = orpheus_decode_loop(self.params, cfg, token, pos, budget,
                                                     self._cache, generator, state,
                                                     step=self._decode_step(config),
                                                     **self._sample_kw(config))
            outputs.extend(new)
            pos += len(new)
            heads = redistribute_output_tokens([t for t in outputs if t != stop], cfg)
            target = len(heads[-1]) - self.snac.RECEPTIVE_FRAMES
            if target > emitted:
                audio = self.snac.decode_window(heads, emitted, target, seed=seed)
                emitted = target
                if len(audio):
                    yield audio
            if len(new) < budget:
                break
        heads = redistribute_output_tokens([t for t in outputs if t != stop], cfg)
        if len(heads[-1]) > emitted:
            audio = self.snac.decode_window(heads, emitted, len(heads[-1]), seed=seed)
            if len(audio):
                yield audio

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        cfg = self.cfg
        t0 = time.perf_counter()
        ids = self._prompt_ids(text, config)
        with torch.inference_mode():
            logits, first, generator, state, max_steps = self._prefill(ids, config)
            _sync(self.device)
            t_prefill = time.perf_counter()
            if spec_enabled(config):
                route = "spec"
                rest = orpheus_decode_loop_spec(self.params, cfg, int(first[0]), len(ids),
                                                max_steps - 1, self._cache)
            else:
                step = self._decode_step(config)
                route = step.route
                rest, _ = orpheus_decode_loop(self.params, cfg, first, len(ids), max_steps - 1,
                                              self._cache, generator, state, step=step,
                                              **self._sample_kw(config))
        outputs = [int(first[0])] + rest
        t_decode = time.perf_counter()

        raw = list(outputs)
        while outputs and outputs[-1] == cfg.stopping_token_id:
            outputs = outputs[:-1]
        heads = redistribute_output_tokens(outputs, cfg)
        if self.capture_trace:
            from tts_tpu_torch.utils.trace import logit_stats

            stop = cfg.stopping_token_id
            self.last_trace = {
                "prompt_ids": ids[:24],
                "n_prompt_tokens": len(ids),
                "step0_logits": logit_stats(logits.float().cpu().numpy()),
                "first_token": int(first[0]),
                "tokens_first": outputs[:32],
                "n_tokens": len(outputs),
                "eos_step": raw.index(stop) if stop in raw else -1,
                "head_lengths": [int(len(h)) for h in heads],
                "head_streams": [h[:16].tolist() for h in heads],
            }
        audio = self.snac.decode(heads, seed=config.seed or 0)
        t_end = time.perf_counter()
        return TTSResponse(
            audio=audio, sample_rate=self.sample_rate,
            timings={"prompt_tokens": len(ids),
                     "prefill_ms": (t_prefill - t0) * 1e3,
                     "decode_ms": (t_decode - t_prefill) * 1e3,
                     "decode_steps": len(outputs),
                     "decode_route": route,
                     "codec_ms": (t_end - t_decode) * 1e3})


@register_loader("orpheus")
def load_orpheus_runner(gguf_file, config: GenerationConfig, device, mesh=None) -> OrpheusRunner:
    """TTS_TPU_ORPHEUS_KV=int8 switches to the int8 KV cache, as in the JAX
    package.  `mesh`: a ("tp",) mesh to shard over (weights load on
    `device`, its lead device)."""
    cfg = OrpheusConfig.from_gguf_kv(gguf_file.kv)
    if os.environ.get("TTS_TPU_ORPHEUS_KV", "").lower() == "int8":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    t0 = time.perf_counter()
    timings: dict = {}
    params = load_orpheus_params(dict(gguf_file.tensors), cfg, device, timings)
    snac_tensors = {n: t for n, t in gguf_file.tensors.items() if n.startswith("snac.")}
    snac = SNACDecoder.from_tensors(snac_tensors, gguf_file.kv, device)
    runner = OrpheusRunner(cfg, params, BPETokenizer.from_gguf_kv(gguf_file.kv), snac, device,
                           mesh=mesh)
    _sync(torch.device(device))
    runner.load_timings = {**timings, "total_s": time.perf_counter() - t0}
    return runner
