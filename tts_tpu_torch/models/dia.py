"""Dia: an encoder-decoder dialogue TTS with classifier-free guidance (CFG),
9 parallel codebook heads and DAC 44.1 kHz decode.

Counterpart of `tts_tpu/models/dia.py`: byte-level tokens with [S1]/[S2] ->
0x01/0x02; the encoder always runs the full 1024-byte context with the
valid/pad block mask; the conditional and unconditional (byte-0) rows run
together as a batch of 2; NEOX RoPE (theta 1e4) on the self- and
cross-attention queries and keys; GQA self-attention (16 query / 4 KV
heads); the unscaled softmax of Dia (scale 1.0) in every attention; the
merge cond + 3 (cond - uncond) with ids past EOS at -inf; the delay pattern
{0, 8, ..., 15} with its 15-step EOS drain, and the delay un-weave before
the codec (`adjust_output_tokens`).

The encoder is plain f32 torch (the JAX package dequantizes it too).
Quantized decoder linears stay on the device as int8 or packed int4 by
`ops.qmatmul.linear_format`'s rule and run through the hand-written GEMMs
of `ops/qmatmul.py` (`apply_linear`): the CFG pair makes every decode step
M = 2, the speculative verify M = 16 and the cross-KV precompute M =
2 x 1024, so Dia launches no GEMV.  Quantized checkpoints keep the KV and
cross caches and the heads in bf16 (the cross K/V are kept as f32 values
rounded to bf16, which the attention reads without a cast per step).  Self-
and cross-attention are plain torch products (no Pallas kernel served them
on the TPU either); self-attention reads the live prefix of the cache only,
which computes what the JAX package's -1e9 mask over the whole cache does.
The full-context encoder is kept as the JAX package runs it: the cross K
past the prompt is zero and the cross-attention has no mask, so the pad
positions carry weight exp(0) with V from the encoder's pad block, and an
exact-length encoder would change the output.

Decode is a host loop, as the port's Parler's is.  The sequential CFG loop
keeps its next input row and drain counter on the device and reads each
sampled row back one step behind; the speculative greedy loop drafts rows
(`ops.spec.ngram_draft_rows`), replays the drain along the draft path on
the host, verifies 8 rows in one forward and recomputes the true evolution
from the model's own argmaxes, with one read per window.  The loop state
(next input row, drain counter, position) lives on the host between calls,
so `generate_stream` resumes either loop chunk by chunk.  The caches are
reused unzeroed: a forward reads only the positions its request wrote.

Not ported, because each exists only for the JAX package's compiler: the
jit and the cache donation, and the DAC frame buckets (the DAC decodes the
exact frame count).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.codecs.dac import DACDecoder
from tts_tpu_torch.core.gguf import GGMLType, GGUFTensor
from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.ops.qmatmul import apply_linear, load_linear
from tts_tpu_torch.ops.sampling import init_state, sample_tokens
from tts_tpu_torch.ops.spec import SPEC_K, ngram_draft_rows, spec_enabled
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError, TTSResponse, TTSRunner

# decode steps the host keeps enqueued past the newest row it has read (the
# stop check): at most this many steps run, and are discarded, after a stop
_LOOKAHEAD = 1


@dataclass(frozen=True)
class DiaConfig:
    n_encoder_layers: int = 12
    n_decoder_layers: int = 18
    encoder_hidden_size: int = 1024
    decoder_hidden_size: int = 2048
    encoder_attn_heads: int = 16
    decoder_attn_heads: int = 16
    decoder_query_heads: int = 4      # GQA group count: kv_heads = heads / groups
    head_size: int = 128
    n_output_heads: int = 9
    output_vocab_size: int = 1028
    audio_vocab_size: int = 1024
    eos_token_id: int = 1024
    pad_token_id: int = 1025
    bos_token_id: int = 1026
    max_encoder_context_length: int = 1024
    max_generation_size: int = 3072
    max_delay: int = 15
    delay_pattern: tuple = (0, 8, 9, 10, 11, 12, 13, 14, 15)
    cfg_scale: float = 3.0
    # the KV and cross caches' storage: f32 for dense checkpoints; the
    # loader switches to bfloat16 when the decoder linears are quantized
    kv_dtype: str = "float32"

    @property
    def kv_heads(self) -> int:
        return self.decoder_attn_heads // self.decoder_query_heads

    @staticmethod
    def from_gguf_kv(kv: dict) -> "DiaConfig":
        g = lambda k, d: int(kv.get(k, d))
        return DiaConfig(
            n_encoder_layers=g("dia.encoder.layers", 12),
            n_decoder_layers=g("dia.decoder.layers", 18),
            encoder_hidden_size=g("dia.encoder.hidden_size", 1024),
            decoder_hidden_size=g("dia.decoder.hidden_size", 2048),
            encoder_attn_heads=g("dia.encoder.attn_heads", 16),
            decoder_attn_heads=g("dia.decoder.attn_heads", 16),
            decoder_query_heads=g("dia.decoder.query_heads", 4),
            head_size=g("dia.attn_head_size", 128),
            n_output_heads=g("dia.decoder.output_heads", 9),
            output_vocab_size=g("dia.decoder.output_vocab_size", 1028),
            audio_vocab_size=g("dia.decoder.audio_vocab_size", 1024),
            eos_token_id=g("dia.eos_token_id", 1024),
            pad_token_id=g("dia.pad_token_id", 1025),
            bos_token_id=g("dia.bos_token_id", 1026),
            max_encoder_context_length=g("dia.encoder.max_context_length", 1024),
            max_generation_size=g("dia.decoder.max_generation_size", 3072),
            max_delay=g("dia.max_delay", 15),
            cfg_scale=float(kv.get("dia.cfg_scale", 3.0)),
        )


def load_dia_params(tensors: dict, cfg: DiaConfig, device="cpu",
                    timings: dict | None = None) -> dict:
    """tensors: name -> GGUFTensor (or numpy array).  Decoder linears become,
    by `load_linear`, {"wq", "scales"} or {"wq4", "scales"}; dense ones
    {"w": f32 [in, out]}.  The encoder (its linears f32 [in, out]) and the
    embeddings are dequantized to f32, as the JAX package's loader does; the
    9 decoder embeddings stack to "embds" [9, audio_vocab + 3, hidden] and
    the 9 heads to "heads" [9, hidden, vocab], in bf16 when any decoder
    linear is quantized.  `timings`, if given, collects packing and upload
    seconds."""
    timings = {} if timings is None else timings
    timings.setdefault("pack_s", 0.0)
    timings.setdefault("upload_s", 0.0)

    def raw(name):
        t = tensors.get(name)
        if t is None:
            raise KeyError(f"dia: missing tensor {name}")
        return t

    def get(name):
        t = raw(name)
        if isinstance(t, GGUFTensor):
            t = t.to_numpy(np.float16 if t.ggml_type == GGMLType.F16 else np.float32)
        t0 = time.perf_counter()
        out = torch.from_numpy(np.array(t)).to(device).float()
        timings["upload_s"] += time.perf_counter() - t0
        return out

    def dense(name):
        return get(name).t().contiguous()

    def lin(name):
        packed = load_linear(raw(name), device, timings)
        return packed if packed is not None else {"w": dense(name)}

    enc = {"embedding": get("dia.encoder.embedding"), "norm": get("dia.encoder.norm"),
           "layers": []}
    for i in range(cfg.n_encoder_layers):
        L = f"dia.encoder.layers.{i}"
        enc["layers"].append({
            "q": dense(f"{L}.q_proj"), "k": dense(f"{L}.k_proj"),
            "v": dense(f"{L}.v_proj"), "o": dense(f"{L}.o_proj"),
            "sa_norm": get(f"{L}.pre_sa_norm"), "mlp_norm": get(f"{L}.post_sa_norm"),
            "gate": dense(f"{L}.gate"), "up": dense(f"{L}.up"), "wo": dense(f"{L}.wo"),
        })
    n_heads = cfg.n_output_heads
    dec = {"norm": get("dia.decoder.norm"),
           "embds": torch.stack([get(f"dia.decoder.embeddings.{i}") for i in range(n_heads)]),
           "heads": torch.stack([dense(f"dia.decoder.heads.{i}")
                                 for i in range(n_heads)]).contiguous(),
           "layers": []}
    for i in range(cfg.n_decoder_layers):
        L = f"dia.decoder.layers.{i}"
        dec["layers"].append({
            "sa_q": lin(f"{L}.self_q_proj"), "sa_k": lin(f"{L}.self_k_proj"),
            "sa_v": lin(f"{L}.self_v_proj"), "sa_o": lin(f"{L}.self_o_proj"),
            "ca_q": lin(f"{L}.cross_q_proj"), "ca_k": lin(f"{L}.cross_k_proj"),
            "ca_v": lin(f"{L}.cross_v_proj"), "ca_o": lin(f"{L}.cross_o_proj"),
            "sa_norm": get(f"{L}.pre_sa_norm"), "ca_norm": get(f"{L}.pre_ca_norm"),
            "mlp_norm": get(f"{L}.pre_mlp_norm"),
            "gate": lin(f"{L}.gate"), "up": lin(f"{L}.up"), "wo": lin(f"{L}.wo"),
        })
    params = {"encoder": enc, "decoder": dec}
    if dia_params_quantized(params):
        # the heads stream 9 x hidden x vocab values per step; bf16 halves
        # them on already-quantized checkpoints (the head product runs f32)
        dec["heads"] = dec["heads"].bfloat16()
    return params


def dia_params_quantized(params) -> bool:
    """True if any decoder linear kept its GGUF quantization on the device
    (the loader then switches the caches to bf16)."""
    return any("w" not in L[n] for L in params["decoder"]["layers"] for n in ("sa_q", "gate"))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope_tables(positions: torch.Tensor, hs: int, theta: float = 10000.0):
    """cos/sin [T, 1, hs/2] of NEOX RoPE at `positions` [T], shared by every
    layer of one forward."""
    freqs = 1.0 / (theta ** (torch.arange(0, hs, 2, dtype=torch.float32,
                                          device=positions.device) / hs))
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [..., T, H, hs]: rotate the (x[i], x[i + hs/2]) pairs."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def dia_encode(params: dict, cfg: DiaConfig, tokens: torch.Tensor, n_valid: int) -> torch.Tensor:
    """tokens [2, T] byte ids (row 0 cond, row 1 uncond: zeros) -> encoder
    states [2, T, enc_hidden] f32.  T is the full context; positions at and
    past n_valid attend only each other (the block mask)."""
    enc = params["encoder"]
    B, T = tokens.shape
    H, hs = cfg.encoder_attn_heads, cfg.head_size
    x = enc["embedding"][tokens.long()]
    positions = torch.arange(T, device=x.device)
    valid = positions < n_valid
    mask = torch.where(valid[:, None] == valid[None, :], 0.0, -1e9)
    cos, sin = _rope_tables(positions, hs)
    for L in enc["layers"]:
        h = _rms(x, L["sa_norm"])
        q = _rope((h @ L["q"]).reshape(B, T, H, hs), cos, sin).transpose(1, 2)
        k = _rope((h @ L["k"]).reshape(B, T, H, hs), cos, sin).permute(0, 2, 3, 1)
        v = (h @ L["v"]).reshape(B, T, H, hs).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, k) + mask, dim=-1)   # scale 1.0 (Dia)
        x = x + torch.matmul(w, v).transpose(1, 2).reshape(B, T, H * hs) @ L["o"]
        h = _rms(x, L["mlp_norm"])
        x = x + (F.silu(h @ L["gate"]) * (h @ L["up"])) @ L["wo"]
    return _rms(x, enc["norm"])


def dia_cross_kv(params: dict, cfg: DiaConfig, enc_states: torch.Tensor, n_valid: int) -> dict:
    """The cross-attention's K (roped, zero past the prompt) and V (full
    length) of every layer: 2 GEMMs per layer at M = 2 x T.  Rounded to
    cfg.kv_dtype, as the JAX package stores them, and kept in f32, which
    the attention reads: "k" [L, 2, H, hs, T] (transposed for the product),
    "v" [L, 2, H, T, hs]."""
    B, T, _ = enc_states.shape
    H, hs = cfg.decoder_attn_heads, cfg.head_size
    dt = getattr(torch, cfg.kv_dtype)
    positions = torch.arange(T, device=enc_states.device)
    valid = (positions < n_valid).float()[:, None, None]
    cos, sin = _rope_tables(positions, hs)
    ks, vs = [], []
    for L in params["decoder"]["layers"]:
        k = _rope(apply_linear(enc_states, L["ca_k"]).reshape(B, T, H, hs), cos, sin) * valid
        v = apply_linear(enc_states, L["ca_v"]).reshape(B, T, H, hs)
        ks.append(k.to(dt).float().permute(0, 2, 3, 1))
        vs.append(v.to(dt).float().transpose(1, 2))
    return {"k": torch.stack(ks).contiguous(), "v": torch.stack(vs).contiguous()}


def init_dia_cache(cfg: DiaConfig, device="cpu") -> dict:
    """Head-major self-attention K/V [L, 2, Hkv, max_gen, hs] in
    cfg.kv_dtype.  Slots past a request's position are never read, so it
    is reused unzeroed."""
    shape = (cfg.n_decoder_layers, 2, cfg.kv_heads, cfg.max_generation_size, cfg.head_size)
    dt = getattr(torch, cfg.kv_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _dia_rows(params: dict, cfg: DiaConfig, rows: torch.Tensor, pos: int, cache: dict,
              cross_kv: dict) -> torch.Tensor:
    """The decoder on input rows [T, 9] (one token per head) at positions
    pos..pos+T-1, the cond and uncond rows together -> the CFG-merged
    logits [T, 9, vocab] f32, ids past EOS at -inf.  Writes the K/V of
    those positions and attends causally over the live slots [0, pos + T);
    T == 1 is a sequential step, T > 1 a verify window."""
    dec = params["decoder"]
    B, T = 2, rows.shape[0]
    Hq, Hkv, hs = cfg.decoder_attn_heads, cfg.kv_heads, cfg.head_size
    G = Hq // Hkv
    end = pos + T
    device = rows.device
    heads = torch.arange(cfg.n_output_heads, device=device)
    # a draft id of -1 (force_miss) wraps to the last row, as jax's gather does
    ids = rows.long() % dec["embds"].shape[1]
    x = dec["embds"][heads[None, :], ids].sum(1).expand(B, T, -1)      # [2, T, hidden]
    positions = torch.arange(pos, end, device=device)
    cos, sin = _rope_tables(positions, hs)
    mask = None
    if T > 1:
        key_pos = torch.arange(end, device=device)
        # the query rows of a KV head run g-major: (g, t) -> g * T + t
        mask = torch.where(key_pos[None, :] <= positions[:, None], 0.0, -1e9).repeat(G, 1)
    for l, L in enumerate(dec["layers"]):
        h = _rms(x, L["sa_norm"])
        q = _rope(apply_linear(h, L["sa_q"]).reshape(B, T, Hq, hs), cos, sin)
        k = _rope(apply_linear(h, L["sa_k"]).reshape(B, T, Hkv, hs), cos, sin)
        v = apply_linear(h, L["sa_v"]).reshape(B, T, Hkv, hs)
        ck, cv = cache["k"][l], cache["v"][l]                           # [2, Hkv, P, hs]
        ck[:, :, pos:end] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, pos:end] = v.transpose(1, 2).to(cv.dtype)
        qg = q.reshape(B, T, Hkv, G, hs).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, hs)
        logits = torch.matmul(qg, ck[:, :, :end].float().transpose(2, 3))
        if mask is not None:
            logits = logits + mask
        attn = torch.matmul(torch.softmax(logits, dim=-1), cv[:, :, :end].float())
        attn = attn.reshape(B, Hkv, G, T, hs).permute(0, 3, 1, 2, 4).reshape(B, T, Hq * hs)
        x = x + apply_linear(attn, L["sa_o"])

        h = _rms(x, L["ca_norm"])
        q = _rope(apply_linear(h, L["ca_q"]).reshape(B, T, Hq, hs), cos, sin).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, cross_kv["k"][l]), dim=-1)
        attn = torch.matmul(w, cross_kv["v"][l]).transpose(1, 2).reshape(B, T, Hq * hs)
        x = x + apply_linear(attn, L["ca_o"])

        h = _rms(x, L["mlp_norm"])
        x = x + apply_linear(F.silu(apply_linear(h, L["gate"])) * apply_linear(h, L["up"]),
                             L["wo"])
    x = _rms(x, dec["norm"])
    logits = torch.matmul(x[:, None], dec["heads"].to(x.dtype))          # [2, 9, T, vocab]
    cond, uncond = logits[0], logits[1]
    merged = (cond + cfg.cfg_scale * (cond - uncond)).transpose(0, 1)
    merged[..., cfg.eos_token_id + 1:] = float("-inf")
    return merged


def dia_step0_logits(params: dict, cfg: DiaConfig, cache: dict, cross_kv: dict) -> torch.Tensor:
    """CFG-merged per-head logits [9, vocab] of decode step 0 (the all-BOS
    row at position 0), consuming no loop or sampler state: the probe that
    places a mismatch in the encoder and decoder or in the sampler and
    codec.  It writes the K/V of position 0, which the first step writes
    again with the same values."""
    rows = torch.full((1, cfg.n_output_heads), cfg.bos_token_id, dtype=torch.int32,
                      device=cache["k"].device)
    return _dia_rows(params, cfg, rows, 0, cache, cross_kv)[0]


def dia_init_loop_state(cfg: DiaConfig):
    """The resumable loop carry, on the host: (next input row [9] int32,
    drain counter (-1 until the drain starts, 0 when it ends), position)."""
    return np.full(cfg.n_output_heads, cfg.bos_token_id, np.int32), -1, 0


def _drain_step(cfg: DiaConfig, row: np.ndarray, pos_after: int, dcur: int, limit: int):
    """One step of the sequential loop's next-input and drain evolution:
    `row` is the step's output, `pos_after` the position after emitting it,
    `dcur` the drain counter before.  Head h reads BOS until position h;
    the drain starts when head 0 emits EOS or the position nears `limit`,
    then feeds each head EOS at its delay and PAD after.  Returns (next
    input row, drain counter after)."""
    heads = np.arange(cfg.n_output_heads)
    nxt = np.where(pos_after > heads, row, cfg.bos_token_id)
    if dcur == -1 and (nxt[0] == cfg.eos_token_id or pos_after >= limit - cfg.max_delay):
        dcur = cfg.max_delay
    if dcur > 0:
        step_after = cfg.max_delay - dcur
        delays = np.asarray(cfg.delay_pattern)
        nxt = np.where(step_after == delays, cfg.eos_token_id,
                       np.where(step_after > delays, cfg.pad_token_id, nxt))
        dcur -= 1
    return nxt.astype(np.int32), dcur


def dia_decode_loop(params: dict, cfg: DiaConfig, limit: int, budget: int, cache: dict,
                    cross_kv: dict, generator, sampler_state: dict, loop_state, *,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                    repetition_penalty: float = 1.0, do_sample: bool = True,
                    use_top_p: bool = True):
    """The sequential CFG loop: up to `budget` steps from `loop_state`,
    stopping after the step that ends the drain; `limit` is the request's
    token cap, which starts the drain.  Returns (rows [n, 9] int32 numpy,
    the sampler state after the last row, the loop state after it);
    `generator` advances in place, so chunked calls decode what one call
    would.

    The next input row and the drain counter evolve on the device (the
    evolution of `_drain_step`); each step's output, counter and next row
    are copied to pinned host memory behind an event and read once
    `_LOOKAHEAD` later steps are enqueued, so the card keeps working while
    the host checks for the stop."""
    tokens, delay, pos = loop_state
    H = cfg.n_output_heads
    if budget <= 0 or delay == 0:
        return np.zeros((0, H), np.int32), sampler_state, loop_state
    device = cache["k"].device
    cuda = device.type == "cuda"
    heads = torch.arange(H, device=device)
    delays = torch.tensor(cfg.delay_pattern, device=device)
    host = torch.empty((budget, 2 * H + 1), dtype=torch.int32, pin_memory=cuda)
    pending: collections.deque = collections.deque()   # (event, sampler state) per unread step
    tok = torch.from_numpy(tokens).to(device)
    dly = torch.tensor(delay, dtype=torch.int32, device=device)
    state = sampler_state
    rows: list[np.ndarray] = []
    last = None
    enqueued = 0
    while len(rows) < budget:
        if enqueued < budget:
            p = pos + enqueued
            merged = _dia_rows(params, cfg, tok[None], p, cache, cross_kv)[0]
            sampled, sampler_state = sample_tokens(
                generator, merged, sampler_state, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty, do_sample=do_sample,
                use_top_p=use_top_p)
            nxt = sampled if p + 1 > H - 1 else torch.where(heads < p + 1, sampled,
                                                            cfg.bos_token_id)
            trigger = dly == -1
            if p + 1 < limit - cfg.max_delay:
                trigger = trigger & (nxt[0] == cfg.eos_token_id)
            dly = torch.where(trigger, cfg.max_delay, dly)
            step_after = cfg.max_delay - dly
            drained = torch.where(step_after == delays, cfg.eos_token_id,
                                  torch.where(step_after > delays, cfg.pad_token_id, nxt))
            tok = torch.where(dly > 0, drained, nxt).to(torch.int32)
            dly = torch.where(dly > 0, dly - 1, dly).to(torch.int32)
            host[enqueued].copy_(torch.cat([sampled, dly[None], tok]), non_blocking=cuda)
            event = torch.cuda.Event() if cuda else None
            if event is not None:
                event.record()
            pending.append((event, sampler_state))
            enqueued += 1
            if len(pending) <= _LOOKAHEAD and enqueued < budget:
                continue
        event, state = pending.popleft()
        if event is not None:
            event.synchronize()
        last = host[len(rows)].numpy().copy()
        rows.append(last[:H])
        if last[H] == 0:
            break
    return (np.stack(rows), state,
            (last[H + 1:].astype(np.int32), int(last[H]), pos + len(rows)))


def dia_decode_loop_spec_resume(params: dict, cfg: DiaConfig, limit: int, budget_end: int,
                                cache: dict, cross_kv: dict, loop_state, out: np.ndarray, *,
                                k: int = SPEC_K, force_miss: bool = False):
    """The resumable greedy speculative CFG loop.  Each iteration drafts k
    rows by prompt lookup over the rows emitted so far
    (`ngram_draft_rows`), replays the sequential loop's next-input and
    drain evolution along the draft path to build the k + 1 verify inputs,
    runs one forward over them (the CFG pair: M = 2 (k + 1) in every GEMM)
    and accepts the longest prefix on which all 9 argmaxes agree with the
    drafts, plus the model's own next row.  The true evolution is then
    recomputed from the model's outputs, so the rows, the drain schedule
    and the stop are the sequential greedy loop's.  `force_miss` rejects
    every draft (id -1 never equals an argmax): one row per forward, the
    floor.

    `out` [max_gen + k + 1, 9] (numpy, PAD-filled past the emitted rows)
    holds every row emitted so far, indexed by position, and takes the new
    ones in place; `budget_end` is the global position bound for this call
    and `limit` the drain-starting token cap.  K/V written for rejected
    drafts sit past the accepted position and are written again before a
    query reads them.  Returns (out, loop state)."""
    tokens, delay, pos = loop_state
    H = cfg.n_output_heads
    device = cache["k"].device
    while delay != 0 and pos < budget_end:
        drafts = (np.full((k, H), -1, np.int32) if force_miss
                  else ngram_draft_rows(out, pos, k))
        ins, dcur = [tokens], delay
        for j in range(1, k + 1):
            nxt, dcur = _drain_step(cfg, drafts[j - 1], pos + j, dcur, limit)
            ins.append(nxt)
        # rows past the cache are never emitted (budget_end <= max_gen)
        w = min(k + 1, cfg.max_generation_size - pos)
        merged = _dia_rows(params, cfg, torch.from_numpy(np.stack(ins[:w])).to(device), pos,
                           cache, cross_kv)
        g = merged.argmax(-1).to(torch.int32).cpu().numpy()            # [w, 9]
        n_acc = int(np.cumprod((drafts[:w - 1] == g[:-1]).all(axis=1)).sum())
        nxts, dafter, dcur = [], [], delay
        for j in range(w):
            nxt, dcur = _drain_step(cfg, g[j], pos + j + 1, dcur, limit)
            nxts.append(nxt)
            dafter.append(dcur)
        # the sequential loop stops after the row that ends the drain
        done = [j for j in range(n_acc + 1) if dafter[j] == 0]
        n_emit = min(done[0] + 1 if done else n_acc + 1, budget_end - pos)
        out[pos:pos + n_emit] = g[:n_emit]
        tokens, delay, pos = nxts[n_emit - 1], dafter[n_emit - 1], pos + n_emit
    return out, (tokens, delay, pos)


def tokenize_dia_sentence(text: str, cfg: DiaConfig) -> list[int]:
    """Byte-level tokens with [S1]/[S2] -> 0x01/0x02: a missing speaker tag
    becomes [S1] and a missing final period is added."""
    text = text.strip()
    if not text.startswith("[S1]") and not text.startswith("[S2]"):
        text = "[S1] " + text
    if not text.endswith("."):
        text = text + "."
    text = text.replace("[S1]", "\x01").replace("[S2]", "\x02")
    data = text.encode("utf-8")
    if len(data) > cfg.max_encoder_context_length:
        raise TTSError(
            f"Dia currently only supports a max of {cfg.max_encoder_context_length} "
            f"characters and received an input of {len(data)} characters.")
    return list(data)


def adjust_output_tokens(output: np.ndarray, cfg: DiaConfig) -> np.ndarray:
    """Delay un-weave and invalid-token filter: output [steps, 9] ->
    [frames, 9] with frame i head h = output[i + delay[h], h]; a frame
    holding any id >= audio_vocab_size (EOS, PAD, ...) is dropped."""
    steps = len(output)
    frames = []
    delays = np.asarray(cfg.delay_pattern)
    for i in range(max(steps - cfg.max_delay, 0)):
        idx = i + delays
        if idx[-1] >= steps:
            break
        row = output[idx, np.arange(cfg.n_output_heads)]
        if (row < cfg.audio_vocab_size).all():
            frames.append(row)
    if not frames:
        return np.zeros((0, cfg.n_output_heads), np.int32)
    return np.stack(frames).astype(np.int32)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DiaRunner(TTSRunner):
    sample_rate = 44100
    architecture = "dia"

    def __init__(self, cfg: DiaConfig, params: dict, dac: DACDecoder, device=None):
        """`device` defaults to the device the params live on."""
        self.cfg = cfg
        self.params = params
        self.dac = dac
        self.device = torch.device(device if device is not None
                                   else params["decoder"]["norm"].device)
        self._cache = None
        self.capture_trace = False
        self.last_trace: dict = {}
        self.load_timings: dict = {}

    def _encode(self, ids: list[int], config: GenerationConfig):
        """The encoder on the cond row (the prompt's bytes) and the uncond
        row (zeros), both at the full context and the prompt's n_valid, and
        the cross-KV; returns (cross_kv, generator, sampler state)."""
        cfg = self.cfg
        tokens = torch.zeros((2, cfg.max_encoder_context_length), dtype=torch.long)
        tokens[0, :len(ids)] = torch.tensor(ids)
        enc = dia_encode(self.params, cfg, tokens.to(self.device), len(ids))
        cross = dia_cross_kv(self.params, cfg, enc, len(ids))
        if self._cache is None:
            self._cache = init_dia_cache(cfg, self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(config.seed if config.seed is not None
                              else np.random.randint(0, 2**31 - 1))
        return cross, generator, init_state(cfg.n_output_heads, self.device)

    def _prompt_ids(self, text: str, config: GenerationConfig) -> list[int]:
        if config.max_tokens and config.max_tokens <= self.cfg.max_delay:
            raise TTSError(f"max_tokens must exceed the delay window ({self.cfg.max_delay})")
        return tokenize_dia_sentence(text, self.cfg)

    def _sample_kw(self, config: GenerationConfig) -> dict:
        return dict(temperature=config.temperature, top_k=config.top_k, top_p=config.top_p,
                    repetition_penalty=config.repetition_penalty, do_sample=config.sample,
                    use_top_p=config.top_p < 1.0)

    def _out_buffer(self) -> np.ndarray:
        cfg = self.cfg
        return np.full((cfg.max_generation_size + SPEC_K + 1, cfg.n_output_heads),
                       cfg.pad_token_id, np.int32)

    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        chunk_steps: int = 48):
        """Yield audio as it is made: the loop runs `chunk_steps` steps at a
        time (the host loop state resumes the drain and the position), and
        the DAC decodes bounded windows with emission held RECEPTIVE_FRAMES
        behind the un-weaved frame head, so the chunks concatenate to
        generate()'s audio for the same tokens.  Greedy requests take the
        speculative loop chunk by chunk (the carried row buffer keeps the
        drafter's history); sampled ones the sequential loop, whose
        generator carries across chunks."""
        config = config or GenerationConfig()
        cfg = self.cfg
        max_gen = config.max_tokens or cfg.max_generation_size
        ids = self._prompt_ids(text, config)
        with torch.inference_mode():
            cross, generator, sampler_state = self._encode(ids, config)
        loop_state = dia_init_loop_state(cfg)
        spec = spec_enabled(config)
        out_buf = self._out_buffer() if spec else None
        outputs = np.zeros((0, cfg.n_output_heads), np.int32)
        emitted = 0
        done = False
        while not done and len(outputs) < max_gen:
            budget = min(chunk_steps, cfg.max_generation_size - len(outputs))
            i_cum = len(outputs)
            with torch.inference_mode():
                if spec:
                    out_buf, loop_state = dia_decode_loop_spec_resume(
                        self.params, cfg, max_gen, i_cum + budget, self._cache, cross,
                        loop_state, out_buf)
                    new = out_buf[i_cum:loop_state[2]]
                else:
                    new, sampler_state, loop_state = dia_decode_loop(
                        self.params, cfg, max_gen, budget, self._cache, cross, generator,
                        sampler_state, loop_state, **self._sample_kw(config))
            done = loop_state[1] == 0                    # the drain ended
            outputs = np.concatenate([outputs, new])
            frames = adjust_output_tokens(outputs, cfg)
            target = (len(frames) if done or len(outputs) >= max_gen
                      else len(frames) - self.dac.RECEPTIVE_FRAMES)
            if target > emitted:
                audio = self.dac.decode_window(frames, emitted, target)
                emitted = target
                if len(audio):
                    yield audio

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        cfg = self.cfg
        max_gen = config.max_tokens or cfg.max_generation_size
        t0 = time.perf_counter()
        ids = self._prompt_ids(text, config)
        trace = {} if self.capture_trace else None
        with torch.inference_mode():
            cross, generator, sampler_state = self._encode(ids, config)
            _sync(self.device)
            t_encode = time.perf_counter()
            if trace is not None:
                from tts_tpu_torch.utils.trace import multihead_logit_stats

                trace["prompt_ids"] = [int(i) for i in ids[:24]]
                trace["n_prompt_tokens"] = len(ids)
                trace["step0_logits"] = multihead_logit_stats(
                    dia_step0_logits(self.params, cfg, self._cache, cross).cpu().numpy())
            if spec_enabled(config):
                out, loop_state = dia_decode_loop_spec_resume(
                    self.params, cfg, max_gen, cfg.max_generation_size, self._cache, cross,
                    dia_init_loop_state(cfg), self._out_buffer())
                outputs = out[:loop_state[2]]
            else:
                outputs, _, _ = dia_decode_loop(
                    self.params, cfg, max_gen, cfg.max_generation_size, self._cache, cross,
                    generator, sampler_state, dia_init_loop_state(cfg),
                    **self._sample_kw(config))
        t_decode = time.perf_counter()

        frames = adjust_output_tokens(outputs, cfg)
        if trace is not None:
            eos = np.where(outputs[:, 0] == cfg.eos_token_id)[0]
            trace.update({
                "n_steps": len(outputs),
                "eos_step_head0": int(eos[0]) if len(eos) else -1,
                "tokens_first_steps": outputs[:8].tolist(),
                "n_frames": int(len(frames)),
                "codes_first_frames": np.asarray(frames[:6], np.int64).tolist(),
            })
            self.last_trace = trace
        audio = self.dac.decode(frames)
        t_end = time.perf_counter()
        return TTSResponse(
            audio=audio, sample_rate=self.sample_rate,
            timings={"prompt_tokens": len(ids),
                     "encode_ms": (t_encode - t0) * 1e3,
                     "decode_ms": (t_decode - t_encode) * 1e3,
                     "decode_steps": len(outputs),
                     "frames": int(len(frames)),
                     "codec_ms": (t_end - t_decode) * 1e3})


@register_loader("dia")
def load_dia_runner(gguf_file, config: GenerationConfig, device) -> DiaRunner:
    """Quantized decoder linears stay int8 / int4 on `device`, with bf16
    caches and bf16 heads; the DAC loads as f32."""
    cfg = DiaConfig.from_gguf_kv(gguf_file.kv)
    t0 = time.perf_counter()
    timings: dict = {}
    params = load_dia_params(dict(gguf_file.tensors), cfg, device, timings)
    if dia_params_quantized(params):
        cfg = dataclasses.replace(cfg, kv_dtype="bfloat16")
    dac_tensors = {n: t for n, t in gguf_file.tensors.items()
                   if n.startswith(("audio_encoder.", "dac."))}
    dac = DACDecoder.from_tensors(dac_tensors, gguf_file.kv, device)
    runner = DiaRunner(cfg, params, dac, device)
    _sync(torch.device(device))
    runner.load_timings = {**timings, "total_s": time.perf_counter() - t0}
    return runner
