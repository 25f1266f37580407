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
on the TPU either), except a sequential step's self-attention on the card.
A sequential step (T = 1) runs at a device position, so it has one shape at
every position: its self-attention is `ops.attention.prefix_attention`, on
the card one hand-written kernel a layer that reads only the live prefix of
the bf16 (or f32) cache, on the CPU the JAX package's read of the whole
cache under its -1e9 mask; a verify window reads the live prefix only in
plain torch.  All three compute the same function.
The full-context encoder is kept as the JAX package runs it: the cross K
past the prompt is zero and the cross-attention has no mask, so the pad
positions carry weight exp(0) with V from the encoder's pad block, and an
exact-length encoder would change the output.

A sequential step is one `DiaStep`, the body of the JAX package's
`dia_decode_loop`: the CFG pair at the device position, the merge, the
sampler, the next input row and the EOS drain (its branches on the
position as device `where`s), over static device buffers, captured on the
card as one CUDA graph per KV cache, cross-KV buffer and static (top_k,
do_sample, use_top_p) and replayed once per step; the host reads each
row back one step behind and stops when the drain ends.  The runner owns
the cross-KV buffer, which each request's encode fills in place.  The
speculative greedy loop drafts rows (`ops.spec.ngram_draft_rows`), replays
the drain along the draft path on the host, verifies 8 rows in one forward
and recomputes the true evolution from the model's own argmaxes, with one
read per window.  The loop state (next input row, drain counter, position)
lives on the host between calls, so `generate_stream` resumes either loop
chunk by chunk.  The caches are reused unzeroed.

Not ported, because each exists only for the JAX package's compiler: the
cache donation, the `lax.while_loop` around the step (the host replays the
step and checks the stop), and the DAC frame buckets (the DAC decodes the
exact frame count).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.codecs.dac import DACDecoder
from tts_tpu_torch.core.gguf import GGMLType, GGUFTensor
from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.ops.attention import arrival_counters, prefix_attention
from tts_tpu_torch.ops.qmatmul import apply_linear, load_linear
from tts_tpu_torch.ops.sampling import init_state
from tts_tpu_torch.ops.spec import SPEC_K, ngram_draft_rows, spec_enabled
from tts_tpu_torch.runtime.api import (GenerationConfig, TTSError, TTSResponse, TTSRunner,
                                       card_device)
from tts_tpu_torch.runtime.step_graph import CapturedStep, device_pos, read_behind

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


def load_dia_params(tensors: dict, cfg: DiaConfig, device=None,
                    timings: dict | None = None) -> dict:
    """tensors: name -> GGUFTensor (or numpy array).  Decoder linears become,
    by `load_linear`, {"wq", "scales"} or {"wq4", "scales"}; dense ones
    {"w": f32 [in, out]}.  The encoder (its linears f32 [in, out]) and the
    embeddings are dequantized to f32, as the JAX package's loader does; the
    9 decoder embeddings stack to "embds" [9, audio_vocab + 3, hidden] and
    the 9 heads to "heads" [9, hidden, vocab], in bf16 when any decoder
    linear is quantized.  `timings`, if given, collects packing and upload
    seconds."""
    device = card_device(device)
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


def init_dia_cache(cfg: DiaConfig, device=None) -> dict:
    """Head-major self-attention K/V [L, 2, Hkv, max_gen, hs] in
    cfg.kv_dtype, and the decode step's `prefix_attention` arrival counters
    [2 * Hkv] of this cache, zeroed (allocated here, so outside any graph
    capture; every launch leaves them at zero).  Slots past a request's
    position are never read, so it is reused unzeroed."""
    device = card_device(device)
    shape = (cfg.n_decoder_layers, 2, cfg.kv_heads, cfg.max_generation_size, cfg.head_size)
    dt = getattr(torch, cfg.kv_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "counters": arrival_counters(2 * cfg.kv_heads, device)}


def _dia_rows(params: dict, cfg: DiaConfig, rows: torch.Tensor, pos, cache: dict,
              cross_kv: dict) -> torch.Tensor:
    """The decoder on input rows [T, 9] (one token per head) at positions
    pos..pos+T-1, the cond and uncond rows together -> the CFG-merged
    logits [T, 9, vocab] f32, ids past EOS at -inf.

    T > 1 (a verify window, at an int pos) writes the K/V of its positions
    and attends causally over the live slots [0, pos + T).  T == 1 (a
    sequential step) runs at the device position pos (an int32 tensor [1];
    an int is made one): RoPE is built from it, K/V are written at that
    slot with index_copy_, and self-attention is `prefix_attention` over
    the layer's cache at the device position (scale 1.0), so the step has
    one shape at every position and a captured graph of it serves them
    all.  On the card that is one hand-written kernel a layer that reads
    only the slots <= pos, each KV head's once for its 4 query heads, in
    f32; on the CPU it is the JAX package's read of all
    cfg.max_generation_size slots under the additive mask (0 where key_pos
    <= pos, -1e9 past it), where a masked key weighs exp(-1e9 - max) = 0
    exactly in f32 while its logit is finite, which holds: the cache is
    zeroed when made and every slot past pos holds K/V an earlier forward
    wrote from finite activations (a non-finite one would have shown in
    that forward's own logits)."""
    dec = params["decoder"]
    B, T = 2, rows.shape[0]
    Hq, Hkv, hs = cfg.decoder_attn_heads, cfg.kv_heads, cfg.head_size
    G = Hq // Hkv
    device = rows.device
    heads = torch.arange(cfg.n_output_heads, device=device)
    # a draft id of -1 (force_miss) wraps to the last row, as jax's gather does
    ids = rows.long() % dec["embds"].shape[1]
    x = dec["embds"][heads[None, :], ids].sum(1).expand(B, T, -1)      # [2, T, hidden]
    if T == 1:
        positions = device_pos(pos, device)
        slot = positions.long()
    else:
        end = pos + T
        positions = torch.arange(pos, end, device=device)
        key_pos = torch.arange(end, device=device)
        # the query rows of a KV head run g-major: (g, t) -> g * T + t
        mask = torch.where(key_pos[None, :] <= positions[:, None], 0.0, -1e9).repeat(G, 1)
    cos, sin = _rope_tables(positions, hs)
    for l, L in enumerate(dec["layers"]):
        h = _rms(x, L["sa_norm"])
        q = _rope(apply_linear(h, L["sa_q"]).reshape(B, T, Hq, hs), cos, sin)
        k = _rope(apply_linear(h, L["sa_k"]).reshape(B, T, Hkv, hs), cos, sin)
        v = apply_linear(h, L["sa_v"]).reshape(B, T, Hkv, hs)
        ck, cv = cache["k"][l], cache["v"][l]                           # [2, Hkv, P, hs]
        k, v = k.transpose(1, 2).to(ck.dtype), v.transpose(1, 2).to(cv.dtype)
        if T == 1:
            ck.index_copy_(2, slot, k)
            cv.index_copy_(2, slot, v)
            attn = prefix_attention(q.reshape(B, Hq, hs), ck, cv, positions,
                                    cache.get("counters"), scale=1.0)[:, None]
        else:
            ck[:, :, pos:end] = k
            cv[:, :, pos:end] = v
            keys, values = ck[:, :, :end], cv[:, :, :end]
            qg = q.reshape(B, T, Hkv, G, hs).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, hs)
            logits = torch.matmul(qg, keys.float().transpose(2, 3)) + mask
            attn = torch.matmul(torch.softmax(logits, dim=-1), values.float())
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


class DiaStep(CapturedStep):
    """One sequential CFG step over static device buffers: the body of the
    JAX package's `dia_decode_loop` (the body at T = 1 on the cond and
    uncond rows at the device position, the merge, `sample_tokens`, then
    the next input row and the EOS drain counter as `_drain_step` evolves
    them, its branches on the position as device `where`s), keyed as that
    jit is: one per KV cache, cross-KV and static (top_k, do_sample,
    use_top_p).  Its buffers: the next input row `row` [9], the drain
    counter `delay` [1], `pos` [1] (each step advances it in place), the
    request's token cap `limit` [1], the sampler state `last` / `count` [9]
    and the 0-d f32 temperature, top_p and repetition penalty.  `buf` is
    [sampled row | count | drain counter | next row] after the latest
    step, the static slot the host copies out.

    With `capture` (a card only) the step is captured at its first `run`
    and replayed by every later one (`runtime/step_graph.py`); without it
    `run` calls the same step."""

    label = "dia"

    def __init__(self, params: dict, cfg: DiaConfig, cache: dict, cross_kv: dict,
                 generator: torch.Generator | None, device, *, top_k: int = 0,
                 do_sample: bool = True, use_top_p: bool = True, capture: bool = False):
        super().__init__(device, generator, top_k=top_k, do_sample=do_sample,
                         use_top_p=use_top_p, capture=capture)
        self.params, self.cfg, self.cache, self.cross_kv = params, cfg, cache, cross_kv
        H = cfg.n_output_heads
        with torch.inference_mode():
            self.buf = torch.zeros(3 * H + 1, dtype=torch.int32, device=self.device)
            self.row = torch.full((H,), cfg.bos_token_id, dtype=torch.int32, device=self.device)
            self.delay = torch.full((1,), -1, dtype=torch.int32, device=self.device)
            self.pos = torch.zeros(1, dtype=torch.int32, device=self.device)
            self.limit = torch.zeros(1, dtype=torch.int32, device=self.device)
            self.heads = torch.arange(H, dtype=torch.int32, device=self.device)
            self.delays = torch.tensor(cfg.delay_pattern, dtype=torch.int32, device=self.device)
        self.state = {"last": self.buf[:H], "count": self.buf[H:2 * H]}

    def load(self, loop_state, limit: int, state: dict, *, temperature: float = 1.0,
             top_p: float = 1.0, repetition_penalty: float = 1.0):
        """Set the buffers from the host loop state (next row, drain
        counter, position), the request's token cap and the sampler
        state."""
        tokens, delay, pos = loop_state
        with torch.inference_mode():
            self.row.copy_(torch.from_numpy(np.asarray(tokens, np.int32)))
            self.delay.fill_(delay)
            self.pos.fill_(pos)
            self.limit.fill_(limit)
        self._load_sampler(state, temperature, top_p, repetition_penalty)

    def _step(self):
        cfg = self.cfg
        merged = _dia_rows(self.params, cfg, self.row[None], self.pos, self.cache,
                           self.cross_kv)[0]
        sampled, state = self._sample(merged)
        self.pos += 1       # in place: the position after this row
        nxt = torch.where(self.pos > self.heads, sampled, cfg.bos_token_id)
        # the drain starts when head 0 emits EOS or the position nears the cap
        trigger = (self.delay == -1) & ((nxt[:1] == cfg.eos_token_id)
                                        | (self.pos >= self.limit - cfg.max_delay))
        delay = torch.where(trigger, cfg.max_delay, self.delay)
        step_after = cfg.max_delay - delay
        drained = torch.where(step_after == self.delays, cfg.eos_token_id,
                              torch.where(step_after > self.delays, cfg.pad_token_id, nxt))
        self.row.copy_(torch.where(delay > 0, drained, nxt))
        self.delay.copy_(torch.where(delay > 0, delay - 1, delay))
        self.buf.copy_(torch.cat([sampled, state["count"], self.delay, self.row]))


def dia_decode_loop(params: dict, cfg: DiaConfig, limit: int, budget: int, cache: dict,
                    cross_kv: dict, generator, sampler_state: dict, loop_state, *,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                    repetition_penalty: float = 1.0, do_sample: bool = True,
                    use_top_p: bool = True, step: DiaStep | None = None):
    """The sequential CFG loop: up to `budget` steps from `loop_state`,
    stopping after the step that ends the drain; `limit` is the request's
    token cap, which starts the drain.  Returns (rows [n, 9] int32 numpy,
    the sampler state after the last row, the loop state after it);
    `generator` advances in place, so chunked calls decode what one call
    would.

    `step` makes each step (`step.run()`): a runner's `DiaStep` of this
    key, cache, cross-KV and generator; None makes an uncaptured one for
    this call (eager steps).  The step loads `loop_state` and `limit` and
    evolves the next input row and the drain counter on the device; the
    host reads each step's [sampled row | count | drain counter | next row]
    `_LOOKAHEAD` steps behind (`read_behind`) while it checks for the
    stop."""
    tokens, delay, pos = loop_state
    H = cfg.n_output_heads
    if budget <= 0 or delay == 0:
        return np.zeros((0, H), np.int32), sampler_state, loop_state
    device = cache["k"].device
    if step is None:
        step = DiaStep(params, cfg, cache, cross_kv, generator, device, top_k=top_k,
                       do_sample=do_sample, use_top_p=use_top_p)
    elif (step.key != (top_k, do_sample, use_top_p) or step.generator is not generator
          or step.cache is not cache or step.cross_kv is not cross_kv):
        raise ValueError(f"dia_decode_loop: the step is keyed {step.key} on its own cache, "
                         f"cross-KV and generator, not {(top_k, do_sample, use_top_p)} on these")
    step.load(loop_state, limit, sampler_state, temperature=temperature, top_p=top_p,
              repetition_penalty=repetition_penalty)
    rows: list[np.ndarray] = []
    for last in read_behind(step, budget, _LOOKAHEAD):
        rows.append(last[:H].numpy().copy())
        if int(last[2 * H]) == 0:
            break
    state = {"last": last[:H].to(device, copy=True), "count": last[H:2 * H].to(device, copy=True)}
    return (np.stack(rows), state,
            (last[2 * H + 1:].numpy().astype(np.int32), int(last[2 * H]), pos + len(rows)))


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
    device_arrays = ("params", "_cache", "_cross")
    device_components = ("dac",)

    def __init__(self, cfg: DiaConfig, params: dict, dac: DACDecoder, device=None):
        """`device` defaults to the device the params live on.

        `decode_route` is how sequential steps run: "graph" (a captured
        `DiaStep` per key, replayed) on a card, "eager" on the CPU; a caller
        may set "eager" on the card to compare the two.  The runner owns
        one generator on its device, reseeded per request, which its graphs
        register, and one cross-KV buffer, which each request's encode
        fills in place, so its graphs read the request's cross-KV."""
        self.cfg = cfg
        self.params = params
        self.dac = dac
        self.device = torch.device(device if device is not None
                                   else params["decoder"]["norm"].device)
        self._cache = None
        self._cross: dict | None = None
        self.capture_trace = False
        self.last_trace: dict = {}
        self.load_timings: dict = {}
        self.decode_route = "graph" if self.device.type == "cuda" else "eager"
        self._generator: torch.Generator | None = None     # made at the first request
        self._steps: dict = {}

    def _encode(self, ids: list[int], config: GenerationConfig):
        """The encoder on the cond row (the prompt's bytes) and the uncond
        row (zeros), both at the full context and the prompt's n_valid, and
        the cross-KV, written into the runner's cross-KV buffer; returns
        (that buffer, the runner's generator reseeded for this request,
        sampler state)."""
        cfg = self.cfg
        tokens = torch.zeros((2, cfg.max_encoder_context_length), dtype=torch.long)
        tokens[0, :len(ids)] = torch.tensor(ids)
        enc = dia_encode(self.params, cfg, tokens.to(self.device), len(ids))
        cross = dia_cross_kv(self.params, cfg, enc, len(ids))
        if self._cross is None:
            self._cross = cross
        else:
            for k, t in cross.items():
                self._cross[k].copy_(t)
        if self._cache is None:
            self._cache = init_dia_cache(cfg, self.device)
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        generator = self._generator
        generator.manual_seed(config.seed if config.seed is not None
                              else np.random.randint(0, 2**31 - 1))
        return self._cross, generator, init_state(cfg.n_output_heads, self.device)

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

    def _decode_step(self, config: GenerationConfig) -> DiaStep:
        """The `DiaStep` of this request's key on `decode_route`, made (and
        on the "graph" route captured at its first step) once per KV cache,
        cross-KV buffer and params."""
        kw = self._sample_kw(config)
        key = (self.decode_route, kw["top_k"], kw["do_sample"], kw["use_top_p"])
        step = self._steps.get(key)
        if (step is None or step.cache is not self._cache or step.cross_kv is not self._cross
                or step.params is not self.params):
            step = self._steps[key] = DiaStep(
                self.params, self.cfg, self._cache, self._cross, self._generator, self.device,
                top_k=key[1], do_sample=key[2], use_top_p=key[3],
                capture=self.decode_route == "graph")
        return step

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
                        sampler_state, loop_state, step=self._decode_step(config),
                        **self._sample_kw(config))
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
                route = "spec"
                out, loop_state = dia_decode_loop_spec_resume(
                    self.params, cfg, max_gen, cfg.max_generation_size, self._cache, cross,
                    dia_init_loop_state(cfg), self._out_buffer())
                outputs = out[:loop_state[2]]
            else:
                step = self._decode_step(config)
                route = step.route
                outputs, _, _ = dia_decode_loop(
                    self.params, cfg, max_gen, cfg.max_generation_size, self._cache, cross,
                    generator, sampler_state, dia_init_loop_state(cfg), step=step,
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
                     "decode_route": route,
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
