"""Parler-TTS: a decoder-only transformer with precomputed T5 cross-attention,
9 parallel codebook heads and DAC 44.1 kHz decode.

Counterpart of `tts_tpu/models/parler.py`: learned positional embeddings,
biasless projections, layer norms with bias and a tanh-GELU FFN; the
BOS-delay staircase across heads, per-head EOS tracking, and the delay
un-weave with invalid frames dropped before the codec
(`adjust_output_tokens`).  Quantized decoder linears stay on the device as
int8 or packed int4 by `ops.qmatmul.linear_format`'s rule and run through
the hand-written kernels of `ops/qmatmul.py` (`apply_linear`): the GEMVs at
M = 1 (every sequential decode step), the GEMMs at M > 1 (the prompt
prefill, the cross-KV precompute, the speculative verify).  Quantized
checkpoints keep the KV cache and the heads in bf16.  Cross-attention,
and self-attention in the prefill and the verify window, are plain torch
products over the live prefix (no Pallas kernel served them on the TPU
either).  A decode step (T = 1) runs at a device position and has one
shape at every position: its self-attention is `ops.attention.
prefix_attention`, on the card one hand-written kernel a layer that reads
the position on the device and each live K/V row once, in place in the
cache's dtype, in f32 arithmetic; on the CPU the JAX package's read of
the whole cache under the additive -1e9 mask.  All compute the same
function (a masked key weighs exactly 0 in f32).

A sequential step is one `ParlerStep`, the body of the JAX package's
`parler_decode_loop`: the row embedded at the device position, the body,
the 9 heads, the sampler, the EOS flags and the staircase of the next row,
over static device buffers, captured on the card as one CUDA graph per
KV cache, cross-KV and static (top_k, do_sample, use_top_p) and replayed
once per row, as JAX runs its compiled loop body; the host reads each row
back one step behind (`_LOOKAHEAD`) and checks for the stop.  The
speculative greedy loop drafts, builds the staircase inputs and accepts on
the host, with one read of the verify window's argmaxes (up to 8 rows) per
forward.  The loop state (next input row, EOS flags, global step) lives on
the host between calls, so `generate_stream` resumes either loop chunk by
chunk on the global staircase.  The cache is written in place and reused
unzeroed.

Not ported: the prompt buckets (`PROMPT_BUCKETS`): prefill runs the exact
prompt length.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.codecs.dac import DACDecoder
from tts_tpu_torch.core.gguf import GGMLType, GGUFFile, GGUFTensor
from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.ops.attention import arrival_counters, attend, prefix_attention
from tts_tpu_torch.ops.qmatmul import apply_linear, load_linear
from tts_tpu_torch.ops.sampling import init_state, sample_tokens
from tts_tpu_torch.ops.spec import SPEC_K, ngram_draft_rows, spec_enabled
from tts_tpu_torch.runtime.api import (GenerationConfig, TTSError, TTSResponse, TTSRunner,
                                       card_device)
from tts_tpu_torch.runtime.step_graph import CapturedStep, device_pos, read_behind
from tts_tpu_torch.text.tokenizers import UnigramTokenizer

# decode steps the host keeps enqueued past the newest row it has read (the
# stop check): at most this many steps run, and are discarded, after a stop
_LOOKAHEAD = 1


@dataclass(frozen=True)
class ParlerConfig:
    """The JAX package's ParlerConfig without the fields nothing reads
    (n_encode_length, use_cross_attn: a request's GenerationConfig turns
    the cross-attention off)."""
    n_layers: int = 24
    hidden_size: int = 1024
    n_attn_heads: int = 16
    n_output_heads: int = 9
    output_vocab_size: int = 1088
    audio_vocab_size: int = 1024
    eos_token_id: int = 1024
    bos_token_id: int = 1025
    max_ctx_length: int = 4096
    # the KV cache's storage and the cross-KV's rounding: f32 for dense
    # checkpoints; the loader switches to bfloat16 when the decoder linears
    # are quantized
    kv_dtype: str = "float32"
    max_generation_size: int = 2580

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.n_attn_heads

    @staticmethod
    def from_gguf_kv(kv: dict) -> "ParlerConfig":
        g = lambda k, d: int(kv.get(k, d))
        return ParlerConfig(
            n_layers=g("parler-tts.decoder.num_hidden_layers", 24),
            hidden_size=g("parler-tts.decoder.hidden_size", 1024),
            n_attn_heads=g("parler-tts.decoder.attention.head_count", 16),
            n_output_heads=g("parler-tts.decoder.output_heads", 9),
            output_vocab_size=g("parler-tts.decoder.out_vocab_size", 1088),
            audio_vocab_size=g("parler-tts.decoder.audio_vocab_size", 1024),
            max_ctx_length=g("parler-tts.decoder.context_length", 4096),
            max_generation_size=g("parler-tts.decoder.max_generation", 2580),
            bos_token_id=g("audio.bos_token_id", 1025),
            eos_token_id=g("audio.eos_token_id", 1024),
        )


def load_parler_params(tensors: dict, cfg: ParlerConfig, device=None,
                       timings: dict | None = None) -> dict:
    """tensors: name -> GGUFTensor (or numpy array).  Quantized decoder
    linears become, by `linear_format`, {"wq", "scales"} (int8, packed on
    the host) or {"wq4", "scales"} (packed int4, unpacked on `device`);
    dense ones {"w": f32 [in, out]}.  Everything else is f32, but the 9
    embeddings stack to "embds" [9, audio_vocab + 2, hidden] and the 9
    heads to "heads" [9, hidden, vocab], in bf16 when any linear is
    quantized.  `timings`, if given, collects packing and upload seconds."""
    device = card_device(device)
    timings = {} if timings is None else timings
    timings.setdefault("pack_s", 0.0)
    timings.setdefault("upload_s", 0.0)

    def raw(name):
        t = tensors.get(name)
        if t is None:
            raise KeyError(f"parler: missing tensor {name}")
        return t

    def get(name):
        t = raw(name)
        if isinstance(t, GGUFTensor):
            t = t.to_numpy(np.float16 if t.ggml_type == GGMLType.F16 else np.float32)
        t0 = time.perf_counter()
        out = torch.from_numpy(np.array(t)).to(device).float()
        timings["upload_s"] += time.perf_counter() - t0
        return out

    def lin(name):
        packed = load_linear(raw(name), device, timings)
        return packed if packed is not None else {"w": get(name).t().contiguous()}

    n_heads = cfg.n_output_heads
    p = {"prompt_embd": get("decoder.embed_prompts"),
         "positional": get("decoder.positional_embed"),
         "text_encoding": get("decoder.text_encoding"),
         "norm_w": get("decoder.layer_norm.weight"),
         "norm_b": get("decoder.layer_norm.bias"),
         "embds": torch.stack([get(f"decoder.embed_tokens.{i}.weight")
                               for i in range(n_heads)]),
         "heads": torch.stack([get(f"decoder.lm_heads.{i}.weight.head").t()
                               for i in range(n_heads)]).contiguous(),
         "layers": []}
    for l in range(cfg.n_layers):
        L = f"decoder.layers.{l}"
        p["layers"].append({
            "sa_norm_w": get(f"{L}.self_attn_layer_norm.weight"),
            "sa_norm_b": get(f"{L}.self_attn_layer_norm.bias"),
            "sa_q": lin(f"{L}.self_attn.q_proj.weight"),
            "sa_k": lin(f"{L}.self_attn.k_proj.weight"),
            "sa_v": lin(f"{L}.self_attn.v_proj.weight"),
            "sa_o": lin(f"{L}.self_attn.out_proj.weight"),
            "ca_norm_w": get(f"{L}.encoder_attn_layer_norm.weight"),
            "ca_norm_b": get(f"{L}.encoder_attn_layer_norm.bias"),
            "ca_q": lin(f"{L}.encoder_attn.q_proj.weight"),
            "ca_k": lin(f"{L}.encoder_attn.k_proj.weight"),
            "ca_v": lin(f"{L}.encoder_attn.v_proj.weight"),
            "ca_o": lin(f"{L}.encoder_attn.out_proj.weight"),
            "fc1": lin(f"{L}.fc1.weight"),
            "fc2": lin(f"{L}.fc2.weight"),
            "out_norm_w": get(f"{L}.final_layer_norm.weight"),
            "out_norm_b": get(f"{L}.final_layer_norm.bias"),
        })
    if parler_params_quantized(p):
        # the heads stream 9 x hidden x vocab values per step; bf16 halves
        # them on already-quantized checkpoints (the head product runs f32)
        p["heads"] = p["heads"].bfloat16()
    return p


def parler_params_quantized(params) -> bool:
    """True if any decoder linear kept its GGUF quantization on the device."""
    return any("w" not in L[n] for L in params["layers"] for n in ("sa_q", "fc1"))


def init_kv_cache(cfg: ParlerConfig, device=None) -> dict:
    """Position-major K/V [L, max_ctx, H, hs] in cfg.kv_dtype, and the
    decode step's `prefix_attention` arrival counters [H] of this cache,
    which every layer's launch leaves at zero."""
    device = card_device(device)
    shape = (cfg.n_layers, cfg.max_ctx_length, cfg.n_attn_heads, cfg.head_size)
    dt = getattr(torch, cfg.kv_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "counters": arrival_counters(cfg.n_attn_heads, device)}


def precompute_cross_kv(params: dict, cfg: ParlerConfig) -> dict:
    """text_encoding [enc, enc_hidden] -> per-layer K/V [L, enc, H, hs]: 2
    products per layer at M = the encoding length.  The values are rounded
    to cfg.kv_dtype, as the JAX package stores them, and kept in f32, which
    the attention reads: no cast per step, for 2x the bytes of a few MB."""
    enc = params["text_encoding"]
    H, hs = cfg.n_attn_heads, cfg.head_size
    dt = getattr(torch, cfg.kv_dtype)

    def proj(name):
        return torch.stack([apply_linear(enc, L[name]).reshape(-1, H, hs).to(dt).float()
                            for L in params["layers"]])
    return {"k": proj("ca_k"), "v": proj("ca_v")}


def _ln(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _transformer(params: dict, cfg: ParlerConfig, x: torch.Tensor, cache: dict,
                 start_pos, cross_kv: dict | None) -> torch.Tensor:
    """x [T, hidden] -> final-normed [T, hidden], writing K/V in place.

    T > 1 (the prefill, a verify window) runs at the int positions
    start_pos.. and attends causally over the live prefix [0, start_pos +
    T).  T == 1 (a decode step) runs at the device position start_pos (an
    int32 tensor [1]; an int is made one): K/V are written at that slot
    with index_copy_ and self-attention is `prefix_attention` over the
    cache layer, so the step has one shape at every position and a
    captured graph of it serves them all.  On the card that is one kernel
    launch a layer reading only the slots <= pos, each byte once in the
    cache's dtype (no f32 copy of the cache, no mask); on the CPU it reads
    all cfg.max_ctx_length slots under the JAX package's additive mask, 0
    where key_pos <= pos and -1e9 past it.  A masked key weighs exp(-1e9 -
    max) = 0 exactly in f32 while its logit is finite, which holds: the
    cache is zeroed when made and every slot past pos holds K/V an earlier
    forward wrote from finite activations (a non-finite one would have
    shown in that forward's own logits), so what earlier requests left
    there changes nothing."""
    H, hs = cfg.n_attn_heads, cfg.head_size
    T = x.shape[0]
    if T == 1:
        pos = device_pos(start_pos, x.device)
        slot = pos.long()
    else:
        end = start_pos + T
        key_pos = torch.arange(end, device=x.device)
        q_pos = start_pos + torch.arange(T, device=x.device)
        mask = torch.where(key_pos[None, :] <= q_pos[:, None], 0.0, -1e9)
    for l, L in enumerate(params["layers"]):
        h = _ln(x, L["sa_norm_w"], L["sa_norm_b"])
        ck, cv = cache["k"][l], cache["v"][l]
        k = apply_linear(h, L["sa_k"]).reshape(T, H, hs).to(ck.dtype)
        v = apply_linear(h, L["sa_v"]).reshape(T, H, hs).to(cv.dtype)
        if T == 1:
            ck.index_copy_(0, slot, k)
            cv.index_copy_(0, slot, v)
        else:
            ck[start_pos:end] = k
            cv[start_pos:end] = v
        q = apply_linear(h, L["sa_q"]).reshape(T, H, hs)
        a = (prefix_attention(q, ck, cv, pos, cache.get("counters")) if T == 1
             else attend(q, ck[:end], cv[:end], mask))
        x = x + apply_linear(a, L["sa_o"])
        if cross_kv is not None:
            h = _ln(x, L["ca_norm_w"], L["ca_norm_b"])
            q = apply_linear(h, L["ca_q"]).reshape(T, H, hs)
            x = x + apply_linear(attend(q, cross_kv["k"][l], cross_kv["v"][l], None), L["ca_o"])
        h = _ln(x, L["out_norm_w"], L["out_norm_b"])
        h = apply_linear(F.gelu(apply_linear(h, L["fc1"]), approximate="tanh"), L["fc2"])
        x = x + h
    return _ln(x, params["norm_w"], params["norm_b"])


def _rows_logits(params: dict, cfg: ParlerConfig, rows: torch.Tensor, pos, cache: dict,
                 cross_kv: dict | None) -> torch.Tensor:
    """Input rows [T, 9] (one token per head) at positions pos.. -> per-head
    logits [T, 9, vocab] f32.  T == 1 reads pos as `_transformer` does: a
    device position, whose positional row is gathered on the device."""
    T = rows.shape[0]
    heads = torch.arange(cfg.n_output_heads, device=rows.device)
    # a head may emit an id past its audio_vocab + 2 embedding rows (the
    # heads are output_vocab wide): the row is clamped, as XLA's gather does
    ids = rows.long().clamp(max=params["embds"].shape[1] - 1)
    if T == 1:
        pos = device_pos(pos, rows.device)
        positional = params["positional"].index_select(0, pos.long())
    else:
        positional = params["positional"][pos:pos + T]
    x = params["embds"][heads[None, :], ids].sum(1) + positional
    x = _transformer(params, cfg, x, cache, pos, cross_kv)
    return torch.matmul(x, params["heads"].to(x.dtype)).transpose(0, 1)


def parler_prefill(params: dict, cfg: ParlerConfig, tokens: torch.Tensor, cache: dict,
                   cross_kv: dict | None):
    """The exact-length text prompt [T] -> K/V at positions 0..T-1 of
    `cache` (in place)."""
    T = tokens.shape[0]
    x = params["prompt_embd"][tokens.long()] + params["positional"][:T]
    _transformer(params, cfg, x, cache, 0, cross_kv)


def parler_decode_step(params: dict, cfg: ParlerConfig, audio_tokens: torch.Tensor, pos,
                       cache: dict, cross_kv: dict | None, generator, sampler_state: dict, *,
                       temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                       repetition_penalty: float = 1.0, do_sample: bool = True,
                       use_top_p: bool = True):
    """One AR step: audio_tokens [9] at position pos (an int, or the device
    int32 tensor [1]) -> (sampled [9] int32, sampler_state)."""
    logits = _rows_logits(params, cfg, audio_tokens[None], pos, cache, cross_kv)[0]
    return sample_tokens(generator, logits, sampler_state, temperature=temperature,
                         top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
                         do_sample=do_sample, use_top_p=use_top_p)


def parler_step0_logits(params: dict, cfg: ParlerConfig, pos: int, cache: dict,
                        cross_kv: dict | None) -> torch.Tensor:
    """Per-head logits [9, vocab] of decode step 0 (the all-BOS row at the
    first decode position), consuming no loop or sampler state: the probe
    that places a mismatch in the backbone or in the sampler and codec.  It
    writes the K/V of that row at pos, which the first decode step writes
    again with the same values."""
    rows = torch.full((1, cfg.n_output_heads), cfg.bos_token_id, dtype=torch.int32,
                      device=cache["k"].device)
    return _rows_logits(params, cfg, rows, pos, cache, cross_kv)[0]


def init_loop_state(cfg: ParlerConfig):
    """The resumable loop carry, on the host: (next input row [9] int32,
    per-head EOS flags [9] bool, global step)."""
    return (np.full(cfg.n_output_heads, cfg.bos_token_id, np.int32),
            np.zeros(cfg.n_output_heads, bool), 0)


def _next_row(cfg: ParlerConfig, row, eos_seen, gstep: int):
    """The staircase input after emitting `row` at global step gstep - 1:
    head h reads BOS until step h, then its own last token, pinned to EOS
    once it has emitted EOS."""
    heads = np.arange(cfg.n_output_heads)
    return np.where(gstep > heads, np.where(eos_seen, cfg.eos_token_id, row),
                    cfg.bos_token_id).astype(np.int32)


class ParlerStep(CapturedStep):
    """One sequential decode step over static device buffers: the body of
    the JAX package's `parler_decode_loop` (the 9-head row embedded at the
    device position, the body at T = 1, the 9 heads, `sample_tokens`, the
    EOS flags and the BOS-delay staircase of the next row), keyed as that
    jit is: one per KV cache, cross-KV (or None) and static (top_k,
    do_sample, use_top_p).  Its buffers: the next input row `row` [9], the
    EOS flags `eos` [9], `gstep` and `pos` [1] (each step advances both in
    place), the sampler state `last` / `count` [9] and the 0-d f32
    temperature, top_p and repetition penalty, which the sampler reads as
    tensors.  `buf` is [sampled row | count] after the latest step, the
    static slot the host copies out.

    With `capture` (a card only) the step is captured at its first `run`
    and replayed by every later one (`runtime/step_graph.py`); without it
    `run` calls the same step."""

    label = "parler"

    def __init__(self, params: dict, cfg: ParlerConfig, cache: dict, cross_kv: dict | None,
                 generator: torch.Generator | None, device, *, top_k: int = 0,
                 do_sample: bool = True, use_top_p: bool = True, capture: bool = False):
        super().__init__(device, generator, top_k=top_k, do_sample=do_sample,
                         use_top_p=use_top_p, capture=capture)
        self.params, self.cfg, self.cache, self.cross_kv = params, cfg, cache, cross_kv
        H = cfg.n_output_heads
        with torch.inference_mode():
            self.buf = torch.zeros(2 * H, dtype=torch.int32, device=self.device)
            self.row = torch.full((H,), cfg.bos_token_id, dtype=torch.int32, device=self.device)
            self.eos = torch.zeros(H, dtype=torch.bool, device=self.device)
            self.gstep = torch.zeros(1, dtype=torch.int32, device=self.device)
            self.pos = torch.zeros(1, dtype=torch.int32, device=self.device)
            self.heads = torch.arange(H, dtype=torch.int32, device=self.device)
        self.state = {"last": self.buf[:H], "count": self.buf[H:]}

    def load(self, loop_state, pos: int, state: dict, *, temperature: float = 1.0,
             top_p: float = 1.0, repetition_penalty: float = 1.0):
        """Set the buffers from the host loop state (next row, EOS flags,
        global step), the position and the sampler state."""
        tokens, eos_seen, gstep = loop_state
        with torch.inference_mode():
            self.row.copy_(torch.from_numpy(np.asarray(tokens, np.int32)))
            self.eos.copy_(torch.from_numpy(np.asarray(eos_seen, bool)))
            self.gstep.fill_(gstep)
            self.pos.fill_(pos)
        self._load_sampler(state, temperature, top_p, repetition_penalty)

    def _step(self):
        cfg = self.cfg
        logits = _rows_logits(self.params, cfg, self.row[None], self.pos, self.cache,
                              self.cross_kv)[0]
        tokens, state = self._sample(logits)
        # in place, read by the next step in stream order
        self.eos |= tokens == cfg.eos_token_id
        self.gstep += 1
        self.row.copy_(torch.where(self.heads < self.gstep,
                                   torch.where(self.eos, cfg.eos_token_id, tokens),
                                   cfg.bos_token_id))
        self.pos += 1
        self.buf.copy_(torch.cat([tokens, state["count"]]))


def parler_decode_loop(params: dict, cfg: ParlerConfig, start_pos: int, limit: int,
                       cache: dict, cross_kv: dict | None, generator, sampler_state: dict,
                       loop_state, *, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0, repetition_penalty: float = 1.0,
                       do_sample: bool = True, use_top_p: bool = True,
                       step: ParlerStep | None = None):
    """The sequential 9-head loop: up to `limit` steps from `loop_state`,
    stopping after the row in which the last head emits EOS.  Returns (rows
    [n, 9] int32 numpy, the sampler state after the last row, the loop
    state after it).  The staircase follows the global step of
    `loop_state`, so chunked calls decode what one call would; `generator`
    advances in place.

    `step` makes each step (`step.run()`): a runner's `ParlerStep` of this
    key, cache, cross-KV and generator; None makes an uncaptured one for
    this call (eager steps).  The step loads `loop_state` and keeps the
    next row, the EOS flags and the global step on the device; the host
    reads each step's [sampled row | count] `_LOOKAHEAD` steps behind
    (`read_behind`) while it checks for the stop."""
    tokens, eos_seen, gstep = loop_state
    H = cfg.n_output_heads
    if limit <= 0 or eos_seen.all():
        return np.zeros((0, H), np.int32), sampler_state, loop_state
    device = cache["k"].device
    if step is None:
        step = ParlerStep(params, cfg, cache, cross_kv, generator, device, top_k=top_k,
                          do_sample=do_sample, use_top_p=use_top_p)
    elif (step.key != (top_k, do_sample, use_top_p) or step.generator is not generator
          or step.cache is not cache or step.cross_kv is not cross_kv):
        raise ValueError(f"parler_decode_loop: the step is keyed {step.key} on its own cache, "
                         f"cross-KV and generator, not {(top_k, do_sample, use_top_p)} on these")
    step.load(loop_state, start_pos, sampler_state, temperature=temperature, top_p=top_p,
              repetition_penalty=repetition_penalty)
    eos_host = eos_seen.copy()
    rows: list[np.ndarray] = []
    for last in read_behind(step, limit, _LOOKAHEAD):
        rows.append(last[:H].numpy().copy())
        eos_host |= rows[-1] == cfg.eos_token_id
        if eos_host.all():
            break
    state = {"last": last[:H].to(device, copy=True), "count": last[H:].to(device, copy=True)}
    g = gstep + len(rows)
    return np.stack(rows), state, (_next_row(cfg, rows[-1], eos_host, g), eos_host, g)


def parler_decode_loop_spec_resume(params: dict, cfg: ParlerConfig, start_pos: int, limit: int,
                                   cache: dict, cross_kv: dict | None, loop_state,
                                   out: np.ndarray, *, k: int = SPEC_K,
                                   force_miss: bool = False):
    """The resumable greedy speculative 9-head loop.  Each iteration drafts
    k rows by prompt lookup over the rows emitted so far
    (`ngram_draft_rows`), builds the k + 1 staircase input rows the
    sequential loop would feed along the draft path (BOS delays, per-head
    EOS pinning), verifies them in one forward, and accepts the longest
    prefix on which all 9 argmaxes agree with the drafts, plus the model's
    own next row; emission stops after the row in which the last head
    emits EOS.  The emitted rows are the model's own greedy outputs, the
    sequential loop's.  `force_miss` rejects every draft: one row per
    forward, the floor.

    `out` [max_gen + k + 1, 9] (numpy, EOS-filled past the emitted rows)
    holds every row emitted so far and takes the new ones in place;
    `limit` is the global emission bound for this call.  K/V written for
    rejected drafts sit past the accepted position and are written again
    before any query reads them.  Returns (out, loop_state, next position)."""
    tokens, eos_seen, gstep = loop_state
    H = cfg.n_output_heads
    device = cache["k"].device
    pos = start_pos
    while gstep < limit and not eos_seen.all():
        # draft id -1 never equals an argmax
        drafts = (np.full((k, H), -1, np.int32) if force_miss
                  else ngram_draft_rows(out, gstep, k))
        ins = [tokens]
        eos = eos_seen
        for j in range(1, k + 1):
            eos = eos | (drafts[j - 1] == cfg.eos_token_id)
            ins.append(_next_row(cfg, drafts[j - 1], eos, gstep + j))
        # rows past the context are never emitted (limit <= max_ctx - prompt)
        w = min(k + 1, cfg.max_ctx_length - pos)
        rows = torch.from_numpy(np.stack(ins[:w])).to(device)
        logits = _rows_logits(params, cfg, rows, pos, cache, cross_kv)
        g = logits.argmax(-1).to(torch.int32).cpu().numpy()            # [w, 9]
        agree = np.cumprod((drafts[:w - 1] == g[:-1]).all(axis=1))
        n_acc = int(agree.sum())
        eos_after = eos_seen[None, :] | (np.cumsum(g == cfg.eos_token_id, axis=0) > 0)
        done = eos_after.all(axis=1) & (np.arange(w) <= n_acc)
        n_emit = int(done.argmax()) + 1 if done.any() else n_acc + 1
        n_emit = min(n_emit, limit - gstep)
        out[gstep:gstep + n_emit] = g[:n_emit]
        eos_seen = eos_after[n_emit - 1]
        gstep += n_emit
        tokens = _next_row(cfg, g[n_emit - 1], eos_seen, gstep)
        pos += n_emit
    return out, (tokens, eos_seen, gstep), pos


def adjust_output_tokens(output: np.ndarray, cfg: ParlerConfig) -> np.ndarray:
    """Delay un-weave and invalid-token filter: output [steps, 9] ->
    [frames, 9] with frame i head h = output[i + h, h]; a frame holding any
    id >= audio_vocab_size (EOS, BOS, ...) is dropped."""
    steps = len(output)
    frames = []
    for i in range(steps):
        idx = i + np.arange(cfg.n_output_heads)
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


class ParlerRunner(TTSRunner):
    sample_rate = 44100
    architecture = "parler-tts"
    device_arrays = ("params", "cross_kv", "_cache")
    device_components = ("dac",)

    def __init__(self, cfg: ParlerConfig, params: dict, tokenizer: UnigramTokenizer,
                 dac: DACDecoder, device=None):
        """`device` defaults to the device the params live on.

        `decode_route` is how sequential steps run: "graph" (a captured
        `ParlerStep` per key, replayed) on a card, "eager" on the CPU; a
        caller may set "eager" on the card to compare the two.  The runner
        owns one generator on its device, reseeded per request, which its
        graphs register."""
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.dac = dac
        self.device = torch.device(device if device is not None
                                   else params["positional"].device)
        with torch.inference_mode():
            self.cross_kv = precompute_cross_kv(params, cfg)
        self._cache = None
        self.capture_trace = False
        self.last_trace: dict = {}
        self.load_timings: dict = {}
        self.decode_route = "graph" if self.device.type == "cuda" else "eager"
        self._generator: torch.Generator | None = None     # made at the first request
        self._steps: dict = {}

    def update_conditional_prompt(self, text_encoder_path: str, prompt: str):
        """Re-encode the voice-conditioning prompt with a T5 GGUF and
        recompute the cross-KV.  Not safe to call while another thread
        generates with this runner: the server serializes both through the
        runner's lock, and direct callers must do the same."""
        from tts_tpu_torch.models.t5 import T5Runner

        with GGUFFile(text_encoder_path) as f:
            t5 = T5Runner.from_gguf(f, tokenizer=self.tokenizer, device=self.device)
            encoding = t5.encode(prompt)
        del t5
        self.params["text_encoding"] = torch.from_numpy(encoding).to(self.device)
        with torch.inference_mode():
            self.cross_kv = precompute_cross_kv(self.params, self.cfg)
        # a graph captured on the old cross-KV would read its freed memory
        self._steps = {k: s for k, s in self._steps.items() if s.cross_kv is None}

    def _prompt_ids(self, text: str) -> list[int]:
        ids = self.tokenizer.tokenize(text) + [self.tokenizer.eos_token]
        if len(ids) >= self.cfg.max_ctx_length:
            raise TTSError(f"The prompt ({len(ids)} tokens) leaves no room to decode in the "
                           f"{self.cfg.max_ctx_length}-position context.")
        return ids

    def _prefill(self, ids: list[int], config: GenerationConfig):
        """Prompt prefill; returns (cross_kv or None, the runner's generator
        reseeded for this request, sampler state, max_steps)."""
        cfg = self.cfg
        cross = self.cross_kv if config.use_cross_attn else None
        if self._cache is None:
            self._cache = init_kv_cache(cfg, self.device)
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        parler_prefill(self.params, cfg, torch.tensor(ids, device=self.device), self._cache,
                       cross)
        generator = self._generator
        generator.manual_seed(config.seed if config.seed is not None
                              else np.random.randint(0, 2**31 - 1))
        max_steps = min(config.max_tokens or cfg.max_generation_size,
                        cfg.max_generation_size, cfg.max_ctx_length - len(ids))
        return cross, generator, init_state(cfg.n_output_heads, self.device), max_steps

    def _sample_kw(self, config: GenerationConfig) -> dict:
        return dict(temperature=config.temperature, top_k=config.top_k, top_p=config.top_p,
                    repetition_penalty=config.repetition_penalty, do_sample=config.sample,
                    use_top_p=config.top_p < 1.0)

    def _out_buffer(self) -> np.ndarray:
        cfg = self.cfg
        return np.full((cfg.max_generation_size + SPEC_K + 1, cfg.n_output_heads),
                       cfg.eos_token_id, np.int32)

    def _decode_step(self, config: GenerationConfig, cross: dict | None) -> ParlerStep:
        """The `ParlerStep` of this request's key on `decode_route`, made
        (and on the "graph" route captured at its first step) once per KV
        cache, cross-KV and params."""
        kw = self._sample_kw(config)
        key = (self.decode_route, kw["top_k"], kw["do_sample"], kw["use_top_p"], cross is None)
        step = self._steps.get(key)
        if (step is None or step.cache is not self._cache or step.cross_kv is not cross
                or step.params is not self.params):
            step = self._steps[key] = ParlerStep(
                self.params, self.cfg, self._cache, cross, self._generator, self.device,
                top_k=key[1], do_sample=key[2], use_top_p=key[3],
                capture=self.decode_route == "graph")
        return step

    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        chunk_steps: int = 48):
        """Yield audio as it is made: the loop runs `chunk_steps` rows at a
        time (the host loop state keeps the staircase global), and the DAC
        decodes bounded windows with emission held RECEPTIVE_FRAMES behind
        the un-weaved frame head, so the chunks concatenate to generate()'s
        audio for the same tokens.  Greedy requests take the speculative
        loop chunk by chunk (the carried row buffer keeps the drafter's
        history); sampled ones the sequential loop, whose generator carries
        across chunks."""
        config = config or GenerationConfig()
        cfg = self.cfg
        ids = self._prompt_ids(text)
        T = len(ids)
        with torch.inference_mode():
            cross, generator, sampler_state, max_steps = self._prefill(ids, config)
        loop_state = init_loop_state(cfg)
        spec = spec_enabled(config)
        out_buf = self._out_buffer() if spec else None
        outputs = np.zeros((0, cfg.n_output_heads), np.int32)
        emitted = 0
        done = False
        while not done and len(outputs) < max_steps:
            budget = min(chunk_steps, max_steps - len(outputs))
            i_cum = len(outputs)
            with torch.inference_mode():
                if spec:
                    out_buf, loop_state, _ = parler_decode_loop_spec_resume(
                        self.params, cfg, T + i_cum, i_cum + budget, self._cache, cross,
                        loop_state, out_buf)
                    new = out_buf[i_cum:loop_state[2]]
                else:
                    new, sampler_state, loop_state = parler_decode_loop(
                        self.params, cfg, T + i_cum, budget, self._cache, cross, generator,
                        sampler_state, loop_state, step=self._decode_step(config, cross),
                        **self._sample_kw(config))
            done = len(new) < budget                   # every head emitted EOS
            outputs = np.concatenate([outputs, new])
            frames = adjust_output_tokens(outputs, cfg)
            target = (len(frames) if done or len(outputs) >= max_steps
                      else len(frames) - self.dac.RECEPTIVE_FRAMES)
            if target > emitted:
                audio = self.dac.decode_window(frames, emitted, target)
                emitted = target
                if len(audio):
                    yield audio

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        cfg = self.cfg
        t0 = time.perf_counter()
        ids = self._prompt_ids(text)
        T = len(ids)
        trace = {} if self.capture_trace else None
        with torch.inference_mode():
            cross, generator, sampler_state, max_steps = self._prefill(ids, config)
            _sync(self.device)
            t_prefill = time.perf_counter()
            if trace is not None:
                from tts_tpu_torch.utils.trace import multihead_logit_stats

                trace["prompt_ids"] = [int(i) for i in ids[:24]]
                trace["n_prompt_tokens"] = T
                trace["step0_logits"] = multihead_logit_stats(
                    parler_step0_logits(self.params, cfg, T, self._cache, cross).cpu().numpy())
            if spec_enabled(config):
                route = "spec"
                out, loop_state, _ = parler_decode_loop_spec_resume(
                    self.params, cfg, T, max_steps, self._cache, cross, init_loop_state(cfg),
                    self._out_buffer())
                outputs = out[:loop_state[2]]
            else:
                step = self._decode_step(config, cross)
                route = step.route
                outputs, _, _ = parler_decode_loop(
                    self.params, cfg, T, max_steps, self._cache, cross, generator,
                    sampler_state, init_loop_state(cfg), step=step, **self._sample_kw(config))
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
            timings={"prompt_tokens": T,
                     "prefill_ms": (t_prefill - t0) * 1e3,
                     "decode_ms": (t_decode - t_prefill) * 1e3,
                     "decode_steps": len(outputs),
                     "decode_route": route,
                     "frames": int(len(frames)),
                     "codec_ms": (t_end - t_decode) * 1e3})


@register_loader("parler-tts")
def load_parler_runner(gguf_file, config: GenerationConfig, device) -> ParlerRunner:
    """Quantized decoder linears stay int8 / int4 on `device`, with a bf16
    cache and bf16 heads; the DAC loads as f32."""
    cfg = ParlerConfig.from_gguf_kv(gguf_file.kv)
    t0 = time.perf_counter()
    timings: dict = {}
    params = load_parler_params(dict(gguf_file.tensors), cfg, device, timings)
    if parler_params_quantized(params):
        cfg = dataclasses.replace(cfg, kv_dtype="bfloat16")
    dac_tensors = {n: t for n, t in gguf_file.tensors.items()
                   if n.startswith(("audio_encoder.", "dac."))}
    dac = DACDecoder.from_tensors(dac_tensors, gguf_file.kv, device)
    runner = ParlerRunner(cfg, params, UnigramTokenizer.from_gguf_kv(gguf_file.kv), dac, device)
    _sync(torch.device(device))
    runner.load_timings = {**timings, "total_s": time.perf_counter() - t0}
    return runner
