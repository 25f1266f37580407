"""Orpheus-3B: a Llama-3.2-3B backbone generating SNAC audio tokens.

Counterpart of `tts_tpu/models/orpheus.py`: 28 layers, GQA (24 query / 8 KV
heads), RMS norms, SiLU-gated MLP, llama-3 scaled RoPE, the voice prompt
frame, and the 7-token frame -> 3 SNAC codebook redistribution.  Quantized
linears stay on the device with f16 block scales, as int8 (Q8_0 / Q5_0) or
packed int4 (Q4_0), by `ops.qmatmul.linear_format`'s rule, and run through
the hand-written kernels of `ops/qmatmul.py`; single-token attention runs
the flash-decode kernel of `ops/attention.py` over a head-major bf16 (or
int8) KV cache.

Decode is a host loop, with the JAX runner's routes: sampled requests take
the sequential loop of eager steps (the position stays on the device as an
int32 tensor; each token is read back one step behind), greedy ones the
speculative loop, which drafts by prompt lookup on the host
(`ops.spec.ngram_drafts`), verifies 8 tokens in one forward at the live
position and accepts the agreeing prefix, with one read of the window's
argmaxes per forward.  `generate_stream` resumes either loop in 70-token
chunks and decodes SNAC windows held RECEPTIVE_FRAMES behind the head.
The cache is reused unzeroed: a forward reads only the slots it or an
earlier one of its request wrote.

Not ported: the prompt buckets (prefill runs the exact prompt length), the
AOT export cache, and the tensor-parallel shard_map islands
(`make_tp_context`, `_tp_qlinear`, `_flash_decode_tp`).
"""

from __future__ import annotations

import collections
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
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError, TTSResponse, TTSRunner
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
    """The JAX package's config without its TPU-only fields (use_flash_attn:
    decode here always takes the flash kernel; tp: no tensor parallelism)
    and the BOS/EOS ids, which only the tokenizer reads."""
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


def load_orpheus_params(tensors: dict, cfg: OrpheusConfig, device="cpu",
                        timings: dict | None = None) -> dict:
    """tensors: name -> GGUFTensor (or numpy array).  Quantized linears
    become, by `linear_format`, {"wq": int8 [in, out], "scales": f16
    [in/32, out]} (Q8_0 / Q5_0, packed on the host) or {"wq4": int8
    [in/2, out], "scales"} (Q4_0: the raw blocks are uploaded and unpacked
    on `device`); q/k/v and gate/up of one layout fuse along the output dim;
    the lm_head pads to 1024 columns.  `timings`, if given, collects packing
    and upload seconds."""
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
        return linear(x.float()[None], params["head"])[0, : cfg.vocab_size]
    return linear(x.float(), params["head"])[:, : cfg.vocab_size]


def padded_cache_length(cfg: OrpheusConfig) -> int:
    return -(-cfg.cache_length // S_CHUNK) * S_CHUNK


def init_kv_cache(cfg: OrpheusConfig, device="cpu") -> dict:
    """Head-major cache [L, Hkv, S, hs], S padded to the kernel's 512 chunk;
    with cfg.kv_quant int8 k/v plus f32 scales ks/vs [L, Hkv, S]; and the
    flash-decode arrival counters of this cache, which every layer's launch
    leaves at zero.  Entries past a request's position are never read, so
    it is reused unzeroed."""
    shape = (cfg.n_layers, cfg.n_kv_attn_heads, padded_cache_length(cfg), cfg.head_size)
    counters = arrival_counters(cfg.n_kv_attn_heads, device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:3], device=device),
                "vs": torch.zeros(shape[:3], device=device), "counters": counters}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device), "counters": counters}


def _gqa_attention(q, k, v, mask, cfg: OrpheusConfig):
    """q [T, Hq, hs] against head-major k/v [Hkv, Tk, hs], in f32, without
    repeating KV heads (the prefill path; no kernel served it on the TPU)."""
    Hkv = cfg.n_kv_attn_heads
    T = q.shape[0]
    qg = q.reshape(T, Hkv, cfg.n_attn_heads // Hkv, cfg.head_size).float()
    logits = torch.einsum("qhgd,hkd->hgqk", qg, k.float()) / math.sqrt(cfg.head_size)
    w = torch.softmax(logits + mask, dim=-1)
    attn = torch.einsum("hgqk,hkd->qhgd", w, v.float())
    return attn.reshape(T, cfg.n_attn_heads * cfg.head_size)


def _orpheus_body(params: dict, cfg: OrpheusConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: dict, start: int = 0) -> torch.Tensor:
    """tokens/positions [T] -> final-normed hidden [T, H] (bf16), writing K/V
    at `positions` into `cache` in place.  T == 1 is a decode step (flash
    kernel; positions is the device int32 position); T > 1 runs at the
    positions start..start+T-1 (the prefill from 0, a verify window) and
    attends causally over the live slots [0, start + T) alone: slots past
    them may hold a rejected draft's K/V and are never read."""
    T = tokens.shape[0]
    x = params["embd"][tokens.long()]
    quant = "ks" in cache
    Hq, Hkv, hs = cfg.n_attn_heads, cfg.n_kv_attn_heads, cfg.head_size
    cos, sin = _rope_tables(positions, params["rope_factors"], cfg.rope_theta, hs)
    slots = positions.long()
    end = start + T
    if T > 1:
        key_pos = torch.arange(end, device=x.device)
        mask = torch.where(key_pos[None, :] <= positions[:, None], 0.0, -1e9)

    for l, L in enumerate(params["layers"]):
        res = x
        h = _rms(x, L["in_norm"])
        if "qkv" in L:
            qkv = linear(h, L["qkv"]).to(x.dtype)
            q, k, v = torch.split(qkv, [Hq * hs, Hkv * hs, Hkv * hs], dim=-1)
        else:
            q, k, v = (linear(h, L[n]).to(x.dtype) for n in ("q", "k", "v"))
        q = _rope(q.reshape(T, Hq, hs), cos, sin)
        k = _rope(k.reshape(T, Hkv, hs), cos, sin)
        v = v.reshape(T, Hkv, hs)
        ck, cv = cache["k"][l], cache["v"][l]
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            cks, cvs = cache["ks"][l], cache["vs"][l]
            ck.index_copy_(1, slots, kq.transpose(0, 1))
            cv.index_copy_(1, slots, vq.transpose(0, 1))
            cks.index_copy_(1, slots, ksc.t())
            cvs.index_copy_(1, slots, vsc.t())
        else:
            ck.index_copy_(1, slots, k.transpose(0, 1).to(ck.dtype))
            cv.index_copy_(1, slots, v.transpose(0, 1).to(cv.dtype))
        if T == 1:
            attn = flash_decode(q[0].float(), ck, cv, positions, cks if quant else None,
                                cvs if quant else None, cache["counters"])
        elif quant:
            attn = _gqa_attention(q, ck[:, :end].float() * cks[:, :end, None],
                                  cv[:, :end].float() * cvs[:, :end, None], mask, cfg)
        else:
            attn = _gqa_attention(q, ck[:, :end], cv[:, :end], mask, cfg)
        x = res + linear(attn.reshape(T, Hq * hs).to(x.dtype), L["o"]).to(x.dtype)
        res = x
        h = _rms(x, L["post_norm"])
        if "gateup" in L:
            gate, up = linear(h, L["gateup"]).chunk(2, dim=-1)
        else:
            gate, up = linear(h, L["gate"]), linear(h, L["up"])
        h = linear((torch.nn.functional.silu(gate) * up).to(x.dtype), L["down"]).to(x.dtype)
        x = res + h
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


def orpheus_decode_loop(params: dict, cfg: OrpheusConfig, first_token: torch.Tensor,
                        start_pos: int, limit: int, cache: dict,
                        generator: torch.Generator | None, sampler_state: dict, *,
                        temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                        repetition_penalty: float = 1.0, do_sample: bool = True,
                        use_top_p: bool = True):
    """Sequential decode of up to `limit` tokens after `first_token` [1],
    stopping at (and including) the stop token, as the JAX loop does.
    Returns (tokens list[int], sampler_state after the last token).

    Each sampled token is copied to pinned host memory behind an event, and
    the host reads it once `_LOOKAHEAD` later steps are enqueued: the card
    keeps working while the host checks for the stop token."""
    out: list[int] = []
    if limit <= 0 or int(first_token[0]) == cfg.stopping_token_id:
        return out, sampler_state
    device = first_token.device
    cuda = device.type == "cuda"
    host = torch.empty(limit, dtype=torch.int32, pin_memory=cuda)
    pending: collections.deque = collections.deque()   # (event, state) per unread step
    token = first_token
    pos = torch.tensor([start_pos], dtype=torch.int32, device=device)
    enqueued = 0
    while len(out) < limit:
        if enqueued < limit:
            logits = orpheus_decode_step(params, cfg, token, pos, cache)
            token, sampler_state = sample_tokens(
                generator, logits[None], sampler_state, temperature=temperature,
                top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
                do_sample=do_sample, use_top_p=use_top_p)
            pos += 1       # in place: the enqueued steps read it in stream order
            host[enqueued:enqueued + 1].copy_(token, non_blocking=cuda)
            event = torch.cuda.Event() if cuda else None
            if event is not None:
                event.record()
            pending.append((event, sampler_state))
            enqueued += 1
            if len(pending) <= _LOOKAHEAD and enqueued < limit:
                continue
        event, state = pending.popleft()
        if event is not None:
            event.synchronize()
        out.append(int(host[len(out)]))
        if out[-1] == cfg.stopping_token_id:
            return out, state
    return out, sampler_state


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
    S = cache["k"].shape[2]
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

    def __init__(self, cfg: OrpheusConfig, params: dict, tokenizer: BPETokenizer,
                 snac: SNACDecoder, device=None):
        """`device` defaults to the device the params live on (the card,
        where the loader's default put them)."""
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.snac = snac
        embd = params.get("embd")
        self.device = torch.device(device if device is not None
                                   else embd.device if embd is not None else "cuda")
        self._cache = None
        self.capture_trace = False
        self.last_trace: dict = {}
        self.load_timings: dict = {}

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
        """Prompt prefill and the first token; returns (prefill logits,
        first token [1], generator, sampler state, max_steps)."""
        cfg = self.cfg
        if self._cache is None:
            self._cache = init_kv_cache(cfg, self.device)
        logits = orpheus_prefill(self.params, cfg, torch.tensor(ids, device=self.device),
                                 self._cache)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(config.seed if config.seed is not None
                              else np.random.randint(0, 2**31 - 1))
        first, state = sample_tokens(generator, logits[None], init_state(1, self.device),
                                     **self._sample_kw(config))
        max_steps = min(config.max_tokens or cfg.max_generation_size, cfg.max_generation_size)
        return logits, first, generator, state, max_steps

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
                rest = orpheus_decode_loop_spec(self.params, cfg, int(first[0]), len(ids),
                                                max_steps - 1, self._cache)
            else:
                rest, _ = orpheus_decode_loop(self.params, cfg, first, len(ids), max_steps - 1,
                                              self._cache, generator, state,
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
                     "codec_ms": (t_end - t_decode) * 1e3})


@register_loader("orpheus")
def load_orpheus_runner(gguf_file, config: GenerationConfig, device) -> OrpheusRunner:
    """TTS_TPU_ORPHEUS_KV=int8 switches to the int8 KV cache, as in the JAX
    package."""
    cfg = OrpheusConfig.from_gguf_kv(gguf_file.kv)
    if os.environ.get("TTS_TPU_ORPHEUS_KV", "").lower() == "int8":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    t0 = time.perf_counter()
    timings: dict = {}
    params = load_orpheus_params(dict(gguf_file.tensors), cfg, device, timings)
    snac_tensors = {n: t for n, t in gguf_file.tensors.items() if n.startswith("snac.")}
    snac = SNACDecoder.from_tensors(snac_tensors, gguf_file.kv, device)
    runner = OrpheusRunner(cfg, params, BPETokenizer.from_gguf_kv(gguf_file.kv), snac, device)
    _sync(torch.device(device))
    runner.load_timings = {**timings, "total_s": time.perf_counter() - t0}
    return runner
