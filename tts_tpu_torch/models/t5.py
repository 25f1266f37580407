"""T5 text encoder: Parler's conditional-prompt encoder.

Counterpart of `tts_tpu/models/t5.py`: an encoder-only T5 with relative
position buckets, RMS norms, a gated-GELU FFN and an optional
down-projection to the Parler hidden size.  Its products are plain matrix
products (`F.linear` on f32 weights), as they were plain `x @ W` under XLA.

NOTE(parity): the reference computes log(ab/max_exact) with integer
division, which collapses the buckets in [max_exact, 2*max_exact); this,
like the JAX package, uses the real T5 formula (float), which is what the
checkpoint was trained with.

It runs the exact token count.  Not ported: `TOKEN_BUCKETS` and the token
mask, which exist so that XLA compiles one graph per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.core.device import card_device
from tts_tpu_torch.core.gguf import GGMLType, GGUFTensor
from tts_tpu_torch.text.tokenizers import UnigramTokenizer


@dataclass(frozen=True)
class T5Config:
    n_layers: int = 24
    hidden_size: int = 2048
    n_attn_heads: int = 32
    relative_attn_buckets: int = 32
    max_distance: int = 128
    eos_token_id: int = 1
    bos_token_id: int = 0
    max_context_length: int = 512
    vocab_size: int = 32128
    output_size: int | None = None

    @property
    def head_size(self) -> int:
        return 64  # T5's fixed d_kv

    @staticmethod
    def from_gguf_kv(kv: dict) -> "T5Config":
        g = lambda k, d: int(kv.get(k, d))
        return T5Config(
            n_layers=g("t5encoder.block_count", 24),
            hidden_size=g("t5encoder.embedding_length", 2048),
            n_attn_heads=g("t5encoder.attention.head_count", 32),
            max_context_length=g("t5encoder.context_length", 512),
            vocab_size=g("t5encoder.vocab_size", 32128),
            output_size=g("t5encoder.output_size", 0) or None,
            bos_token_id=g("tokenizer.ggml.bos_token_id", 0),
            eos_token_id=g("tokenizer.ggml.eos_token_id", 1),
        )


def load_t5_params(tensors: dict, cfg: T5Config, device=None) -> dict:
    """tensors: name -> GGUFTensor or numpy array.  Every tensor becomes f32
    on `device` (F16 ones are uploaded as F16 and widened there); linears
    keep their [out, in] layout for `F.linear`."""
    device = card_device(device)

    def get(name, optional=False):
        t = tensors.get(name)
        if t is None:
            if optional:
                return None
            raise KeyError(f"t5: missing tensor {name}")
        if isinstance(t, GGUFTensor):
            t = t.to_numpy(np.float16 if t.ggml_type == GGMLType.F16 else np.float32)
        return torch.from_numpy(np.array(t)).to(device).float()

    p = {"embd": get("t5encoder.token_embd"),
         "out_norm": get("t5encoder.enc.final_layer_norm"),
         "rel_b": get("t5encoder.enc.blk.0.attn_rel_b"),   # [n_buckets, heads]
         "layers": []}
    down = get("t5encoder.down_proj", optional=True)
    if down is not None:
        p["down_proj"] = down
        p["down_proj_b"] = get("t5encoder.down_proj_bias")
    for i in range(cfg.n_layers):
        L = f"t5encoder.enc.blk.{i}"
        p["layers"].append({
            "attn_norm": get(f"{L}.attn_norm"),
            "q": get(f"{L}.attn_q"), "k": get(f"{L}.attn_k"),
            "v": get(f"{L}.attn_v"), "o": get(f"{L}.attn_o"),
            "ffn_norm": get(f"{L}.ffn_norm"),
            "wi_0": get(f"{L}.ffn_up"), "wi_1": get(f"{L}.ffn_gate"),
            "wo": get(f"{L}.ffn_down"),
        })
    return p


def _rms_norm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def relative_position_buckets(n: int, n_buckets: int = 32, max_distance: int = 128,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 relative position buckets [n, n] (query, key):
    rel = key - query, offset by half the buckets for future keys (the
    JAX package's convention, held to transformers' T5EncoderModel)."""
    device = card_device(device)
    half = n_buckets // 2
    max_exact = half // 2
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    rel = k - q
    out = np.where(rel > 0, half, 0)
    ab = np.abs(rel)
    log_big = (max_exact +
               (np.log(np.maximum(ab, 1) / max_exact)
                / np.log(max_distance / max_exact) * max_exact)).astype(np.int64)
    val = np.where(ab < max_exact, ab, np.minimum(half - 1, log_big))
    return torch.from_numpy(out + val).to(device)


def t5_encode(params: dict, cfg: T5Config, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [T] -> hidden states [T, output_size] f32."""
    T = tokens.shape[0]
    x = params["embd"][tokens.long()]
    buckets = relative_position_buckets(T, cfg.relative_attn_buckets, cfg.max_distance,
                                        x.device)
    pos_bias = params["rel_b"][buckets].permute(2, 0, 1)      # [heads, q, k]
    H, hs = cfg.n_attn_heads, cfg.head_size
    for L in params["layers"]:
        h = _rms_norm(x, L["attn_norm"])
        q = F.linear(h, L["q"]).reshape(T, H, hs)
        k = F.linear(h, L["k"]).reshape(T, H, hs)
        v = F.linear(h, L["v"]).reshape(T, H, hs)
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) + pos_bias, dim=-1)
        attn = torch.einsum("hqk,khd->qhd", w, v).reshape(T, H * hs)
        x = x + F.linear(attn, L["o"])

        h = _rms_norm(x, L["ffn_norm"])
        h = F.gelu(F.linear(h, L["wi_0"]), approximate="tanh") * F.linear(h, L["wi_1"])
        x = x + F.linear(h, L["wo"])

    x = _rms_norm(x, params["out_norm"])
    if "down_proj" in params:
        x = F.linear(x, params["down_proj"], params["down_proj_b"])
    return x


class T5Runner:
    """Standalone text encoder: text -> [tokens, output_size] numpy."""

    def __init__(self, cfg: T5Config, params: dict, tokenizer: UnigramTokenizer):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer

    @classmethod
    def from_gguf(cls, gguf_file, tokenizer: UnigramTokenizer | None = None,
                  device=None) -> "T5Runner":
        """Load onto `device`, the card when None (no card: TTSError)."""
        device = card_device(device)
        cfg = T5Config.from_gguf_kv(gguf_file.kv)
        tokenizer = tokenizer or UnigramTokenizer.from_gguf_kv(gguf_file.kv)
        return cls(cfg, load_t5_params(dict(gguf_file.tensors), cfg, device), tokenizer)

    def encode(self, text: str) -> np.ndarray:
        ids = self.tokenizer.tokenize(text) + [self.cfg.eos_token_id]
        device = self.params["embd"].device
        with torch.inference_mode():
            out = t5_encode(self.params, self.cfg, torch.tensor(ids, device=device))
        return out.cpu().numpy()
