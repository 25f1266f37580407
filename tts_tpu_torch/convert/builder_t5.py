"""Seeded random-weight T5 encoder GGUFs (the t5encoder layout), up to the
widths of flan-t5-large, Parler-TTS mini v1's prompt encoder.

The port's own copy of `tts_tpu/convert/builder_t5.py`: with its defaults
the same arguments give a byte-identical file.  `out_size=None` leaves out
the down-projection (flan-t5-large's d_model is already Parler mini's
hidden size), and `dtype=np.float16` halves the full-width file (0.7 GB
against 1.4 GB); the loader widens it to f32.
"""

from __future__ import annotations

import numpy as np

from tts_tpu_torch.core.gguf import GGUFWriter

# google/flan-t5-large's encoder: 24 blocks, d_model 1024, 16 heads of 64,
# gated-GELU FFN 2816, vocabulary 32,128
FLAN_T5_LARGE = dict(n_layers=24, hidden=1024, heads=16, ffn=2816, vocab=32128, out_size=None)


def build_t5_tensors(rng: np.random.Generator, *, n_layers: int = 2,
                     hidden: int = 64, heads: int = 4, ffn: int = 128,
                     vocab: int = 120, out_size: int | None = 64, scale: float = 0.05):
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    head_dim = 64  # T5's fixed d_kv
    t("t5encoder.token_embd", vocab, hidden)
    t("t5encoder.enc.final_layer_norm", hidden)
    if out_size is not None:
        t("t5encoder.down_proj", out_size, hidden)
        t("t5encoder.down_proj_bias", out_size)
    t("t5encoder.enc.blk.0.attn_rel_b", 32, heads)
    for i in range(n_layers):
        L = f"t5encoder.enc.blk.{i}"
        t(f"{L}.attn_norm", hidden)
        t(f"{L}.attn_q", heads * head_dim, hidden)
        t(f"{L}.attn_k", heads * head_dim, hidden)
        t(f"{L}.attn_v", heads * head_dim, hidden)
        t(f"{L}.attn_o", hidden, heads * head_dim)
        t(f"{L}.ffn_norm", hidden)
        t(f"{L}.ffn_up", ffn, hidden)
        t(f"{L}.ffn_gate", ffn, hidden)
        t(f"{L}.ffn_down", hidden, ffn)

    tokens = ["<unk>", "</s>", " "] + [chr(ord("a") + i) for i in range(26)]
    while len(tokens) < vocab:
        tokens.append(f"<extra{len(tokens)}>")
    kv = {
        "general.architecture": "t5encoder",
        "t5encoder.block_count": n_layers,
        "t5encoder.embedding_length": hidden,
        "t5encoder.attention.head_count": heads,
        "t5encoder.context_length": 512,
        "t5encoder.vocab_size": vocab,
    }
    if out_size is not None:
        kv["t5encoder.output_size"] = out_size
    kv.update({
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": np.full(len(tokens), -1.0, np.float32),
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.eos_token_id": 1,
        "tokenizer.ggml.bos_token_id": 0,
    })
    return T, kv


def write_t5_gguf(path, seed: int = 0, dtype=np.float32, **kwargs):
    """Write `build_t5_tensors(default_rng(seed), **kwargs)` with every
    tensor stored as `dtype` (float32 or float16).  With
    `dtype=np.float16, **FLAN_T5_LARGE` the file is 0.68 GB."""
    rng = np.random.default_rng(seed)
    tensors, kv = build_t5_tensors(rng, **kwargs)
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr.astype(dtype))
    w.write()
    return path
