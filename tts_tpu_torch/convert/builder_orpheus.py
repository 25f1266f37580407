"""Seeded random-weight Orpheus GGUFs (llama backbone + SNAC + BPE tokenizer).

`build_orpheus_tensors` and `write_orpheus_gguf` are the port's own copies of
`tts_tpu/convert/builder_orpheus.py`: the same arguments give a
byte-identical dense (f32) file, at tiny dims for tests.  That builder draws
float weights and lets the GGUF writer quantize them: at 3 B weights it
would take minutes and 12 GB of host memory.  `write_random_orpheus` writes
Q8_0 or Q4_0 linears at any width, up to the full Orpheus-3B, with the
quantized blocks written directly in the GGML layout: random values with a
random f16 `d` per block of 32.
"""

from __future__ import annotations

import numpy as np

from tts_tpu_torch.convert.builder_codecs import build_snac_tensors
from tts_tpu_torch.core.gguf import GGMLType, GGUFWriter

# Orpheus-3B: OrpheusConfig defaults (Llama-3.2-3B widths) and SNAC 24 kHz
ORPHEUS_3B = dict(n_layers=28, hidden=3072, heads=24, kv_heads=8, head_dim=128, ffn=8192,
                  vocab=156940, snac_embd=768, snac_channels=(768, 384, 192, 96))
# per quantized type: (bytes of values per 32-value block, std of the raw
# values).  Q8_0: 32 uniform int8, std ~73.9.  Q4_0: 16 bytes of two uniform
# nibbles q each, value q - 8, std sqrt(255/12) ~4.61.
_BLOCKS = {"Q8_0": (32, 73.9), "Q4_0": (16, 4.61)}


def orpheus_kv(n_layers: int, hidden: int, heads: int, kv_heads: int, head_dim: int,
               vocab: int) -> dict:
    """GGUF metadata of a random Orpheus: its widths, the real special token
    ids, lenient audio codes (random weights cannot keep to the per-position
    SNAC code ranges) and a minimal BPE vocabulary of ASCII letters."""
    tokens = [chr(c) for c in range(33, 127)] + ["Ġ"] + [f"Ġ{chr(c)}" for c in range(97, 123)]
    return {"general.architecture": "orpheus", "orpheus.layers": n_layers,
            "orpheus.hidden_size": hidden, "orpheus.attn_heads": heads,
            "orpheus.kv_attn_heads": kv_heads, "orpheus.head_dim": head_dim,
            "orpheus.vocab_size": vocab, "orpheus.stopping_token_id": 128258,
            "orpheus.lenient_audio_codes": 1,
            "tokenizer.ggml.bos_token_id": 128000, "tokenizer.ggml.eos_token_id": 128009,
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": ["Ġ a"]}


def build_orpheus_tensors(rng: np.random.Generator, *, n_layers: int = 2,
                          hidden: int = 64, heads: int = 4, kv_heads: int = 2,
                          head_dim: int = 16, vocab: int = 156940,
                          ffn: int = 128, scale: float = 0.05):
    """-> (tensors: name -> f32 array, kv), drawn from `rng` in the JAX
    builder's order (its unused `tiny_vocab` flag is left out).  The
    embedding keeps the real vocabulary (prompt token ids index it) at tiny
    widths."""
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    t("orpheus.embed_tokens", vocab, hidden)
    t("orpheus.lm_head", vocab, hidden)
    t("orpheus.norm", hidden)
    T["orpheus.rope_frequencies"] = np.ones(head_dim // 2, np.float32)
    for l in range(n_layers):
        L = f"orpheus.layers.{l}"
        t(f"{L}.input_layernorm", hidden)
        t(f"{L}.post_attention_layernorm", hidden)
        t(f"{L}.self_attn.q_proj", heads * head_dim, hidden)
        t(f"{L}.self_attn.k_proj", kv_heads * head_dim, hidden)
        t(f"{L}.self_attn.v_proj", kv_heads * head_dim, hidden)
        t(f"{L}.self_attn.o_proj", hidden, heads * head_dim)
        t(f"{L}.mlp.gate_proj", ffn, hidden)
        t(f"{L}.mlp.up_proj", ffn, hidden)
        t(f"{L}.mlp.down_proj", hidden, ffn)

    snac_tensors, snac_kv = build_snac_tensors(rng)
    T.update(snac_tensors)
    # the JAX builder's key order (the file's bytes follow it): the model's
    # keys, SNAC's, then the tokenizer's
    kv = orpheus_kv(n_layers, hidden, heads, kv_heads, head_dim, vocab)
    tokenizer = {k: kv.pop(k) for k in ("tokenizer.ggml.tokens", "tokenizer.ggml.merges")}
    return T, {**kv, **snac_kv, **tokenizer}


def write_orpheus_gguf(path, seed: int = 0, **kwargs):
    """A dense random Orpheus (`build_orpheus_tensors(**kwargs)`) at `path`."""
    rng = np.random.default_rng(seed)
    tensors, kv = build_orpheus_tensors(rng, **kwargs)
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path


def write_random_linear(w: GGUFWriter, rng: np.random.Generator, name: str, out_dim: int,
                        in_dim: int, qtype: str, std: float):
    """Add a random `qtype` linear [out_dim, in_dim] to `w`.  Q8_0 or Q4_0:
    uniform raw values, and per block of 32 an f16 `d` that scales them to
    about `std`, +-50%.  F32: normal values of std `std` (for the quantize
    app to quantize)."""
    if qtype == "F32":
        weight = rng.standard_normal((out_dim, in_dim), dtype=np.float32)
        w.add_tensor(name, weight * np.float32(std))
        return
    nbytes, raw_std = _BLOCKS[qtype]
    nb = out_dim * in_dim // 32
    blocks = np.empty((nb, 2 + nbytes), np.uint8)
    blocks[:, 2:] = np.frombuffer(rng.bytes(nb * nbytes), np.uint8).reshape(nb, nbytes)
    d = (std / raw_std * (0.5 + rng.random(nb, dtype=np.float32))).astype(np.float16)
    blocks[:, :2] = d.view(np.uint8).reshape(nb, 2)
    w.add_raw_tensor(name, (in_dim, out_dim), GGMLType[qtype], blocks.reshape(-1))


def write_random_orpheus(path, seed: int = 0, *, qtype: str = "Q8_0", n_layers: int,
                         hidden: int, heads: int, kv_heads: int, head_dim: int, ffn: int,
                         vocab: int, snac_embd: int, snac_channels: tuple,
                         std: float = 0.02):
    """Write a random Orpheus with `qtype` (Q8_0 or Q4_0) linears (weights of
    about `std`), an F16 embedding, f32 unit norms, unit RoPE factors and a
    dense-residual SNAC of the given widths.  With `**ORPHEUS_3B` the full
    model is 4.6 GB in Q8_0 (about 25 s) and 2.9 GB in Q4_0."""
    rng = np.random.default_rng(seed)
    snac_tensors, snac_kv = build_snac_tensors(rng, embd=snac_embd, channels=snac_channels)
    w = GGUFWriter(path)
    for k, v in {**orpheus_kv(n_layers, hidden, heads, kv_heads, head_dim, vocab),
                 **snac_kv}.items():
        w.add_kv(k, v)

    def linear(name, out_dim, in_dim):
        write_random_linear(w, rng, name, out_dim, in_dim, qtype, std)

    embd = rng.standard_normal(vocab * hidden, dtype=np.float32).reshape(vocab, hidden)
    w.add_tensor("orpheus.embed_tokens", (embd * std).astype(np.float16))
    del embd
    linear("orpheus.lm_head", vocab, hidden)
    w.add_tensor("orpheus.norm", np.ones(hidden, np.float32))
    w.add_tensor("orpheus.rope_frequencies", np.ones(head_dim // 2, np.float32))
    for l in range(n_layers):
        L = f"orpheus.layers.{l}"
        w.add_tensor(f"{L}.input_layernorm", np.ones(hidden, np.float32))
        w.add_tensor(f"{L}.post_attention_layernorm", np.ones(hidden, np.float32))
        linear(f"{L}.self_attn.q_proj", heads * head_dim, hidden)
        linear(f"{L}.self_attn.k_proj", kv_heads * head_dim, hidden)
        linear(f"{L}.self_attn.v_proj", kv_heads * head_dim, hidden)
        linear(f"{L}.self_attn.o_proj", hidden, heads * head_dim)
        linear(f"{L}.mlp.gate_proj", ffn, hidden)
        linear(f"{L}.mlp.up_proj", ffn, hidden)
        linear(f"{L}.mlp.down_proj", hidden, ffn)
    for name, arr in snac_tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path
