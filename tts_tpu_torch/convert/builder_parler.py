"""Random-weight Parler-TTS GGUFs (decoder, DAC and unigram tokenizer in the
py-gguf layout), from test sizes up to the full Parler-TTS mini v1.

`build_parler_tensors` and `write_parler_gguf` are the port's own copies of
`tts_tpu/convert/builder_parler.py`: the same arguments give a
byte-identical file.  `write_random_parler` writes a full-width model
without a real checkpoint, as `builder_orpheus.write_random_orpheus` does:
every decoder linear, the cross-attention k/v included, as Q8_0 or Q4_0
blocks written directly (random values, a random f16 `d` per block of 32)
or as F32 (for the quantize app), F16 embeddings and heads, and the DAC of
`builder_codecs.DAC_44KHZ`.
"""

from __future__ import annotations

import numpy as np

from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ, build_dac_tensors
from tts_tpu_torch.convert.builder_orpheus import write_random_linear
from tts_tpu_torch.core.gguf import GGUFWriter

# Parler-TTS mini v1 (parler-tts/parler-tts-mini-v1): the ParlerConfig
# defaults, a 32,128-row prompt embedding (the T5 tokenizer's vocabulary)
# and a 1024-wide T5 encoding (flan-t5-large) of `enc_len` tokens
PARLER_MINI_V1 = dict(n_layers=24, hidden=1024, heads=16, ffn=4096, n_output_heads=9,
                      vocab=1088, audio_vocab=1024, prompt_vocab=32128, enc_len=32,
                      enc_hidden=1024, max_ctx=4096, max_gen=2580)


def build_parler_tensors(rng: np.random.Generator, *, n_layers: int = 2,
                         hidden: int = 64, heads: int = 4, n_output_heads: int = 9,
                         vocab: int = 1088, audio_vocab: int = 1024,
                         prompt_vocab: int = 120, enc_len: int = 12,
                         enc_hidden: int = 64, max_ctx: int = 512,
                         max_gen: int = 64, ffn: int = 128, scale: float = 0.05):
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    t("decoder.embed_prompts", prompt_vocab, hidden)
    t("decoder.positional_embed", max_ctx, hidden)
    t("decoder.text_encoding", enc_len, enc_hidden)
    t("decoder.layer_norm.weight", hidden)
    t("decoder.layer_norm.bias", hidden)
    for i in range(n_output_heads):
        t(f"decoder.embed_tokens.{i}.weight", audio_vocab + 2, hidden)
        t(f"decoder.lm_heads.{i}.weight.head", vocab, hidden)
    for l in range(n_layers):
        L = f"decoder.layers.{l}"
        for n in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            t(f"{L}.{n}.weight", hidden)
            t(f"{L}.{n}.bias", hidden)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t(f"{L}.self_attn.{n}.weight", hidden, hidden)
        t(f"{L}.encoder_attn.q_proj.weight", hidden, hidden)
        t(f"{L}.encoder_attn.k_proj.weight", hidden, enc_hidden)
        t(f"{L}.encoder_attn.v_proj.weight", hidden, enc_hidden)
        t(f"{L}.encoder_attn.out_proj.weight", hidden, hidden)
        t(f"{L}.fc1.weight", ffn, hidden)
        t(f"{L}.fc2.weight", hidden, ffn)

    dac_tensors, dac_kv = build_dac_tensors(rng, n_heads=n_output_heads,
                                            codebook_size=audio_vocab)
    T.update(dac_tensors)
    kv = parler_kv(n_layers=n_layers, hidden=hidden, heads=heads,
                   n_output_heads=n_output_heads, vocab=vocab, audio_vocab=audio_vocab,
                   prompt_vocab=prompt_vocab, enc_len=enc_len, max_ctx=max_ctx,
                   max_gen=max_gen)
    kv.update(dac_kv)
    kv.update(unigram_kv(prompt_vocab))
    return T, kv


def parler_kv(*, n_layers: int, hidden: int, heads: int, n_output_heads: int, vocab: int,
              audio_vocab: int, prompt_vocab: int, enc_len: int, max_ctx: int,
              max_gen: int) -> dict:
    """The decoder's GGUF metadata (the tokenizer's and the DAC's apart)."""
    return {
        "general.architecture": "parler-tts",
        "parler-tts.decoder.num_hidden_layers": n_layers,
        "parler-tts.decoder.hidden_size": hidden,
        "parler-tts.decoder.attention.head_count": heads,
        "parler-tts.decoder.output_heads": n_output_heads,
        "parler-tts.decoder.out_vocab_size": vocab,
        "parler-tts.decoder.audio_vocab_size": audio_vocab,
        "parler-tts.decoder.context_length": max_ctx,
        "parler-tts.decoder.max_generation": max_gen,
        "parler-tts.decoder.encode_length": enc_len,
        "audio.bos_token_id": audio_vocab + 1,
        "audio.eos_token_id": audio_vocab,
    }


def unigram_kv(prompt_vocab: int) -> dict:
    """A tiny unigram vocabulary: a..z, space and unk, padded with unused
    tokens to `prompt_vocab` entries."""
    tokens = ["<unk>", "</s>", " "] + [chr(ord("a") + i) for i in range(26)]
    while len(tokens) < prompt_vocab:
        tokens.append(f"<extra{len(tokens)}>")
    return {"tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.full(len(tokens), -1.0, np.float32),
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.eos_token_id": 1}


def write_parler_gguf(path, seed: int = 0, **kwargs):
    rng = np.random.default_rng(seed)
    tensors, kv = build_parler_tensors(rng, **kwargs)
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path


def write_random_parler(path, seed: int = 0, *, qtype: str = "Q8_0", n_layers: int,
                        hidden: int, heads: int, ffn: int, n_output_heads: int, vocab: int,
                        audio_vocab: int, prompt_vocab: int, enc_len: int, enc_hidden: int,
                        max_ctx: int, max_gen: int, dac: dict | None = None,
                        std: float = 0.02):
    """Write a random Parler-TTS with `qtype` (Q8_0, Q4_0 or F32) decoder
    linears (weights of about `std`), F16 embeddings and heads, unit layer norms
    with zero bias, and a DAC of `dac`'s widths (`DAC_44KHZ` by default).
    The heads' rows for the ids at and above `audio_vocab` (EOS, BOS, the
    unused rest) are drawn 10x smaller, so that the random heads, like a
    trained model's, mostly emit audio codes; greedy decoding then never
    picks EOS, and every request runs to its `max_tokens`.  With
    `**PARLER_MINI_V1` the Q8_0 file is 0.76 GB, the Q4_0 one 0.56 GB and
    the F32 one about 2 GB."""
    rng = np.random.default_rng(seed)
    dac_tensors, dac_kv = build_dac_tensors(rng, **(DAC_44KHZ if dac is None else dac))
    w = GGUFWriter(path)
    kv = parler_kv(n_layers=n_layers, hidden=hidden, heads=heads,
                   n_output_heads=n_output_heads, vocab=vocab, audio_vocab=audio_vocab,
                   prompt_vocab=prompt_vocab, enc_len=enc_len, max_ctx=max_ctx,
                   max_gen=max_gen)
    for k, v in {**kv, **dac_kv, **unigram_kv(prompt_vocab)}.items():
        w.add_kv(k, v)

    def normal(*shape, s=std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)

    def linear(name, out_dim, in_dim):
        write_random_linear(w, rng, name, out_dim, in_dim, qtype, std)

    w.add_tensor("decoder.embed_prompts", normal(prompt_vocab, hidden, s=1.0).astype(np.float16))
    w.add_tensor("decoder.positional_embed", normal(max_ctx, hidden, s=0.1).astype(np.float16))
    w.add_tensor("decoder.text_encoding", normal(enc_len, enc_hidden, s=0.1))
    w.add_tensor("decoder.layer_norm.weight", np.ones(hidden, np.float32))
    w.add_tensor("decoder.layer_norm.bias", np.zeros(hidden, np.float32))
    for i in range(n_output_heads):
        w.add_tensor(f"decoder.embed_tokens.{i}.weight",
                     normal(audio_vocab + 2, hidden, s=1.0 / n_output_heads).astype(np.float16))
        head = normal(vocab, hidden, s=0.1)
        head[audio_vocab:] *= 0.1
        w.add_tensor(f"decoder.lm_heads.{i}.weight.head", head.astype(np.float16))
    for l in range(n_layers):
        L = f"decoder.layers.{l}"
        for n in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            w.add_tensor(f"{L}.{n}.weight", np.ones(hidden, np.float32))
            w.add_tensor(f"{L}.{n}.bias", np.zeros(hidden, np.float32))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{L}.self_attn.{n}.weight", hidden, hidden)
        linear(f"{L}.encoder_attn.q_proj.weight", hidden, hidden)
        linear(f"{L}.encoder_attn.k_proj.weight", hidden, enc_hidden)
        linear(f"{L}.encoder_attn.v_proj.weight", hidden, enc_hidden)
        linear(f"{L}.encoder_attn.out_proj.weight", hidden, hidden)
        linear(f"{L}.fc1.weight", ffn, hidden)
        linear(f"{L}.fc2.weight", hidden, ffn)
    for name, arr in dac_tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path
