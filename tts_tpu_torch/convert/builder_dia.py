"""Random-weight Dia GGUFs (byte-level encoder, 9-head decoder, DAC), from
test sizes up to the full Dia-1.6B.

`build_dia_tensors` and `write_dia_gguf` are the port's own copies of
`tts_tpu/convert/builder_dia.py`: the same arguments give a byte-identical
file (tiny dims, f32).  `write_random_dia` writes a full-width model without
a real checkpoint, as `builder_parler.write_random_parler` does: what the
JAX quantize tool's Dia rule keeps in `qtype` (the encoder, the embeddings
and every decoder linear) as Q8_0 or Q4_0 blocks written directly (random
values, a random f16 `d` per block of 32); the norms, the heads and the
DAC of `builder_codecs.DAC_44KHZ` dense.
"""

from __future__ import annotations

import numpy as np

from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ, build_dac_tensors
from tts_tpu_torch.convert.builder_orpheus import write_random_linear
from tts_tpu_torch.core.gguf import GGUFWriter

# Dia-1.6B (nari-labs/Dia-1.6B): the DiaConfig defaults, with the encoder's
# FFN (4096) apart from the decoder's (8192)
DIA_1_6B = dict(enc_layers=12, dec_layers=18, enc_hidden=1024, dec_hidden=2048, enc_heads=16,
                dec_heads=16, query_heads=4, head_size=128, n_output_heads=9, vocab=1028,
                audio_vocab=1024, enc_ctx=1024, max_gen=3072, enc_ffn=4096, ffn=8192)


def build_dia_tensors(rng: np.random.Generator, *, enc_layers: int = 2,
                      dec_layers: int = 2, enc_hidden: int = 32,
                      dec_hidden: int = 64, enc_heads: int = 4, dec_heads: int = 4,
                      query_heads: int = 2, head_size: int = 16,
                      n_output_heads: int = 9, vocab: int = 1028,
                      audio_vocab: int = 1024, enc_ctx: int = 128,
                      max_gen: int = 64, ffn: int = 64, scale: float = 0.05):
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    t("dia.encoder.embedding", 256, enc_hidden)
    t("dia.encoder.norm", enc_hidden)
    for i in range(enc_layers):
        L = f"dia.encoder.layers.{i}"
        t(f"{L}.q_proj", enc_heads * head_size, enc_hidden)
        t(f"{L}.k_proj", enc_heads * head_size, enc_hidden)
        t(f"{L}.v_proj", enc_heads * head_size, enc_hidden)
        t(f"{L}.o_proj", enc_hidden, enc_heads * head_size)
        t(f"{L}.pre_sa_norm", enc_hidden)
        t(f"{L}.post_sa_norm", enc_hidden)
        t(f"{L}.gate", ffn, enc_hidden)
        t(f"{L}.up", ffn, enc_hidden)
        t(f"{L}.wo", enc_hidden, ffn)

    t("dia.decoder.norm", dec_hidden)
    kv_heads = dec_heads // query_heads
    for i in range(n_output_heads):
        t(f"dia.decoder.embeddings.{i}", audio_vocab + 3, dec_hidden)
        t(f"dia.decoder.heads.{i}", vocab, dec_hidden)
    for i in range(dec_layers):
        L = f"dia.decoder.layers.{i}"
        t(f"{L}.self_q_proj", dec_heads * head_size, dec_hidden)
        t(f"{L}.self_k_proj", kv_heads * head_size, dec_hidden)
        t(f"{L}.self_v_proj", kv_heads * head_size, dec_hidden)
        t(f"{L}.self_o_proj", dec_hidden, dec_heads * head_size)
        t(f"{L}.cross_q_proj", dec_heads * head_size, dec_hidden)
        t(f"{L}.cross_k_proj", dec_heads * head_size, enc_hidden)
        t(f"{L}.cross_v_proj", dec_heads * head_size, enc_hidden)
        t(f"{L}.cross_o_proj", dec_hidden, dec_heads * head_size)
        t(f"{L}.pre_sa_norm", dec_hidden)
        t(f"{L}.pre_ca_norm", dec_hidden)
        t(f"{L}.pre_mlp_norm", dec_hidden)
        t(f"{L}.gate", ffn, dec_hidden)
        t(f"{L}.up", ffn, dec_hidden)
        t(f"{L}.wo", dec_hidden, ffn)

    dac_tensors, dac_kv = build_dac_tensors(rng, n_heads=n_output_heads,
                                            codebook_size=audio_vocab)
    T.update(dac_tensors)
    kv = dia_kv(enc_layers=enc_layers, dec_layers=dec_layers, enc_hidden=enc_hidden,
                dec_hidden=dec_hidden, enc_heads=enc_heads, dec_heads=dec_heads,
                query_heads=query_heads, head_size=head_size, n_output_heads=n_output_heads,
                vocab=vocab, audio_vocab=audio_vocab, enc_ctx=enc_ctx, max_gen=max_gen)
    kv.update(dac_kv)
    return T, kv


def dia_kv(*, enc_layers: int, dec_layers: int, enc_hidden: int, dec_hidden: int,
           enc_heads: int, dec_heads: int, query_heads: int, head_size: int,
           n_output_heads: int, vocab: int, audio_vocab: int, enc_ctx: int,
           max_gen: int) -> dict:
    """The model's GGUF metadata (the DAC's apart)."""
    return {
        "general.architecture": "dia",
        "dia.encoder.layers": enc_layers,
        "dia.decoder.layers": dec_layers,
        "dia.encoder.hidden_size": enc_hidden,
        "dia.decoder.hidden_size": dec_hidden,
        "dia.encoder.attn_heads": enc_heads,
        "dia.decoder.attn_heads": dec_heads,
        "dia.decoder.query_heads": query_heads,
        "dia.attn_head_size": head_size,
        "dia.decoder.output_heads": n_output_heads,
        "dia.decoder.output_vocab_size": vocab,
        "dia.decoder.audio_vocab_size": audio_vocab,
        "dia.eos_token_id": audio_vocab,
        "dia.pad_token_id": audio_vocab + 1,
        "dia.bos_token_id": audio_vocab + 2,
        "dia.encoder.max_context_length": enc_ctx,
        "dia.decoder.max_generation_size": max_gen,
        "dia.max_delay": 15,
        "dia.cfg_scale": 3.0,
    }


def write_dia_gguf(path, seed: int = 0, **kwargs):
    rng = np.random.default_rng(seed)
    tensors, kv = build_dia_tensors(rng, **kwargs)
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path


def write_random_dia(path, seed: int = 0, *, qtype: str = "Q8_0", enc_layers: int,
                     dec_layers: int, enc_hidden: int, dec_hidden: int, enc_heads: int,
                     dec_heads: int, query_heads: int, head_size: int, n_output_heads: int,
                     vocab: int, audio_vocab: int, enc_ctx: int, max_gen: int, enc_ffn: int,
                     ffn: int, dac: dict | None = None, std: float = 0.02):
    """Write a random Dia with `qtype` (Q8_0 or Q4_0) encoder, embeddings and
    decoder linears (weights of about `std`; the embeddings about 1 in the
    encoder and 1/9 per head in the decoder, whose 9 rows add), f32 unit
    norms, F16 heads and a DAC of `dac`'s widths (`DAC_44KHZ` by default).
    The heads' EOS rows (id `audio_vocab`) are drawn 10x smaller, so that
    the random heads, like a trained model's, mostly emit audio codes and
    every request runs to its `max_tokens`.  With `**DIA_1_6B` the decoder
    linears hold 1.32 B weights: the Q8_0 file is about 1.8 GB, the Q4_0
    one about 1.0 GB."""
    rng = np.random.default_rng(seed)
    dac_tensors, dac_kv = build_dac_tensors(rng, **(DAC_44KHZ if dac is None else dac))
    w = GGUFWriter(path)
    kv = dia_kv(enc_layers=enc_layers, dec_layers=dec_layers, enc_hidden=enc_hidden,
                dec_hidden=dec_hidden, enc_heads=enc_heads, dec_heads=dec_heads,
                query_heads=query_heads, head_size=head_size, n_output_heads=n_output_heads,
                vocab=vocab, audio_vocab=audio_vocab, enc_ctx=enc_ctx, max_gen=max_gen)
    for k, v in {**kv, **dac_kv}.items():
        w.add_kv(k, v)

    def linear(name, out_dim, in_dim, s=std):
        write_random_linear(w, rng, name, out_dim, in_dim, qtype, s)

    def norm(name, n):
        w.add_tensor(name, np.ones(n, np.float32))

    linear("dia.encoder.embedding", 256, enc_hidden, s=1.0)
    norm("dia.encoder.norm", enc_hidden)
    for i in range(enc_layers):
        L = f"dia.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj"):
            linear(f"{L}.{n}", enc_heads * head_size, enc_hidden)
        linear(f"{L}.o_proj", enc_hidden, enc_heads * head_size)
        norm(f"{L}.pre_sa_norm", enc_hidden)
        norm(f"{L}.post_sa_norm", enc_hidden)
        linear(f"{L}.gate", enc_ffn, enc_hidden)
        linear(f"{L}.up", enc_ffn, enc_hidden)
        linear(f"{L}.wo", enc_hidden, enc_ffn)

    norm("dia.decoder.norm", dec_hidden)
    kv_heads = dec_heads // query_heads
    for i in range(n_output_heads):
        linear(f"dia.decoder.embeddings.{i}", audio_vocab + 3, dec_hidden,
               s=1.0 / n_output_heads)
        head = rng.standard_normal((vocab, dec_hidden), dtype=np.float32) * np.float32(0.1)
        head[audio_vocab] *= 0.1
        w.add_tensor(f"dia.decoder.heads.{i}", head.astype(np.float16))
    for i in range(dec_layers):
        L = f"dia.decoder.layers.{i}"
        linear(f"{L}.self_q_proj", dec_heads * head_size, dec_hidden)
        linear(f"{L}.self_k_proj", kv_heads * head_size, dec_hidden)
        linear(f"{L}.self_v_proj", kv_heads * head_size, dec_hidden)
        linear(f"{L}.self_o_proj", dec_hidden, dec_heads * head_size)
        linear(f"{L}.cross_q_proj", dec_heads * head_size, dec_hidden)
        linear(f"{L}.cross_k_proj", dec_heads * head_size, enc_hidden)
        linear(f"{L}.cross_v_proj", dec_heads * head_size, enc_hidden)
        linear(f"{L}.cross_o_proj", dec_hidden, dec_heads * head_size)
        norm(f"{L}.pre_sa_norm", dec_hidden)
        norm(f"{L}.pre_ca_norm", dec_hidden)
        norm(f"{L}.pre_mlp_norm", dec_hidden)
        linear(f"{L}.gate", ffn, dec_hidden)
        linear(f"{L}.up", ffn, dec_hidden)
        linear(f"{L}.wo", dec_hidden, ffn)
    for name, arr in dac_tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path
