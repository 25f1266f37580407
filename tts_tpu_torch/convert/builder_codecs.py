"""Random-weight DAC and SNAC tensors (GGUF name layout) for the random-model
builders.

The port's own copies of `build_dac_tensors` and `build_snac_tensors` from
`tts_tpu/convert/builder_codecs.py`: the same tensors from the same
generator state.  `build_dac_tensors` adds `decoder_dim`, the in-conv's
output width, which the JAX builder ties to `channels[0]`: the descript
44.1 kHz decoder goes 1024 -> 1536 in its in-conv, then 1536 -> 768 -> 384
-> 192 -> 96 through its four blocks (`DAC_44KHZ`)."""

from __future__ import annotations

import numpy as np

# the descript 44.1 kHz DAC decoder: latent 1024, decoder dim 1536, rates
# 8/8/4/2 (x512), 9 codebooks of 1024 entries x dim 8
DAC_44KHZ = dict(latent=1024, decoder_dim=1536, channels=(768, 384, 192, 96),
                 strides=(8, 8, 4, 2), n_heads=9, codebook_size=1024, codebook_dim=8)


def build_dac_tensors(rng: np.random.Generator, *, n_heads: int = 9,
                      codebook_size: int = 1024, codebook_dim: int = 8,
                      latent: int = 96, channels: tuple = (48, 24, 12, 6),
                      strides: tuple = (8, 8, 4, 2), scale: float = 0.05,
                      prefix: str = "audio_encoder.", decoder_dim: int | None = None):
    """Returns (tensors, kv).  Default dims are a scaled-down DAC;
    `**DAC_44KHZ` gives the published 44.1 kHz widths.  `decoder_dim`
    defaults to channels[0], which draws the JAX builder's tensors."""
    T: dict[str, np.ndarray] = {}
    decoder_dim = channels[0] if decoder_dim is None else decoder_dim

    def t(name, *shape):
        T[prefix + name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def alpha(name, c):
        T[prefix + name] = np.ones((1, c, 1), np.float32)

    t("initial.weight", decoder_dim, latent, 7)
    t("initial.bias", decoder_dim)
    prev = decoder_dim
    for i, ch in enumerate(channels):
        base = f"decoder_block.{i + 1}"
        alpha(f"{base}.final.alpha", prev)
        k = strides[i] * 2
        T[prefix + f"{base}.final.weight"] = (
            rng.standard_normal((prev, ch, k)) * scale).astype(np.float32)
        t(f"{base}.final.bias", ch)
        for j in range(3):
            ub = f"{base}.residual_unit.{j}"
            alpha(f"{ub}.res.initial.alpha", ch)
            t(f"{ub}.res.initial.weight", ch, ch, 7)
            t(f"{ub}.res.initial.bias", ch)
            alpha(f"{ub}.res.final.alpha", ch)
            t(f"{ub}.res.final.weight", ch, ch, 1)
            t(f"{ub}.res.final.bias", ch)
        prev = ch
    alpha("final.alpha", channels[-1])
    t("final.weight", 1, channels[-1], 7)
    t("final.bias", 1)
    for i in range(n_heads):
        t(f"quantizers.{i}.codebook.weight", codebook_size, codebook_dim)
        t(f"quantizers.{i}.out_proj.weight", latent, codebook_dim, 1)
        t(f"quantizers.{i}.out_proj.bias", latent)

    kv = {"dac.up_sampling_factor": int(np.prod(strides))}
    for i, s in enumerate(strides):
        kv[f"dac.dac_layer_stride_{i}"] = s
        kv[f"dac.dac_layer_padding_{i}"] = s // 2 if s > 1 else 0
    return T, kv


def build_snac_tensors(rng: np.random.Generator, *, codebook_size: int = 4096,
                       codebook_dim: int = 8, embd: int = 96,
                       channels: tuple = (48, 24, 12, 6),
                       strides: tuple = (8, 8, 4, 2), scale: float = 0.05,
                       prefix: str = "snac."):
    """Returns (tensors, kv).  Real SNAC 24kHz: embd=768, channels=(768, 384,
    192, 96); the residual convs are dense (groups=1) here."""
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[prefix + name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def alpha(name, c):
        T[prefix + name] = np.ones((1, c, 1), np.float32)

    t("in.weight", embd, 1, 7)              # depthwise
    t("in.bias", embd)
    t("up.weight", channels[0], embd, 1)
    t("up.bias", channels[0])
    prev = channels[0]
    for i, ch in enumerate(channels):
        base = f"layers.{i}"
        alpha(f"{base}.alpha", prev)
        T[prefix + f"{base}.weight"] = (
            rng.standard_normal((prev, ch, strides[i] * 2)) * scale).astype(np.float32)
        t(f"{base}.bias", ch)
        t(f"{base}.noise_weight", ch, ch, 1)
        for j in range(3):
            ub = f"{base}.residual_unit.{j}"
            alpha(f"{ub}.res.initial.alpha", ch)
            t(f"{ub}.res.initial.weight", ch, ch, 7)
            t(f"{ub}.res.initial.bias", ch)
            alpha(f"{ub}.res.final.alpha", ch)
            t(f"{ub}.res.final.weight", ch, ch, 1)
            t(f"{ub}.res.final.bias", ch)
        prev = ch
    alpha("alpha_out", channels[-1])
    t("final.weight", 1, channels[-1], 7)
    t("final.bias", 1)
    for i in range(3):
        t(f"quantizers.{i}.codebook.weight", codebook_size, codebook_dim)
        t(f"quantizers.{i}.out_proj.weight", embd, codebook_dim, 1)
        t(f"quantizers.{i}.out_proj.bias", embd)

    kv = {
        "snac.audio_token_channels": 3,
        "snac.up_sampling_factor": int(np.prod(strides)),
        "snac.max_generation_size": 2580,
    }
    for i, s in enumerate(strides):
        kv[f"snac.snac_layer_stride_{i}"] = s
        kv[f"snac.snac_layer_padding_{i}"] = s // 2 if s > 1 else 0
        kv[f"snac.snac_layer_grouping_{i}"] = 1
    return T, kv
