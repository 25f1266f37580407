"""Random-weight SNAC tensors (GGUF name layout) for the random-model builders.

The port's own copy of `build_snac_tensors` from
`tts_tpu/convert/builder_codecs.py`: the same tensors from the same
generator state."""

from __future__ import annotations

import numpy as np


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
