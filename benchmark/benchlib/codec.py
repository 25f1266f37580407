"""The DAC 44.1 kHz decoder's tensors for the weight plans (the names the
program's loader reads, under `audio_encoder.`), shared by Parler-TTS and
Dia: random f32 weights of scale 0.05 and unit snake alphas, as the port's
random builders draw them."""

from __future__ import annotations

import numpy as np

# the descript 44.1 kHz decoder: latent 1024, in-conv to 1536, blocks to
# 768 / 384 / 192 / 96 channels at strides 8 / 8 / 4 / 2 (x512), 9
# codebooks of 1024 entries x 8
DAC_44KHZ = dict(latent=1024, decoder_dim=1536, channels=[768, 384, 192, 96],
                 strides=[8, 8, 4, 2], n_heads=9, codebook_size=1024, codebook_dim=8)
SCALE = 0.05
P = "audio_encoder."


def plan(dac: dict) -> tuple[dict, list]:
    out = []

    def t(name, *shape):
        out.append((P + name, shape, "f32", SCALE))

    def alpha(name, c):
        out.append((P + name, (1, c, 1), "ones", None))

    t("initial.weight", dac["decoder_dim"], dac["latent"], 7)
    t("initial.bias", dac["decoder_dim"])
    prev = dac["decoder_dim"]
    for i, (ch, s) in enumerate(zip(dac["channels"], dac["strides"])):
        base = f"decoder_block.{i + 1}"
        alpha(f"{base}.final.alpha", prev)
        t(f"{base}.final.weight", prev, ch, 2 * s)
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
    alpha("final.alpha", dac["channels"][-1])
    t("final.weight", 1, dac["channels"][-1], 7)
    t("final.bias", 1)
    for i in range(dac["n_heads"]):
        t(f"quantizers.{i}.codebook.weight", dac["codebook_size"], dac["codebook_dim"])
        t(f"quantizers.{i}.out_proj.weight", dac["latent"], dac["codebook_dim"], 1)
        t(f"quantizers.{i}.out_proj.bias", dac["latent"])
    kv = {"dac.up_sampling_factor": int(np.prod(dac["strides"]))}
    for i, s in enumerate(dac["strides"]):
        kv[f"dac.dac_layer_stride_{i}"] = s
        kv[f"dac.dac_layer_padding_{i}"] = s // 2 if s > 1 else 0
    return kv, out
