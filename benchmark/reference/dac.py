"""Plain PyTorch DAC 44.1 kHz decoder (descript-audio-codec's `Decoder`
and the residual quantizer's `from_codes`), from the run's GGUF file.

Per codebook the code's embedding through a 1x1 out-projection, summed;
a k7 convolution in; four blocks of snake, a transposed convolution
(kernel 2s, stride s, padding s/2) and three residual units (snake, k7
convolution with dilation 1/3/9, snake, 1x1 convolution, plus the input);
snake, a k7 convolution out, tanh.  Snake: x + sin^2(alpha x) / alpha.
Float32; the caller sets TF32 off (the control turns it on)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import tensor

P = "audio_encoder."


def load(reader, cfg: dict, device) -> dict:
    dac = cfg["dac"]

    def t(name):
        return tensor(reader, P + name, device)

    def alpha(name):
        return t(name).reshape(1, -1, 1)

    p = {"in": (t("initial.weight"), t("initial.bias")),
         "out": (alpha("final.alpha"), t("final.weight"), t("final.bias")),
         "q": [(t(f"quantizers.{i}.codebook.weight"), t(f"quantizers.{i}.out_proj.weight")[:, :, 0],
                t(f"quantizers.{i}.out_proj.bias")) for i in range(dac["n_heads"])],
         "blocks": [], "strides": dac["strides"]}
    for i in range(len(dac["strides"])):
        b = f"decoder_block.{i + 1}"
        units = []
        for j in range(3):
            u = f"{b}.residual_unit.{j}"
            units.append((alpha(f"{u}.res.initial.alpha"), t(f"{u}.res.initial.weight"),
                          t(f"{u}.res.initial.bias"), alpha(f"{u}.res.final.alpha"),
                          t(f"{u}.res.final.weight"), t(f"{u}.res.final.bias")))
        p["blocks"].append((alpha(f"{b}.final.alpha"), t(f"{b}.final.weight"),
                            t(f"{b}.final.bias"), units))
    return p


def _snake(x, a):
    return x + torch.sin(a * x) ** 2 / a


def decode(p: dict, codes) -> torch.Tensor:
    """codes [frames, 9] -> audio [frames * 512] f32."""
    codes = torch.as_tensor(codes, device=p["in"][0].device).long()
    z = sum(cb[codes[:, i]] @ w.T + b for i, (cb, w, b) in enumerate(p["q"]))   # [F, latent]
    x = z.T[None]

    def conv(x, w, b, **kw):
        return F.conv1d(x, w, b, **kw)

    x = conv(x, *p["in"], padding=3)
    for (a, w, b, units), s in zip(p["blocks"], p["strides"]):
        x = F.conv_transpose1d(_snake(x, a), w, b, stride=s,
                               padding=s // 2 if s > 1 else 0)
        for j, (a1, w1, b1, a2, w2, b2) in enumerate(units):
            y = conv(_snake(x, a1), w1, b1, padding=3 ** (j + 1), dilation=3 ** j)
            x = x + conv(_snake(y, a2), w2, b2)
    a, w, b = p["out"]
    return torch.tanh(conv(_snake(x, a), w, b, padding=3))[0, 0]
