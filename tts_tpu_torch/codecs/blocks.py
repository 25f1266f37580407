"""Neural-audio-codec building blocks on time-major [T, C] tensors;
counterpart of `tts_tpu/codecs/blocks.py`."""

from __future__ import annotations

import torch

from tts_tpu_torch.ops.basic import snake
from tts_tpu_torch.ops.conv import conv1d, conv_transpose1d


def residual_unit(x, unit: dict, *, padding: int, dilation: int, groups: int = 1):
    """snake -> conv(k7, dilated) -> snake -> conv1x1, plus the residual."""
    cur = snake(x, unit["in_alpha"])
    cur = conv1d(cur, unit["in_w"], unit["in_b"], padding=padding, dilation=dilation,
                 groups=groups)
    cur = snake(cur, unit["out_alpha"])
    cur = conv1d(cur, unit["out_w"], unit["out_b"])
    return cur + x


def codec_layer(x, layer: dict, *, stride: int, padding: int, groups: int = 1, noise=None):
    """snake -> transposed-conv upsample -> optional noise FiLM -> 3 residual
    units with dilations 1/3/9.  noise: [T_out, 1] or None."""
    cur = snake(x, layer["in_alpha"])
    cur = conv_transpose1d(cur, layer["in_w"], layer["in_b"], stride=stride, padding=padding)
    if noise is not None and "noise_w" in layer:
        cur = cur + conv1d(cur, layer["noise_w"]) * noise
    for i, unit in enumerate(layer["units"]):
        cur = residual_unit(cur, unit, padding=3 ** (i + 1), dilation=3 ** i, groups=groups)
    return cur


def quantizer_decode(codes: torch.Tensor, quantizers: list) -> torch.Tensor:
    """codes [T, H] -> summed latents [T, C]: per head a codebook lookup then
    a 1x1 out-projection."""
    out = None
    for i, q in enumerate(quantizers):
        proj = q["codebook"][codes[:, i]] @ q["out_w"] + q["out_b"]
        out = proj if out is None else out + proj
    return out
