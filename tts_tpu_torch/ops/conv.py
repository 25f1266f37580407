"""1-D convolutions on time-major [T, C] tensors, counterpart of
`tts_tpu/ops/conv.py`.  Weights keep the torch/GGUF layout, so they load
without reshuffling.  No Pallas kernel stood here: these go to cuDNN."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x [T, C_in], w [C_out, C_in/groups, K] -> [T_out, C_out]."""
    out = F.conv1d(x.t()[None], w.to(x.dtype), None if b is None else b.to(x.dtype),
                   stride=stride, padding=padding, dilation=dilation, groups=groups)
    return out[0].t()


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     stride: int = 1, padding: int = 0, output_padding: int = 0,
                     dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x [T, C_in], w [C_in, C_out/groups, K] -> [T_out, C_out] with
    T_out = (T-1)*stride - 2*padding + dilation*(K-1) + 1 + output_padding."""
    out = F.conv_transpose1d(x.t()[None], w.to(x.dtype),
                             None if b is None else b.to(x.dtype), stride=stride,
                             padding=padding, output_padding=output_padding,
                             groups=groups, dilation=dilation)
    return out[0].t()


def reflect_pad_front(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Reflect-pad n steps in front of [T, C] (rows n..1 before row 0), as
    the Kokoro generator does after its last upsample."""
    return torch.cat([x[1:n + 1].flip(0), x], dim=0)
