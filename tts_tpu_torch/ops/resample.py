"""Integer-factor upsampling along one axis, counterpart of
`tts_tpu/ops/resample.py` (Kokoro's harmonic source)."""

from __future__ import annotations

import torch


def upsample_nearest(x: torch.Tensor, factor: int, axis: int = 0) -> torch.Tensor:
    """Repeat each element `factor` times along `axis`."""
    return torch.repeat_interleave(x, factor, dim=axis)


def upsample_linear(x: torch.Tensor, factor: int, axis: int = 0) -> torch.Tensor:
    """Linear interpolation by an integer factor along `axis`, with the
    align_corners=False convention and neighbours clipped at both ends: the
    JAX package's arithmetic, step for step, in f32 sample positions."""
    x = x.movedim(axis, 0)
    t = x.shape[0]
    pos = (torch.arange(t * factor, device=x.device, dtype=torch.float32) + 0.5) / factor - 0.5
    lo = torch.floor(pos).long().clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    frac = (pos - lo).clamp(0.0, 1.0)
    shape = (t * factor,) + (1,) * (x.dim() - 1)
    out = x[lo] * (1 - frac).reshape(shape) + x[hi] * frac.reshape(shape)
    return out.movedim(0, axis)
