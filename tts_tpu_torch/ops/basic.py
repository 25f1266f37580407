"""Elementwise ops on time-major [T, C] tensors.  Counterpart of
`tts_tpu/ops/basic.py`; this slice needs only `snake`."""

from __future__ import annotations

import math

import torch

# the JAX package's minimax fit of sin^2(pi*r)/r^2 over r in [-1/2, 1/2],
# ascending powers of s = r^2 (tts_tpu/ops/basic.py:_SIN2_POLY)
_SIN2_POLY = (9.8696044004342909, -32.469696735562913, 42.728389790226231,
              -30.121841925204695, 13.207344107547643, -3.9158874684971994,
              0.74598669778179405)


def _sin2(t: torch.Tensor) -> torch.Tensor:
    """sin^2(t) as s*p(s), s the squared phase reduced to [-1/2, 1/2] of a
    period: the same polynomial the JAX package evaluates, so both agree."""
    u = t * (1.0 / math.pi)
    r = u - torch.round(u)
    s = r * r
    p = torch.full_like(s, _SIN2_POLY[-1])
    for c in _SIN2_POLY[-2::-1]:
        p = p * s + c
    return s * p


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha, alpha per channel [C]; the
    phase is computed in f32."""
    a = alpha.float()
    t = x.float() * a
    return x + (_sin2(t) / a).to(x.dtype)
