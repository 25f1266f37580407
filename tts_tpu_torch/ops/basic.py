"""Elementwise and normalisation ops on time-major [T, C] tensors.

Counterpart of `tts_tpu/ops/basic.py`, with the same signatures so model
code ports line for line.  The port runs exact shapes, so the JAX package's
`mask` and `zero_tail` arguments (padded buckets) have no counterpart here.
Variances are biased, as `jnp.var` is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise over channels (the last axis, the only one the models
    normalise along), with no learned scale or shift: callers apply
    their own."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def ada_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """AdaLayerNorm: LayerNorm over channels per step, then
    xn * (1 + gamma) + beta with style-conditioned gamma, beta [C]."""
    return layer_norm(x, eps=eps) * (1.0 + gamma) + beta


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d: normalise [T, C] over time per channel.  Statistics
    are taken in f32 whatever x's dtype; the result has x's dtype."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=0, keepdim=True, unbiased=False)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


def ada_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """AdaIN: instance norm over time, then the style-conditioned affine
    xn * (1 + gamma) + beta, gamma and beta [C] cast to x's dtype."""
    xn = instance_norm_time(x, eps=eps)
    return xn * (1.0 + gamma).to(x.dtype) + beta.to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


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
