"""What the plain references share: float32 with TF32 off, the weights read
from the run's GGUF file (Q4_0 blocks dequantized exactly), and the
control's lower precision.  Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from benchlib import gguf
from benchlib.weights import q4_dequant


def strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tensor(reader: gguf.Reader, name: str, device) -> torch.Tensor:
    """A tensor of the file as f32 on `device` (row-major shape)."""
    gt, shape, raw = reader.raw(name)
    if gt == gguf.Q4_0:
        return q4_dequant(raw, shape, device)
    dt = np.float16 if gt == gguf.F16 else np.float32
    return torch.from_numpy(raw.view(dt).reshape(shape).astype(np.float32)).to(device)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (its absolute
    maximum to 448): the control's activations, one step below bf16."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def keep(x: torch.Tensor) -> torch.Tensor:
    return x


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position and head: how far the token's logit lies below the best
    one.  logits [S, H, V], tokens [S, H] -> [S, H]."""
    best = logits.max(-1).values
    return best - logits.gather(-1, tokens.long()[..., None])[..., 0]
