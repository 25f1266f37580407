"""STFT and iSTFT as dense DFT products, counterpart of `tts_tpu/ops/stft.py`.

Kokoro's n_fft is 20 with hop 5: framing plus one [n_fft, 2*bins] product
is exact and small.  The DFT bases are built as the JAX package builds
them (float64 numpy, cast to f32), so both packages multiply by identical
numbers.  Conventions (torch.stft(center=True)'s):
  * centred framing: the input is reflect-padded by n_fft/2 on both sides;
  * stft gives F = len(x)//hop + 1 frames of one-sided spectra, bins =
    n_fft//2 + 1, as (magnitude, phase);
  * istft of F frames gives (F-1)*hop samples: tap j of frame f lands on
    sample f*hop + j - n_fft/2, normalised by the window^2 overlap sum.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """sin^2 window (periodic Hann)."""
    i = np.arange(n_fft)
    return np.square(np.sin(np.pi * i / n_fft)).astype(np.float32)


def _dft_bases(n_fft: int, n_bins: int):
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), -np.sin(ang).astype(np.float32)


def _inverse_bases(n_fft: int, n_bins: int):
    """cos and sin bases of the one-sided inverse DFT, the non-DC,
    non-Nyquist bins doubled and everything divided by n_fft."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    scale = np.ones(n_bins, np.float32) * 2.0
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    return ((np.cos(ang) * scale[None, :] / n_fft).astype(np.float32),
            (np.sin(ang) * scale[None, :] / n_fft).astype(np.float32))


def stft(x: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int):
    """x [T] f32 -> (magnitude [F, bins], phase [F, bins]), F = T//hop + 1."""
    n_bins = n_fft // 2 + 1
    half = n_fft // 2
    xp = F.pad(x.float()[None, None], (half, half), mode="reflect")[0, 0]
    cos_b, sin_b = (torch.from_numpy(b).to(x.device) for b in _dft_bases(n_fft, n_bins))
    win = window.reshape(-1, 1).float()
    kern = torch.cat([cos_b * win, sin_b * win], dim=1)          # [n_fft, 2*bins]
    frames = xp.unfold(0, n_fft, hop)                             # [F, n_fft]
    out = frames @ kern
    re, im = out[:, :n_bins], out[:, n_bins:]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    return mag, torch.atan2(im, re)


def istft(mag: torch.Tensor, phase: torch.Tensor, window: torch.Tensor,
          window_sq_sum: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(magnitude, phase) [F, bins] -> [(F-1)*hop] samples: inverse one-sided
    DFT per frame, windowed overlap-add (first frame centred on sample 0),
    divided by `window_sq_sum` [(F-1)*hop]."""
    n_frames, n_bins = mag.shape
    re = mag * torch.cos(phase)
    im = mag * torch.sin(phase)
    cos_i, sin_i = (torch.from_numpy(b).to(mag.device) for b in _inverse_bases(n_fft, n_bins))
    frames = (re @ cos_i.T - im @ sin_i.T) * window[None, :]     # [F, n_fft]
    out_len = (n_frames - 1) * hop
    half = n_fft // 2
    ola = F.fold(frames.T[None], output_size=(1, out_len + n_fft), kernel_size=(1, n_fft),
                 stride=(1, hop))                                 # [1, 1, 1, L]
    return ola.reshape(-1)[half:half + out_len] / window_sq_sum


def window_squared_sum(window: np.ndarray, n_fft: int, hop: int,
                       n_frames: int, out_len: int | None = None) -> np.ndarray:
    """Accumulated window^2 for iSTFT normalisation (host side, numpy), over
    the (F-1)*hop samples of an F-frame spectrum.  `out_len` pads the tail
    with ones."""
    cutoff = (n_frames - 1) * hop
    half = n_fft // 2
    tgt = np.zeros(max(cutoff, 1), np.float32)
    w2 = np.square(window.astype(np.float32))
    # window tap j contributes w2[j] at samples f*hop + (j - half) for every
    # frame f: one strided slice-add per tap
    for j in range(n_fft):
        start = j - half
        lo_f = (-start + hop - 1) // hop if start < 0 else 0
        hi_f = min(n_frames, (cutoff - start + hop - 1) // hop)
        if hi_f > lo_f:
            tgt[lo_f * hop + start : hi_f * hop + start : hop] += w2[j]
    tgt[tgt == 0] = 1e-6
    if out_len is not None and out_len > cutoff:
        tgt = np.concatenate([tgt, np.ones(out_len - cutoff, np.float32)])
    return tgt
