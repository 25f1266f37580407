"""Where the port's tensors go: `card_device` resolves a caller's `device`
argument, the card ("cuda") when it gives none, and raises `TTSError`
rather than fall back to the CPU when a CUDA device is asked for and no
card is there.  Both live here, below `ops`, so that every layer can use
them; `runtime.api` re-exports them.
"""

from __future__ import annotations


class TTSError(RuntimeError):
    """Recoverable user-facing error (bad voice, prompt too long, ...)."""


def card_device(device=None):
    """`device` as a torch.device, the card ("cuda") when None.  A CUDA
    device with no card raises TTSError: nothing falls back to the CPU."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise TTSError(f"device '{device}' requested but no CUDA device is available")
    return device
