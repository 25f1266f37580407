"""Energy-based voice-inactivity trimming.

The port's own copy of `tts_tpu/runtime/vad.py` (host numpy, the same
function line for line), held to it by `tests/test_torch_apps.py`.

Behavior parity with the reference CLI's examples/cli/vad.{h,cpp}: min-max
normalized per-frame energies, trailing-silence clipping, and early cutoff on
long internal silence.  Vectorized in numpy (host-side post-processing)."""

from __future__ import annotations

import numpy as np


def trim_silence(audio: np.ndarray, sample_rate: float,
                 ms_per_frame: int = 10, frame_threshold: int = 20,
                 normalized_energy_threshold: float = 0.01,
                 trailing_silent_frames: int = 5,
                 early_cutoff_seconds_threshold: int = 3,
                 early_cutoff_energy_threshold: float = 0.1) -> np.ndarray:
    samples_per_frame = int(ms_per_frame * sample_rate / 1000.0)
    n_frames = len(audio) // samples_per_frame
    if n_frames == 0:
        return audio
    frames = audio[: n_frames * samples_per_frame].reshape(n_frames, samples_per_frame)
    # float64 accumulation: extreme sample values must not overflow the sums
    energies = np.sum(np.square(frames.astype(np.float64)), axis=1)

    # early cutoff: a run of completely silent frames terminates the audio
    early_frames = int(early_cutoff_seconds_threshold * 1000 / ms_per_frame)
    silent = energies <= early_cutoff_energy_threshold
    run = 0
    for i, s in enumerate(silent):
        run = run + 1 if s else 0
        if run >= early_frames:
            end = (i + 1 + trailing_silent_frames - run) * samples_per_frame
            return audio[:max(end, 0)]

    # trailing silence clip on min-max normalized energy
    emin, emax = float(energies.min()), float(energies.max())
    if emax <= emin:
        return audio
    norm = (energies - emin) / (emax - emin)
    trailing = 0
    for e in norm[::-1]:
        if e < normalized_energy_threshold:
            trailing += 1
        else:
            break
    if trailing >= frame_threshold:
        cut = (trailing - trailing_silent_frames) * samples_per_frame
        return audio[: len(audio) - cut]
    return audio
