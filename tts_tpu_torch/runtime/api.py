"""The port's runner API: request config, response, error and runner base.

The port's own copy of `tts_tpu/runtime/api.py` (the same fields and
defaults, so both packages' servers and clients speak the same requests),
without the JAX runners' prompt-bucket pinning and device-state
declarations: the port runs the exact prompt length and keeps its tensors
on one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tts_tpu_torch.core.device import TTSError, card_device  # noqa: F401


@dataclass
class GenerationConfig:
    """Per-call sampling / voice configuration."""

    temperature: float = 1.0
    repetition_penalty: float = 1.0
    top_k: int = 0                  # 0 = disabled
    top_p: float = 1.0              # 1.0 = disabled
    max_tokens: int = 0             # 0 = model default cap
    voice: str = ""
    espeak_voice_id: str = ""
    use_cross_attn: bool = True
    sample: bool = True             # False = greedy argmax
    seed: int | None = None


@dataclass
class TTSResponse:
    """Generated audio (float32 PCM in [-1, 1]) + metadata."""

    audio: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 44100
    # per-stage wall times in ms, filled by runners
    timings: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return float(len(self.audio)) / float(self.sample_rate)


class TTSRunner:
    """Abstract runner: text in, audio out.  Concrete runners (orpheus,
    dummy) implement `generate`."""

    sample_rate: int = 44100
    architecture: str = "unknown"
    # device state, for parallel/serving.move_to_device: attributes holding
    # tensors / nested components that declare their own
    device_arrays: tuple = ()
    device_components: tuple = ()

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        raise NotImplementedError

    def list_voices(self) -> list[str]:
        return []

    def update_conditional_prompt(self, text_encoder_path: str, prompt: str) -> None:
        raise TTSError(f"{self.architecture} does not support conditional prompts")
