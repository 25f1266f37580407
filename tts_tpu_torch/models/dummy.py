"""Weight-free test runner (`test:dummy`): one second of 440 Hz sine per input
character, so the server can be exercised end to end without model weights.

The port's own copy of `tts_tpu/models/dummy.py` (the same audio)."""

from __future__ import annotations

import numpy as np

from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.runtime.api import GenerationConfig, TTSResponse, TTSRunner


class DummyRunner(TTSRunner):
    sample_rate = 44100
    architecture = "dummy"

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        n = max(len(text), 0)
        t = np.arange(n * self.sample_rate, dtype=np.float32) / self.sample_rate
        audio = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        return TTSResponse(audio=audio, sample_rate=self.sample_rate)

    def list_voices(self):
        return ["dummy"]


@register_loader("dummy", is_test=True)
def _load_dummy(config: GenerationConfig, device) -> DummyRunner:
    return DummyRunner()
