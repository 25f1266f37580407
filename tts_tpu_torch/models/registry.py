"""Model registry and `runner_from_file`, the port's top-level entry point.

Counterpart of `tts_tpu/models/registry.py`, which imports the JAX model
modules and so cannot be shared.  Loaders register per GGUF
`general.architecture`; the `test:` prefix returns the weight-free fakes of
`tts_tpu.models.dummy` (jax-free, shared by import).
"""

from __future__ import annotations

from typing import Callable

import torch

from tts_tpu.core.gguf import GGUFFile
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError, TTSRunner

_LOADERS: dict[str, Callable] = {}
_TEST_LOADERS: dict[str, Callable] = {}


def register_loader(architecture: str, is_test: bool = False):
    def deco(fn):
        (_TEST_LOADERS if is_test else _LOADERS)[architecture] = fn
        return fn
    return deco


def list_architectures() -> list[str]:
    return sorted(_LOADERS)


@register_loader("dummy", is_test=True)
def _load_dummy(config: GenerationConfig, device) -> TTSRunner:
    from tts_tpu.models.dummy import DummyRunner

    return DummyRunner()


def runner_from_file(path: str, config: GenerationConfig | None = None,
                     device="cuda") -> TTSRunner:
    """Load a GGUF model file onto `device` and return its runner.  A CUDA
    device with no card raises TTSError: nothing falls back to the CPU."""
    import tts_tpu_torch.models.orpheus  # noqa: F401  (registers its loader)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise TTSError("device 'cuda' requested but no CUDA device is available")
    config = config or GenerationConfig()
    if path.startswith("test:"):
        name = path[len("test:"):]
        if name not in _TEST_LOADERS:
            raise TTSError(f"unknown test runner '{name}'")
        return _TEST_LOADERS[name](config, device)

    f = GGUFFile(path)
    arch = f.architecture
    if arch not in _LOADERS:
        raise TTSError(f"architecture '{arch}' is not supported by tts_tpu_torch "
                       f"(supported: {', '.join(list_architectures())})")
    return _LOADERS[arch](f, config, device)
