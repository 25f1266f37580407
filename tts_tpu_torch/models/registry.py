"""Model registry and `runner_from_file`, the port's top-level entry point.

Counterpart of `tts_tpu/models/registry.py`.  Loaders register per GGUF
`general.architecture`; the `test:` prefix returns the weight-free fakes
(`test:dummy`, models/dummy.py).
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from tts_tpu_torch.core.gguf import GGUFFile
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError, TTSRunner, card_device

_LOADERS: dict[str, Callable] = {}
_TEST_LOADERS: dict[str, Callable] = {}


def register_loader(architecture: str, is_test: bool = False):
    def deco(fn):
        (_TEST_LOADERS if is_test else _LOADERS)[architecture] = fn
        return fn
    return deco


def list_architectures() -> list[str]:
    return sorted(_LOADERS)


def runner_from_file(path: str, config: GenerationConfig | None = None,
                     device=None, mesh=None) -> TTSRunner:
    """Load a GGUF model file onto `device` (default: cuda) and return its
    runner.  A CUDA device with no card raises TTSError: nothing falls
    back to the CPU.  `mesh`: a ("tp",) mesh (`parallel.mesh.Mesh`) for the
    architectures with a tensor-parallel form (Orpheus); the runner then
    lives on the mesh's devices, loading on its lead device.  Test runners
    and architectures without a `mesh` parameter raise TTSError."""
    import tts_tpu_torch.models.dia  # noqa: F401  (register their loaders)
    import tts_tpu_torch.models.dummy  # noqa: F401
    import tts_tpu_torch.models.kokoro_runner  # noqa: F401
    import tts_tpu_torch.models.orpheus  # noqa: F401
    import tts_tpu_torch.models.parler  # noqa: F401

    if mesh is not None:
        if device is not None and torch.device(device) != mesh.lead:
            raise TTSError(f"device {device} is not the mesh's lead device {mesh.lead}")
        device = mesh.lead
    device = card_device(device)
    config = config or GenerationConfig()
    if path.startswith("test:"):
        name = path[len("test:"):]
        if name not in _TEST_LOADERS:
            raise TTSError(f"unknown test runner '{name}'")
        if mesh is not None:
            raise TTSError("test runners have no tensor-parallel config (mesh=)")
        return _TEST_LOADERS[name](config, device)

    f = GGUFFile(path)
    arch = f.architecture
    if arch not in _LOADERS:
        raise TTSError(f"architecture '{arch}' is not supported by tts_tpu_torch "
                       f"(supported: {', '.join(list_architectures())})")
    if mesh is not None:
        if "mesh" not in inspect.signature(_LOADERS[arch]).parameters:
            raise TTSError(f"architecture '{arch}' has no tensor-parallel config (mesh=)")
        return _LOADERS[arch](f, config, device, mesh=mesh)
    return _LOADERS[arch](f, config, device)
