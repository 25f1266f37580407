"""The runner API of the port: `tts_tpu.runtime.api`'s request config,
response, error and runner base class, shared by import (that module is
jax-free), so both packages' runners answer the same server and clients."""

from tts_tpu.runtime.api import GenerationConfig, TTSError, TTSResponse, TTSRunner

__all__ = ["GenerationConfig", "TTSError", "TTSResponse", "TTSRunner"]
