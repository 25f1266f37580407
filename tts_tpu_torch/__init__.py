"""tts_tpu_torch — the PyTorch + CUDA port of `tts_tpu`, for one NVIDIA H100.

The JAX package `tts_tpu` stays the reference: every module here mirrors its
counterpart's name and layout (`ops/qmatmul.py`, `ops/attention.py`,
`models/orpheus.py`, ...), and the tests in `tests/test_torch_*.py` run both
on the same inputs.  This package imports `torch` and never `jax`; host-side
modules of `tts_tpu` that are jax-free (GGUF reader, tokenizers, runner API,
audio encoders, the server's handler) are shared by import.

Layer map:
  csrc/     hand-written Hopper (sm_90a) CUDA kernels, one per TPU Pallas kernel
  ops/      kernel wrappers with their plain PyTorch versions, sampling, convs
  codecs/   SNAC decoder
  models/   Orpheus-3B (Q8_0 weights, bf16 KV cache) + registry
  apps/     OpenAI-compatible speech server on `--device cuda`
"""

__version__ = "0.1.0"
