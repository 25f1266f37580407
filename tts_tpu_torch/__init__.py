"""tts_tpu_torch — the PyTorch + CUDA port of `tts_tpu`, for one NVIDIA H100.

The JAX package `tts_tpu` stays the reference: every module here mirrors its
counterpart's name and layout (`ops/qmatmul.py`, `ops/attention.py`,
`models/orpheus.py`, ...), and the tests in `tests/test_torch_*.py` run both
on the same inputs.  This package imports `torch` and never `jax`, nor any
module of `tts_tpu`: the host-side pieces it needs (GGUF reader and writer,
quant codecs, tokenizers, Kokoro's phonemizer and espeak binding, runner
API, audio encoders, server, dummy runner, GGUF builders) are its own
copies.

Layer map:
  csrc/     hand-written Hopper (sm_90a) CUDA kernels, one per TPU Pallas kernel
  ops/      kernel wrappers with their plain PyTorch versions, sampling, convs,
            norms, LSTM (cuDNN), STFT/iSTFT, resampling
  core/     GGUF reader/writer and the Q4_0/Q5_0/Q8_0 block codecs
  text/     BPE and single-pass tokenizers, Kokoro's phonemizer (rules or espeak)
  codecs/   SNAC decoder
  models/   Orpheus-3B (Q8_0 or Q4_0 weights, bf16 KV cache), Kokoro-82M
            (exact shapes, bf16 frame-rate path), dummy + registry
  runtime/  runner API
  apps/     OpenAI-compatible speech server on `--device cuda`
  convert/  seeded random-weight GGUF builders
"""

__version__ = "0.1.0"
