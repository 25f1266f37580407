"""tts_tpu_torch — the PyTorch + CUDA port of `tts_tpu`, for one NVIDIA H100.

The JAX package `tts_tpu` stays the reference: every module here mirrors its
counterpart's name and layout (`ops/qmatmul.py`, `ops/attention.py`,
`models/orpheus.py`, ...), each subpackage re-exports its counterpart's
names, and the tests in `tests/test_torch_*.py` run both on the same
inputs.  This package imports `torch` and never `jax`, nor any module of
`tts_tpu`: the host-side pieces it needs (GGUF reader and writer, quant
codecs, tokenizers, Kokoro's phonemizer and espeak binding, runner API,
audio codecs, server, apps, converters, dummy runner, GGUF builders) are
its own copies.  Its entry points run on the card ("cuda") unless the
caller asks for the CPU; with no card they raise TTSError.

Layer map:
  csrc/     hand-written Hopper (sm_90a) CUDA kernels, one per TPU Pallas kernel
  ops/      kernel wrappers with their plain PyTorch versions, sampling,
            speculative drafting, convs, norms, LSTM (cuDNN), STFT/iSTFT,
            resampling
  core/     GGUF reader/writer, the Q4_0/Q5_0/Q8_0 block codecs, and the
            threaded C++ codecs of native/ggufc (native.py, built into build/)
  text/     BPE, Unigram and single-pass tokenizers, Kokoro's phonemizer
            (rules or espeak)
  codecs/   SNAC (24 kHz) and DAC (44.1 kHz) decoders
  models/   Orpheus-3B, Kokoro-82M, Parler-TTS with its T5 encoder, Dia-1.6B,
            dummy + registry (runner_from_file)
  runtime/  runner API, voice-inactivity trimming, SDL2 playback
  parallel/ meshes of devices, Orpheus tensor parallelism, data-parallel
            replicas, the Kokoro duration trainer
  apps/     OpenAI-compatible speech server, cli, quantize, perf_battery and
            phonemize, each on `--device cuda` where it runs a model
  convert/  seeded random-weight GGUF builders, the HF checkpoint converters
            (from_hf) and the phonemizer trainer
  tools/    parity_report (a checkpoint's stages and its audio against a
            reference WAV) and orpheus_step_breakdown (where a decode step's
            device time goes)

JAX names whose counterpart here has another name (`tests/test_torch_surface.py`
reads these lines):
  tts_tpu.ops.qmatmul.pack_linear -> tts_tpu_torch.ops.qmatmul.load_linear
  tts_tpu.ops.qmatmul.quantized_matmul_ref -> tts_tpu_torch.ops.qmatmul.qgemm_int8_plain
      (and qgemv_int8_plain, qgemv_int4_plain, qgemm_int4_plain: one per kernel)
  tts_tpu.ops.attention.gqa_decode_attention_dyn -> tts_tpu_torch.ops.attention.flash_decode
  tts_tpu.ops.stft.frame_signal -> tts_tpu_torch.ops.stft.stft
      (framing is inside stft)
  tts_tpu.models.kokoro.generation_forward -> tts_tpu_torch.models.kokoro.decode
      (and generator_tail, which takes the decoder's output to PCM)
  tts_tpu.ops.lstm.lstm -> tts_tpu_torch.ops.lstm.bilstm
      (both directions in one cuDNN call; so `tts_tpu_torch.ops` has no `lstm`)
Not ported: `runtime/aot.py` and the names that exist only for buckets, jit
or Pallas, each recorded in the port module it would belong to.
"""

__version__ = "0.1.0"

from tts_tpu_torch.runtime.api import GenerationConfig, TTSResponse  # noqa: E402,F401
