from tts_tpu_torch.utils.audio import read_wav, write_aiff, write_wav  # noqa: F401
