from tts_tpu_torch.runtime.api import GenerationConfig, TTSResponse, TTSRunner  # noqa: F401
