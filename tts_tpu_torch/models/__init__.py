from tts_tpu_torch.models.registry import register_loader, runner_from_file  # noqa: F401
