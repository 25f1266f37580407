from tts_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
