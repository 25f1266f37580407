from tts_tpu_torch.core.gguf import GGUFFile, GGUFTensor, GGUFWriter, GGMLType  # noqa: F401
