from tts_tpu_torch.text.tokenizers import (  # noqa: F401
    BPETokenizer,
    SinglePassTokenizer,
    UnigramTokenizer,
)
