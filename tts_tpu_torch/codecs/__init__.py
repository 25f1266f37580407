from tts_tpu_torch.codecs.dac import DACDecoder  # noqa: F401
from tts_tpu_torch.codecs.snac import SNACDecoder  # noqa: F401
