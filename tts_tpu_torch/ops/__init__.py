"""The JAX package's `tts_tpu.ops` names, less `lstm`: the port's `bilstm`
runs both directions of a layer in one cuDNN call, so it has no
one-direction LSTM (the renamed names are listed in `tts_tpu_torch`'s
docstring).  Importing these builds no kernel: `ops/_ext.py` builds on
first launch."""

from tts_tpu_torch.ops.basic import (  # noqa: F401
    ada_layer_norm, instance_norm_time, layer_norm, leaky_relu, snake,
)
from tts_tpu_torch.ops.conv import conv1d, conv_transpose1d  # noqa: F401
from tts_tpu_torch.ops.lstm import bilstm, pack_lstm_params  # noqa: F401
from tts_tpu_torch.ops.stft import hann_window, istft, stft, window_squared_sum  # noqa: F401
from tts_tpu_torch.ops.resample import upsample_linear, upsample_nearest  # noqa: F401
