"""DAC (Descript Audio Codec) decoder: 9 RVQ codebooks -> 44.1 kHz PCM.

Counterpart of `tts_tpu/codecs/dac.py`: the quantizer embedding sum, the
in-conv, 4 upsampling layers (x512 in all), snake, the out-conv and tanh,
built from `codecs/blocks.py` (cuDNN convolutions; no Pallas kernel sat on
this path).  Any widths load: the in-conv's output and each block's come
from the tensors' shapes.

It runs the exact number of frames.  Not ported: `FRAME_BUCKETS`,
`pick_bucket` and the pad-frame latent mask, which exist so that XLA
compiles one graph per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tts_tpu_torch.codecs.blocks import codec_layer, quantizer_decode
from tts_tpu_torch.ops.basic import snake
from tts_tpu_torch.ops.conv import conv1d


@dataclass(frozen=True)
class DACConfig:
    """The JAX package's DACConfig without the fields exact-shape decoding
    never reads (max_generation_size)."""
    n_layers: int = 4
    n_heads: int = 9
    up_sampling_factor: int = 512
    strides: tuple = (8, 8, 4, 2)
    paddings: tuple = (4, 4, 2, 1)

    @staticmethod
    def from_gguf_kv(kv: dict) -> "DACConfig":
        g = lambda k, d: int(kv.get(k, d))
        return DACConfig(
            n_heads=g("parler-tts.decoder.output_heads", g("dia.decoder.output_heads", 9)),
            up_sampling_factor=g("dac.up_sampling_factor", g("dac.up_scaling_factor", 512)),
            strides=tuple(g(f"dac.dac_layer_stride_{i}", s)
                          for i, s in enumerate((8, 8, 4, 2))),
            paddings=tuple(g(f"dac.dac_layer_padding_{i}", p)
                           for i, p in enumerate((4, 4, 2, 1))),
        )


def load_dac_params(tensors: dict, cfg: DACConfig, device="cpu",
                    prefix: str = "audio_encoder.") -> dict:
    """tensors: name -> numpy array or GGUFTensor; returns f32 tensors on
    `device` in the JAX loader's tree."""
    def get(name):
        t = tensors.get(prefix + name)
        if t is None:
            raise KeyError(f"dac: missing tensor {prefix}{name}")
        arr = t.to_numpy() if hasattr(t, "to_numpy") else t
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    def unit(base):
        return {"in_alpha": get(f"{base}.res.initial.alpha").reshape(-1),
                "in_w": get(f"{base}.res.initial.weight"),
                "in_b": get(f"{base}.res.initial.bias"),
                "out_alpha": get(f"{base}.res.final.alpha").reshape(-1),
                "out_w": get(f"{base}.res.final.weight"),
                "out_b": get(f"{base}.res.final.bias")}

    p = {"in_w": get("initial.weight"), "in_b": get("initial.bias"),
         "out_w": get("final.weight"), "out_b": get("final.bias"),
         "out_alpha": get("final.alpha").reshape(-1),
         "layers": [], "quantizers": []}
    for i in range(1, cfg.n_layers + 1):
        base = f"decoder_block.{i}"
        p["layers"].append({"in_alpha": get(f"{base}.final.alpha").reshape(-1),
                            "in_w": get(f"{base}.final.weight"),
                            "in_b": get(f"{base}.final.bias"),
                            "units": [unit(f"{base}.residual_unit.{j}") for j in range(3)]})
    for i in range(cfg.n_heads):
        w = get(f"quantizers.{i}.out_proj.weight")
        p["quantizers"].append({"codebook": get(f"quantizers.{i}.codebook.weight"),
                                "out_w": w.reshape(w.shape[0], -1).t().contiguous(),
                                "out_b": get(f"quantizers.{i}.out_proj.bias")})
    return p


def dac_decode(params: dict, cfg: DACConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [T, H] -> audio [T * up_sampling_factor] float32."""
    x = quantizer_decode(codes, params["quantizers"])          # [T, latent]
    x = conv1d(x, params["in_w"], params["in_b"], padding=3)
    for i, layer in enumerate(params["layers"]):
        x = codec_layer(x, layer, stride=cfg.strides[i], padding=cfg.paddings[i])
    x = snake(x, params["out_alpha"])
    x = conv1d(x, params["out_w"], params["out_b"], padding=3)
    return torch.tanh(x)[:, 0]


class DACDecoder:
    """Host wrapper: codes [T, 9] -> float32 PCM numpy."""

    sample_rate = 44100
    # receptive field in frames: in-conv +/-3, layer-1 residual units
    # +/-39/8, transposed-conv kernels +/-~1 each, deeper layers sub-frame;
    # 16 gives margin (tests hold a windowed decode to the full one)
    RECEPTIVE_FRAMES = 16

    def __init__(self, cfg: DACConfig, params: dict, device="cpu"):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)

    @classmethod
    def from_tensors(cls, tensors: dict, kv: dict, device="cpu") -> "DACDecoder":
        cfg = DACConfig.from_gguf_kv(kv)
        return cls(cfg, load_dac_params(tensors, cfg, device), device)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if len(codes) == 0:
            return np.zeros(0, np.float32)
        with torch.inference_mode():
            audio = dac_decode(self.params, self.cfg,
                               torch.from_numpy(np.asarray(codes, np.int64)).to(self.device))
        return audio.float().cpu().numpy()

    def decode_window(self, codes: np.ndarray, emit_start: int,
                      emit_end: int) -> np.ndarray:
        """The samples of frames [emit_start, emit_end), decoded from a
        window with RECEPTIVE_FRAMES of context on both sides: O(chunk)
        codec work per chunk.  With emission held RECEPTIVE_FRAMES behind
        the frame head (Parler's generate_stream), the concatenated chunks
        equal one full decode (DAC draws no noise)."""
        total = len(codes)
        emit_end = min(emit_end, total)
        if emit_end <= emit_start:
            return np.zeros(0, np.float32)
        start = max(0, emit_start - self.RECEPTIVE_FRAMES)
        end = min(total, emit_end + self.RECEPTIVE_FRAMES)
        audio = self.decode(np.asarray(codes[start:end], np.int32))
        up = self.cfg.up_sampling_factor
        return audio[(emit_start - start) * up:(emit_end - start) * up]
