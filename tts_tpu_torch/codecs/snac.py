"""SNAC decoder for Orpheus: three multi-rate codebook streams -> 24 kHz PCM.

Counterpart of `tts_tpu/codecs/snac.py`.  It runs the exact number of frames
(the JAX package pads to a frame bucket).  Per-layer noise is a tensor the
caller may supply; by default it is a seeded counter-based normal keyed on
(seed, layer, absolute sample position), so a window decoded with context
draws the same noise as the full decode.  It is not the JAX package's
`jax.random` noise: tests inject those values to compare the two.
`SNACDecoder.decode_window` decodes a bounded window of a stream, as the
JAX package's does, for Orpheus's `generate_stream`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tts_tpu_torch.codecs.blocks import codec_layer, quantizer_decode
from tts_tpu_torch.core.device import card_device
from tts_tpu_torch.ops.basic import snake
from tts_tpu_torch.ops.conv import conv1d


@dataclass(frozen=True)
class SNACConfig:
    """The JAX package's SNACConfig without the fields exact-shape decoding
    never reads (up_sampling_factor, embd, max_generation_size,
    noise_steps, use_noise)."""
    n_layers: int = 4
    n_heads: int = 3
    repeats: tuple = (4, 2, 1)
    strides: tuple = (8, 8, 4, 2)
    paddings: tuple = (4, 4, 2, 1)
    groups: tuple = (1, 1, 1, 1)

    @staticmethod
    def from_gguf_kv(kv: dict) -> "SNACConfig":
        g = lambda k, d: int(kv.get(k, d))
        return SNACConfig(
            n_heads=g("snac.audio_token_channels", 3),
            strides=tuple(g(f"snac.snac_layer_stride_{i}", s)
                          for i, s in enumerate((8, 8, 4, 2))),
            paddings=tuple(g(f"snac.snac_layer_padding_{i}", p)
                           for i, p in enumerate((4, 4, 2, 1))),
            groups=tuple(g(f"snac.snac_layer_grouping_{i}", 1) for i in range(4)),
        )


def load_snac_params(tensors: dict, cfg: SNACConfig, device=None, prefix: str = "snac.") -> dict:
    """tensors: name -> numpy array or GGUFTensor; returns f32 tensors."""
    device = card_device(device)

    def get(name, optional=False):
        t = tensors.get(prefix + name)
        if t is None:
            if optional:
                return None
            raise KeyError(f"snac: missing tensor {prefix}{name}")
        arr = t.to_numpy() if hasattr(t, "to_numpy") else t
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    def unit(base):
        return {"in_alpha": get(f"{base}.res.initial.alpha").reshape(-1),
                "in_w": get(f"{base}.res.initial.weight"),
                "in_b": get(f"{base}.res.initial.bias"),
                "out_alpha": get(f"{base}.res.final.alpha").reshape(-1),
                "out_w": get(f"{base}.res.final.weight"),
                "out_b": get(f"{base}.res.final.bias")}

    p = {"in_w": get("in.weight"), "in_b": get("in.bias"),
         "up_w": get("up.weight"), "up_b": get("up.bias"),
         "out_w": get("final.weight"), "out_b": get("final.bias"),
         "out_alpha": get("alpha_out").reshape(-1),
         "layers": [], "quantizers": []}
    for i in range(cfg.n_layers):
        base = f"layers.{i}"
        layer = {"in_alpha": get(f"{base}.alpha").reshape(-1),
                 "in_w": get(f"{base}.weight"), "in_b": get(f"{base}.bias"),
                 "units": [unit(f"{base}.residual_unit.{j}") for j in range(3)]}
        noise_w = get(f"{base}.noise_weight", optional=True)
        if noise_w is not None:
            layer["noise_w"] = noise_w
        p["layers"].append(layer)
    for i in range(cfg.n_heads):
        w = get(f"quantizers.{i}.out_proj.weight")
        p["quantizers"].append({"codebook": get(f"quantizers.{i}.codebook.weight"),
                                "out_w": w.reshape(w.shape[0], -1).t().contiguous(),
                                "out_b": get(f"quantizers.{i}.out_proj.bias")})
    return p


def _to_torch(arr, device):
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:               # raw f16 bits (the JAX int8 scales)
        return torch.from_numpy(arr.view(np.float16).copy()).to(device)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(np_params, device=None):
    """A params tree from one of the JAX package's loaders (SNAC here, the
    Orpheus backbone in models/orpheus.py), as numpy arrays -> the same tree
    of torch tensors: uint16 scale bits become float16, every other array
    keeps its values and dtype (bfloat16 included)."""
    device = card_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    if isinstance(np_params, list):
        return [params_from_jax(v, device) for v in np_params]
    return _to_torch(np_params, device)


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finalizer (lowbias32), on a Python int or an int64
    tensor holding uint32 values (a wrapped int64 product keeps the low 32
    bits, so both give the same numbers)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def position_noise(seed: int, layer: int, start: int, length: int, device=None) -> torch.Tensor:
    """[length, 1] standard normals; the value at absolute sample position p
    depends only on (seed, layer, p).  Box-Muller over two hashed uniforms."""
    device = card_device(device)
    idx = start + torch.arange(length, dtype=torch.int64, device=device)
    key = _mix32((seed & _M32) ^ ((layer * 0x9E3779B9) & _M32))
    h1 = _mix32(idx ^ key)
    h2 = _mix32(h1 ^ 0x5BD1E995)
    u1 = (h1.double() + 0.5) / 2.0 ** 32
    u2 = (h2.double() + 0.5) / 2.0 ** 32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.float()[:, None]


def snac_decode(params: dict, cfg: SNACConfig, codes: torch.Tensor, seed: int = 0,
                start_frame: int = 0, noise: list | None = None) -> torch.Tensor:
    """codes [T, 3] at the finest rate (head 0 repeated x4, head 1 x2) ->
    audio [T * prod(strides)].  `start_frame` is the absolute frame of
    codes[0]; noise positions follow it.  `noise`, if given, holds one
    [T_out, 1] tensor per layer in place of `position_noise`."""
    x = quantizer_decode(codes, params["quantizers"])
    x = conv1d(x, params["in_w"], params["in_b"], padding=3, groups=x.shape[1])
    x = conv1d(x, params["up_w"], params["up_b"])
    rate = 1
    for i, layer in enumerate(params["layers"]):
        t_out = x.shape[0] * cfg.strides[i]
        rate *= cfg.strides[i]
        n = None
        if "noise_w" in layer:
            n = (noise[i] if noise is not None
                 else position_noise(seed, i, start_frame * rate, t_out, x.device))
        x = codec_layer(x, layer, stride=cfg.strides[i], padding=cfg.paddings[i],
                        groups=cfg.groups[i], noise=n)
    x = snake(x, params["out_alpha"])
    x = conv1d(x, params["out_w"], params["out_b"], padding=3)
    return torch.tanh(x)[:, 0]


class SNACDecoder:
    """Host wrapper: three token lists at rates x4/x2/x1 -> float32 PCM."""

    sample_rate = 24000
    device_arrays = ("params",)
    # ~12 fine-rate frames of receptive field per side (in-conv +/-3, layer-1
    # residual units +/-39/8, transposed-conv kernels +/-~1 each, the rest
    # sub-frame); 16 gives margin (tests hold a windowed decode to the full one)
    RECEPTIVE_FRAMES = 16

    def __init__(self, cfg: SNACConfig, params: dict, device=None):
        self.cfg = cfg
        self.params = params
        self.device = card_device(device)

    @classmethod
    def from_tensors(cls, tensors: dict, kv: dict, device=None) -> "SNACDecoder":
        """Load onto `device`, the card when None (no card: TTSError)."""
        device = card_device(device)
        cfg = SNACConfig.from_gguf_kv(kv)
        return cls(cfg, load_snac_params(tensors, cfg, device), device)

    def decode(self, heads: list, seed: int = 0, start_frame: int = 0,
               noise: list | None = None) -> np.ndarray:
        """heads[i] has len T / repeats[i]; T = len(heads[-1])."""
        t = len(heads[-1])
        if t == 0:
            return np.zeros(0, np.float32)
        codes = np.zeros((t, self.cfg.n_heads), np.int64)
        for i, rep in enumerate(self.cfg.repeats):
            expanded = np.repeat(np.asarray(heads[i], np.int64), rep)[:t]
            codes[: len(expanded), i] = expanded
        with torch.inference_mode():
            audio = snac_decode(self.params, self.cfg,
                                torch.from_numpy(codes).to(self.device), seed,
                                start_frame, noise)
        return audio.float().cpu().numpy()

    def decode_window(self, heads: list, emit_start: int, emit_end: int,
                      seed: int = 0) -> np.ndarray:
        """The samples of fine-rate frames [emit_start, emit_end) of the
        head streams `heads`, decoded from a window with RECEPTIVE_FRAMES of
        context on both sides (its start aligned to the x4 head): O(chunk)
        codec work per chunk.  With emission held RECEPTIVE_FRAMES behind
        the frame head until a final flush (Orpheus's generate_stream), the
        concatenated chunks equal one full decode: the noise is keyed by
        absolute position, so a window draws the full decode's."""
        total = len(heads[-1])
        emit_end = min(emit_end, total)
        if emit_end <= emit_start:
            return np.zeros(0, np.float32)
        start = max(0, emit_start - self.RECEPTIVE_FRAMES)
        start -= start % 4
        end = min(total, emit_end + self.RECEPTIVE_FRAMES)
        window = [np.asarray(heads[i], np.int64)[start // rep:-(-end // rep)]
                  for i, rep in enumerate(self.cfg.repeats)]
        audio = self.decode(window, seed=seed, start_frame=start)
        up = math.prod(self.cfg.strides)
        return audio[(emit_start - start) * up:(emit_end - start) * up]
