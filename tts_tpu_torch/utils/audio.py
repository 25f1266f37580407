"""WAV / AIFF encoders for float32 PCM (no third-party deps).

The port's own copy of `encode_wav` / `encode_aiff` from
`tts_tpu/utils/audio.py`: the same bytes for the same audio (16-bit PCM by
default, as the server sends it)."""

from __future__ import annotations

import io
import math
import struct

import numpy as np


def _to_int16(audio: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2")


def encode_wav(audio: np.ndarray, sample_rate: int, bit_depth: int = 16) -> bytes:
    """float32 [-1,1] mono -> RIFF/WAVE bytes (16-bit PCM or 32-bit float)."""
    out = io.BytesIO()
    if bit_depth == 16:
        data = _to_int16(audio).tobytes()
        fmt, block, bits = 1, 2, 16
    elif bit_depth == 32:
        data = np.asarray(audio, "<f4").tobytes()
        fmt, block, bits = 3, 4, 32
    else:
        raise ValueError(f"unsupported bit depth {bit_depth}")
    out.write(b"RIFF")
    out.write(struct.pack("<I", 36 + len(data)))
    out.write(b"WAVEfmt ")
    out.write(struct.pack("<IHHIIHH", 16, fmt, 1, sample_rate,
                          sample_rate * block, block, bits))
    out.write(b"data")
    out.write(struct.pack("<I", len(data)))
    out.write(data)
    return out.getvalue()


def _f80(value: float) -> bytes:
    """80-bit IEEE 754 extended float (AIFF sample-rate field)."""
    if value == 0:
        return b"\x00" * 10
    m, e = math.frexp(value)
    exponent = e + 16382
    mantissa = int(m * (1 << 64))
    return struct.pack(">H", exponent) + struct.pack(">Q", mantissa)


def encode_aiff(audio: np.ndarray, sample_rate: int) -> bytes:
    """float32 [-1,1] mono -> AIFF bytes (16-bit PCM big-endian)."""
    data = _to_int16(audio).astype(">i2").tobytes()
    n = len(audio)
    comm = struct.pack(">hIh", 1, n, 16) + _f80(float(sample_rate))
    ssnd = struct.pack(">II", 0, 0) + data
    size = 4 + (8 + len(comm)) + (8 + len(ssnd))
    out = io.BytesIO()
    out.write(b"FORM")
    out.write(struct.pack(">I", size))
    out.write(b"AIFF")
    out.write(b"COMM")
    out.write(struct.pack(">I", len(comm)))
    out.write(comm)
    out.write(b"SSND")
    out.write(struct.pack(">I", len(ssnd)))
    out.write(ssnd)
    return out.getvalue()
