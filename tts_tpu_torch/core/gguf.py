"""GGUF v3 reader/writer.

The port's own copy of `tts_tpu/core/gguf.py`: parse any GGUF (header, typed
KV metadata, tensor table, quant blocks) into numpy arrays, and write GGUF
byte for byte as the JAX package's writer does.  Reading uses mmap so
weights stream lazily; quantized blocks decode with the numpy codecs of
`core/quant.py` (the JAX package's optional C library is not carried over).
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, BinaryIO

import numpy as np

from tts_tpu_torch.core import quant

GGUF_MAGIC = 0x46554747  # 'GGUF'
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NUMPY_DTYPES = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
    GGMLType.I64: np.dtype(np.int64),
    GGMLType.F64: np.dtype(np.float64),
}

_QUANT_BLOCK_BYTES = {
    GGMLType.Q4_0: quant.Q4_0_BLOCK_BYTES,
    GGMLType.Q5_0: quant.Q5_0_BLOCK_BYTES,
    GGMLType.Q8_0: quant.Q8_0_BLOCK_BYTES,
}

_DEQUANT = {
    GGMLType.Q4_0: quant.dequantize_q4_0,
    GGMLType.Q5_0: quant.dequantize_q5_0,
    GGMLType.Q8_0: quant.dequantize_q8_0,
}


def ggml_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    t = GGMLType(ggml_type)
    if t in _NUMPY_DTYPES:
        return n_elements * _NUMPY_DTYPES[t].itemsize
    if t == GGMLType.BF16:
        return n_elements * 2
    if t in _QUANT_BLOCK_BYTES:
        assert n_elements % quant.QK == 0, f"quantized tensor size {n_elements} not /32"
        return (n_elements // quant.QK) * _QUANT_BLOCK_BYTES[t]
    raise ValueError(f"unsupported ggml type {ggml_type}")


@dataclass
class GGUFTensor:
    """One entry of the tensor table.  `dims` are GGML order (dims[0] fastest);
    `shape` is the numpy/JAX row-major shape (reversed dims)."""

    name: str
    dims: tuple[int, ...]
    ggml_type: GGMLType
    offset: int          # relative to the start of the data section
    _file: "GGUFFile | None" = field(default=None, repr=False)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.dims))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return ggml_nbytes(self.ggml_type, self.n_elements)

    def raw(self) -> np.ndarray:
        """Raw bytes view (zero-copy out of the mmap)."""
        assert self._file is not None
        start = self._file.data_offset + self.offset
        return np.frombuffer(self._file.mm, dtype=np.uint8, count=self.nbytes, offset=start)

    def to_numpy(self, dtype=np.float32) -> np.ndarray:
        """Materialize as a numpy array of `dtype` (dequantizing if needed)."""
        t = GGMLType(self.ggml_type)
        if t in _NUMPY_DTYPES:
            arr = self.raw().view(_NUMPY_DTYPES[t])[: self.n_elements]
        elif t == GGMLType.BF16:
            u16 = self.raw().view(np.uint16)[: self.n_elements].astype(np.uint32) << 16
            arr = u16.view(np.float32)
        else:
            arr = _DEQUANT[t](self.raw(), self.n_elements)
        return np.ascontiguousarray(arr.reshape(self.shape).astype(dtype, copy=False))

    def to_int8_scales(self):
        """(int8 values [shape], f32 per-32-block scales) for quantized matmuls."""
        t = GGMLType(self.ggml_type)
        if t == GGMLType.Q8_0:
            v, s = quant.q8_0_to_int8_scales(self.raw(), self.n_elements)
        elif t == GGMLType.Q4_0:
            v, s = quant.q4_0_to_int8_scales(self.raw(), self.n_elements)
        elif t == GGMLType.Q5_0:
            v, s = quant.q5_0_to_int8_scales(self.raw(), self.n_elements)
        else:
            raise ValueError(f"no int8 view for {t}")
        return v.reshape(self.shape), s


class GGUFFile:
    """mmap-backed GGUF reader.

    Usage:
        f = GGUFFile("model.gguf")
        arch = f.kv["general.architecture"]
        w = f.tensors["decoder.layers.0.attn.q.weight"].to_numpy()
    """

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        self.mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self._parse()

    # -- low-level cursor reads ------------------------------------------------
    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.mm, self._pos)
        self._pos += size
        return vals[0] if len(vals) == 1 else vals

    def _read_string(self) -> str:
        n = self._read("<Q")
        s = bytes(self.mm[self._pos : self._pos + n]).decode("utf-8")
        self._pos += n
        return s

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self._read("<I"))
            count = self._read("<Q")
            if etype == GGUFValueType.STRING:
                return [self._read_string() for _ in range(count)]
            if etype == GGUFValueType.ARRAY:
                return [self._read_value(GGUFValueType.ARRAY) for _ in range(count)]
            fmt = _SCALAR_FMT[etype]
            itemsize = struct.calcsize(fmt)
            arr = np.frombuffer(self.mm, dtype=np.dtype(fmt[1]).newbyteorder("<"),
                                count=count, offset=self._pos)
            self._pos += itemsize * count
            return arr
        return self._read(_SCALAR_FMT[vtype])

    # -- header / tables -------------------------------------------------------
    def _parse(self):
        magic = self._read("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic:#x})")
        self.version = self._read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._read("<Q")
        n_kv = self._read("<Q")

        self.kv: dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._read_string()
            vtype = GGUFValueType(self._read("<I"))
            self.kv[key] = self._read_value(vtype)

        self.tensors: dict[str, GGUFTensor] = {}
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("<I")
            dims = tuple(int(self._read("<Q")) for _ in range(n_dims))
            ggml_type = GGMLType(self._read("<I"))
            offset = self._read("<Q")
            self.tensors[name] = GGUFTensor(name, dims, ggml_type, offset, _file=self)

        self.alignment = int(self.kv.get("general.alignment", DEFAULT_ALIGNMENT))
        pad = (-self._pos) % self.alignment
        self.data_offset = self._pos + pad

    @property
    def architecture(self) -> str:
        return self.kv.get("general.architecture", "")

    def close(self):
        # Tensor views are zero-copy out of the mmap; if any are still alive
        # the mapping must stay valid, so closing is best-effort (the OS frees
        # the mapping when the last view is GC'd).
        try:
            self.mm.close()
        except BufferError:
            pass
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Writer (used by the random-model builders and the tests).
# ---------------------------------------------------------------------------

def _guess_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v < 0 or v >= 2**32) else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    """Write a GGUF v3 file.  Tensors may be numpy arrays (F32/F16/I32 inferred
    from dtype) or pre-quantized raw bytes (`add_raw_tensor`)."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._kv: list[tuple[str, Any, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv.append((key, value, vtype))

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: GGMLType | None = None):
        """array shape is numpy row-major; stored dims are reversed (GGML order)."""
        arr = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = {
                np.dtype(np.float32): GGMLType.F32,
                np.dtype(np.float16): GGMLType.F16,
                np.dtype(np.int32): GGMLType.I32,
                np.dtype(np.int64): GGMLType.I64,
                np.dtype(np.int8): GGMLType.I8,
            }[arr.dtype]
            data = arr.tobytes()
        elif ggml_type == GGMLType.Q4_0:
            data = quant.quantize_q4_0(arr.astype(np.float32))
        elif ggml_type == GGMLType.Q5_0:
            data = quant.quantize_q5_0(arr.astype(np.float32))
        elif ggml_type == GGMLType.Q8_0:
            data = quant.quantize_q8_0(arr.astype(np.float32))
        elif ggml_type == GGMLType.F16:
            data = arr.astype(np.float16).tobytes()
        elif ggml_type == GGMLType.F32:
            data = arr.astype(np.float32).tobytes()
        elif ggml_type == GGMLType.BF16:
            f32 = arr.astype(np.float32).view(np.uint32)
            data = ((f32 + 0x7FFF + ((f32 >> 16) & 1)) >> 16).astype(np.uint16).tobytes()
        else:
            raise ValueError(f"unsupported write type {ggml_type}")
        dims = tuple(reversed(arr.shape)) if arr.ndim else (1,)
        self._tensors.append((name, dims, ggml_type, data))

    def add_raw_tensor(self, name: str, dims_ggml: tuple[int, ...],
                       ggml_type: GGMLType, data: bytes):
        """Pre-quantized blocks, written as given: dims already in GGML order."""
        self._tensors.append((name, tuple(dims_ggml), GGMLType(ggml_type), data))

    # -- serialization ----------------------------------------------------------
    @staticmethod
    def _pack_string(out: BinaryIO, s: str):
        b = s.encode("utf-8")
        out.write(struct.pack("<Q", len(b)))
        out.write(b)

    def _pack_value(self, out: BinaryIO, v: Any, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            self._pack_string(out, v)
        elif vtype == GGUFValueType.ARRAY:
            if len(v) and isinstance(v[0], str):
                etype = GGUFValueType.STRING
            elif isinstance(v, np.ndarray):
                etype = {
                    np.dtype(np.float32): GGUFValueType.FLOAT32,
                    np.dtype(np.int32): GGUFValueType.INT32,
                    np.dtype(np.uint32): GGUFValueType.UINT32,
                    np.dtype(np.int64): GGUFValueType.INT64,
                    np.dtype(np.float64): GGUFValueType.FLOAT64,
                }[v.dtype]
            elif len(v) and isinstance(v[0], float):
                etype = GGUFValueType.FLOAT32
            else:
                etype = GGUFValueType.INT32
            out.write(struct.pack("<IQ", int(etype), len(v)))
            for el in v:
                self._pack_value(out, el, etype)
        else:
            out.write(struct.pack(_SCALAR_FMT[vtype], v))

    def write(self):
        align = DEFAULT_ALIGNMENT
        with open(self.path, "wb") as out:
            out.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                                  len(self._tensors), len(self._kv)))
            for key, value, vtype in self._kv:
                vtype = vtype or _guess_vtype(value)
                self._pack_string(out, key)
                out.write(struct.pack("<I", int(vtype)))
                self._pack_value(out, value, vtype)

            offset = 0
            for name, dims, ggml_type, data in self._tensors:
                self._pack_string(out, name)
                out.write(struct.pack("<I", len(dims)))
                for d in dims:
                    out.write(struct.pack("<Q", d))
                out.write(struct.pack("<IQ", int(ggml_type), offset))
                offset += len(data) + ((-len(data)) % align)

            out.write(b"\x00" * ((-out.tell()) % align))
            for _, _, _, data in self._tensors:
                out.write(data)
                out.write(b"\x00" * ((-len(data)) % align))
