"""A small GGUF v3 writer and reader of the benchmark's own: the weights it
makes are written in the format the program loads, and the references read
the same raw file back without the program's loader."""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

MAGIC = 0x46554747          # 'GGUF'
ALIGN = 32
F32, F16, Q4_0 = 0, 1, 2
_ITEM = {F32: (4, 1), F16: (2, 1), Q4_0: (18, 32)}      # bytes per block, values per block
# value types
_U8, _I32, _F32, _BOOL, _STR, _ARR, _U64 = 0, 5, 6, 7, 8, 9, 10


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v) -> bytes:
    if isinstance(v, str):
        return struct.pack("<I", _STR) + _pack_str(v)
    if isinstance(v, bool):
        return struct.pack("<I?", _BOOL, v)
    if isinstance(v, int):
        return struct.pack("<Ii", _I32, v)
    if isinstance(v, float):
        return struct.pack("<If", _F32, v)
    if isinstance(v, np.ndarray) and v.dtype == np.float32:
        return struct.pack("<IIQ", _ARR, _F32, len(v)) + v.astype("<f4").tobytes()
    if isinstance(v, (list, tuple)) and all(isinstance(x, str) for x in v):
        return struct.pack("<IIQ", _ARR, _STR, len(v)) + b"".join(_pack_str(x) for x in v)
    raise TypeError(f"gguf: cannot write {type(v).__name__}")


def nbytes(ggml_type: int, n: int) -> int:
    size, per = _ITEM[ggml_type]
    return n // per * size


def write(path: str, kv: dict, tensors: list):
    """tensors: (name, numpy row-major shape, ggml type, uint8 or typed array
    holding exactly the tensor's bytes).  Written to a temporary name in the
    same directory and renamed, so a reader never sees half a file."""
    tmp = f"{path}.part"
    with open(tmp, "wb") as out:
        out.write(struct.pack("<IIQQ", MAGIC, 3, len(tensors), len(kv)))
        for k, v in kv.items():
            out.write(_pack_str(k) + _pack_value(v))
        offset = 0
        for name, shape, gt, data in tensors:
            n = int(np.prod(shape))
            if data.nbytes != nbytes(gt, n):
                raise ValueError(f"gguf: {name} holds {data.nbytes} bytes, not {nbytes(gt, n)}")
            dims = tuple(reversed(shape))
            out.write(_pack_str(name) + struct.pack("<I", len(dims))
                      + b"".join(struct.pack("<Q", d) for d in dims)
                      + struct.pack("<IQ", gt, offset))
            offset += data.nbytes + (-data.nbytes) % ALIGN
        out.write(b"\x00" * ((-out.tell()) % ALIGN))
        for _, _, _, data in tensors:
            out.write(memoryview(np.ascontiguousarray(data)).cast("B"))
            out.write(b"\x00" * ((-data.nbytes) % ALIGN))
    os.replace(tmp, path)


class Reader:
    """kv, and each tensor as (ggml type, row-major shape, raw bytes view)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self.mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.pos = 0
        magic, _, n_t, n_kv = self._take("<IIQQ")
        if magic != MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        self.kv = {}
        for _ in range(n_kv):
            key = self._str()
            self.kv[key] = self._value(self._take("<I")[0])
        info = []
        for _ in range(n_t):
            name = self._str()
            nd = self._take("<I")[0]
            dims = self._take(f"<{nd}Q")
            gt, off = self._take("<IQ")
            info.append((name, gt, tuple(reversed(dims)), off))
        base = self.pos + (-self.pos) % ALIGN
        self.tensors = {n: (gt, shape, base + off) for n, gt, shape, off in info}

    def _take(self, fmt: str):
        vals = struct.unpack_from(fmt, self.mm, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals

    def _str(self) -> str:
        n = self._take("<Q")[0]
        s = bytes(self.mm[self.pos:self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def _value(self, t: int):
        if t == _STR:
            return self._str()
        if t == _ARR:
            et, n = self._take("<IQ")
            return [self._value(et) for _ in range(n)]
        fmt = {_U8: "<B", _I32: "<i", _F32: "<f", _BOOL: "<?", _U64: "<Q"}[t]
        return self._take(fmt)[0]

    def raw(self, name: str) -> tuple[int, tuple, np.ndarray]:
        gt, shape, start = self.tensors[name]
        n = nbytes(gt, int(np.prod(shape)))
        return gt, shape, np.frombuffer(self.mm, np.uint8, count=n, offset=start)

    def close(self):
        """Close the file; the mapping goes with the last view of it."""
        self._fh.close()
