"""ctypes binding for the threaded C++ GGUF block codecs (`native/ggufc`).

The port's counterpart of `tts_tpu/core/native.py`, with its API.  It
compiles the JAX package's C++ source, `native/ggufc/ggufc.cpp`, where it
lies: that file is plain C++ outside the `tts_tpu` package, and no Python of
the JAX package is imported.  Compiling the one file, rather than copying
it, keeps the two packages' codecs from drifting apart.

On first use `get_lib` runs g++ with the flags of `native/ggufc/Makefile`
(`-O3 -fPIC -std=c++17 -pthread -shared`) into `build/` at the repository
root (listed in .gitignore), under a name hashed from the source and the
flags.  The build holds an `fcntl` lock in that directory and renames the
finished file into place, so processes that start together build it once
and never load half a file.  It never runs `make -C native/ggufc`, which
writes `native/ggufc/libggufc.so` in place: concurrent test workers race on
that file.  Importing this module builds nothing.

The library is optional: with no compiler, or if the build fails,
`get_lib()` is None, `available()` is false, and `GGUFTensor.to_numpy`
decodes with the numpy codecs of `core/quant.py`, which give the same bits.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "ggufc", "ggufc.cpp")
BUILD_DIR = os.path.join(_ROOT, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
# the decoders: (bytes, values) of one input block
_DEQUANT = {"ggufc_dequant_q4_0": (18, 32), "ggufc_dequant_q5_0": (22, 32),
            "ggufc_dequant_q8_0": (34, 32), "ggufc_f16_to_f32": (2, 1),
            "ggufc_bf16_to_f32": (2, 1)}

_lock = threading.Lock()


def _build(build_dir: str) -> str | None:
    """The library's path in `build_dir`, compiled there if it is not yet;
    None without a compiler or the source, or if g++ fails."""
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    path = os.path.join(build_dir, f"libggufc_{digest}.so")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libggufc.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # released when the file closes
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                               timeout=120, check=True)
            except (subprocess.SubprocessError, OSError):
                if os.path.exists(tmp):
                    os.remove(tmp)
                return None
            os.replace(tmp, path)               # atomic: no process sees half a file
    return path


@functools.lru_cache(maxsize=None)
def _load(build_dir: str):
    path = _build(build_dir)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name in _DEQUANT:
        fn = getattr(lib, name)
        fn.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_int]
        fn.restype = None
    lib.ggufc_quant_q8_0.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_int]
    lib.ggufc_quant_q8_0.restype = None
    return lib


def get_lib():
    """The loaded library (built on first call), or None."""
    with _lock:
        return _load(BUILD_DIR)


def available() -> bool:
    return get_lib() is not None


# values each thread takes: a call over fewer than twice this many runs on
# one thread (chip_smoke.py phase 11's sweep: on an 8-core host a thread's
# start costs more than splitting a 65,536-block dequant gains)
VALUES_PER_THREAD = 1 << 21


def _threads(n_values: int) -> int:
    """Threads for a call over `n_values` values: one per VALUES_PER_THREAD,
    at least one, at most 16 and the CPUs this process may run on."""
    return max(1, min(len(os.sched_getaffinity(0)), 16, n_values // VALUES_PER_THREAD))


def _call(fn_name: str, raw: np.ndarray, n_elements: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    block_bytes, block_values = _DEQUANT[fn_name]
    raw = np.ascontiguousarray(raw)
    if raw.nbytes < -(-n_elements // block_values) * block_bytes:
        raise ValueError(f"{fn_name}: {raw.nbytes} bytes hold fewer than {n_elements} values")
    out = np.empty(n_elements, np.float32)
    getattr(lib, fn_name)(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          n_elements, _threads(n_elements))
    return out


def dequant_q4_0(raw, n):
    return _call("ggufc_dequant_q4_0", raw, n)


def dequant_q5_0(raw, n):
    return _call("ggufc_dequant_q5_0", raw, n)


def dequant_q8_0(raw, n):
    return _call("ggufc_dequant_q8_0", raw, n)


def f16_to_f32(raw, n):
    return _call("ggufc_f16_to_f32", raw, n)


def bf16_to_f32(raw, n):
    return _call("ggufc_bf16_to_f32", raw, n)


def quant_q8_0(arr: np.ndarray) -> bytes | None:
    """f32 values -> Q8_0 blocks (34 bytes per 32 values), or None."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(arr, np.float32).reshape(-1)
    out = np.empty((x.size + 31) // 32 * 34, np.uint8)
    lib.ggufc_quant_q8_0(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), x.size,
                         _threads(x.size))
    return out.tobytes()
