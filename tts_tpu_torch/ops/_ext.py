"""Build and bind the port's CUDA kernels (`csrc/*.cu`) with nvcc and ctypes.

On first use, nvcc compiles every source in `csrc/` for `sm_90a` into one
shared library with a plain C interface, under `build/` at the repository
root (listed in .gitignore), named by a hash of the sources and flags so an
edited source never loads a stale library.  It is loaded with ctypes:
pointers and the CUDA stream pass as `c_void_p`, and each entry point
returns `cudaGetLastError()` after its launches, which `check` turns into an
exception.  A plain C interface builds in seconds; a source that includes
PyTorch's headers (torch.utils.cpp_extension) takes minutes.

Importing this module builds nothing: the tests on a machine without nvcc
import every module of the port.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types, in the order of csrc/*.cu's extern "C" API
SIGNATURES = {
    # x_bf16, wq, scales, partial, out, K, N, splits, blocks_per_split, stream
    "qgemv_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x_f32, wq, scales, out, M, K, N, stream
    "qgemm_int8": (_P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, k_scale, v_scale, pos, part_m, part_l, part_acc, out,
    # Hq, Hkv, S, kv_int8, scale, stream
    "flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}       # filled by the first build: seconds, path, log


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build() -> str:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libtts_tpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        build_info.update(seconds=0.0, path=path, log="(cached)")
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builders never see half a file
    build_info.update(seconds=seconds, path=path, log=proc.stderr + proc.stdout)
    return path


def load():
    """The kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.tts_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tts_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error (refused launches never run,
    and a later synchronize would not report them)."""
    if err != 0:
        msg = load().tts_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
