"""Build and bind the port's CUDA kernels (`csrc/*.cu`) with nvcc and ctypes.

On first use, nvcc compiles every source in `csrc/` for `sm_90a`, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under `build/` at the repository
root (listed in .gitignore), named by a hash of the sources, headers and
flags so an edited file never loads a stale library.  It is loaded with ctypes:
pointers and the CUDA stream pass as `c_void_p`, and each entry point
returns `cudaGetLastError()` after its launches, which `check` turns into an
exception.  A plain C interface builds in seconds; a source that includes
PyTorch's headers (torch.utils.cpp_extension) takes minutes.

Importing this module builds nothing: the tests on a machine without nvcc
import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import json
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
# Launch geometry that a kernel and its wrapper's host-side plan must agree
# on, kept here only: nvcc gets each entry as -DTTS_<NAME>=<value>, and
# ops/qmatmul.py and ops/attention.py read it from this dict.
GEOMETRY = {
    "GEMV_WARPS": 8,          # the GEMVs: warps per CTA, each streaming its own blocks
    "GEMV_TILE_N": 256,       # the GEMVs: weight columns per CTA (two warps' worth)
    "GEMV_RING": 2,           # the GEMVs: 32-row blocks in flight per warp (cp.async)
    "GEMV_CTAS_PER_SM": 2,    # the GEMVs: CTAs resident per SM (shared memory)
    "GEMV_MAX_X": 8192,       # the GEMVs: x elements one CTA stages (bf16), at most
    "GEMV_MAX_CLUSTER": 8,    # the GEMVs: K splits, one CTA each of a cluster, at most
    "G4_STAGES": 4,           # qgemm_int4: cp.async ring depth (packed blocks)
    "G4_CTAS_PER_SM_8": 3,    # qgemm_int4: CTAs resident per SM, 8-token tile
    "G4_CTAS_PER_SM": 2,      # qgemm_int4: the same, 16- to 64-token tiles
    "G4_WIDE_TOKENS": 16,     # qgemm_int4: M tiles up to this also run 256 columns wide
    "FD_CHUNK": 64,           # flash_decode: cache positions per CTA
    "FD_MAX_G": 4,            # flash_decode: query heads per KV head, at most
    "FD_MAX_S": 32768,        # flash_decode: cache positions, at most
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *(f"-DTTS_{k}={v}" for k, v in GEOMETRY.items()))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types, in the order of csrc/*.cu's extern "C" API
SIGNATURES = {
    # x, x_f32, wq, scales, out, K, N, splits, per, stream
    "qgemv_int8": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # x_f32, wq, scales, out, M, K, N, stream
    "qgemm_int8": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, x_f32, wq4, scales, out, K, N, splits, per, stream
    "qgemv_int4": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # x_f32, wq4, scales, partial, out, M, K, N, m_tile, tile_n, splits,
    # blocks_per_split, stream
    "qgemm_int4": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, k_scale, v_scale, pos, counters, part_m, part_l, part_acc,
    # out, Hq, Hkv, S, kv_int8, scale, stream
    "flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _F, _P),
}

# device_activity: sessions run at most, host seconds between a session's
# edges and fn, and the host calls that put work on the device
_SESSIONS = 5
_SESSION_MARGIN_S = 0.005
_DEVICE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                 "cuMemset")

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
    for s in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"libtts_tpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        build_info.update(seconds=0.0, path=path, log="(cached)")
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(s)} ({p.returncode}):\n{log}")
    link = subprocess.run([_nvcc(), "-shared", "-o", f"{tmp}.tmp", *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for o in objs:
        os.remove(o)
    os.replace(f"{tmp}.tmp", path)   # atomic: concurrent builders never see half a file
    build_info.update(seconds=time.perf_counter() - t0, path=path, log="".join(logs))
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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device `device_index`."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_activity(fn) -> list[dict]:
    """What one call of fn runs on the card, in launch order, from
    torch.profiler's CUDA activity: {"name", "grid"} per kernel, copy or
    memset, "grid" the launch's [x, y, z] (None for copies and memsets).

    On the card, sessions lost nearly every device record (keeping the
    host's launch calls) when fn's inputs had just come from pageable host
    memory and fn's first launch fell inside a session, and lost none when
    fn had run once before profiling; the cause was not established.  So
    fn runs once unprofiled first, and a session counts only when it lists
    exactly as many device records as fn made launch, copy and memset
    calls (up to _SESSIONS are run).  fn runs _SESSION_MARGIN_S inside each
    session's window, as the device's timestamps drift from the host's by
    up to about a millisecond."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    acts = []
    for _ in range(_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(_SESSION_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(_SESSION_MARGIN_S)
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"trace_{os.getpid()}_{threading.get_ident()}.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        acts = sorted((e for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                      key=lambda e: e["ts"])
        calls = sum(e.get("cat") == "cuda_runtime" and e["name"].startswith(_DEVICE_CALLS)
                    for e in events)
        if acts and len(acts) == calls:
            break
    return [{"name": e["name"],
             "grid": e.get("args", {}).get("grid") if e["cat"] == "kernel" else None}
            for e in acts]
