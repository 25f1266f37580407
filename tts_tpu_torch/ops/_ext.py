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
    "GEMV_SMALL_MAX_THREADS": 512,   # the GEMVs' small-call instance: threads per CTA, at most
    "G8_STAGES": 6,           # qgemm_int8: cp.async ring depth (32-row blocks)
    "G8_CTAS_PER_SM_8": 3,    # qgemm_int8: CTAs resident per SM, 8-token tile
    "G8_CTAS_PER_SM": 2,      # qgemm_int8: the same, 16- to 64-token tiles
    "G8_WIDE_TOKENS": 16,     # qgemm_int8: M tiles up to this also run 256 columns wide
    "G4_STAGES": 4,           # qgemm_int4: cp.async ring depth (packed blocks)
    "G4_CTAS_PER_SM_8": 3,    # qgemm_int4: CTAs resident per SM, 8-token tile
    "G4_CTAS_PER_SM": 2,      # qgemm_int4: the same, 16- to 64-token tiles
    "G4_WIDE_TOKENS": 16,     # qgemm_int4: M tiles up to this also run 256 columns wide
    "FD_CHUNK": 64,           # flash_decode: cache positions per CTA
    "FD_MAX_G": 4,            # flash_decode: query heads per KV head, at most
    "FD_MAX_S": 32768,        # flash_decode: cache positions, at most
    "PA_CHUNK": 64,           # prefix_attention: cache positions per CTA
    "PA_MAX_S": 32768,        # prefix_attention: cache positions, at most
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *(f"-DTTS_{k}={v}" for k, v in GEOMETRY.items()))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types, in the order of csrc/*.cu's extern "C" API
SIGNATURES = {
    # x, x_f32, wq, scales, out, K, N, tile_n, splits, per, rows, stream
    "qgemv_int8": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, x_f32, wq, scales, partial, out, M, K, N, m_tile, tile_n, splits,
    # per, stream
    "qgemm_int8": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, x_f32, wq4, scales, out, K, N, tile_n, splits, per, rows, stream
    "qgemv_int4": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the same with wq4
    "qgemm_int4": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, k_scale, v_scale, pos, counters, part_m, part_l, part_acc,
    # out, Hq, Hkv, S, kv_int8, scale, stream
    "flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _F, _P),
    # q, k, v, pos, counters, part_m, part_l, part_acc, out, nkv, S,
    # head_size, group, head_major, elem_bytes, scale, stream
    "prefix_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _F, _P),
}

# device_activity: the graph node types it reports (cuda.h CUgraphNodeType),
# by name
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


class _KernelNodeParams(ctypes.Structure):
    """cuda.h CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p),
                *((f"{d}Dim{a}", ctypes.c_uint) for d in ("grid", "block") for a in "XYZ"),
                ("sharedMemBytes", ctypes.c_uint), ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

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


@functools.lru_cache(maxsize=None)
def _libcuda():
    """libcuda, with the graph-inspection entry points typed."""
    cu = ctypes.CDLL("libcuda.so.1")
    size_p = ctypes.POINTER(ctypes.c_size_t)
    for name, argtypes in (
            ("cuGraphGetNodes", (_P, _P, size_p)),
            ("cuGraphNodeGetDependencies", (_P, _P, size_p)),
            ("cuGraphNodeGetType", (_P, ctypes.POINTER(ctypes.c_int))),
            ("cuGraphKernelNodeGetParams_v2", (_P, ctypes.POINTER(_KernelNodeParams))),
            ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), _P)),
            ("cuKernelGetName", (ctypes.POINTER(ctypes.c_char_p), _P))):
        fn = getattr(cu, name, None)     # cuKernelGetName: libcuda of CUDA 12.3 on
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return cu


def _cu(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: libcuda error {err}")


def _graph_nodes(cu, getter, owner) -> list[int]:
    """The nodes a cuGraphGetNodes-like getter lists for `owner`."""
    n = ctypes.c_size_t(0)
    _cu(getter(owner, None, ctypes.byref(n)), getter.__name__)
    if n.value == 0:                  # libcuda refuses an empty array
        return []
    nodes = (ctypes.c_void_p * n.value)()
    _cu(getter(owner, nodes, ctypes.byref(n)), getter.__name__)
    return [nodes[i] for i in range(n.value)]


def device_activity(fn) -> list[dict]:
    """What one call of fn puts on the card, in launch order: {"name",
    "grid"} per kernel, copy or memset, "grid" the kernel's launch grid
    [x, y, z] (None for copies and memsets), "name" the kernel's (mangled)
    function name or "memcpy" / "memset".

    Read from a CUDA graph captured around one call, through libcuda: the
    graph's nodes in dependency order, each kernel node's grid, and its
    function's name.  fn runs once uncaptured first (that loads the kernel
    library and sets kernel attributes), and the captured call never runs.
    A capture records every launch, where torch.profiler on the card lost
    device records."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    cu = _libcuda()
    nodes = _graph_nodes(cu, cu.cuGraphGetNodes, graph.raw_cuda_graph())
    depth: dict[int, int] = {}

    def node_depth(node) -> int:      # one stream's launches form a chain
        if node not in depth:
            deps = _graph_nodes(cu, cu.cuGraphNodeGetDependencies, node)
            depth[node] = 1 + max((node_depth(d) for d in deps), default=-1)
        return depth[node]

    acts = []
    for node in sorted(nodes, key=lambda nd: (node_depth(nd), nodes.index(nd))):
        code = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(code)), "cuGraphNodeGetType")
        kind = _NODE_TYPES.get(code.value)
        if kind != "kernel":
            if kind is not None:
                acts.append({"name": kind, "grid": None})
            continue
        p = _KernelNodeParams()
        _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _cu(cu.cuFuncGetName(ctypes.byref(name), p.func), "cuFuncGetName")
        else:                         # a node may name its kernel by a CUkernel handle only
            _cu(cu.cuKernelGetName(ctypes.byref(name), p.kern), "cuKernelGetName")
        acts.append({"name": name.value.decode(),
                     "grid": [p.gridDimX, p.gridDimY, p.gridDimZ]})
    return acts
