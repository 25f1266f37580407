#!/usr/bin/env python3
"""Smoke test of tts_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that its
server answers requests from full-width Orpheus-3B models with Q8_0 and with
Q4_0 linears.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):
  1. environment: versions, the card's name and power limit; no card -> exit 1
  2. build: nvcc of tts_tpu_torch/csrc into build/, with ptxas register/spill lines
  3. kernels against their plain PyTorch versions at the Orpheus-3B shapes
     (the GEMMs at every linear's (K, N) and at M = 8, 32 and the prompt
     lengths of phase 5; flash-decode at the edges of its chunks), with
     device times (CUDA graphs replayed plain, kernel, [library, library,]
     kernel, plain), achieved GB/s, and each call's bound: the larger of its
     bytes over 3.35 TB/s and its operations over 989 TFLOP/s.  Every
     product runs on bf16 x, as the layers pass it; the lm_head GEMVs also
     on f32 x, as the head passes it, and the GEMMs on f32 x at one shape.
     The library call, where one computes the same function:
     scaled_dot_product_attention for bf16 flash-decode,
     torch._weight_int4pack_mm for the int4 products.  The GEMVs and GEMMs
     show their CTAs and K splits as a CUDA graph captured around one call
     records the launch (held to the plan: a GEMM at least one CTA per SM
     on the path, a split GEMV at most one), their device kernels per call
     (a GEMV exactly one; a GEMM one, plus the split-K pass where K
     splits: no cast), and give identical bits twice; flash_decode must
     be one device kernel per call
  4. model: tiny Q8_0 and Q4_0 models' CUDA forwards checked against the
     port's CPU (plain) forwards, then seeded random full-width Orpheus-3B
     GGUFs (28 layers, F16 embedding, full-width SNAC), Q8_0 and Q4_0,
     written under smoke_models/
  5. server: the port's server on cuda answers 3 /v1/audio/speech requests
     (2 sampled, 1 greedy) from the Q8_0 model, then 3 from the Q4_0 model;
     the launch counts of each run show which kernels served it
The line before the last is a JSON object of per-kernel results; the last is
{"ok": true, "device": {...}}.  It imports only tts_tpu_torch, and fails if
jax or any module of the JAX package tts_tpu was imported.
"""

from __future__ import annotations

import gc
import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(ROOT, "smoke_models")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = 989e12                # H100 SXM dense bf16/fp16 tensor cores, data sheet
L2_ROTATE_BYTES = 128 << 20        # > 2x the 50 MB L2: weights come from HBM
# Orpheus-3B (tts_tpu/models/orpheus.py OrpheusConfig defaults)
LAYERS, HIDDEN, HQ, HKV, HS, FFN, VOCAB = 28, 3072, 24, 8, 128, 8192, 156940
S_CACHE = 3584                     # (1024 + 2100) padded to the 512 chunk
# (K, N) of every quantized linear; prefill runs all but lm_head at M = the
# prompt length, and lm_head on the last row only (M = 1)
LINEAR_SHAPES = {"qkv": (3072, 5120), "o": (3072, 3072), "gateup": (3072, 16384),
                 "down": (8192, 3072), "lm_head": (3072, 157696)}
GEMM_M = (8, 32)                   # beside the prompt lengths of phase 5's requests
GEMM_F32_SHAPE = "down"            # the GEMMs' f32-x rows (the prefill passes bf16 x)
LINEARS_PER_LAYER = 4              # fused qkv, o, fused gateup, down
GEMV_TOL = GEMM_TOL = 1e-4         # same f32 sums in another order
# torch._weight_int4pack_mm, the int4 yardstick, rounds x, the scales and its
# output to bf16 (2^-9 each)
INT4_LIBRARY_TOL = 1e-2
FLASH_TOL = 4e-3                   # bf16(p) against chunk vs running max: <= 2^-9
# flash-decode positions: one live slot, the edges of the kernel's 64-position
# chunks and of the plain version's 512, and the full cache
FLASH_POSITIONS = (0, 63, 64, 511, 512, 2047, 3583)
TINY_TOL = 1e-2                    # tiny model logits, CUDA vs CPU (see phase 4)
TINY = dict(n_layers=2, hidden=256, heads=4, kv_heads=2, head_dim=128, ffn=512, vocab=VOCAB,
            snac_embd=96, snac_channels=(48, 24, 12, 6))
QTYPES = ("Q8_0", "Q4_0")
# per path: the kernels it must launch, and those it must not
PATH_KERNELS = {"Q8_0": ("qgemv_int8", "qgemm_int8"), "Q4_0": ("qgemv_int4", "qgemm_int4")}
# phase 5's requests to each model: (kind, /v1/audio/speech payload)
REQUESTS = (
    ("sampled", {"input": "Hello from the port, this is a first test.", "voice": "zoe",
                 "max_tokens": 280, "seed": 1}),
    ("sampled", {"input": "A second sampled request, with the server's sampling.",
                 "voice": "leo", "max_tokens": 280, "seed": 2}),
    ("greedy", {"input": "And a greedy one to finish.", "max_tokens": 280, "sample": False}),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    print(f"\n=== {name} ===", flush=True)


# ---------------------------------------------------------------- timing ---
def _graph(fn, iters: int):
    """A CUDA graph of `iters` calls fn(0..iters-1): replaying it times the
    device work alone, without the host's per-launch cost in between."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                               # warm call outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i)
    return g


def _replay_ms(g, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(fns: dict, iters: dict) -> dict:
    """Device ms per call of each fn, each captured in a CUDA graph of
    iters[name] calls and replayed in the order given, then in reverse
    (plain, kernel, kernel, plain); each time is the mean of its two replays."""
    graphs = {name: _graph(fn, iters[name]) for name, fn in fns.items()}
    order = list(fns) + list(fns)[::-1]
    ms = {name: 0.0 for name in fns}
    for name in order:
        ms[name] += _replay_ms(graphs[name], iters[name]) / 2
    return ms


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak rate, whichever is larger (ms, which)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


# ---------------------------------------------------------------- phases ---
def environment():
    phase("1 environment")
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test needs one card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card


def build():
    phase("2 build")
    from tts_tpu_torch.ops import _ext

    _ext.load()
    info = _ext.build_info
    print(f"nvcc: {info['seconds']:.2f} s -> {os.path.relpath(info['path'], ROOT)}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line:
            print("  " + line.split("'")[1][:110])
        elif "registers" in line or "spill" in line:
            print("    " + line.strip())


def prompt_lengths() -> list[int]:
    """The prefill M of each of phase 5's requests: the runner's prompt
    (voice prefix, special tokens) under the random models' tokenizer."""
    from tts_tpu_torch.convert.builder_orpheus import ORPHEUS_3B, orpheus_kv
    from tts_tpu_torch.models.orpheus import APPENDED_TOKENS, PREPENDED_TOKENS
    from tts_tpu_torch.text.tokenizers import BPETokenizer

    kv = orpheus_kv(**{k: ORPHEUS_3B[k] for k in ("n_layers", "hidden", "heads", "kv_heads",
                                                  "head_dim", "vocab")})
    tok = BPETokenizer.from_gguf_kv(kv)
    lengths = []
    for _, payload in REQUESTS:
        voice = payload.get("voice", "")
        text = f"{voice}: {payload['input']}" if voice else payload["input"]
        lengths.append(len(PREPENDED_TOKENS) + len(tok.tokenize(text)) + len(APPENDED_TOKENS))
    return lengths


def int4_library_weight(wq4, scales):
    """The port's int4 layout as torch._weight_int4pack_mm takes it (a
    yardstick only; the port never calls it): u = q + 8 in 0..15, [N, K]
    with even k in the high nibble, tiled by _convert_weight_to_int4pack,
    and per group of 32 a bf16 scale d with zero 0: it computes (u - 8) * d."""
    import torch

    p = wq4.to(torch.int16)
    q = torch.cat([((p & 0xF) ^ 8) - 8, p >> 4]) + 8          # [K, N] in 0..15
    w = q.t().to(torch.uint8)
    w = (w[:, ::2] << 4 | w[:, 1::2]).contiguous()
    sz = torch.stack([scales.bfloat16(), torch.zeros_like(scales, dtype=torch.bfloat16)], -1)
    return torch._convert_weight_to_int4pack(w, 8), sz.contiguous()


def rotating_weights(K, N, device, seed, int4: bool):
    """Enough copies of a random quantized [K, N] weight (int8 [K, N], or
    packed int4 [K/2, N]) with f16 scales that cycling through them exceeds
    the L2 cache, as the decode step's gigabytes of weights do."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    rows = K // 2 if int4 else K
    copies = max(1, math.ceil(L2_ROTATE_BYTES / (rows * N)))
    return [(torch.randint(-128, 128, (rows, N), generator=g, device=device, dtype=torch.int8),
             (torch.rand((K // 32, N), generator=g, device=device) * 2e-3 + 1e-4).half())
            for _ in range(copies)]


def kernels():
    phase("3 kernels against plain")
    import torch

    from tts_tpu_torch.ops import _ext
    from tts_tpu_torch.ops import attention as ta
    from tts_tpu_torch.ops import qmatmul as tq

    dev = torch.device("cuda")
    sms = _ext.sm_count(0)
    print(f"{sms} SMs")
    results = []

    def record(name, source, replaces, rows):
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        lib = [r["library_ms"] for r in rows if r["library_ms"] is not None]
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": max(r["abs"] for r in rows),
                        "max_rel_err": max(r["rel"] for r in rows),
                        "ms": sum(r["ms"] for r in rows),
                        "plain_ms": sum(r["plain_ms"] for r in rows),
                        "bound_ms": sum(r["bound_ms"] for r in rows),
                        "bound_by": ("bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in rows)
                                     else "operations"),
                        # one PyTorch call computing the same function, where
                        # there is one (summed over the rows it covers)
                        "library_ms": sum(lib) if lib else None,
                        "rows": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms", "library_rel",
                                                    "rel", "ctas", "splits", "device_kernels")
                                           if k in r}
                                 for r in rows]})

    def row(shape, a, r, ms, plain_ms, nbytes, flops, library_ms=None, library_rel=None,
            **launch):
        b_ms, by = bound(nbytes, flops)
        return {"shape": shape, "abs": a, "rel": r, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms,
                "library_rel": library_rel, **launch}

    def int4_library(fns, x, ws, want, label):
        """Add torch._weight_int4pack_mm on the same weights to `fns`, after
        checking that it computes the same product (bf16 x, scales, out);
        returns its rel err against the plain version."""
        lib_ws = [int4_library_weight(*w) for w in ws]
        xb = x.bfloat16()                   # the GEMV rows' x already is bf16

        def library(j):
            w, sz = lib_ws[j % len(lib_ws)]
            return torch._weight_int4pack_mm(xb, w, 32, sz)

        fns["library"] = library
        _, lr = rel_err(fns["library"](0), want)
        check(lr < INT4_LIBRARY_TOL, f"_weight_int4pack_mm {label}: rel err {lr} >= "
              f"{INT4_LIBRARY_TOL}: the yardstick does not compute the same product")
        return lr

    def launch_grid(name, kernel, label, call, want_grid, want_kernels):
        """The grid of `kernel` (its device name) as a CUDA graph captured
        around one call records the launch, held to the plan; the call's
        device kernels counted; identical bits twice."""
        acts = _ext.device_activity(call)
        grids = [a["grid"] for a in acts if kernel in a["name"]]
        check(len(grids) == 1 and grids[0] is not None, f"{name} {label}: the capture saw {acts}")
        check(grids[0] == want_grid, f"{name} {label}: launched grid {grids[0]}, planned "
              f"{want_grid}")
        check(len(acts) == want_kernels, f"{name} {label}: {len(acts)} device kernels per call "
              f"({[a['name'] for a in acts]}), not {want_kernels}")
        check(torch.equal(call(), call()), f"{name} {label}: two calls differ")
        return {"ctas": math.prod(grids[0]), "device_kernels": len(acts)}

    # M = 1: decode steps (bf16 x, as the layers pass it) and the lm_head
    # (also f32 x, as _head_logits passes it); M > 1: the rest of prefill
    # (bf16 x, as the layers pass it; f32 x at one shape, which runs the
    # kernels' hi + lo products)
    gemm_ms = sorted(set(GEMM_M) | set(prompt_lengths()))
    for bits, fn, plain, tpu_line, ms_list, iters in (
            (8, tq.qgemv_int8, tq.qgemv_int8_plain, "tts_tpu/ops/qmatmul.py:144", (1,), 20),
            (4, tq.qgemv_int4, tq.qgemv_int4_plain, "tts_tpu/ops/qmatmul.py:367", (1,), 20),
            (8, tq.qgemm_int8, tq.qgemm_int8_plain, "tts_tpu/ops/qmatmul.py:134", gemm_ms, 10),
            (4, tq.qgemm_int4, tq.qgemm_int4_plain, "tts_tpu/ops/qmatmul.py:350", gemm_ms, 10)):
        rows = []
        gemv = ms_list == (1,)
        tol = GEMV_TOL if gemv else GEMM_TOL
        for i, (name, (K, N)) in enumerate(LINEAR_SHAPES.items()):
            ws = rotating_weights(K, N, dev, 100 * (not gemv) + i + bits, int4=bits == 4)
            runs = [(M, torch.bfloat16) for M in ms_list] + [
                (M, torch.float32) for M in ms_list if name == (
                    "lm_head" if gemv else GEMM_F32_SHAPE)]
            for M, xdtype in runs:
                x = torch.randn((M, K), device=dev).to(xdtype)
                label = f"{name} M={M} x={str(xdtype)[6:]}"
                want = plain(x, *ws[0])
                a, r = rel_err(fn(x, *ws[0]), want)
                fns = {"plain": lambda j: plain(x, *ws[j % len(ws)]),
                       "kernel": lambda j: fn(x, *ws[j % len(ws)])}
                lr = int4_library(fns, x, ws, want, label) if bits == 4 else None
                launch = {}
                if gemv:
                    # one device kernel per call (no cast, no split-K pass),
                    # its grid (splits, column tiles) as planned: where the
                    # column tiles leave SMs free, one wave of at most one
                    # CTA per SM
                    tile_n, splits, _ = tq.gemv_plan(K, N, sms, bits == 4)
                    tiles = -(-N // tile_n)
                    launch = launch_grid(fn.__name__, "qgemv_kernel", label,
                                         lambda: fn(x, *ws[0]), [splits, tiles, 1], 1)
                    launch["splits"] = splits
                    check(tiles >= sms or launch["ctas"] <= sms, f"{fn.__name__} {label}: "
                          f"{launch['ctas']} CTAs in {splits} splits > {sms} SMs")
                else:
                    # the shared GEMM's grid (column tiles, M tiles, K
                    # splits), then the split-K pass when K splits, and no
                    # other device kernel (no cast of x)
                    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, sms, bits == 4)
                    launch = launch_grid(fn.__name__, "qgemm_kernel", label,
                                         lambda: fn(x, *ws[0]),
                                         [-(-N // tile_n), -(-M // m_tile), splits],
                                         1 + (splits > 1))
                    launch["splits"] = splits
                    check(name == "lm_head" or launch["ctas"] >= sms,
                          f"{fn.__name__} {label}: {launch['ctas']} CTAs < {sms} SMs")
                t = timed(fns, {"plain": 3, "kernel": iters, "library": iters})
                wbytes = K * N * bits // 8 + K // 32 * N * 2
                rows.append(row(f"{label} K={K} N={N}", a, r, t["kernel"], t["plain"],
                                wbytes + M * K * x.element_size() + M * N * 4, 2 * M * K * N,
                                t.get("library"), lr, **launch))
                tflops = 2 * M * K * N / (t["kernel"] * 1e-3) / 1e12
                gbs = wbytes / (t["kernel"] * 1e-3) / 1e9
                lib = f"  library {t['library'] * 1e3:8.1f} us" if "library" in t else ""
                lib_note = f"  (library rel_err {lr:.1e})" if lr is not None else ""
                grid = (f"  {launch['ctas']} CTAs ({launch['splits']} splits, "
                        f"{launch['device_kernels']} device kernels)" if launch else "")
                print(f"{fn.__name__} {label:22s} K={K:5d} N={N:6d}  rel_err {r:.2e} "
                      f"(tol {tol:.0e})  kernel {t['kernel'] * 1e3:8.1f} us  plain "
                      f"{t['plain'] * 1e3:9.1f} us{lib}  bound "
                      f"{rows[-1]['bound_ms'] * 1e3:6.1f} us  {tflops:5.2f} TFLOP/s  "
                      f"{gbs:7.1f} GB/s = {gbs * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s"
                      f"{grid}{lib_note}")
                check(r < tol, f"{fn.__name__} {label}: rel err {r} >= {tol}")
            del ws
        record(fn.__name__, f"tts_tpu_torch/csrc/qmatmul{'4' if bits == 4 else ''}.cu",
               tpu_line, rows)

    rows = []
    g = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for quant in (False, True):
        if quant:
            k = torch.randint(-127, 128, (HKV, S_CACHE, HS), generator=g, device=dev,
                              dtype=torch.int8)
            v = torch.randint(-127, 128, (HKV, S_CACHE, HS), generator=g, device=dev,
                              dtype=torch.int8)
            ks = torch.rand((HKV, S_CACHE), generator=g, device=dev) * 0.02 + 1e-3
            vs = torch.rand((HKV, S_CACHE), generator=g, device=dev) * 0.02 + 1e-3
        else:
            k = torch.randn((HKV, S_CACHE, HS), generator=g, device=dev).bfloat16()
            v = torch.randn((HKV, S_CACHE, HS), generator=g, device=dev).bfloat16()
            ks = vs = None
        q = torch.randn((HQ, HS), generator=g, device=dev)
        counters = ta.arrival_counters(HKV, dev)
        kind = "int8" if quant else "bf16"
        for pos in FLASH_POSITIONS:
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
            a, r = rel_err(ta.flash_decode(q, k, v, pos_t, ks, vs, counters), want)
            names = [e["name"] for e in _ext.device_activity(
                lambda: ta.flash_decode(q, k, v, pos_t, ks, vs, counters))]
            check(len(names) == 1, f"flash_decode {pos}: {len(names)} device kernels per call "
                  f"({names}), not 1")
            fns = {"plain": lambda j: ta.flash_decode_plain(q, k, v, pos, ks, vs),
                   "kernel": lambda j: ta.flash_decode(q, k, v, pos_t, ks, vs, counters)}
            lr = None
            if not quant:
                # the yardstick: one PyTorch call on the live prefix, bf16 q
                qb, kl, vl = q.bfloat16()[None, :, None], k[None, :, :pos + 1], v[None, :, :pos + 1]
                fns["library"] = lambda j: sdpa(qb, kl, vl, enable_gqa=True)
                _, lr = rel_err(fns["library"](0).reshape(HQ, HS), want)
            t = timed(fns, {"plain": 3, "kernel": 20, "library": 20})
            live = (pos + 1) * HKV
            nbytes = 2 * HQ * HS * 4 + live * (2 * HS * k.element_size() + (8 if quant else 0))
            rows.append(row(f"{kind} Hq={HQ} Hkv={HKV} S={S_CACHE} pos={pos}", a, r,
                            t["kernel"], t["plain"], nbytes, 4 * HQ * (pos + 1) * HS,
                            t.get("library"), lr, device_kernels=len(names)))
            gbs = nbytes / (t["kernel"] * 1e-3) / 1e9
            lib = f"  library {t['library'] * 1e3:7.1f} us" if "library" in t else ""
            lib_note = f"  (library rel_err {lr:.1e})" if lr is not None else ""
            print(f"flash_decode {kind} pos={pos:4d}  rel_err {r:.2e} (tol {FLASH_TOL:.0e})  "
                  f"kernel {t['kernel'] * 1e3:7.1f} us  plain {t['plain'] * 1e3:8.1f} us{lib}  "
                  f"bound {rows[-1]['bound_ms'] * 1e3:5.2f} us  {gbs:7.1f} GB/s  "
                  f"{len(names)} device kernel per call{lib_note}")
            check(r < FLASH_TOL, f"flash_decode {kind} pos={pos}: rel err {r} >= {FLASH_TOL}")
    record("flash_decode", "tts_tpu_torch/csrc/attention.cu", "tts_tpu/ops/attention.py:30",
           rows)
    torch.cuda.synchronize()
    return results


def tiny_cuda_vs_cpu(qtype: str):
    """A 2-layer hs=128 model: prefill and 8 teacher-forced decode logits on
    cuda (kernels) against the CPU (plain versions, which the CPU tests hold
    to the JAX package).  bf16 activations round differently when an f32 sum
    differs in its last bit (port vs JAX on the CPU: ~4e-3 of max|logit|),
    so the bound is 1e-2 of max|logit|."""
    import torch

    from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus
    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.models.registry import runner_from_file

    path = write_random_orpheus(os.path.join(MODEL_DIR, f"tiny_{qtype.lower()}_seed0.gguf"),
                                seed=0, qtype=qtype, **TINY)
    ids = torch.tensor([128259, 128000, 72, 105, 128009, 128260, 128261, 128257])
    forced = [128300 + 97 * i for i in range(8)]
    logits = {}
    for dev in ("cuda", "cpu"):
        r = runner_from_file(path, device=dev)
        key = "wq4" if qtype == "Q4_0" else "wq"
        check(key in r.params["head"], f"tiny {qtype}: head not packed as {key}")
        cache = tor.init_kv_cache(r.cfg, dev)
        with torch.inference_mode():
            out = [tor.orpheus_prefill(r.params, r.cfg, ids.to(dev), cache)]
            for i, t in enumerate(forced):
                out.append(tor.orpheus_decode_step(
                    r.params, r.cfg, torch.tensor([t], device=dev),
                    torch.tensor([len(ids) + i], dtype=torch.int32, device=dev), cache))
        logits[dev] = torch.stack(out).float().cpu()
    a, r = rel_err(logits["cuda"], logits["cpu"])
    same = (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).sum().item()
    print(f"tiny {qtype} model cuda vs cpu: 9 logit rows, max abs diff {a:.3e}, rel {r:.2e} "
          f"(tol {TINY_TOL:.0e}), argmax agrees on {same}/9")
    check(bool(torch.isfinite(logits["cuda"]).all()), f"tiny {qtype}: non-finite logits on cuda")
    check(r < TINY_TOL, f"tiny {qtype}: cuda vs cpu logits rel diff {r} >= {TINY_TOL}")


def model() -> dict:
    phase("4 model")
    os.makedirs(MODEL_DIR, exist_ok=True)
    for qtype in QTYPES:
        tiny_cuda_vs_cpu(qtype)
    from tts_tpu_torch.convert.builder_orpheus import ORPHEUS_3B, write_random_orpheus

    paths = {}
    for qtype in QTYPES:
        path = os.path.join(MODEL_DIR, f"orpheus3b_{qtype[:2].lower()}_seed0.gguf")
        t0 = time.perf_counter()
        write_random_orpheus(path, seed=0, qtype=qtype, **ORPHEUS_3B)
        print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path) / 1e9:.2f} GB "
              f"in {time.perf_counter() - t0:.1f} s (host)")
        paths[qtype] = path
    return paths


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/audio/speech",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def launch_counters() -> dict:
    from tts_tpu_torch.ops import attention as ta
    from tts_tpu_torch.ops import qmatmul as tq

    return {k.__name__: k for k in (tq.qgemv_int8, tq.qgemm_int8, tq.qgemv_int4,
                                    tq.qgemm_int4, ta.flash_decode)}


def server(path: str, qtype: str) -> dict:
    """Serve 3 requests from one full-width model; returns the launch counts
    of that run, every counter set to 0 just before it."""
    phase(f"5 server, Orpheus-3B {qtype}")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.runtime.api import GenerationConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = 2**30
    print(f"before load: memory_allocated {torch.cuda.memory_allocated() / gib:.2f} GiB")
    name = f"orpheus3b_{qtype}"
    state = ServerState({name: path}, GenerationConfig(top_k=50), 1, device="cuda")
    t0 = time.perf_counter()
    runner, _ = state._get_runner(name)
    print(f"model load: {time.perf_counter() - t0:.1f} s  "
          + "  ".join(f"{k} {v:.1f}" for k, v in runner.load_timings.items()))
    print(f"after load: memory_allocated {torch.cuda.memory_allocated() / gib:.2f} GiB, "
          f"max_memory_allocated during load {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    responses = []
    generate = runner.generate

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    try:
        for kind, payload in REQUESTS:
            t = time.perf_counter()
            status, body, ctype = _post(port, payload)
            wall = time.perf_counter() - t
            check(status == 200 and ctype == "audio/wav", f"{kind}: HTTP {status} {ctype}: "
                  f"{body[:200]!r}")
            resp = responses[-1]
            steps = resp.timings["decode_steps"]
            with wave.open(io.BytesIO(body)) as wf:
                n = wf.getnframes()
                check(wf.getframerate() == 24000, f"{kind}: rate {wf.getframerate()}")
            check(n > 0 and n == len(resp.audio), f"{kind}: wav {n} samples, audio "
                  f"{len(resp.audio)}")
            check(bool(np.isfinite(resp.audio).all()), f"{kind}: non-finite audio")
            check(float(np.abs(resp.audio).max()) > 0, f"{kind}: silent audio")
            check(n == (steps // 7) * 4 * 512, f"{kind}: {n} samples for {steps} tokens")
            check(resp.timings["prompt_tokens"] in prompt_lengths(),
                  f"{kind}: prefill M={resp.timings['prompt_tokens']} was not checked in phase 3")
            dec_s = resp.timings["decode_ms"] / 1e3
            print(f"{kind:7s} wall {wall * 1e3:8.1f} ms  prefill {resp.timings['prompt_tokens']}"
                  f" tok in {resp.timings['prefill_ms']:7.1f} ms  decode {steps} tok in {dec_s * 1e3:8.1f} ms = {steps / dec_s:6.1f} tok/s"
                  f"  codec {resp.timings['codec_ms']:6.1f} ms  audio {n / 24000:.3f} s  "
                  f"RTF {wall / (n / 24000):.3f}")
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    tokens = sum(r.timings["decode_steps"] for r in responses)
    steps = sum(r.timings["decode_steps"] - 1 for r in responses)
    print(f"launches over {len(responses)} requests ({tokens} tokens): {counts}")
    gemv, gemm = PATH_KERNELS[qtype]
    check(len(responses) == len(REQUESTS), f"{len(responses)} responses")
    check(counts[gemv] >= (LAYERS * LINEARS_PER_LAYER + 1) * steps,
          f"{gemv} launched {counts[gemv]} < (28 * 4 + 1) * {steps} decode steps")
    check(counts["flash_decode"] >= LAYERS * steps,
          f"flash_decode launched {counts['flash_decode']} < 28 * {steps} decode steps")
    check(counts[gemm] >= LAYERS * LINEARS_PER_LAYER * len(responses),
          f"{gemm} launched {counts[gemm]} < one prefill per request")
    for other in PATH_KERNELS.values():
        if other != (gemv, gemm):
            check(counts[other[0]] == counts[other[1]] == 0,
                  f"the {qtype} path launched {other}: {counts}")
    print(f"after the requests: memory_allocated {torch.cuda.memory_allocated() / gib:.2f} GiB"
          f" (the runner keeps its KV cache), max_memory_allocated during the requests "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    return counts


def main() -> int:
    card = environment()
    import torch

    build()
    results = kernels()
    paths = model()
    counts = {qtype: server(paths[qtype], qtype) for qtype in QTYPES}
    for r in results:
        path = next((q for q, ks in PATH_KERNELS.items() if r["name"] in ks), QTYPES[0])
        r["launches"] = counts[path][r["name"]]
        r["launches_by_path"] = {q: c[r["name"]] for q, c in counts.items()}
    blocked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tts_tpu"))
    check(not blocked, f"imported jax or the JAX package: {blocked[:5]}")
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
