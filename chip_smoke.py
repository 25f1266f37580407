#!/usr/bin/env python3
"""Smoke test of tts_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that its
server answers requests from full-width Orpheus-3B, Parler-TTS mini v1 and
Dia-1.6B models with Q8_0 and with Q4_0 linears, and from Kokoro-82M.

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
     Orpheus product runs on bf16 x, as its layers pass it; the lm_head
     GEMVs also on f32 x, as the head passes it, and the GEMMs on f32 x at
     one shape.  Then Parler-TTS mini v1's shapes on f32 x, as its layers
     pass it: the GEMVs at (K, N) = (1024, 1024), (1024, 4096), (4096,
     1024), the GEMMs there at M = 8 (the verify window), phase 7's prompt
     lengths and its encoding lengths (the cross-KV).  Then Dia-1.6B's
     GEMMs on f32 x: (K, N) = (2048, 2048), (2048, 512), (2048, 8192),
     (8192, 2048) at M = 2 (a CFG decode step) and 16 (an 8-row verify),
     and (1024, 2048) at M = 2048 (the cross-KV of the 1024-byte context).
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
     (2 sampled, 1 greedy: the speculative loop) and a greedy PCM stream
     (TTFA) from the Q8_0 model, then from the Q4_0 model; the launch
     counts of each run, exact against the forwards it ran, show which
     kernels served it; then the greedy bracket: speculative, force_miss
     and sequential tok/s after one prefill
  6. Kokoro-82M, which runs none of the five kernels: a tiny model's cuda
     run against its CPU run (f32, cuDNN TF32 off, the same noise; stage by
     stage, as the CPU tests hold port to JAX); then a
     seeded random full-width Kokoro-82M GGUF under smoke_models/, served
     through the port's server on cuda with torch's default math flags: the
     ten Harvard sentences (a warm pass, then a timed one: wall, RTF,
     frames, peak memory), one input past the 510-phoneme context (the
     chunked path), time to first audio through generate_stream and as
     the server's PCM stream, bf16
     against f32 on one sentence, and one torch.profiler pass of a warm
     request (device-busy share, top kernels); the five kernels' launch
     counts must stay 0 over the served requests
  7. Parler-TTS mini v1, which runs the four matmul kernels and not
     flash_decode: tiny Q8_0 and Q4_0 models' CUDA forwards (8 GEMV steps,
     one 8-row GEMM verify) and DAC against the CPU; then seeded random
     full-width Q8_0 and Q4_0 GGUFs and a flan-t5-large-width T5 GGUF
     under smoke_models/, each Parler served through the port's server
     with torch's default math flags: a sampled request, a greedy one (the
     speculative loop), a PCM stream (TTFA), a /v1/audio/conditional-prompt
     call and a sampled request on the new encoding, 256 rows each (wall,
     rows/s, RTF, load s, peak memory); the launch counts must show the
     int8 pair alone on Q8_0 and the int4 pair alone on Q4_0, 192 GEMVs per
     sequential row, flash_decode 0; then the greedy bracket: speculative,
     force_miss and sequential rows/s after one prefill, and where the rows
     part
  8. Dia-1.6B, which runs the format's GEMM alone (the CFG pair makes every
     decode step M = 2): tiny Q8_0 and Q4_0 models' CUDA forwards (8 steps,
     one 8-row verify at M = 16), cross-KV and DAC against the CPU; then
     seeded random full-width Q8_0 and Q4_0 GGUFs under smoke_models/, each
     served through the port's server with torch's default math flags: a
     sampled request, a greedy one (the speculative loop), a PCM stream
     (TTFA) and a second sampled request, 256 tokens each (wall, steps/s,
     RTF, load s, peak memory); the launch counts must be exact: the
     format's GEMM 36 per request (the cross-KV) plus 162 per step and per
     verify window, the GEMVs, flash_decode and the other GEMM 0; then the
     greedy bracket and one profiled request
The line before the last is a JSON object of per-kernel results (each
kernel's launches on its Orpheus path, and by path); the last is
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
# phase 6: Harvard sentences, list 1 (IEEE recommended practice, public
# domain; bench.py's battery)
HARVARD = (
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
)
# the random model's duration head: sigmoid(-2.6) * 50 ~ 3.5 frames per token
# (bench.py's calibration, ~11 characters of text per second of audio)
KOKORO_DURATION_BIAS = -2.6
# tiny Kokoro, cuda against cpu in f32 with TF32 off: the same f32 math in
# another order (the CPU tests hold port and JAX to 1e-3 of the peak at the
# decoder output, through a deep chain of instance norms)
KOKORO_TINY_TOL = 1e-3
# full width, bf16 frame-rate activations against f32 on the same noise and
# durations: bf16 keeps 8 bits through ~100 convolutions and norms
KOKORO_BF16_MIN_CORR = 0.95
# phase 7, Parler-TTS mini v1 (tts_tpu/models/parler.py ParlerConfig
# defaults): its linears' (K, N) (q/k/v/o and the cross-attention's at
# hidden 1024 with a 1024-wide encoding, fc1, fc2), 8 of them per layer
PARLER_SHAPES = {"attn": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
PARLER_LAYERS, PARLER_LINEARS = 24, 8
PARLER_MAX_TOKENS = 256            # rows per request: random heads never stop
PARLER_PROFILE_ROWS = 48           # rows of the sampled request profiled
PARLER_TEXTS = ("Hello from Parler on the card.", "A greedy request on the speculative path.",
                "And a streamed one, sent as it is made.")
# the voice description sent to /v1/audio/conditional-prompt (Parler-TTS's
# own example description)
PARLER_DESCRIPTION = ("A female speaker delivers a slightly expressive and animated speech "
                      "with a moderate speed and pitch. The recording is of very high quality.")
# the tiny model of phase 7's cuda-against-cpu check (tests/torch_tiny.py's
# widths), with a tiny DAC
PARLER_TINY = dict(n_layers=2, hidden=256, heads=4, ffn=512, prompt_vocab=64, enc_len=12,
                   enc_hidden=64, max_ctx=512, max_gen=64)
PARLER_TINY_DAC = dict(latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
DAC_TOL = 1e-4                     # DAC audio, cuda against cpu, f32 with TF32 off
# phase 8, Dia-1.6B (tts_tpu/models/dia.py DiaConfig defaults): its decoder
# linears' (K, N) (self q/o and cross q/o, self k/v, gate/up, wo), run at
# M = 2 and 16; the cross-KV's k/v at M = 2 x 1024
DIA_SHAPES = {"q/o": (2048, 2048), "k/v": (2048, 512), "gate/up": (2048, 8192),
              "wo": (8192, 2048)}
DIA_GEMM_M = (2, 16)
DIA_CROSS = ("cross k/v", 2048, 1024, 2048)     # (name, M, K, N)
DIA_LAYERS, DIA_LINEARS = 18, 9
DIA_MAX_TOKENS = 256               # per request: random heads never emit EOS
DIA_BRACKET_TOKENS = 128           # the greedy bracket's requests
DIA_PROFILE_TOKENS = 48
DIA_TEXTS = ("[S1] Hello from Dia on the card. [S2] Hi, glad to hear it.",
             "[S1] A greedy request on the speculative path.",
             "[S1] And a streamed one. [S2] Sent as it is made.",
             "[S2] A second sampled request, with another voice first.")
# the tiny model of phase 8's cuda-against-cpu check (tests/torch_tiny.py's
# widths: every decoder output a multiple of 256)
DIA_TINY = dict(enc_layers=2, dec_layers=2, enc_hidden=256, dec_hidden=256, enc_heads=4,
                dec_heads=4, query_heads=2, enc_ffn=512, ffn=512, enc_ctx=128, max_gen=64)
# cross K/V, cuda against cpu: both round to bf16, and an f32 value a last
# bit apart may round to the neighbouring bf16: one bf16 step of a value is
# at most 2^-7 of the largest magnitude
DIA_CROSS_TOL = 2.0 ** -7
ORPHEUS_BRACKET_TOKENS = 140       # phase 5's greedy bracket
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


def parler_gemm_lengths() -> list[int]:
    """The M of phase 7's Parler GEMMs: the verify window (8), each
    request's prompt (the random model's tokenizer, plus EOS), the GGUF's
    encoding and the T5 encoding of PARLER_DESCRIPTION (the cross-KV)."""
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, unigram_kv
    from tts_tpu_torch.text.tokenizers import UnigramTokenizer

    tok = UnigramTokenizer.from_gguf_kv(unigram_kv(PARLER_MINI_V1["prompt_vocab"]))
    return sorted({8, PARLER_MINI_V1["enc_len"], len(tok.tokenize(PARLER_DESCRIPTION)) + 1,
                   *(len(tok.tokenize(t)) + 1 for t in PARLER_TEXTS)})


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

    def measure(fn, plain, bits, label, K, N, M, x, ws, tol, iters, fill_sms):
        """One row: the kernel against plain on x and the rotated weights
        ws, its launch held to the plan, timed against plain (and, for
        int4, the library call).  fill_sms: the GEMM must launch at least
        one CTA per SM (the Orpheus prefill's shapes)."""
        gemv = M == 1
        want = plain(x, *ws[0])
        a, r = rel_err(fn(x, *ws[0]), want)
        fns = {"plain": lambda j: plain(x, *ws[j % len(ws)]),
               "kernel": lambda j: fn(x, *ws[j % len(ws)])}
        lr = int4_library(fns, x, ws, want, label) if bits == 4 else None
        if gemv:
            # one device kernel per call (no cast, no split-K pass), its
            # grid (splits, column tiles) as planned: where the column tiles
            # leave SMs free, one wave of at most one CTA per SM
            tile_n, splits, _ = tq.gemv_plan(K, N, sms, bits == 4)
            tiles = -(-N // tile_n)
            launch = launch_grid(fn.__name__, "qgemv_kernel", label, lambda: fn(x, *ws[0]),
                                 [splits, tiles, 1], 1)
            check(tiles >= sms or launch["ctas"] <= sms, f"{fn.__name__} {label}: "
                  f"{launch['ctas']} CTAs in {splits} splits > {sms} SMs")
        else:
            # the shared GEMM's grid (column tiles, M tiles, K splits), then
            # the split-K pass when K splits, and no other device kernel
            m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, sms, bits == 4)
            launch = launch_grid(fn.__name__, "qgemm_kernel", label, lambda: fn(x, *ws[0]),
                                 [-(-N // tile_n), -(-M // m_tile), splits], 1 + (splits > 1))
            check(not fill_sms or launch["ctas"] >= sms,
                  f"{fn.__name__} {label}: {launch['ctas']} CTAs < {sms} SMs")
        launch["splits"] = splits
        t = timed(fns, {"plain": 3, "kernel": iters, "library": iters})
        wbytes = K * N * bits // 8 + K // 32 * N * 2
        out = row(f"{label} K={K} N={N}", a, r, t["kernel"], t["plain"],
                  wbytes + M * K * x.element_size() + M * N * 4, 2 * M * K * N,
                  t.get("library"), lr, **launch)
        tflops = 2 * M * K * N / (t["kernel"] * 1e-3) / 1e12
        gbs = wbytes / (t["kernel"] * 1e-3) / 1e9
        lib = f"  library {t['library'] * 1e3:8.1f} us" if "library" in t else ""
        lib_note = f"  (library rel_err {lr:.1e})" if lr is not None else ""
        print(f"{fn.__name__} {label:29s} K={K:5d} N={N:6d}  rel_err {r:.2e} (tol {tol:.0e})  "
              f"kernel {t['kernel'] * 1e3:8.1f} us  plain {t['plain'] * 1e3:9.1f} us{lib}  bound "
              f"{out['bound_ms'] * 1e3:6.1f} us  {tflops:5.2f} TFLOP/s  "
              f"{gbs:7.1f} GB/s = {gbs * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s  "
              f"{launch['ctas']} CTAs ({splits} splits, {launch['device_kernels']} device "
              f"kernels){lib_note}")
        check(r < tol, f"{fn.__name__} {label}: rel err {r} >= {tol}")
        return out

    # M = 1: decode steps (bf16 x, as the Orpheus layers pass it) and the
    # lm_head (also f32 x, as _head_logits passes it); M > 1: the rest of
    # prefill (bf16 x; f32 x at one shape, which runs the kernels' hi + lo
    # products).  Then Parler-TTS mini v1's shapes, on f32 x as its layers
    # pass it: the GEMVs of a decode step, the GEMMs at the verify window,
    # phase 7's prompt lengths and encoding lengths; and Dia-1.6B's GEMMs
    # on f32 x: a CFG step (M = 2), a verify (16), the cross-KV (2048).
    gemm_ms = sorted(set(GEMM_M) | set(prompt_lengths()))
    parler_ms = parler_gemm_lengths()
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
                rows.append(measure(fn, plain, bits, f"{name} M={M} x={str(xdtype)[6:]}", K, N,
                                    M, x, ws, tol, iters, name != "lm_head"))
            del ws
        for i, (name, (K, N)) in enumerate(PARLER_SHAPES.items()):
            ws = rotating_weights(K, N, dev, 300 + 10 * (not gemv) + i + bits, int4=bits == 4)
            for M in ((1,) if gemv else parler_ms):
                x = torch.randn((M, K), device=dev)
                rows.append(measure(fn, plain, bits, f"parler {name} M={M} x=float32", K, N, M,
                                    x, ws, tol, iters, False))
            del ws
        if not gemv:
            dia = [(name, M, K, N) for name, (K, N) in DIA_SHAPES.items() for M in DIA_GEMM_M]
            for i, (name, M, K, N) in enumerate(dia + [DIA_CROSS]):
                ws = rotating_weights(K, N, dev, 500 + 10 * i + bits, int4=bits == 4)
                x = torch.randn((M, K), device=dev)
                rows.append(measure(fn, plain, bits, f"dia {name} M={M} x=float32", K, N, M, x,
                                    ws, tol, iters, False))
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


def _counting(module, name: str, kind):
    """Replace module.name by a wrapper that counts its calls in a Counter
    under kind(*args) (the forwards a served run made, against which its
    launch counts are checked); returns (counter, restore)."""
    import collections

    fn = getattr(module, name)
    calls: collections.Counter = collections.Counter()

    def wrapped(*args, **kw):
        calls[kind(*args, **kw)] += 1
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, fn)


def orpheus_bracket(runner, text: str) -> dict:
    """Greedy tok/s of one ORPHEUS_BRACKET_TOKENS request decoded three ways
    after the same prefill: the speculative loop, its force_miss floor
    (every draft rejected: one token per 8-token forward) and the
    sequential loop; the first token where each parts from the sequential
    tokens.  Launches made here are not counted for the path."""
    import torch

    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.runtime.api import GenerationConfig

    config = GenerationConfig(sample=False, seed=0, max_tokens=ORPHEUS_BRACKET_TOKENS)
    ids = runner._prompt_ids(text, config)
    toks, rates = {}, {}
    for mode in ("spec", "force_miss", "sequential"):
        with torch.inference_mode():
            _, first, _, state, max_steps = runner._prefill(ids, config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                got, _ = tor.orpheus_decode_loop(runner.params, runner.cfg, first, len(ids),
                                                 max_steps - 1, runner._cache, None, state,
                                                 do_sample=False)
            else:
                got = tor.orpheus_decode_loop_spec(runner.params, runner.cfg, int(first[0]),
                                                   len(ids), max_steps - 1, runner._cache,
                                                   force_miss=mode == "force_miss")
            torch.cuda.synchronize()
        toks[mode] = got
        rates[mode] = len(got) / (time.perf_counter() - t0)
    seq = toks["sequential"]
    part = {m: next((i for i, (a, b) in enumerate(zip(toks[m], seq)) if a != b),
                    min(len(toks[m]), len(seq))) for m in ("spec", "force_miss")}
    print(f"greedy bracket ({len(seq)} tokens after a {len(ids)}-token prefill): "
          + ", ".join(f"{m} {v:.1f} tok/s" for m, v in rates.items())
          + f"; tokens equal to the sequential loop's up to token {part['spec']} (spec), "
          f"{part['force_miss']} (force_miss)")
    return {"tok_per_s": rates, "tokens": len(seq), "first_part_from_sequential": part}


def server(path: str, qtype: str) -> dict:
    """Serve 3 requests and a greedy PCM stream from one full-width model;
    returns the launch counts of that run, every counter set to 0 just
    before it."""
    phase(f"5 server, Orpheus-3B {qtype}")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.models import orpheus as tor
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
    # a forward of one token is a decode step, one at position 0 a prefill,
    # any other a verify window
    forwards, restore = _counting(tor, "_orpheus_body", lambda p, c, tokens, positions, cache,
                                  start=0: "step" if tokens.shape[0] == 1
                                  else "verify" if start else "prefill")
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
        verify_before = forwards["verify"]
        check(verify_before > 0, "the greedy request ran no verify window")
        kind, payload = REQUESTS[2]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/speech",
            data=json.dumps({**payload, "response_format": "pcm"}).encode(),
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=900) as resp:
            head = resp.read(2)
            ttfa = time.perf_counter() - t
            n = (len(head) + len(resp.read())) // 2
        wall = time.perf_counter() - t
        check(n == (payload["max_tokens"] // 7) * 4 * 512, f"greedy pcm stream: {n} samples")
        check(forwards["verify"] > verify_before, "the greedy stream ran no verify window")
        print(f"greedy pcm stream (speculative, 70-token chunks)  TTFA {ttfa * 1e3:8.1f} ms  "
              f"wall {wall * 1e3:8.1f} ms  audio {n / 24000:.3f} s  RTF {wall / (n / 24000):.3f}")
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        restore()
        runner.generate = generate
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    tokens = sum(r.timings["decode_steps"] for r in responses)
    print(f"launches over {len(responses)} requests and a stream ({tokens} tokens in the "
          f"requests; forwards {dict(forwards)}): {counts}")
    gemv, gemm = PATH_KERNELS[qtype]
    per = LAYERS * LINEARS_PER_LAYER
    check(len(responses) == len(REQUESTS), f"{len(responses)} responses")
    check(forwards["prefill"] == len(REQUESTS) + 1, f"forwards {dict(forwards)}")
    check(counts[gemv] == (per + 1) * forwards["step"] + forwards["prefill"],
          f"{gemv} launched {counts[gemv]}, not (28 * 4 + 1) per decode step and one (the "
          f"lm_head) per prefill: {dict(forwards)}")
    check(counts["flash_decode"] == LAYERS * forwards["step"],
          f"flash_decode launched {counts['flash_decode']}, not 28 per decode step")
    check(counts[gemm] == per * forwards["prefill"] + (per + 1) * forwards["verify"],
          f"{gemm} launched {counts[gemm]}, not 28 * 4 per prefill and 28 * 4 + 1 per verify "
          f"window: {dict(forwards)}")
    for other in PATH_KERNELS.values():
        if other != (gemv, gemm):
            check(counts[other[0]] == counts[other[1]] == 0,
                  f"the {qtype} path launched {other}: {counts}")
    print(f"after the requests: memory_allocated {torch.cuda.memory_allocated() / gib:.2f} GiB"
          f" (the runner keeps its KV cache), max_memory_allocated during the requests "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    summary = {"ttfa_ms": ttfa * 1e3, "bracket": orpheus_bracket(runner, REQUESTS[2][1]["input"])}
    print(json.dumps({f"orpheus_{qtype}": summary}))
    return counts


def kokoro_tiny_cuda_vs_cpu():
    """KokoroDims.tiny() on cuda against the CPU (the plain PyTorch path the
    CPU tests hold to the JAX package), f32 with cuDNN's TF32 off, the same
    source noise, checked as the CPU tests check port against JAX:
    durations equal up to sums within 1e-4 of x.5 (the CPU's then drive
    both); the decoder's F0 curve and output within KOKORO_TINY_TOL of their
    peaks; the harmonic spectrum's magnitude within it and its phase modulo
    2 pi; the generator tail on one shared spectrum within it; a whole
    request of equal length and finite.  A whole request's audio is not
    compared: the spectrum's DC and Nyquist bins have an imaginary part of
    +-0 or +-1e-7, so their phase (atan2) lands on +pi or -pi by the sign of
    a rounding, and the noise convolutions read the phase as a number."""
    import dataclasses

    import torch

    from tts_tpu_torch.convert.builder_kokoro import KokoroDims, write_kokoro_gguf
    from tts_tpu_torch.models import kokoro as tk
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops.stft import stft

    path = write_kokoro_gguf(os.path.join(MODEL_DIR, "tiny_kokoro_seed0.gguf"),
                             KokoroDims.tiny(), seed=0, duration_bias=KOKORO_DURATION_BIAS)
    models = {}
    for dev in ("cpu", "cuda"):
        m = runner_from_file(str(path), device=dev).model
        m.cfg = dataclasses.replace(m.cfg, compute_dtype="float32")
        models[dev] = m
    tokens = [0] + [int(t) for t in np.random.default_rng(1).integers(1, 40, 30)] + [0]
    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.inference_mode():
        for dev, m in models.items():
            sg, sp = m.voice_style("af_heart", len(tokens))
            tt = torch.tensor(tokens, device=m.device)
            out[dev] = {"sums": tk.duration_raw(m.params, m.cfg, tt, sp)[0].cpu().numpy()}
        sums = out["cpu"]["sums"]
        dur = np.clip(np.round(sums), 1, 50)
        tie = np.abs(sums - np.floor(sums) - 0.5) <= 1e-4
        same = np.clip(np.round(out["cuda"]["sums"]), 1, 50) == dur
        check(bool(same[~tie].all()), f"tiny Kokoro: durations differ cuda vs cpu at "
              f"{np.nonzero(~same)[0].tolist()}")
        n_frames = int(dur.sum())
        noise = models["cpu"].source_noise(n_frames, seed=0)
        shared = None
        for dev, m in models.items():
            sg, sp = m.voice_style("af_heart", len(tokens))
            tt = torch.tensor(tokens, device=m.device)
            d = torch.from_numpy(dur.astype(np.float32)).to(m.device)
            _, hidden = tk.duration_raw(m.params, m.cfg, tt, sp)
            f0, _, cur = tk.decode(m.params, m.cfg, tt, d, hidden, sg, sp, n_frames)
            gen = m.params["decoder"]["generator"]
            har = torch.tanh(tk._sine_source(m.cfg, f0, noise.to(m.device)) @ gen["m_source_w"]
                             + gen["m_source_b"])[:, 0]
            mag, phase = stft(har, m.window, m.cfg.n_fft, m.cfg.hop)
            if shared is None:
                shared = torch.cat([mag, phase], dim=-1).cpu()
            tail = tk.generator_tail(gen, m.cfg, cur, shared.to(m.device), sg, m.window,
                                     n_frames * m.cfg.up_sampling_factor)
            audio = m.synthesize(tokens, "af_heart", noise=noise, durations=dur)
            out[dev].update({k: v.cpu().numpy() for k, v in (
                ("f0", f0), ("cur", cur), ("mag", mag), ("phase", phase), ("tail", tail))},
                audio=audio)
    a, b = out["cuda"], out["cpu"]
    rel = {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
           for k in ("f0", "cur", "mag", "tail")}
    wrapped = float(np.abs((a["phase"] - b["phase"] + np.pi) % (2 * np.pi) - np.pi).max())
    flips = int((np.abs(a["phase"] - b["phase"]) > np.pi).sum())
    whole = float(np.abs(a["audio"] - b["audio"]).max() / np.abs(b["audio"]).max())
    print(f"tiny Kokoro cuda vs cpu (f32, TF32 off): {len(tokens)} tokens, durations equal on "
          f"{int(same.sum())}/{len(tokens)} ({int(tie.sum())} ties; sums max diff "
          f"{np.abs(a['sums'] - b['sums']).max():.2e}), {n_frames} frames; max diff / peak: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {KOKORO_TINY_TOL:.0e}); spectrum phase mod 2 pi {wrapped:.2e} (tol 1e-3), "
          f"{flips} of {a['phase'].size} phases on the other side of +-pi; whole request "
          f"{whole:.2e} of peak (not compared)")
    for k, v in rel.items():
        check(v <= KOKORO_TINY_TOL, f"tiny Kokoro: cuda vs cpu {k} {v:.2e} of peak > "
              f"{KOKORO_TINY_TOL}")
    check(wrapped < 1e-3, f"tiny Kokoro: spectrum phase differs by {wrapped} mod 2 pi")
    check(a["audio"].shape == b["audio"].shape == (n_frames * 600,), "tiny Kokoro: lengths")
    check(bool(np.isfinite(a["audio"]).all()), "tiny Kokoro: non-finite audio on cuda")


def _kokoro_frames(model, chunks) -> list[int]:
    """Each chunk's frame count as the duration predictor gives it, computed
    apart from the request that synthesized it."""
    import torch

    from tts_tpu_torch.models import kokoro as tk

    frames = []
    with torch.inference_mode():
        for tokens in chunks:
            _, style = model.voice_style("af_heart", len(tokens))
            dur, _ = tk.duration_forward(model.params, model.cfg,
                                         torch.tensor(tokens, device=model.device), style)
            frames.append(int(dur.sum().item()))
    return frames


def _profile_request(runner, text, cfg, name: str) -> dict:
    """One warm request under torch.profiler: the time during which some
    kernel ran on the device (kernel intervals merged), as a share of the
    profiled wall and of the same request's wall unprofiled just before
    (the median of three; the profiler's own cost lengthens the first), and
    the ten kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(MODEL_DIR, f"{name}_profile.json")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.generate(text, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        resp = runner.generate(text, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(len(kernels) > 0, "torch.profiler recorded no device kernel")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    first = spans[0][0]
    return {"request": text, "wall_ms": wall_ms, "unprofiled_wall_ms": plain_ms,
            "audio_s": resp.duration_s, "device_kernels": len(kernels),
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e3 / wall_ms,
            "device_busy_share_of_unprofiled_wall": busy / 1e3 / plain_ms,
            "first_to_last_kernel_ms": (end - first) / 1e3,
            "top_kernels": [{"name": n[:120], "calls": c, "device_ms": t / 1e3}
                            for n, (c, t) in top]}


def _kokoro_config():
    from tts_tpu_torch.runtime.api import GenerationConfig

    return GenerationConfig(voice="af_heart", seed=0)


def kokoro() -> dict:
    """Phase 6; returns the five kernels' launch counts over the Kokoro
    requests, every counter set to 0 just before them."""
    phase("6 Kokoro-82M")
    import dataclasses

    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.convert.builder_kokoro import KokoroDims, write_kokoro_gguf

    kokoro_tiny_cuda_vs_cpu()
    # the library's users run with torch's defaults; phases 3-4 turned TF32 off
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    t0 = time.perf_counter()
    write_kokoro_gguf(path, KokoroDims.kokoro_82m(), seed=0, duration_bias=KOKORO_DURATION_BIAS)
    print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    state = ServerState({"kokoro82m": path}, _kokoro_config(), 1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    runner, _ = state._get_runner("kokoro82m")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = runner.model
    n_params = sum(t.numel() for t in _tensors(model.params))
    print(f"model load: {load_s:.2f} s, {n_params / 1e6:.1f} M params on {model.device}, "
          f"memory_allocated {torch.cuda.memory_allocated() / 2**20 - base_mib:.0f} MiB over "
          f"the {base_mib:.0f} MiB left by the earlier phases, compute_dtype "
          f"{model.cfg.compute_dtype}")

    chunks, responses = [], []
    synthesize, generate = model.synthesize, runner.generate

    def recording_synthesize(token_ids, voice, seed=0, **kw):
        chunks.append(list(token_ids))
        return synthesize(token_ids, voice, seed=seed, **kw)

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    model.synthesize, runner.generate = recording_synthesize, recording_generate
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()

    def request(text, label):
        """One /v1/audio/speech request; checks the WAV against the audio
        and the frames the duration predictor gives its chunks."""
        del chunks[:], responses[:]
        t = time.perf_counter()
        status, body, ctype = _post(port, {"input": text, "voice": "af_heart", "seed": 0})
        wall = time.perf_counter() - t
        check(status == 200 and ctype == "audio/wav", f"{label}: HTTP {status} {ctype}: "
              f"{body[:200]!r}")
        with wave.open(io.BytesIO(body)) as wf:
            n = wf.getnframes()
            check(wf.getframerate() == 24000, f"{label}: rate {wf.getframerate()}")
        resp = responses[-1]
        frames = _kokoro_frames(model, chunks)
        check(n > 0 and n == len(resp.audio), f"{label}: wav {n} samples, audio "
              f"{len(resp.audio)}")
        check(n == 600 * sum(frames), f"{label}: {n} samples for {sum(frames)} frames "
              f"({frames} over {len(chunks)} chunks)")
        check(bool(np.isfinite(resp.audio).all()), f"{label}: non-finite audio")
        check(float(np.abs(resp.audio).max()) > 0, f"{label}: silent audio")
        return {"wall_ms": wall * 1e3, "audio_s": n / 24000, "rtf": wall / (n / 24000),
                "frames": sum(frames), "chunks": len(chunks), "tokens": sum(map(len, chunks)),
                "synthesize_ms": resp.timings["synthesize_ms"]}

    try:
        for kernel in counters.values():
            kernel.launches = 0
        t = time.perf_counter()
        for i, text in enumerate(HARVARD):
            request(text, f"warm {i + 1}")
        print(f"warm pass (cuDNN picks its algorithms per new shape): 10 requests in "
              f"{time.perf_counter() - t:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for i, text in enumerate(HARVARD):
            r = request(text, f"harvard {i + 1}")
            rows.append(r)
            print(f"harvard {i + 1:2d}  wall {r['wall_ms']:7.1f} ms  synthesize "
                  f"{r['synthesize_ms']:7.1f} ms  audio {r['audio_s']:.3f} s  RTF "
                  f"{r['rtf']:.4f}  {r['tokens']} tokens  {r['frames']} frames")
        rtfs = sorted(r["rtf"] for r in rows)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20 - base_mib
        summary = {"p50_rtf": float(np.median(rtfs)), "max_rtf": rtfs[-1],
                   "mean_wall_ms": float(np.mean([r["wall_ms"] for r in rows])),
                   "audio_s": sum(r["audio_s"] for r in rows), "load_s": load_s,
                   "max_memory_allocated_mib": peak_mib}
        print(f"Harvard pass: p50 RTF {summary['p50_rtf']:.4f}, max RTF {rtfs[-1]:.4f}, "
              f"{summary['audio_s']:.2f} s of audio, max_memory_allocated {peak_mib:.0f} MiB over "
              f"the earlier phases' {base_mib:.0f} MiB (weights and activations)")

        long_text = " ".join(HARVARD * 2)
        phonemes = runner.phonemizer.text_to_phonemes(long_text)
        check(len(phonemes) >= model.cfg.max_context_length - 2,
              f"long input: {len(phonemes)} phonemes fit one chunk")
        r = request(long_text, "long")
        check(r["chunks"] > 1, f"long input: {r['chunks']} chunk")
        summary["long"] = r
        print(f"long input: {len(phonemes)} phonemes -> {r['chunks']} chunks, {r['frames']} "
              f"frames (the chunks' sum), wall {r['wall_ms']:.1f} ms, RTF {r['rtf']:.4f}")

        ttfa = []
        for _ in range(3):
            del chunks[:]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/audio/speech",
                data=json.dumps({"input": HARVARD[0], "voice": "af_heart", "seed": 0,
                                 "response_format": "pcm"}).encode(),
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as resp:
                first = resp.read(2)
                ttfa.append((time.perf_counter() - t) * 1e3)
                n = (len(first) + len(resp.read())) // 2
            frames = _kokoro_frames(model, chunks)
            check(n == 600 * sum(frames), f"pcm stream: {n} samples for {frames} frames")
        summary["ttfa_http_ms"] = sorted(ttfa)[1]
        print(f"pcm stream through the server (generate_stream): time to its first bytes "
              f"{summary['ttfa_http_ms']:.1f} ms (median of 3), {len(chunks)} chunks, "
              f"{n / 24000:.3f} s of audio")
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        model.synthesize, runner.generate = synthesize, generate
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    print(f"launches over the Kokoro requests: {counts}")
    check(not any(counts.values()), f"the Kokoro path launched {counts}")

    ttfa = []
    for _ in range(3):
        t = time.perf_counter()
        stream = runner.generate_stream(HARVARD[0], _kokoro_config())
        first = next(stream)
        ttfa.append((time.perf_counter() - t) * 1e3)
        rest = list(stream)
        check(len(first) > 0 and bool(np.isfinite(first).all()), "stream: first chunk")
    summary["ttfa_ms"] = sorted(ttfa)[1]
    print(f"generate_stream TTFA (median of 3): {summary['ttfa_ms']:.1f} ms, first chunk "
          f"{len(first) / 24000:.3f} s of audio, {1 + len(rest)} chunks")

    tokens = [0] + runner.tokenizer.tokenize(runner.phonemizer.text_to_phonemes(
        HARVARD[1]).replace(".", "").strip()) + [0]
    dur = _kokoro_frames(model, [tokens])[0]
    noise = model.source_noise(dur, seed=0)
    audio = {}
    for dtype in ("bfloat16", "float32"):
        model.cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
        audio[dtype] = model.synthesize(tokens, "af_heart", noise=noise)
    model.cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    a, b = audio["bfloat16"].astype(np.float64), audio["float32"].astype(np.float64)
    rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    corr = float(np.corrcoef(a, b)[0, 1])
    summary["bf16_vs_f32"] = {"rel_l2": rel_l2, "corr": corr}
    print(f"bf16 vs f32 (full width, same noise): rel L2 {rel_l2:.3e}, correlation {corr:.6f} "
          f"(floor {KOKORO_BF16_MIN_CORR}), peak |audio| {np.abs(b).max():.3e} (random weights: "
          f"the generator's exp(magnitude) is unbounded)")
    check(bool(np.isfinite(a).all() and np.isfinite(b).all()), "bf16 vs f32: non-finite audio")
    check(corr >= KOKORO_BF16_MIN_CORR, f"bf16 vs f32: correlation {corr} < "
          f"{KOKORO_BF16_MIN_CORR}")

    prof = _profile_request(runner, HARVARD[0], _kokoro_config(), "kokoro")
    print(json.dumps({"kokoro_profile": prof}))
    summary["device_busy_share"] = prof["device_busy_share"]
    summary["device_busy_share_of_unprofiled_wall"] = prof["device_busy_share_of_unprofiled_wall"]
    print(json.dumps({"kokoro": summary}))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return counts


def _staircase(cfg, rows):
    """The sequential loop's input rows before each of `rows` [n, 9]."""
    from tts_tpu_torch.models import parler as tp

    tokens, eos, _ = tp.init_loop_state(cfg)
    ins = []
    for i, row in enumerate(rows):
        ins.append(tokens)
        eos = eos | (row == cfg.eos_token_id)
        tokens = tp._next_row(cfg, row, eos, i + 1)
    return np.stack(ins)


def _parler_logits_along(r, ids, ins, widths):
    """Logits [n, 9, vocab] of runner r teacher-forced along input rows
    `ins` after the prompt's prefill, the forwards `widths` rows wide."""
    import torch

    from tts_tpu_torch.models import parler as tp

    cache = tp.init_kv_cache(r.cfg, r.device)
    out, i = [], 0
    with torch.inference_mode():
        tp.parler_prefill(r.params, r.cfg, torch.tensor(ids, device=r.device), cache, r.cross_kv)
        for w in widths:
            out.append(tp._rows_logits(r.params, r.cfg, torch.from_numpy(ins[i:i + w]).to(r.device),
                                       len(ids) + i, cache, r.cross_kv))
            i += w
    return torch.cat(out).float()


def parler_tiny_cuda_vs_cpu(qtype: str):
    """A 2-layer hidden-256 Parler with `qtype` linears (every decoder linear
    quantized, the cross-attention's too): the prompt prefill, 8
    teacher-forced rows one per forward (the GEMVs) and 8 in one forward
    (the verify's GEMMs), on cuda (kernels) against the CPU (plain
    versions, which the CPU tests hold to the JAX package): logits within
    TINY_TOL of max |logit|; its DAC on 24 random frames within DAC_TOL."""
    import torch

    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler
    from tts_tpu_torch.models.registry import runner_from_file

    path = write_random_parler(os.path.join(MODEL_DIR, f"tiny_parler_{qtype.lower()}.gguf"),
                               qtype=qtype, dac=dict(DAC_44KHZ, **PARLER_TINY_DAC),
                               **dict(PARLER_MINI_V1, **PARLER_TINY))
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1024, (24, 9)).astype(np.int32)
    forced = rng.integers(0, 1024, (16, 9)).astype(np.int32)
    logits, audio = {}, {}
    for dev in ("cuda", "cpu"):
        r = runner_from_file(path, device=dev)
        key = "wq4" if qtype == "Q4_0" else "wq"
        check(key in r.params["layers"][0]["fc1"] and key in r.params["layers"][0]["ca_k"],
              f"tiny Parler {qtype}: linears not packed as {key}")
        ids = r.tokenizer.tokenize("hello world") + [r.tokenizer.eos_token]
        logits[dev] = _parler_logits_along(r, ids, _staircase(r.cfg, forced), [1] * 8 + [8]).cpu()
        audio[dev] = r.dac.decode(codes)
    a, rel = rel_err(logits["cuda"], logits["cpu"])
    same = (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).float().mean().item()
    dac = float(np.abs(audio["cuda"] - audio["cpu"]).max())
    print(f"tiny Parler {qtype} cuda vs cpu: 16 rows x 9 heads of logits (8 GEMV steps, one "
          f"8-row GEMM verify), max abs diff {a:.3e}, rel {rel:.2e} (tol {TINY_TOL:.0e}), argmax "
          f"agrees on {same:.1%}; DAC on 24 frames max abs diff {dac:.2e} (tol {DAC_TOL:.0e})")
    check(bool(torch.isfinite(logits["cuda"]).all()), f"tiny Parler {qtype}: non-finite logits")
    check(rel < TINY_TOL, f"tiny Parler {qtype}: cuda vs cpu logits rel diff {rel} >= {TINY_TOL}")
    check(audio["cuda"].shape == (24 * 512,) and dac < DAC_TOL,
          f"tiny Parler {qtype}: DAC cuda vs cpu {dac} >= {DAC_TOL}")


def parler_models() -> tuple[dict, str]:
    """Seeded random full-width Parler-TTS mini v1 GGUFs, Q8_0 and Q4_0, and
    a flan-t5-large-width T5 GGUF (F16), under smoke_models/."""
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler
    from tts_tpu_torch.convert.builder_t5 import FLAN_T5_LARGE, write_t5_gguf

    paths = {}
    for qtype in QTYPES:
        path = os.path.join(MODEL_DIR, f"parler_mini_v1_{qtype[:2].lower()}_seed0.gguf")
        t0 = time.perf_counter()
        write_random_parler(path, seed=0, qtype=qtype, **PARLER_MINI_V1)
        print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path) / 1e9:.3f} GB in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        paths[qtype] = path
    t5 = os.path.join(MODEL_DIR, "flan_t5_large_f16_seed0.gguf")
    t0 = time.perf_counter()
    write_t5_gguf(t5, seed=0, dtype=np.float16, **FLAN_T5_LARGE)
    print(f"wrote {os.path.relpath(t5, ROOT)}: {os.path.getsize(t5) / 1e9:.3f} GB in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return paths, t5


def _first_part(a, b) -> int:
    """The first row where two row arrays [n, 9] differ (n if none)."""
    n = min(len(a), len(b))
    diff = np.nonzero((a[:n] != b[:n]).any(axis=1))[0]
    return int(diff[0]) if len(diff) else n


def parler_bracket(runner, text: str) -> dict:
    """Greedy rows/s of one 256-row request decoded three ways after the
    same prefill: the speculative loop, its force_miss floor (every draft
    rejected: one row per 8-row forward), and the sequential loop; the
    first row where each parts from the sequential rows and, for the
    speculative loop, the top-2 gap of the sequential path's logits there
    (the tests hold the two equal up to near-ties).  Launches made here are
    not counted for the path."""
    import torch

    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.runtime.api import GenerationConfig

    cfg = runner.cfg
    ids = runner._prompt_ids(text)
    config = GenerationConfig(sample=False, seed=0, max_tokens=PARLER_MAX_TOKENS)
    rows, rates = {}, {}
    for mode in ("spec", "force_miss", "sequential"):
        with torch.inference_mode():
            cross, _, state, limit = runner._prefill(ids, config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                got, _, _ = tp.parler_decode_loop(runner.params, cfg, len(ids), limit,
                                                  runner._cache, cross, None, state,
                                                  tp.init_loop_state(cfg), do_sample=False)
            else:
                out, loop, _ = tp.parler_decode_loop_spec_resume(
                    runner.params, cfg, len(ids), limit, runner._cache, cross,
                    tp.init_loop_state(cfg), runner._out_buffer(),
                    force_miss=mode == "force_miss")
                got = out[:loop[2]]
            torch.cuda.synchronize()
        rows[mode] = got
        rates[mode] = len(got) / (time.perf_counter() - t0)
    seq = rows["sequential"]
    part = {m: _first_part(rows[m], seq) for m in ("spec", "force_miss")}
    gap = None
    if part["spec"] < len(seq):
        r = part["spec"]
        lg = _parler_logits_along(runner, ids, _staircase(cfg, seq[:r + 1]), [1] * (r + 1))[r]
        heads = np.nonzero(rows["spec"][r] != seq[r])[0]
        top2 = lg.topk(2, dim=-1).values
        gap = float((top2[heads, 0] - top2[heads, 1]).min())
    out = {"rows_per_s": rates,
           "rows": len(seq), "first_part_from_sequential": part,
           "spec_part_top2_gap": gap}
    print(f"greedy bracket ({len(seq)} rows after a {len(ids)}-token prefill): "
          + ", ".join(f"{m} {v:.1f} rows/s" for m, v in out["rows_per_s"].items())
          + f"; rows equal to the sequential loop's up to row {part['spec']} (spec), "
          f"{part['force_miss']} (force_miss)"
          + (f"; top-2 gap at the spec part {gap:.2e}" if gap is not None else ""))
    return out


def parler_server(path: str, qtype: str, t5_path: str) -> tuple[dict, dict]:
    """Serve one full-width Parler-TTS mini v1: a sampled request, a greedy
    one (the speculative loop), a PCM stream, a conditional-prompt call
    (T5 flan-t5-large width) and a sampled request on the new encoding,
    each capped at PARLER_MAX_TOKENS rows; returns the launch counts of that
    run (every counter set to 0 just before it) and its metrics."""
    phase(f"7 server, Parler-TTS mini v1 {qtype}")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.runtime.api import GenerationConfig

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    name = f"parler_mini_v1_{qtype}"
    state = ServerState({name: path}, GenerationConfig(top_k=50), 1, device="cuda")
    t0 = time.perf_counter()
    runner, _ = state._get_runner(name)
    load_s = time.perf_counter() - t0
    mib = 2**20
    key = "wq4" if qtype == "Q4_0" else "wq"
    check(all(key in runner.params["layers"][0][n] for n in ("sa_q", "ca_k", "fc1", "fc2")),
          f"Parler {qtype}: linears not packed as {key}")
    check(runner.cfg.kv_dtype == "bfloat16" and runner.params["heads"].dtype == torch.bfloat16,
          f"Parler {qtype}: cache {runner.cfg.kv_dtype}, heads {runner.params['heads'].dtype}")
    print(f"model load: {load_s:.2f} s  " + "  ".join(f"{k} {v:.2f}" for k, v in
                                                     runner.load_timings.items())
          + f"; memory_allocated {(torch.cuda.memory_allocated() - base) / mib:.0f} MiB")
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
    summary = {"load_s": load_s, "load_timings": runner.load_timings, "requests": {}}

    def speech(kind, payload):
        t = time.perf_counter()
        status, body, ctype = _post(port, payload)
        wall = time.perf_counter() - t
        check(status == 200 and ctype == "audio/wav", f"{kind}: HTTP {status} {ctype}: "
              f"{body[:200]!r}")
        resp = responses[-1]
        with wave.open(io.BytesIO(body)) as wf:
            n = wf.getnframes()
            check(wf.getframerate() == 44100, f"{kind}: rate {wf.getframerate()}")
        steps, frames = resp.timings["decode_steps"], resp.timings["frames"]
        check(steps == PARLER_MAX_TOKENS, f"{kind}: {steps} rows, not {PARLER_MAX_TOKENS}")
        check(0 < n == len(resp.audio) == 512 * frames, f"{kind}: wav {n} samples, audio "
              f"{len(resp.audio)}, {frames} frames")
        check(bool(np.isfinite(resp.audio).all()), f"{kind}: non-finite audio")
        check(float(np.abs(resp.audio).max()) > 0, f"{kind}: silent audio")
        check(resp.timings["prompt_tokens"] in parler_gemm_lengths(),
              f"{kind}: prefill M={resp.timings['prompt_tokens']} was not checked in phase 3")
        dec_s = resp.timings["decode_ms"] / 1e3
        m = {"wall_ms": wall * 1e3, "prefill_ms": resp.timings["prefill_ms"],
             "prompt_tokens": resp.timings["prompt_tokens"], "rows": steps,
             "decode_rows_per_s": steps / dec_s, "codec_ms": resp.timings["codec_ms"],
             "frames": frames, "audio_s": n / 44100, "rtf": wall / (n / 44100)}
        print(f"{kind:15s} wall {wall * 1e3:8.1f} ms  prefill {m['prompt_tokens']} tok in "
              f"{m['prefill_ms']:6.1f} ms  decode {steps} rows in {dec_s * 1e3:8.1f} ms = "
              f"{m['decode_rows_per_s']:6.1f} rows/s  codec {m['codec_ms']:6.1f} ms  {frames} "
              f"frames, audio {m['audio_s']:.3f} s  RTF {m['rtf']:.3f}")
        summary["requests"][kind] = m
        return resp

    try:
        first = speech("sampled", {"input": PARLER_TEXTS[0], "max_tokens": PARLER_MAX_TOKENS,
                                   "seed": 1})
        speech("greedy (spec)", {"input": PARLER_TEXTS[1], "max_tokens": PARLER_MAX_TOKENS,
                                 "sample": False})
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/speech",
            data=json.dumps({"input": PARLER_TEXTS[2], "max_tokens": PARLER_MAX_TOKENS, "seed": 2,
                             "response_format": "pcm"}).encode(),
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=900) as resp:
            head = resp.read(2)
            ttfa = time.perf_counter() - t
            n = (len(head) + len(resp.read())) // 2
        wall = time.perf_counter() - t
        check(n > 0, "pcm stream: no audio")
        summary["requests"]["stream"] = {"ttfa_ms": ttfa * 1e3, "wall_ms": wall * 1e3,
                                         "audio_s": n / 44100, "rtf": wall / (n / 44100)}
        print(f"pcm stream      TTFA {ttfa * 1e3:8.1f} ms  wall {wall * 1e3:8.1f} ms  audio "
              f"{n / 44100:.3f} s  RTF {wall / (n / 44100):.3f}")
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/conditional-prompt",
            data=json.dumps({"prompt": PARLER_DESCRIPTION, "text_encoder_path": t5_path}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as resp:
            check(resp.status == 200 and json.loads(resp.read()) == {"status": "ok"},
                  "conditional-prompt failed")
        cond_ms = (time.perf_counter() - t) * 1e3
        enc = tuple(runner.params["text_encoding"].shape)
        check(enc[0] in parler_gemm_lengths() and enc[1] == 1024,
              f"conditional-prompt: encoding {enc} not checked in phase 3")
        summary["conditional_prompt_ms"] = cond_ms
        print(f"conditional-prompt: T5 load + encode + cross-KV {cond_ms:.1f} ms -> encoding {enc}")
        after = speech("sampled, new prompt", {"input": PARLER_TEXTS[0],
                                               "max_tokens": PARLER_MAX_TOKENS, "seed": 1})
        check(not (after.audio.shape == first.audio.shape
                   and np.array_equal(after.audio, first.audio)),
              "the conditional prompt did not change the audio")
        summary["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated() - base) / mib
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        runner.generate = generate
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    print(f"launches over the Parler {qtype} requests: {counts}")
    sequential = 3 * PARLER_MAX_TOKENS     # rows of the three sampled requests
    per = PARLER_LAYERS * PARLER_LINEARS
    gemv, gemm = PATH_KERNELS[qtype]
    check(per * sequential <= counts[gemv] <= per * (sequential + 3),
          f"{gemv} launched {counts[gemv]}, not {per} per sequential row ({sequential} rows)")
    check(counts[gemm] >= per * (4 + PARLER_MAX_TOKENS // 8) + 2 * PARLER_LAYERS,
          f"{gemm} launched {counts[gemm]} < 4 prefills, one greedy request's verify windows "
          f"and one cross-KV precompute")
    check(counts["flash_decode"] == 0, f"the Parler path launched flash_decode {counts}")
    for other in PATH_KERNELS.values():
        if other != (gemv, gemm):
            check(counts[other[0]] == counts[other[1]] == 0,
                  f"the Parler {qtype} path launched {other}: {counts}")
    print(f"max_memory_allocated during the requests {summary['max_memory_allocated_mib']:.0f} "
          f"MiB over what was allocated before the load (weights, cache, T5 while encoding)")
    summary["bracket"] = parler_bracket(runner, PARLER_TEXTS[1])
    prof = _profile_request(runner, PARLER_TEXTS[0],
                            GenerationConfig(seed=1, top_k=50, max_tokens=PARLER_PROFILE_ROWS),
                            f"parler_{qtype}")
    print(json.dumps({f"parler_{qtype}_profile": prof}))
    summary["profile"] = {k: prof[k] for k in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                                               "device_busy_share",
                                               "device_busy_share_of_unprofiled_wall")}
    return counts, summary


def parler() -> dict:
    """Phase 7; returns the launch counts of each Parler path's served
    requests."""
    phase("7 Parler-TTS mini v1: tiny models, cuda against cpu")
    import torch

    os.makedirs(MODEL_DIR, exist_ok=True)
    for qtype in QTYPES:
        parler_tiny_cuda_vs_cpu(qtype)
    paths, t5 = parler_models()
    # served with torch's default math flags, as users run it
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    counts, summary = {}, {}
    for qtype in QTYPES:
        counts[f"parler_{qtype}"], summary[qtype] = parler_server(paths[qtype], qtype, t5)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    print(json.dumps({"parler": summary}))
    return counts


def _dia_staircase(cfg, rows):
    """The sequential loop's input rows before each of `rows` [n, 9] (a
    max_tokens that never starts the drain)."""
    from tts_tpu_torch.models import dia as td

    tokens, delay, _ = td.dia_init_loop_state(cfg)
    ins = []
    for i, row in enumerate(rows):
        ins.append(tokens)
        tokens, delay = td._drain_step(cfg, row, i + 1, delay, 10_000)
    return np.stack(ins)


def dia_tiny_cuda_vs_cpu(qtype: str):
    """A 2+2-layer hidden-256 Dia with `qtype` encoder, embeddings and
    decoder linears: the encoder and cross-KV (M = 2 x 128), 8
    teacher-forced steps one per forward (M = 2) and 8 in one forward
    (the verify, M = 16), on cuda (kernels) against the CPU (plain
    versions, which the CPU tests hold to the JAX package): merged logits
    within TINY_TOL of max |logit|, the cross K/V within DIA_CROSS_TOL of
    their peaks; the DAC on 24 random frames within DAC_TOL."""
    import torch

    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    from tts_tpu_torch.convert.builder_dia import DIA_1_6B, write_random_dia
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    path = write_random_dia(os.path.join(MODEL_DIR, f"tiny_dia_{qtype.lower()}.gguf"),
                            qtype=qtype, dac=dict(DAC_44KHZ, **PARLER_TINY_DAC),
                            **dict(DIA_1_6B, **DIA_TINY))
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1024, (24, 9)).astype(np.int32)
    forced = rng.integers(0, 1024, (16, 9)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        r = runner_from_file(path, device=dev)
        key = "wq4" if qtype == "Q4_0" else "wq"
        layer = r.params["decoder"]["layers"][0]
        check(all(key in layer[n] for n in ("sa_q", "ca_k", "gate", "wo")),
              f"tiny Dia {qtype}: decoder linears not packed as {key}")
        ins = torch.from_numpy(_dia_staircase(r.cfg, forced)).to(dev)
        with torch.inference_mode():
            cross, _, _ = r._encode(td.tokenize_dia_sentence(DIA_TEXTS[0], r.cfg),
                                    GenerationConfig())
            logits = [td._dia_rows(r.params, r.cfg, ins[i:i + 1], i, r._cache, cross)
                      for i in range(8)]
            logits.append(td._dia_rows(r.params, r.cfg, ins[8:], 8, r._cache, cross))
        eos = r.cfg.eos_token_id
        out[dev] = {"logits": torch.cat(logits)[..., :eos + 1].float().cpu(),
                    "masked": torch.cat(logits)[..., eos + 1:].cpu(),
                    "k": cross["k"].cpu(), "v": cross["v"].cpu(), "audio": r.dac.decode(codes)}
    a, b = out["cuda"], out["cpu"]
    _, rel = rel_err(a["logits"], b["logits"])
    cross = {k: rel_err(a[k], b[k])[1] for k in ("k", "v")}
    same = (a["logits"].argmax(-1) == b["logits"].argmax(-1)).float().mean().item()
    dac = float(np.abs(a["audio"] - b["audio"]).max())
    print(f"tiny Dia {qtype} cuda vs cpu: 16 rows x 9 heads of merged logits (8 steps at M = 2, "
          f"one 8-row verify at M = 16), rel {rel:.2e} (tol {TINY_TOL:.0e}), argmax agrees on "
          f"{same:.1%}; cross K/V rel {cross['k']:.2e} / {cross['v']:.2e} (tol "
          f"{DIA_CROSS_TOL:.1e}); DAC on 24 frames max abs diff {dac:.2e} (tol {DAC_TOL:.0e})")
    check(bool(torch.isfinite(a["logits"]).all()), f"tiny Dia {qtype}: non-finite logits")
    check(bool(torch.isneginf(a["masked"]).all()), f"tiny Dia {qtype}: ids past EOS not -inf")
    check(rel < TINY_TOL, f"tiny Dia {qtype}: cuda vs cpu logits rel diff {rel} >= {TINY_TOL}")
    check(max(cross.values()) < DIA_CROSS_TOL, f"tiny Dia {qtype}: cross K/V {cross}")
    check(a["audio"].shape == (24 * 512,) and dac < DAC_TOL,
          f"tiny Dia {qtype}: DAC cuda vs cpu {dac} >= {DAC_TOL}")


def dia_models() -> dict:
    """Seeded random full-width Dia-1.6B GGUFs, Q8_0 and Q4_0, under
    smoke_models/."""
    from tts_tpu_torch.convert.builder_dia import DIA_1_6B, write_random_dia

    paths = {}
    for qtype in QTYPES:
        path = os.path.join(MODEL_DIR, f"dia_1_6b_{qtype[:2].lower()}_seed0.gguf")
        t0 = time.perf_counter()
        write_random_dia(path, seed=0, qtype=qtype, **DIA_1_6B)
        print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path) / 1e9:.3f} GB in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        paths[qtype] = path
    return paths


def dia_bracket(runner, text: str) -> dict:
    """Greedy steps/s of one DIA_BRACKET_TOKENS request decoded three ways after
    the same encode: the speculative loop, its force_miss floor and the
    sequential loop; the first row where each parts from the sequential
    rows.  Launches made here are not counted for the path."""
    import torch

    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.runtime.api import GenerationConfig

    cfg = runner.cfg
    config = GenerationConfig(sample=False, seed=0, max_tokens=DIA_BRACKET_TOKENS)
    ids = runner._prompt_ids(text, config)
    rows, rates = {}, {}
    for mode in ("spec", "force_miss", "sequential"):
        with torch.inference_mode():
            cross, _, state = runner._encode(ids, config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                got, _, _ = td.dia_decode_loop(runner.params, cfg, DIA_BRACKET_TOKENS,
                                               cfg.max_generation_size, runner._cache, cross,
                                               None, state, td.dia_init_loop_state(cfg),
                                               do_sample=False)
            else:
                out, loop = td.dia_decode_loop_spec_resume(
                    runner.params, cfg, DIA_BRACKET_TOKENS, cfg.max_generation_size, runner._cache,
                    cross, td.dia_init_loop_state(cfg), runner._out_buffer(),
                    force_miss=mode == "force_miss")
                got = out[:loop[2]]
            torch.cuda.synchronize()
        rows[mode] = got
        rates[mode] = len(got) / (time.perf_counter() - t0)
    seq = rows["sequential"]
    part = {m: _first_part(rows[m], seq) for m in ("spec", "force_miss")}
    print(f"greedy bracket ({len(seq)} steps after a {len(ids)}-byte encode): "
          + ", ".join(f"{m} {v:.1f} steps/s" for m, v in rates.items())
          + f"; rows equal to the sequential loop's up to row {part['spec']} (spec), "
          f"{part['force_miss']} (force_miss) of {len(seq)}")
    return {"steps_per_s": rates, "steps": len(seq), "first_part_from_sequential": part}


def dia_server(path: str, qtype: str) -> tuple[dict, dict]:
    """Serve one full-width Dia-1.6B: a sampled request, a greedy one (the
    speculative loop), a PCM stream and a second sampled request, each
    capped at DIA_MAX_TOKENS; returns the launch counts of that run (every
    counter set to 0 just before it) and its metrics."""
    phase(f"8 server, Dia-1.6B {qtype}")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.runtime.api import GenerationConfig

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    name = f"dia_1_6b_{qtype}"
    state = ServerState({name: path}, GenerationConfig(top_k=50), 1, device="cuda")
    t0 = time.perf_counter()
    runner, _ = state._get_runner(name)
    load_s = time.perf_counter() - t0
    mib = 2**20
    key = "wq4" if qtype == "Q4_0" else "wq"
    layers = runner.params["decoder"]["layers"]
    check(all(key in L[n] for L in layers for n in ("sa_q", "sa_k", "sa_v", "sa_o", "ca_q", "ca_k",
                                                    "ca_v", "ca_o", "gate", "up", "wo")),
          f"Dia {qtype}: decoder linears not packed as {key}")
    check(runner.cfg.kv_dtype == "bfloat16"
          and runner.params["decoder"]["heads"].dtype == torch.bfloat16,
          f"Dia {qtype}: cache {runner.cfg.kv_dtype}, heads "
          f"{runner.params['decoder']['heads'].dtype}")
    load_mib = (torch.cuda.memory_allocated() - base) / mib
    print(f"model load: {load_s:.2f} s  " + "  ".join(f"{k} {v:.2f}" for k, v in
                                                     runner.load_timings.items())
          + f"; memory_allocated {load_mib:.0f} MiB")
    torch.cuda.reset_peak_memory_stats()
    responses = []
    generate = runner.generate

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
    forwards, restore_rows = _counting(td, "_dia_rows", lambda p, c, rows, *a: (
        "step" if rows.shape[0] == 1 else "verify"))
    encodes, restore_cross = _counting(td, "dia_cross_kv", lambda *a: "encode")
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    summary = {"load_s": load_s, "load_timings": runner.load_timings, "load_mib": load_mib,
               "requests": {}}
    steps_want = DIA_MAX_TOKENS - 1           # the drain ends one step short of the cap
    frames_want = steps_want - runner.cfg.max_delay

    def speech(kind, payload):
        t = time.perf_counter()
        status, body, ctype = _post(port, {**payload, "max_tokens": DIA_MAX_TOKENS})
        wall = time.perf_counter() - t
        check(status == 200 and ctype == "audio/wav", f"{kind}: HTTP {status} {ctype}: "
              f"{body[:200]!r}")
        resp = responses[-1]
        with wave.open(io.BytesIO(body)) as wf:
            n = wf.getnframes()
            check(wf.getframerate() == 44100, f"{kind}: rate {wf.getframerate()}")
        steps, frames = resp.timings["decode_steps"], resp.timings["frames"]
        check(steps == steps_want and frames == frames_want,
              f"{kind}: {steps} steps and {frames} frames, not {steps_want} and {frames_want}")
        check(n == len(resp.audio) == 512 * frames, f"{kind}: wav {n} samples, audio "
              f"{len(resp.audio)}, {frames} frames")
        check(bool(np.isfinite(resp.audio).all()), f"{kind}: non-finite audio")
        check(float(np.abs(resp.audio).max()) > 0, f"{kind}: silent audio")
        dec_s = resp.timings["decode_ms"] / 1e3
        m = {"wall_ms": wall * 1e3, "encode_ms": resp.timings["encode_ms"],
             "prompt_bytes": resp.timings["prompt_tokens"], "steps": steps,
             "decode_steps_per_s": steps / dec_s, "codec_ms": resp.timings["codec_ms"],
             "frames": frames, "audio_s": n / 44100, "rtf": wall / (n / 44100)}
        print(f"{kind:15s} wall {wall * 1e3:8.1f} ms  encode {m['prompt_bytes']} bytes in "
              f"{m['encode_ms']:6.1f} ms  decode {steps} steps in {dec_s * 1e3:8.1f} ms = "
              f"{m['decode_steps_per_s']:6.1f} steps/s  codec {m['codec_ms']:6.1f} ms  "
              f"{frames} frames, audio {m['audio_s']:.3f} s  RTF {m['rtf']:.3f}")
        summary["requests"][kind] = m
        return resp

    try:
        first = speech("sampled", {"input": DIA_TEXTS[0], "seed": 1})
        speech("greedy (spec)", {"input": DIA_TEXTS[1], "sample": False})
        check(forwards["verify"] > 0, "the greedy request ran no verify window")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/speech",
            data=json.dumps({"input": DIA_TEXTS[2], "max_tokens": DIA_MAX_TOKENS, "seed": 2,
                             "response_format": "pcm"}).encode(),
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=900) as resp:
            head = resp.read(2)
            ttfa = time.perf_counter() - t
            n = (len(head) + len(resp.read())) // 2
        wall = time.perf_counter() - t
        check(n == 512 * frames_want, f"pcm stream: {n} samples, not {512 * frames_want}")
        summary["requests"]["stream"] = {"ttfa_ms": ttfa * 1e3, "wall_ms": wall * 1e3,
                                         "audio_s": n / 44100, "rtf": wall / (n / 44100)}
        print(f"pcm stream      TTFA {ttfa * 1e3:8.1f} ms  wall {wall * 1e3:8.1f} ms  audio "
              f"{n / 44100:.3f} s  RTF {wall / (n / 44100):.3f}")
        again = speech("sampled again", {"input": DIA_TEXTS[3], "seed": 3})
        check(not (again.audio.shape == first.audio.shape
                   and np.array_equal(again.audio, first.audio)),
              "two sampled requests gave the same audio")
        summary["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated() - base) / mib
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        restore_rows()
        restore_cross()
        runner.generate = generate
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    print(f"launches over the Dia {qtype} requests (forwards {dict(forwards)}, encodes "
          f"{encodes['encode']}): {counts}")
    per = DIA_LAYERS * DIA_LINEARS
    gemm = PATH_KERNELS[qtype][1]
    check(encodes["encode"] == 4, f"{encodes['encode']} encodes for 4 requests")
    check(counts[gemm] == 2 * DIA_LAYERS * encodes["encode"]
          + per * (forwards["step"] + forwards["verify"]),
          f"{gemm} launched {counts[gemm]}, not 36 per request plus 162 per step and per "
          f"verify window: {dict(forwards)}")
    others = [k for k in counts if k != gemm]
    check(not any(counts[k] for k in others), f"the Dia {qtype} path launched {counts}")
    summary["forwards"] = dict(forwards)
    print(f"max_memory_allocated during the requests {summary['max_memory_allocated_mib']:.0f} "
          f"MiB over what was allocated before the load (weights, caches, activations)")
    summary["bracket"] = dia_bracket(runner, DIA_TEXTS[1])
    prof = _profile_request(runner, DIA_TEXTS[0],
                            GenerationConfig(seed=1, top_k=50, max_tokens=DIA_PROFILE_TOKENS),
                            f"dia_{qtype}")
    print(json.dumps({f"dia_{qtype}_profile": prof}))
    summary["profile"] = {k: prof[k] for k in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                                               "device_busy_share",
                                               "device_busy_share_of_unprofiled_wall",
                                               "device_kernels")}
    return counts, summary


def dia() -> dict:
    """Phase 8; returns the launch counts of each Dia path's served
    requests."""
    phase("8 Dia-1.6B: tiny models, cuda against cpu")
    import torch

    os.makedirs(MODEL_DIR, exist_ok=True)
    for qtype in QTYPES:
        dia_tiny_cuda_vs_cpu(qtype)
    paths = dia_models()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    counts, summary = {}, {}
    for qtype in QTYPES:
        counts[f"dia_{qtype}"], summary[qtype] = dia_server(paths[qtype], qtype)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    print(json.dumps({"dia": summary}))
    return counts


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def main() -> int:
    card = environment()
    import torch

    build()
    results = kernels()
    paths = model()
    counts = {qtype: server(paths[qtype], qtype) for qtype in QTYPES}
    counts["kokoro"] = kokoro()
    counts.update(parler())
    counts.update(dia())
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
