#!/usr/bin/env python3
"""Smoke test of tts_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, that its
server answers requests from full-width Orpheus-3B, Parler-TTS mini v1 and
Dia-1.6B models with Q8_0 and with Q4_0 linears, and from Kokoro-82M, that
its command-line apps (quantize, cli, perf_battery, phonemize) run the same
models, that its parallel layer (the duration trainer, Orpheus-3B over
tp = 2, data-parallel replicas) runs on the card, and that its last modules
(the native GGUF codecs, the parity report, the Orpheus step breakdown) do,
and that its benchmark, bench_torch.py, runs.

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
  5. server: the port's server on cuda, after its --warmup (the server's
     warmup(): three prompts and a streamed first chunk, which capture the
     decode graph of the default sampling key), answers 3 /v1/audio/speech
     requests (2 sampled: the captured decode step replayed once per token;
     1 greedy: the speculative loop) and a greedy PCM stream (TTFA) from the
     Q8_0 model, then from the Q4_0 model (the first request's wall beside
     the second's); the launch counts of each run, exact against the
     forwards it ran (a graph replay counts what its capture launched),
     show which kernels served it (no GEMV of Orpheus-3B the small-call
     instance); then the decode rounds: sampled tok/s of
     the eager and the graph route in alternating rounds (eager, graph,
     graph, eager) at one seed, tokens equal and launches exact, other
     sampling values on the same graph equal to their eager run, the device
     ms of one replay and a profiled graph-route request (device busy
     share); then the greedy bracket: speculative, force_miss and
     sequential tok/s after one prefill; on Q4_0 last, `python -m
     tts_tpu_torch.apps.server --warmup` as its own process (`warmup ok`
     before it listens, then two sampled requests)
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
  7. Parler-TTS mini v1, which runs the four matmul kernels and
     prefix_attention (its decode step's self-attention), not flash_decode:
     prefix_attention against its plain version (the masked read of the
     whole cache) at 16 heads of 64 over 4,096 slots, pos 63-4,095, timed
     from CUDA-graph replays beside its bound and scaled_dot_product_attention
     on the same live bf16 rows; tiny Q8_0 and Q4_0 models' CUDA forwards (8 GEMV steps
     at a device position, one 8-row GEMM verify) and DAC against the CPU,
     and their sampled and greedy rows on the graph route (one captured
     ParlerStep per key) equal to the eager route's; then seeded random
     full-width Q8_0 and Q4_0 GGUFs and a flan-t5-large-width T5 GGUF
     under smoke_models/, each Parler served through the port's server
     with torch's default math flags after its warmup() (which must
     capture the default key's graph): a sampled request, a greedy one
     (the speculative loop), a PCM stream (TTFA), a
     /v1/audio/conditional-prompt call and a sampled request on the new
     encoding, 256 rows each (wall, rows/s, route, RTF, load s, peak
     memory); the launch counts must show the int8 pair alone on Q8_0 and
     the int4 pair alone on Q4_0, exactly 192 GEMVs and 24 prefix_attention
     per sequential step (a replay counts what its capture launched), every
     GEMV of them the small-call instance, flash_decode 0; then the
     decode rounds: sampled rows/s of the eager and the graph route in
     alternating rounds (eager, graph, graph, eager) at one seed, rows
     equal and launches exact, the graph route faster in every pair, other
     sampling values on the same graph equal to their eager run, the device
     ms of one replay, and one row's device ms with the masked read
     captured in the kernel's place (before) and as it runs (after) at pos
     300, 1,000 and 2,000; the greedy bracket: speculative, force_miss and
     sequential (graph) rows/s after one prefill, and where the rows part;
     and a profiled graph-route request (device busy share)
  8. Dia-1.6B, which runs the format's GEMM (the CFG pair makes every
     decode step M = 2) and prefix_attention's head-major GQA instance (its
     decode step's self-attention): prefix_attention against its plain
     version (Dia's masked read of the whole cache) at the CFG pair of 16
     query heads over 4 KV heads of 128 in 3,072 slots, pos 63-3,071,
     timed from CUDA-graph replays beside its bound and
     scaled_dot_product_attention (enable_gqa) on the same live bf16 rows;
     tiny Q8_0 and Q4_0 models' CUDA forwards (8 steps
     at a device position, one 8-row verify at M = 16), cross-KV and DAC
     against the CPU, and their sampled and greedy rows on the graph route
     (one captured DiaStep per key) equal to the eager route's; then
     seeded random full-width Q8_0 and Q4_0 GGUFs under smoke_models/, each
     served through the port's server with torch's default math flags
     after its warmup() (which must capture the default key's graph): a
     sampled request, a greedy one (the speculative loop), a PCM stream
     (TTFA) and a second sampled request, 256 tokens each (wall, steps/s,
     route, RTF, load s, peak memory); the launch counts must be exact: the
     format's GEMM 36 per request (the cross-KV) plus 162 per step and per
     verify window, prefix_attention 18 per sequential step, the GEMVs,
     flash_decode and the other GEMM 0; then the decode rounds as in phase
     7 (steps/s, and one step's device ms with the masked read captured in
     the kernel's place and as it runs at pos 300, 1,000 and 2,000), the
     greedy bracket and one profiled graph-route request
  9. the apps on the card: a seeded random full-width f32 Parler-TTS mini v1
     quantized to Q4_0 and Q8_0 by `python -m tts_tpu_torch.apps.quantize`
     (the printed counts held to the Parler rule's, host seconds); the cli
     (tts_tpu_torch.apps.cli.main) in this process on each, 256 rows, and on
     the Q4_0 one again with --conditional-prompt and phase 7's T5, then on
     phase 5's Orpheus-3B Q4_0 with --vad (WAV rate and length held to the
     response; launches exact: the format's GEMV 192 per Parler row and GEMM
     192 per prefill, Orpheus 113 GEMVs and 28 flash_decode per step and 112
     GEMMs per prefill, everything else 0); `python -m tts_tpu_torch.apps.cli`
     once as its own process; perf_battery's JSON line on phase 6's
     Kokoro-82M and its Q8_0 (30 sentences, warmup 1, no kernel launched);
     phonemize against the runner's own phonemizer
 10. the parallel layer, on one card: the Kokoro duration trainer at Kokoro-82M's
     widths (phase 6's GGUF; f32, TF32 off), one step on cuda held to the same
     step on the CPU (loss, five gradients), then 5 steps of 8 x 128 padded
     tokens at mesh (1, 1) and (1, 2) = [cuda:0, cuda:0] (the loss falls; tp = 2
     losses within 1e-5 of tp = 1; ms per step, peak memory; the five kernels
     launch 0 times); phase 5's Orpheus-3B Q8_0 params cut over tp = 2 on
     [cuda:0, cuda:0] by make_tp_context (shard shapes, the KV cache split by KV
     heads), a greedy (speculative) and a sampled request through the
     tensor-parallel runner with exact launches (394 qgemv_int8 and 56
     flash_decode per decode step, 392 qgemm_int8 per prefill and 394 per verify
     window), its greedy tokens against the unsharded runner's up to a near-tie
     and both runners' sequential decode tok/s; Q4_0 stays at tp = 1; the
     server's --data-parallel serves a Kokoro-82M request from its one replica,
     and --tensor-parallel 2 raises on one card
 11. the last modules: core/native.py builds native/ggufc into build/ and its
     dequants and quant_q8_0 give the numpy codecs' bits on phase 4's
     Orpheus-3B Q8_0 and Q4_0 gate_proj; to_numpy over every tensor of phase
     9's Kokoro-82M Q8_0 and quantized Parler files with the library and with
     the numpy codecs alone (host s, bit-equal); tts_tpu_torch.tools.parity_report
     on phase 6's Kokoro-82M (no kernel launched; the durations' frames are the
     audio's; its audio peaks far past 1, so the reference is the first run's
     audio array, saved beside its 16-bit WAV as 32-bit float, not the
     clipped 16-bit WAV) and on phase 4's
     Orpheus-3B Q4_0 with --max-tokens 70 on the sequential route (launches
     exact: 113 qgemv_int4 and 28 flash_decode per step, 112 qgemm_int4 per
     prefill, the rest 0), each saving its WAV and then giving MATCH against
     it; tools.orpheus_step_breakdown on phase 5's Q8_0 runner and a Q4_0
     one at KV positions 320 and 3583 (body, head, sample, attn, linears from
     CUDA-graph replays, residue, graph step, eager step)
 12. bench_torch.py as its own process on phase 6's Kokoro-82M (no file
     rewritten): its JSON line, printed here, must parse, with the kernel
     smoke passed (qgemm_int8's CUDA kernel launched), complete, cold_buckets
     0 and a positive RTF
The line before the last is a JSON object of per-kernel results (each
kernel's launches on its Orpheus path, and by path); the last is
{"ok": true, "device": {...}}.  It imports only tts_tpu_torch, and fails if
jax or any module of the JAX package tts_tpu was imported.
"""

from __future__ import annotations

import gc
import io
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
import types
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
# the shards each of phase 10's tp = 2 Q8_0 linears runs (make_tp_context):
# qkv / gateup unfused, q/k/v/gate/up and the head (padded to 256 * tp
# columns) cut by columns, o/down by rows
TP2_SHAPES = {"tp2 q": (3072, 1536), "tp2 k/v": (3072, 512), "tp2 gate/up": (3072, 4096),
              "tp2 o": (1536, 3072), "tp2 down": (4096, 3072), "tp2 lm_head": (3072, 78848)}
GEMM_M = (8, 32)                   # beside the prompt lengths of phase 5's requests
GEMM_F32_SHAPES = ("down", "tp2 down")  # the GEMMs' f32-x rows (the prefill passes bf16 x)
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
# phase 7's prefix_attention rows: Parler-TTS mini v1's self-attention (16
# heads of 64, a 4,096-slot bf16 cache), at these positions, against the
# masked read of the whole cache; the sums differ in order only
PARLER_ATTN = (16, 64, 4096)
PARLER_ATTN_POSITIONS = (63, 511, 1023, 2047, 4095)
PARLER_ATTN_TOL = 1e-5
# positions at which phase 7 times one graph row with the kernel and with
# the masked read captured in its place
PARLER_ROW_POSITIONS = (300, 1000, 2000)
# phase 8's prefix_attention rows: Dia-1.6B's self-attention (the CFG pair
# of 16 query heads over 4 KV heads of 128, a head-major 3,072-slot bf16
# cache, unscaled), at these positions, against the masked read of the whole
# cache; the sums differ in order only
DIA_ATTN = (2, 4, 4, 128, 3072)          # (B, Hkv, G, hs, S)
DIA_ATTN_POSITIONS = (63, 511, 1023, 2047, 3071)
# positions at which phase 8 times one graph step with the kernel and with
# the masked read captured in its place
DIA_STEP_POSITIONS = (300, 1000, 2000)
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
DIA_BRACKET_TOKENS = 64            # the greedy bracket's requests
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
# phases 7-8: a row of Parler or a step of Dia adds one 512-sample DAC frame
# at 44.1 kHz, so decode keeps up with real time (RTF < 1) from 86.1 a second
REAL_TIME_RATE = round(44100 / 512, 1)
# the --warmup of phases 7-8's in-process servers: the cap of its three
# prompts and first chunk (random heads never stop)
AR_WARM_TOKENS = 48
ORPHEUS_BRACKET_TOKENS = 70        # phase 5's greedy bracket
# phase 5's --warmup: the cap of its three prompts and first chunk on the
# in-process server (random weights never emit the stop token)
WARM_TOKENS = 280
# phase 5's decode rounds (eager, graph, graph, eager; then other sampling
# values, graph and eager): one sampled request each
ROUND_TOKENS = 210
PROFILE_TOKENS = 140               # the profiled graph-route request
REPLAYS = 64                       # graph replays timed with CUDA events
SERVER_START_S = 300               # the --warmup server process: load, warmup, listen
# phase 5's requests to each model: (kind, /v1/audio/speech payload)
REQUESTS = (
    ("sampled", {"input": "Hello from the port, this is a first test.", "voice": "zoe",
                 "max_tokens": 280, "seed": 1}),
    ("sampled", {"input": "A second sampled request, with the server's sampling.",
                 "voice": "leo", "max_tokens": 280, "seed": 2}),
    ("greedy", {"input": "And a greedy one to finish.", "max_tokens": 280, "sample": False}),
)


_START = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    print(f"\n=== {name} === (at {time.perf_counter() - _START:.0f} s)", flush=True)


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


def prompt_lengths(payloads=None) -> list[int]:
    """The prefill M of each of phase 5's requests (or of `payloads`): the
    runner's prompt (voice prefix, special tokens) under the random models'
    tokenizer."""
    from tts_tpu_torch.convert.builder_orpheus import ORPHEUS_3B, orpheus_kv
    from tts_tpu_torch.models.orpheus import APPENDED_TOKENS, PREPENDED_TOKENS
    from tts_tpu_torch.text.tokenizers import BPETokenizer

    kv = orpheus_kv(**{k: ORPHEUS_3B[k] for k in ("n_layers", "hidden", "heads", "kv_heads",
                                                  "head_dim", "vocab")})
    tok = BPETokenizer.from_gguf_kv(kv)
    lengths = []
    for payload in payloads or [p for _, p in REQUESTS]:
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
            tile_n, splits, _ = tq.gemv_plan(K, N, sms, bits == 4)[:3]
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
    # phase 10's tp = 2 prefills and verify windows
    tp2_ms = sorted(set(GEMM_M) | set(prompt_lengths([{"input": t} for t in TP_TEXTS])))
    parler_ms = parler_gemm_lengths()
    for bits, fn, plain, tpu_line, ms_list, iters in (
            (8, tq.qgemv_int8, tq.qgemv_int8_plain, "tts_tpu/ops/qmatmul.py:144", (1,), 20),
            (4, tq.qgemv_int4, tq.qgemv_int4_plain, "tts_tpu/ops/qmatmul.py:367", (1,), 20),
            (8, tq.qgemm_int8, tq.qgemm_int8_plain, "tts_tpu/ops/qmatmul.py:134", gemm_ms, 10),
            (4, tq.qgemm_int4, tq.qgemm_int4_plain, "tts_tpu/ops/qmatmul.py:350", gemm_ms, 10)):
        rows = []
        gemv = ms_list == (1,)
        tol = GEMV_TOL if gemv else GEMM_TOL
        # the tp = 2 shards run Q8_0 only: Q4_0 stays whole (make_tp_context)
        orpheus = {**LINEAR_SHAPES, **(TP2_SHAPES if bits == 8 else {})}
        for i, (name, (K, N)) in enumerate(orpheus.items()):
            ws = rotating_weights(K, N, dev, 100 * (not gemv) + i + bits, int4=bits == 4)
            f32 = name.endswith("lm_head") if gemv else name in GEMM_F32_SHAPES
            m_values = tp2_ms if name in TP2_SHAPES and not gemv else ms_list
            runs = [(M, torch.bfloat16) for M in m_values] + [
                (M, torch.float32) for M in m_values if f32]
            for M, xdtype in runs:
                x = torch.randn((M, K), device=dev).to(xdtype)
                rows.append(measure(fn, plain, bits, f"{name} M={M} x={str(xdtype)[6:]}", K, N,
                                    M, x, ws, tol, iters, name in ("qkv", "o", "gateup", "down")))
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

    # flash_decode over Orpheus-3B's heads, and over the stripe of them
    # (12 query heads on 4 KV heads) that each of phase 10's tp = 2 cache
    # shards holds
    rows = []
    g = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (hq, hkv), quant in itertools.product(((HQ, HKV), (HQ // 2, HKV // 2)), (False, True)):
        if quant:
            k = torch.randint(-127, 128, (hkv, S_CACHE, HS), generator=g, device=dev,
                              dtype=torch.int8)
            v = torch.randint(-127, 128, (hkv, S_CACHE, HS), generator=g, device=dev,
                              dtype=torch.int8)
            ks = torch.rand((hkv, S_CACHE), generator=g, device=dev) * 0.02 + 1e-3
            vs = torch.rand((hkv, S_CACHE), generator=g, device=dev) * 0.02 + 1e-3
        else:
            k = torch.randn((hkv, S_CACHE, HS), generator=g, device=dev).bfloat16()
            v = torch.randn((hkv, S_CACHE, HS), generator=g, device=dev).bfloat16()
            ks = vs = None
        q = torch.randn((hq, HS), generator=g, device=dev)
        counters = ta.arrival_counters(hkv, dev)
        kind = "int8" if quant else "bf16"
        for pos in FLASH_POSITIONS:
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
            a, r = rel_err(ta.flash_decode(q, k, v, pos_t, ks, vs, counters), want)
            names = [e["name"] for e in _ext.device_activity(
                lambda: ta.flash_decode(q, k, v, pos_t, ks, vs, counters))]
            label = f"{kind} Hq={hq} Hkv={hkv} pos={pos}"
            check(len(names) == 1, f"flash_decode {label}: {len(names)} device kernels per "
                  f"call ({names}), not 1")
            fns = {"plain": lambda j: ta.flash_decode_plain(q, k, v, pos, ks, vs),
                   "kernel": lambda j: ta.flash_decode(q, k, v, pos_t, ks, vs, counters)}
            lr = None
            if not quant:
                # the yardstick: one PyTorch call on the live prefix, bf16 q
                qb, kl, vl = q.bfloat16()[None, :, None], k[None, :, :pos + 1], v[None, :, :pos + 1]
                fns["library"] = lambda j: sdpa(qb, kl, vl, enable_gqa=True)
                _, lr = rel_err(fns["library"](0).reshape(hq, HS), want)
            t = timed(fns, {"plain": 3, "kernel": 20, "library": 20})
            live = (pos + 1) * hkv
            nbytes = 2 * hq * HS * 4 + live * (2 * HS * k.element_size() + (8 if quant else 0))
            rows.append(row(f"{kind} Hq={hq} Hkv={hkv} S={S_CACHE} pos={pos}", a, r,
                            t["kernel"], t["plain"], nbytes, 4 * hq * (pos + 1) * HS,
                            t.get("library"), lr, device_kernels=len(names)))
            gbs = nbytes / (t["kernel"] * 1e-3) / 1e9
            lib = f"  library {t['library'] * 1e3:7.1f} us" if "library" in t else ""
            lib_note = f"  (library rel_err {lr:.1e})" if lr is not None else ""
            print(f"flash_decode {kind} Hq={hq:2d} Hkv={hkv} pos={pos:4d}  rel_err {r:.2e} "
                  f"(tol {FLASH_TOL:.0e})  "
                  f"kernel {t['kernel'] * 1e3:7.1f} us  plain {t['plain'] * 1e3:8.1f} us{lib}  "
                  f"bound {rows[-1]['bound_ms'] * 1e3:5.2f} us  {gbs:7.1f} GB/s  "
                  f"{len(names)} device kernel per call{lib_note}")
            check(r < FLASH_TOL, f"flash_decode {label}: rel err {r} >= {FLASH_TOL}")
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
                                    tq.qgemm_int4, ta.flash_decode, ta.prefix_attention)}


def small_launches() -> dict:
    """{name: .small_launches} of the GEMV wrappers: their launches that
    took the small-call instance (ops/qmatmul.py gemv_plan)."""
    from tts_tpu_torch.ops import qmatmul as tq

    return {k.__name__: k.small_launches for k in (tq.qgemv_int8, tq.qgemv_int4)}


def reset_small_launches():
    from tts_tpu_torch.ops import qmatmul as tq

    tq.qgemv_int8.small_launches = tq.qgemv_int4.small_launches = 0


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


def orpheus_forwards():
    """Count Orpheus forwards by kind in one Counter: "prefill" and
    "verify" from `_orpheus_body` at T > 1, "step" from `DecodeGraph.run`
    (one decode step on the card: a graph replay, the first step and its
    capture, or an eager step; the body a step runs is not counted again);
    returns (counter, restore)."""
    import collections

    from tts_tpu_torch.models import orpheus as tor

    calls: collections.Counter = collections.Counter()
    body, run = tor._orpheus_body, tor.DecodeGraph.run

    def counted_body(params, cfg, tokens, positions, cache, start=0):
        if tokens.shape[0] > 1:
            calls["verify" if start else "prefill"] += 1
        return body(params, cfg, tokens, positions, cache, start)

    def counted_run(self):
        calls["step"] += 1
        return run(self)

    tor._orpheus_body, tor.DecodeGraph.run = counted_body, counted_run

    def restore():
        tor._orpheus_body, tor.DecodeGraph.run = body, run
    return calls, restore


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


def server(path: str, qtype: str) -> tuple[dict, object]:
    """Serve 3 requests and a greedy PCM stream from one full-width model
    after the server's --warmup; returns the launch counts of that run,
    every counter set to 0 just before it, and the runner.  Then the decode
    rounds, eager against graph, and (Q4_0) the server as its own process
    with --warmup."""
    phase(f"5 server, Orpheus-3B {qtype}")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers, warmup
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
    t0 = time.perf_counter()
    check(warmup(state, GenerationConfig(top_k=50, max_tokens=WARM_TOKENS)), "--warmup failed")
    graph = runner._steps.get(("graph", 50, True, False))
    check(graph is not None and graph.graph is not None,
          f"--warmup captured no decode graph of the default key: {list(runner._steps)}")
    print(f"--warmup (the server's warmup(): its three prompts and a streamed first chunk, "
          f"{WARM_TOKENS} tokens each): {time.perf_counter() - t0:.1f} s; decode steps "
          f"captured: {[k for k, v in runner._steps.items() if v.graph is not None]}")
    torch.cuda.reset_peak_memory_stats()
    responses = []
    generate = runner.generate

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
    forwards, restore = orpheus_forwards()
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    reset_small_launches()
    walls = []
    try:
        for kind, payload in REQUESTS:
            t = time.perf_counter()
            status, body, ctype = _post(port, payload)
            wall = time.perf_counter() - t
            walls.append(wall)
            check(status == 200 and ctype == "audio/wav", f"{kind}: HTTP {status} {ctype}: "
                  f"{body[:200]!r}")
            resp = responses[-1]
            steps = resp.timings["decode_steps"]
            route = resp.timings["decode_route"]
            check(route == ("graph" if kind == "sampled" else "spec"),
                  f"{kind}: decode route {route}")
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
                  f" ({route})  codec {resp.timings['codec_ms']:6.1f} ms  audio {n / 24000:.3f} s  "
                  f"RTF {wall / (n / 24000):.3f}")
        print(f"first request after --warmup: wall {walls[0] * 1e3:.1f} ms; the second "
              f"(same length, same key): {walls[1] * 1e3:.1f} ms")
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
    small = small_launches()
    check(not any(small.values()), f"Orpheus-3B's GEMVs took the small-call instance: {small}")
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
          f" (the runner keeps its KV cache and decode graph), max_memory_allocated during "
          f"the requests {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    summary = {"ttfa_ms": ttfa * 1e3, "first_wall_ms": walls[0] * 1e3,
               "second_wall_ms": walls[1] * 1e3, "rounds": decode_rounds(runner, qtype),
               "bracket": orpheus_bracket(runner, REQUESTS[2][1]["input"])}
    if qtype == "Q4_0":
        summary["server_process"] = server_process(path)
    print(json.dumps({f"orpheus_{qtype}": summary}))
    return counts, runner


def decode_rounds(runner, qtype: str) -> dict:
    """Sampled decode tok/s of the eager and the graph route in alternating
    rounds (eager, graph, graph, eager) of one ROUND_TOKENS request through
    runner.generate at one seed, every round's tokens equal and the launches
    exact; then a request with another temperature and penalty on the same
    key (the same captured graph), graph then eager: equal to each other,
    not to the first config's; the device ms of one graph replay (CUDA
    events over REPLAYS replays); and one profiled graph-route request."""
    import dataclasses

    import torch

    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.runtime.api import GenerationConfig
    from tts_tpu_torch.utils.trace import profile_request

    text = REQUESTS[0][1]["input"]
    a = GenerationConfig(top_k=50, seed=11, max_tokens=ROUND_TOKENS, voice="zoe")
    b = dataclasses.replace(a, temperature=0.7, repetition_penalty=1.2)
    seen = []
    loop = tor.orpheus_decode_loop

    def recording(*args, **kw):
        out = loop(*args, **kw)
        seen.append(out[0])
        return out

    tor.orpheus_decode_loop = recording
    forwards, restore = orpheus_forwards()
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    rates: dict = {"eager": [], "graph": []}
    toks: dict = {}
    try:
        for route, config in (("eager", a), ("graph", a), ("graph", a), ("eager", a),
                              ("graph", b), ("eager", b)):
            runner.decode_route = route
            resp = runner.generate(text, config)
            check(resp.timings["decode_route"] == route,
                  f"rounds: a {route} request took {resp.timings['decode_route']}")
            toks.setdefault((route, config is a), []).append(seen[-1])
            rate = len(seen[-1]) / (resp.timings["decode_ms"] / 1e3)
            if config is a:
                rates[route].append(rate)
            print(f"[{qtype}] round {route:5s} temperature {config.temperature} penalty "
                  f"{config.repetition_penalty}: {len(seen[-1])} tokens decoded at "
                  f"{rate:6.1f} tok/s, wall {resp.timings['decode_ms']:8.1f} ms")
    finally:
        counts = _kernel_counts()
        restore()
        tor.orpheus_decode_loop = loop
        runner.decode_route = "graph"
    gemv, gemm = PATH_KERNELS[qtype]
    per = LAYERS * LINEARS_PER_LAYER
    want = dict.fromkeys(counts, 0)
    want.update({gemv: (per + 1) * forwards["step"] + forwards["prefill"],
                 gemm: per * forwards["prefill"], "flash_decode": LAYERS * forwards["step"]})
    print(f"[{qtype}] launches over the rounds (forwards {dict(forwards)}): {counts}")
    check(counts == want and forwards["prefill"] == 6, f"rounds: launches {counts}, not {want}")
    first = toks[("eager", True)][0]
    check(all(t == first for k, ts_ in toks.items() if k[1] for t in ts_),
          f"[{qtype}] the graph and eager rounds' tokens differ at one seed")
    check(toks[("graph", False)] == toks[("eager", False)],
          f"[{qtype}] other sampling values: graph and eager tokens differ")
    check(toks[("graph", False)][0] != first,
          f"[{qtype}] other sampling values gave the first config's tokens")
    step = runner._decode_step(a)
    check(step.graph is not None, "no captured graph after the rounds")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        for _ in range(REPLAYS):
            step.graph.replay()
        end.record()
        end.synchronize()
    replay_ms = start.elapsed_time(end) / REPLAYS
    graph_rate = sum(rates["graph"]) / len(rates["graph"])
    print(f"[{qtype}] sampled decode tok/s in rounds eager, graph, graph, eager: "
          f"{rates['eager'][0]:.1f}, {rates['graph'][0]:.1f}, {rates['graph'][1]:.1f}, "
          f"{rates['eager'][1]:.1f}; tokens equal at one seed in all four; other values "
          f"(temperature 0.7, penalty 1.2) on the same graph equal their eager run")
    print(f"[{qtype}] one graph replay: {replay_ms:.3f} ms of device time (CUDA events, "
          f"{REPLAYS} replays) -> {1e3 / replay_ms:.1f} tok/s bound; the graph rounds' decode "
          f"keeps the device busy ~{graph_rate * replay_ms / 1e3:.1%} of their wall")
    prof = profile_request(runner, text, dataclasses.replace(a, max_tokens=PROFILE_TOKENS))
    print(f"[{qtype}] profiled graph-route request ({PROFILE_TOKENS} tokens): wall "
          f"{prof['wall_ms']:.1f} ms (unprofiled {prof['unprofiled_wall_ms']:.1f}), device busy "
          f"{prof['device_busy_ms']:.1f} ms = {prof['device_busy_share_of_unprofiled_wall']:.1%} "
          f"of the unprofiled wall, {prof['device_kernels']} device kernels; top: "
          + "; ".join(f"{k['name'][:60]} x{k['calls']} {k['device_ms']:.1f} ms"
                      for k in prof["top_kernels"][:5]))
    return {"tok_per_s": rates, "replay_ms": replay_ms, "profile": {
        k: prof[k] for k in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                             "device_busy_share_of_unprofiled_wall", "device_kernels")}}


def server_process(path: str) -> dict:
    """`python -m tts_tpu_torch.apps.server --warmup` as its own process on
    `path`: it must print `warmup ok` before its listening line, then
    answer two sampled requests (walls of the first and the second); the
    process is ended after."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tts_tpu_torch.apps.server", "--model-path",
                             path, "--port", str(port), "--warmup"], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines: list = []

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while not any("listening" in line for line in lines):
            check(proc.poll() is None and time.perf_counter() - t0 < SERVER_START_S,
                  f"server --warmup: not listening (exit {proc.poll()}): {lines[-10:]}")
            time.sleep(0.5)
        start_s = time.perf_counter() - t0
        listening = next(i for i, line in enumerate(lines) if "listening" in line)
        check("warmup ok" in lines[:listening], f"server --warmup: {lines[:listening]}")
        walls = []
        for kind, payload in REQUESTS[:2]:
            t = time.perf_counter()
            status, body, ctype = _post(port, payload)
            walls.append(time.perf_counter() - t)
            with wave.open(io.BytesIO(body)) as wf:
                n = wf.getnframes()
            check(status == 200 and n == (payload["max_tokens"] // 7) * 4 * 512,
                  f"server process {kind}: HTTP {status}, {n} samples")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    warm = [line for line in lines[:listening] if "warm" in line]
    print(f"python -m tts_tpu_torch.apps.server --warmup (Q4_0, its own process): listening "
          f"{start_s:.1f} s after its start ({warm}); first request wall "
          f"{walls[0] * 1e3:.1f} ms, second {walls[1] * 1e3:.1f} ms")
    return {"listening_s": start_s, "first_wall_ms": walls[0] * 1e3,
            "second_wall_ms": walls[1] * 1e3}


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


def _kokoro_config():
    from tts_tpu_torch.runtime.api import GenerationConfig

    return GenerationConfig(voice="af_heart", seed=0)


def kokoro() -> dict:
    """Phase 6; returns the five kernels' launch counts over the Kokoro
    requests, every counter set to 0 just before them."""
    phase("6 Kokoro-82M")
    import contextlib
    import dataclasses

    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.convert.builder_kokoro import KokoroDims, write_kokoro_gguf
    from tts_tpu_torch.utils.trace import profile_request

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

    responses = []
    generate = runner.generate
    recording = contextlib.ExitStack()
    chunks = recording.enter_context(model.recording_chunks())

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
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
        frames = model.chunk_frames(chunks, "af_heart")
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
            frames = model.chunk_frames(chunks, "af_heart")
            check(n == 600 * sum(frames), f"pcm stream: {n} samples for {frames} frames")
        summary["ttfa_http_ms"] = sorted(ttfa)[1]
        print(f"pcm stream through the server (generate_stream): time to its first bytes "
              f"{summary['ttfa_http_ms']:.1f} ms (median of 3), {len(chunks)} chunks, "
              f"{n / 24000:.3f} s of audio")
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        runner.generate = generate
        recording.close()
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
    dur = model.chunk_frames([tokens], "af_heart")[0]
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

    prof = profile_request(runner, HARVARD[0], _kokoro_config(),
                           os.path.join(MODEL_DIR, "kokoro_profile.json"))
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


def tiny_graph_vs_eager(r, model: str, text: str):
    """A tiny Parler's or Dia's cuda runner decodes sampled and greedy
    (sequential: TTS_TPU_NO_SPEC set) requests on the graph route and on
    the eager route at one seed: the rows must be equal; a second graph
    request replays the first one's capture."""
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.runtime.api import GenerationConfig

    mod, name = (tp, "parler_decode_loop") if model == "parler" else (td, "dia_decode_loop")
    seen = []
    loop = getattr(mod, name)

    def recording(*args, **kw):
        out = loop(*args, **kw)
        seen.append(out[0])
        return out

    setattr(mod, name, recording)
    os.environ["TTS_TPU_NO_SPEC"] = "1"
    try:
        for sample in (True, False):
            config = GenerationConfig(seed=7, top_k=50, max_tokens=40, sample=sample)
            rows = {}
            for route in ("eager", "graph", "graph"):
                r.decode_route = route
                check(r.generate(text, config).timings["decode_route"] == route,
                      f"tiny {model}: not the {route} route")
                rows.setdefault(route, []).append(seen[-1])
            check(all(np.array_equal(g, rows["eager"][0]) for g in rows["graph"]),
                  f"tiny {model} ({'sampled' if sample else 'greedy'}): the graph route's rows "
                  f"differ from the eager route's at one seed")
    finally:
        os.environ.pop("TTS_TPU_NO_SPEC")
        setattr(mod, name, loop)
        r.decode_route = "graph"
    captured = [k for k, v in r._steps.items() if v.graph is not None]
    check(len(captured) == 2, f"tiny {model}: graphs captured {captured}")
    print(f"tiny {model} graph route: sampled and greedy rows ({len(seen[-1])} each) equal to the "
          f"eager route's at one seed, captured {captured}")


def prefix_attention_rows(label: str, q, k, v, counters, positions, scale, library,
                          kv_per_pos: int) -> list:
    """prefix_attention's kernel rows for one model's layout: q against the
    layers' caches k and v ([layers, ...] bf16) at `positions`: against its
    plain version (the masked read of the whole cache, here on the card)
    within PARLER_ATTN_TOL of max|out|, one device kernel per call,
    identical bits twice; device times from CUDA-graph replays (plain,
    kernel, library, library, kernel, plain) cycling through the layers'
    caches, so that past a few hundred positions the live rows come from
    HBM, as in a decode step, beside the bound (the live K/V, q and out over
    3.35 TB/s) and `library(layer, pos)`, scaled_dot_product_attention on
    the same live bf16 rows (bf16 q: the library yardstick, which the port
    never calls).  kv_per_pos: K elements a position."""
    import torch

    from tts_tpu_torch.ops import _ext
    from tts_tpu_torch.ops import attention as ta

    layers = k.shape[0]
    rows = []
    for pos in positions:
        pos_t = torch.tensor([pos], dtype=torch.int32, device=q.device)
        want = ta.prefix_attention_plain(q, k[0], v[0], pos_t, scale)
        got = ta.prefix_attention(q, k[0], v[0], pos_t, counters, scale)
        a, r = rel_err(got, want)
        names = [e["name"] for e in _ext.device_activity(
            lambda: ta.prefix_attention(q, k[0], v[0], pos_t, counters, scale))]
        check(len(names) == 1 and "prefix_attention_kernel" in names[0],
              f"prefix_attention {label} pos={pos}: device kernels per call {names}")
        check(torch.equal(got, ta.prefix_attention(q, k[0], v[0], pos_t, counters, scale)),
              f"prefix_attention {label} pos={pos}: two calls differ")
        fns = {"plain": lambda j: ta.prefix_attention_plain(q, k[j % layers], v[j % layers],
                                                            pos_t, scale),
               "kernel": lambda j: ta.prefix_attention(q, k[j % layers], v[j % layers], pos_t,
                                                       counters, scale),
               "library": lambda j: library(j % layers, pos)}
        _, lr = rel_err(fns["library"](0).reshape(want.shape), want)
        t = timed(fns, {"plain": 3, "kernel": 2 * layers, "library": 2 * layers})
        nbytes = (pos + 1) * kv_per_pos * 2 * 2 + 2 * q.numel() * 4
        rows.append({"shape": f"{label} pos={pos}", "abs": a, "rel": r,
                     "ms": t["kernel"], "plain_ms": t["plain"],
                     "bound_ms": bound(nbytes, 4 * q.numel() * (pos + 1))[0], "bound_by": "bytes",
                     "library_ms": t["library"], "library_rel": lr, "device_kernels": 1})
        gbs = nbytes / (t["kernel"] * 1e-3) / 1e9
        print(f"prefix_attention bf16 {label} pos={pos:4d}  rel_err {r:.2e} (tol "
              f"{PARLER_ATTN_TOL:.0e})  kernel {t['kernel'] * 1e3:6.2f} us  plain "
              f"{t['plain'] * 1e3:8.1f} us  library {t['library'] * 1e3:6.2f} us  bound "
              f"{rows[-1]['bound_ms'] * 1e3:5.2f} us  {gbs:7.1f} GB/s  1 device kernel per call  "
              f"(library rel_err {lr:.1e}, bf16 q)")
        check(r < PARLER_ATTN_TOL, f"prefix_attention {label} pos={pos}: rel err {r} >= "
              f"{PARLER_ATTN_TOL}")
    check(not counters.any(), f"prefix_attention left its counters at {counters.tolist()}")
    return rows


def parler_attention() -> list:
    """Phase 7's kernel rows: prefix_attention (Parler's decode-step
    self-attention) at Parler-TTS mini v1's shapes, 16 heads of 64 over a
    position-major 4,096-slot bf16 cache, 24 layers' caches (403 MB per K
    and V), at PARLER_ATTN_POSITIONS (`prefix_attention_rows`)."""
    import torch

    from tts_tpu_torch.ops import attention as ta

    dev = torch.device("cuda")
    H, hs, S = PARLER_ATTN
    g = torch.Generator(device=dev).manual_seed(18)
    k = torch.randn((PARLER_LAYERS, S, H, hs), generator=g, device=dev).bfloat16()
    v = torch.randn((PARLER_LAYERS, S, H, hs), generator=g, device=dev).bfloat16()
    q = torch.randn((1, H, hs), generator=g, device=dev)
    qb = q.bfloat16().transpose(0, 1)[None]                          # [1, H, 1, hs]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(layer, pos):
        return sdpa(qb, k[layer, :pos + 1].transpose(0, 1)[None],
                    v[layer, :pos + 1].transpose(0, 1)[None])

    rows = prefix_attention_rows(f"H={H} hs={hs} S={S}", q, k, v, ta.arrival_counters(H, dev),
                                 PARLER_ATTN_POSITIONS, None, library, H * hs)
    del k, v
    torch.cuda.empty_cache()
    return rows


def dia_attention() -> list:
    """Phase 8's kernel rows: prefix_attention's head-major GQA instance
    (Dia's decode-step self-attention) at Dia-1.6B's shapes, the CFG pair
    of 16 query heads over 4 KV heads of 128 in a head-major 3,072-slot bf16
    cache, scale 1.0, 18 layers' caches (113 MB per K and V), at
    DIA_ATTN_POSITIONS (`prefix_attention_rows`; the library call is
    scaled_dot_product_attention with enable_gqa)."""
    import torch

    from tts_tpu_torch.ops import attention as ta

    dev = torch.device("cuda")
    B, Hkv, G, hs, S = DIA_ATTN
    g = torch.Generator(device=dev).manual_seed(21)
    k = torch.randn((DIA_LAYERS, B, Hkv, S, hs), generator=g, device=dev).mul_(0.3).bfloat16()
    v = torch.randn((DIA_LAYERS, B, Hkv, S, hs), generator=g, device=dev).bfloat16()
    q = torch.randn((B, Hkv * G, hs), generator=g, device=dev)
    qb = q.bfloat16()[:, :, None]                                    # [B, Hq, 1, hs]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(layer, pos):
        return sdpa(qb, k[layer, :, :, :pos + 1], v[layer, :, :, :pos + 1], scale=1.0,
                    enable_gqa=True)

    rows = prefix_attention_rows(f"Dia B={B} Hkv={Hkv} G={G} hs={hs} S={S}", q, k, v,
                                 ta.arrival_counters(B * Hkv, dev), DIA_ATTN_POSITIONS, 1.0,
                                 library, B * Hkv * hs)
    del k, v
    torch.cuda.empty_cache()
    return rows


def prefix_attention_record(rows: list) -> dict:
    """prefix_attention's record for the kernels JSON line, from phase 7's
    (Parler) and phase 8's (Dia) rows."""
    return {"name": "prefix_attention", "route": "cuda",
            "source": "tts_tpu_torch/csrc/prefix_attention.cu",
            "replaces": "none (the masked reads of tts_tpu/models/parler.py::_transformer and "
                        "tts_tpu/models/dia.py::_dia_step, plain jnp)",
            "max_abs_err": max(r["abs"] for r in rows), "max_rel_err": max(r["rel"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows), "rows": rows}


def replay_before_after(before, after, positions, tag: str) -> dict:
    """One graph replay's device ms of the step `before` (the masked read
    captured in the kernel's place) and of `after` (the runner's own step),
    at each position, each the mean of REPLAYS replays (CUDA events) in the
    order before, after, after, before."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms: dict = {}
    with torch.inference_mode():
        for pos in positions:
            for label, step in (("before", before), ("after", after), ("after", after),
                                ("before", before)):
                step.pos.fill_(pos)
                start.record()
                for _ in range(REPLAYS):
                    step.graph.replay()
                end.record()
                end.synchronize()
                ms.setdefault(pos, {}).setdefault(label, []).append(
                    start.elapsed_time(end) / REPLAYS)
    out = {pos: {k: sum(v) / len(v) for k, v in m.items()} for pos, m in ms.items()}
    print(f"[{tag}] one graph step, device ms (before: the masked read captured in the "
          f"kernel's place; after: prefix_attention), {REPLAYS} replays each, before, after, "
          f"after, before: " + "; ".join(f"pos {p}: {m['before']:.3f} -> {m['after']:.3f}"
                                        for p, m in out.items()))
    return out


def capture_masked_read(mod, before, after, masked_read, loop_state, limit: int):
    """Capture `before`, a step of `after`'s key over the same cache, with
    `masked_read` in the place of model module `mod`'s prefix_attention:
    the step as it ran before the kernel.  Its capture launches no
    prefix_attention."""
    import torch

    from tts_tpu_torch.ops import attention as ta

    kernel = mod.prefix_attention
    mod.prefix_attention = masked_read
    n = ta.prefix_attention.launches
    try:
        with torch.inference_mode():
            before.load(loop_state, limit,
                        {"last": after.state["last"], "count": after.state["count"]})
            before.run()                           # the eager step and the capture
    finally:
        mod.prefix_attention = kernel
    check(before.graph is not None and ta.prefix_attention.launches == n,
          f"the masked-read {before.label} step launched prefix_attention")


def parler_row_before_after(runner, qtype: str) -> dict:
    """One graph row's device ms, before and after (`replay_before_after`):
    the runner's own step (prefix_attention) against the same step
    captured with the masked read of the whole cache in its place (one mask
    a forward, every layer's cache widened to f32 under it), at
    PARLER_ROW_POSITIONS."""
    import torch

    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.ops import attention as ta
    from tts_tpu_torch.runtime.api import GenerationConfig

    after = runner._decode_step(GenerationConfig(top_k=50, seed=11), runner.cross_kv)
    check(after.graph is not None, "no captured graph of the rounds' key")
    before = tp.ParlerStep(runner.params, runner.cfg, runner._cache, runner.cross_kv,
                           runner._generator, runner.device, top_k=after.top_k,
                           do_sample=after.do_sample, use_top_p=after.use_top_p, capture=True)
    masks: dict = {}

    def masked_read(q, k, v, pos, counters=None, scale=None):
        # one mask a forward (the capture makes its own), the whole cache
        # read under it in every layer
        key = (pos.data_ptr(), torch.cuda.is_current_stream_capturing())
        if key not in masks:
            key_pos = torch.arange(k.shape[0], device=k.device)
            masks[key] = torch.where(key_pos[None, :] <= pos[:, None], 0.0, -1e9)
        return ta.attend(q, k, v, masks[key])

    capture_masked_read(tp, before, after, masked_read, tp.init_loop_state(runner.cfg),
                        PARLER_ROW_POSITIONS[0])
    out = replay_before_after(before, after, PARLER_ROW_POSITIONS, f"parler {qtype}")
    del before
    return out


def dia_step_before_after(runner, qtype: str) -> dict:
    """One graph step's device ms, before and after (`replay_before_after`):
    the runner's own step (prefix_attention) against the same step
    captured with Dia's masked read of the whole cache in its place (one
    mask a forward repeated over a KV head's query rows, every layer's
    cache widened to f32 under it, no scale), at DIA_STEP_POSITIONS."""
    import torch

    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.runtime.api import GenerationConfig

    after = runner._decode_step(GenerationConfig(top_k=50, seed=11))
    check(after.graph is not None, "no captured Dia graph of the rounds' key")
    before = td.DiaStep(runner.params, runner.cfg, runner._cache, runner._cross,
                        runner._generator, runner.device, top_k=after.top_k,
                        do_sample=after.do_sample, use_top_p=after.use_top_p, capture=True)
    masks: dict = {}

    def masked_read(q, k, v, pos, counters=None, scale=None):
        B, Hkv, S, hs = k.shape
        G = q.shape[1] // Hkv
        key = (pos.data_ptr(), torch.cuda.is_current_stream_capturing())
        if key not in masks:
            key_pos = torch.arange(S, device=k.device)
            masks[key] = torch.where(key_pos[None, :] <= pos[:, None], 0.0, -1e9).repeat(G, 1)
        logits = torch.matmul(q.reshape(B, Hkv, G, hs), k.float().transpose(2, 3)) + masks[key]
        return torch.matmul(torch.softmax(logits, dim=-1), v.float()).reshape(B, -1)

    capture_masked_read(td, before, after, masked_read, td.dia_init_loop_state(runner.cfg),
                        runner.cfg.max_generation_size)
    out = replay_before_after(before, after, DIA_STEP_POSITIONS, f"dia {qtype}")
    del before
    return out


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
        if dev == "cuda":
            tiny_graph_vs_eager(r, "parler", "hello world")
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


def ar_forwards(module, body: str, step_cls):
    """Count Parler or Dia forwards by kind in one Counter: "step" from
    `step_cls.run` (one decode step on the card: a graph replay, the first
    step and its capture, or an eager step; the body a step runs is not
    counted again), "verify" from `module.body` at T > 1 (the speculative
    verify window); returns (counter, restore)."""
    import collections

    calls: collections.Counter = collections.Counter()
    fn, run = getattr(module, body), step_cls.run

    def counted_body(params, cfg, rows, *args, **kw):
        if rows.shape[0] > 1:
            calls["verify"] += 1
        return fn(params, cfg, rows, *args, **kw)

    def counted_run(self):
        calls["step"] += 1
        return run(self)

    setattr(module, body, counted_body)
    step_cls.run = counted_run

    def restore():
        setattr(module, body, fn)
        step_cls.run = run
    return calls, restore


def ar_warmup(state, runner, key: tuple) -> float:
    """The server's warmup() on a Parler or Dia default model, its prompts
    capped at AR_WARM_TOKENS: it must capture the decode graph of the
    default sampling key (`key` in runner._steps).  Returns its seconds."""
    from tts_tpu_torch.apps.server import warmup
    from tts_tpu_torch.runtime.api import GenerationConfig

    t0 = time.perf_counter()
    check(warmup(state, GenerationConfig(top_k=50, max_tokens=AR_WARM_TOKENS)), "--warmup failed")
    secs = time.perf_counter() - t0
    step = runner._steps.get(key)
    check(step is not None and step.graph is not None,
          f"--warmup captured no decode graph of the default key {key}: {list(runner._steps)}")
    print(f"--warmup (the server's warmup(): its three prompts and a streamed first chunk, "
          f"{AR_WARM_TOKENS} tokens each): {secs:.1f} s; decode steps captured: "
          f"{[k for k, v in runner._steps.items() if v.graph is not None]}")
    return secs


def print_profile(label: str, what: str, prof: dict):
    """One line of a profile_request result: wall, device busy share, top
    kernels."""
    print(f"[{label}] profiled graph-route request ({what}): wall {prof['wall_ms']:.1f} ms "
          f"(unprofiled {prof['unprofiled_wall_ms']:.1f}), device busy "
          f"{prof['device_busy_ms']:.1f} ms = {prof['device_busy_share_of_unprofiled_wall']:.1%} "
          f"of the unprofiled wall, {prof['device_kernels']} device kernels; top: "
          + "; ".join(f"{k['name'][:60]} x{k['calls']} {k['device_ms']:.1f} ms"
                      for k in prof["top_kernels"][:5]))


def ar_decode_rounds(runner, model: str, qtype: str) -> dict:
    """Phases 7-8's decode rounds: sampled rows/s (Parler) or steps/s (Dia)
    of the eager and the graph route in alternating rounds (eager, graph,
    graph, eager) of one request of PARLER_MAX_TOKENS rows or DIA_MAX_TOKENS
    tokens through runner.generate at one seed, every round's rows equal and
    the launches exact (Parler: the format's GEMV 192 and prefix_attention
    24 per step and its GEMM 192 per prefill; Dia: the format's GEMM 162
    per step and 36 per encode, prefix_attention 18 per step; everything
    else 0); then a request with another temperature
    and penalty on the same key (the same captured graph), graph then
    eager: equal to each other, not to the first config's; and the device
    ms of one graph replay (CUDA events over REPLAYS replays)."""
    import dataclasses

    import torch

    from tts_tpu_torch.runtime.api import GenerationConfig

    if model == "parler":
        from tts_tpu_torch.models import parler as mod
        loop_name, body, cls, unit = "parler_decode_loop", "_rows_logits", mod.ParlerStep, "rows"
        text, n_tok, per = PARLER_TEXTS[0], PARLER_MAX_TOKENS, PARLER_LAYERS * PARLER_LINEARS
    else:
        from tts_tpu_torch.models import dia as mod
        loop_name, body, cls, unit = "dia_decode_loop", "_dia_rows", mod.DiaStep, "steps"
        text, n_tok, per = DIA_TEXTS[0], DIA_MAX_TOKENS, DIA_LAYERS * DIA_LINEARS
    a = GenerationConfig(top_k=50, seed=11, max_tokens=n_tok)
    b = dataclasses.replace(a, temperature=0.7, repetition_penalty=1.2)
    seen = []
    loop = getattr(mod, loop_name)

    def recording(*args, **kw):
        out = loop(*args, **kw)
        seen.append(out[0])
        return out

    setattr(mod, loop_name, recording)
    forwards, restore = ar_forwards(mod, body, cls)
    for kernel in launch_counters().values():
        kernel.launches = 0
    rates: dict = {"eager": [], "graph": []}
    rows: dict = {}
    rounds = (("eager", a), ("graph", a), ("graph", a), ("eager", a), ("graph", b), ("eager", b))
    try:
        for route, config in rounds:
            runner.decode_route = route
            resp = runner.generate(text, config)
            check(resp.timings["decode_route"] == route,
                  f"rounds: a {route} request took {resp.timings['decode_route']}")
            rows.setdefault((route, config is a), []).append(seen[-1])
            rate = len(seen[-1]) / (resp.timings["decode_ms"] / 1e3)
            if config is a:
                rates[route].append(rate)
            print(f"[{model} {qtype}] round {route:5s} temperature {config.temperature} penalty "
                  f"{config.repetition_penalty}: {len(seen[-1])} {unit} decoded at "
                  f"{rate:6.1f} {unit}/s, wall {resp.timings['decode_ms']:8.1f} ms")
    finally:
        counts = _kernel_counts()
        restore()
        setattr(mod, loop_name, loop)
        runner.decode_route = "graph"
    gemv, gemm = PATH_KERNELS[qtype]
    want = dict.fromkeys(counts, 0)
    if model == "parler":
        want.update({gemv: per * forwards["step"], gemm: per * len(rounds),
                     "prefix_attention": PARLER_LAYERS * forwards["step"]})
    else:
        want.update({gemm: per * forwards["step"] + 2 * DIA_LAYERS * len(rounds),
                     "prefix_attention": DIA_LAYERS * forwards["step"]})
    print(f"[{model} {qtype}] launches over the rounds (forwards {dict(forwards)}): {counts}")
    check(counts == want and not forwards["verify"], f"rounds: launches {counts}, not {want}")
    first = rows[("eager", True)][0]
    check(all(np.array_equal(r, first) for k, rs in rows.items() if k[1] for r in rs),
          f"[{model} {qtype}] the graph and eager rounds' rows differ at one seed")
    check(np.array_equal(rows[("graph", False)][0], rows[("eager", False)][0]),
          f"[{model} {qtype}] other sampling values: graph and eager rows differ")
    check(not np.array_equal(rows[("graph", False)][0], first),
          f"[{model} {qtype}] other sampling values gave the first config's rows")
    step = runner._decode_step(a, runner.cross_kv) if model == "parler" else runner._decode_step(a)
    check(step.graph is not None, "no captured graph after the rounds")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        for _ in range(REPLAYS):
            step.graph.replay()
        end.record()
        end.synchronize()
    replay_ms = start.elapsed_time(end) / REPLAYS
    graph_rate = sum(rates["graph"]) / len(rates["graph"])
    print(f"[{model} {qtype}] sampled decode {unit}/s in rounds eager, graph, graph, eager: "
          f"{rates['eager'][0]:.1f}, {rates['graph'][0]:.1f}, {rates['graph'][1]:.1f}, "
          f"{rates['eager'][1]:.1f}; rows equal at one seed in all four; other values "
          f"(temperature 0.7, penalty 1.2) on the same graph equal their eager run")
    print(f"[{model} {qtype}] one graph replay: {replay_ms:.3f} ms of device time (CUDA events, "
          f"{REPLAYS} replays) -> {1e3 / replay_ms:.1f} {unit}/s bound; the graph rounds' decode "
          f"keeps the device busy ~{graph_rate * replay_ms / 1e3:.1%} of their wall; real time "
          f"needs {REAL_TIME_RATE} {unit}/s")
    check(min(rates["graph"]) > max(rates["eager"]),
          f"[{model} {qtype}] the graph route is not faster than eager in every pair: {rates}")
    return {f"{unit}_per_s": rates, "replay_ms": replay_ms, "forwards": dict(forwards)}


def parler_bracket(runner, text: str) -> dict:
    """Greedy rows/s of one 256-row request decoded three ways after the
    same prefill: the speculative loop, its force_miss floor (every draft
    rejected: one row per 8-row forward), and the sequential loop (on the
    runner's captured step of the greedy key); the
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
            cross, generator, state, limit = runner._prefill(ids, config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                got, _, _ = tp.parler_decode_loop(runner.params, cfg, len(ids), limit,
                                                  runner._cache, cross, generator, state,
                                                  tp.init_loop_state(cfg),
                                                  step=runner._decode_step(config, cross),
                                                  **runner._sample_kw(config))
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
    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.runtime.api import GenerationConfig
    from tts_tpu_torch.utils.trace import profile_request

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
    warm_s = ar_warmup(state, runner, ("graph", 50, True, False, False))
    torch.cuda.reset_peak_memory_stats()
    responses = []
    generate = runner.generate

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
    forwards, restore = ar_forwards(tp, "_rows_logits", tp.ParlerStep)
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    reset_small_launches()
    summary = {"load_s": load_s, "load_timings": runner.load_timings, "warmup_s": warm_s,
               "requests": {}}

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
        route = resp.timings["decode_route"]
        check(steps == PARLER_MAX_TOKENS, f"{kind}: {steps} rows, not {PARLER_MAX_TOKENS}")
        check(route == ("spec" if payload.get("sample") is False else "graph"),
              f"{kind}: decode route {route}")
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
              f"{m['decode_rows_per_s']:6.1f} rows/s ({route})  codec {m['codec_ms']:6.1f} ms  "
              f"{frames} frames, audio {m['audio_s']:.3f} s  RTF {m['rtf']:.3f}")
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
        restore()
        runner.generate = generate
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    print(f"launches over the Parler {qtype} requests (forwards {dict(forwards)}): {counts}")
    sequential = 3 * PARLER_MAX_TOKENS     # rows of the three sampled requests
    per = PARLER_LAYERS * PARLER_LINEARS
    gemv, gemm = PATH_KERNELS[qtype]
    check(counts[gemv] == per * forwards["step"] and forwards["step"] >= sequential,
          f"{gemv} launched {counts[gemv]}, not {per} per sequential step ({dict(forwards)}, "
          f"{sequential} rows)")
    small = small_launches()
    check(small[gemv] == counts[gemv], f"{small[gemv]} of the {counts[gemv]} {gemv} launches "
          f"took the small-call instance, not all {per} of each row")
    print(f"the small-call instance: {small}")
    check(counts[gemm] >= per * (4 + PARLER_MAX_TOKENS // 8) + 2 * PARLER_LAYERS,
          f"{gemm} launched {counts[gemm]} < 4 prefills, one greedy request's verify windows "
          f"and one cross-KV precompute")
    check(counts["prefix_attention"] == PARLER_LAYERS * forwards["step"],
          f"prefix_attention launched {counts['prefix_attention']}, not {PARLER_LAYERS} per "
          f"sequential step ({dict(forwards)})")
    check(counts["flash_decode"] == 0, f"the Parler path launched flash_decode {counts}")
    for other in PATH_KERNELS.values():
        if other != (gemv, gemm):
            check(counts[other[0]] == counts[other[1]] == 0,
                  f"the Parler {qtype} path launched {other}: {counts}")
    print(f"max_memory_allocated during the requests {summary['max_memory_allocated_mib']:.0f} "
          f"MiB over what was allocated before the load (weights, cache, T5 while encoding)")
    summary["rounds"] = ar_decode_rounds(runner, "parler", qtype)
    summary["row_before_after"] = parler_row_before_after(runner, qtype)
    summary["bracket"] = parler_bracket(runner, PARLER_TEXTS[1])
    prof = profile_request(runner, PARLER_TEXTS[0],
                           GenerationConfig(seed=1, top_k=50, max_tokens=PARLER_PROFILE_ROWS),
                           os.path.join(MODEL_DIR, f"parler_{qtype}_profile.json"))
    print_profile(f"Parler {qtype}", f"{PARLER_PROFILE_ROWS} rows", prof)
    print(json.dumps({f"parler_{qtype}_profile": prof}))
    summary["profile"] = {k: prof[k] for k in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                                               "device_busy_share",
                                               "device_busy_share_of_unprofiled_wall")}
    return counts, summary


def parler() -> tuple[dict, list]:
    """Phase 7; returns the launch counts of each Parler path's served
    requests, and prefix_attention's kernel rows at Parler's shapes."""
    phase("7 Parler-TTS mini v1: prefix_attention, tiny models cuda against cpu")
    import torch

    os.makedirs(MODEL_DIR, exist_ok=True)
    attention = parler_attention()
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
    return counts, attention


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
        if dev == "cuda":
            tiny_graph_vs_eager(r, "dia", DIA_TEXTS[0])
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
    sequential loop (on the runner's captured step of the greedy key); the
    first row where each parts from the sequential rows.  Launches made here are not counted for the path."""
    import torch

    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.runtime.api import GenerationConfig

    cfg = runner.cfg
    config = GenerationConfig(sample=False, seed=0, max_tokens=DIA_BRACKET_TOKENS)
    ids = runner._prompt_ids(text, config)
    rows, rates = {}, {}
    for mode in ("spec", "force_miss", "sequential"):
        with torch.inference_mode():
            cross, generator, state = runner._encode(ids, config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                got, _, _ = td.dia_decode_loop(runner.params, cfg, DIA_BRACKET_TOKENS,
                                               cfg.max_generation_size, runner._cache, cross,
                                               generator, state, td.dia_init_loop_state(cfg),
                                               step=runner._decode_step(config),
                                               **runner._sample_kw(config))
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
    from tts_tpu_torch.utils.trace import profile_request

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
    warm_s = ar_warmup(state, runner, ("graph", 50, True, False))
    torch.cuda.reset_peak_memory_stats()
    responses = []
    generate = runner.generate

    def recording_generate(text, config=None):
        resp = generate(text, config)
        responses.append(resp)
        return resp

    runner.generate = recording_generate
    forwards, restore_rows = ar_forwards(td, "_dia_rows", td.DiaStep)
    encodes, restore_cross = _counting(td, "dia_cross_kv", lambda *a: "encode")
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    summary = {"load_s": load_s, "load_timings": runner.load_timings, "load_mib": load_mib,
               "warmup_s": warm_s, "requests": {}}
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
        route = resp.timings["decode_route"]
        check(steps == steps_want and frames == frames_want,
              f"{kind}: {steps} steps and {frames} frames, not {steps_want} and {frames_want}")
        check(route == ("spec" if payload.get("sample") is False else "graph"),
              f"{kind}: decode route {route}")
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
              f"{m['decode_steps_per_s']:6.1f} steps/s ({route})  codec {m['codec_ms']:6.1f} ms  "
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
    check(counts["prefix_attention"] == DIA_LAYERS * forwards["step"],
          f"prefix_attention launched {counts['prefix_attention']}, not {DIA_LAYERS} per step: "
          f"{dict(forwards)}")
    others = [k for k in counts if k not in (gemm, "prefix_attention")]
    check(not any(counts[k] for k in others), f"the Dia {qtype} path launched {counts}")
    summary["forwards"] = dict(forwards)
    print(f"max_memory_allocated during the requests {summary['max_memory_allocated_mib']:.0f} "
          f"MiB over what was allocated before the load (weights, caches, activations)")
    summary["rounds"] = ar_decode_rounds(runner, "dia", qtype)
    summary["step_before_after"] = dia_step_before_after(runner, qtype)
    summary["bracket"] = dia_bracket(runner, DIA_TEXTS[1])
    prof = profile_request(runner, DIA_TEXTS[0],
                           GenerationConfig(seed=1, top_k=50, max_tokens=DIA_PROFILE_TOKENS),
                           os.path.join(MODEL_DIR, f"dia_{qtype}_profile.json"))
    print_profile(f"Dia {qtype}", f"{DIA_PROFILE_TOKENS - 1} steps", prof)
    print(json.dumps({f"dia_{qtype}_profile": prof}))
    summary["profile"] = {k: prof[k] for k in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                                               "device_busy_share",
                                               "device_busy_share_of_unprofiled_wall",
                                               "device_kernels")}
    return counts, summary


def dia() -> tuple[dict, list]:
    """Phase 8; returns the launch counts of each Dia path's served
    requests, and prefix_attention's kernel rows at Dia's shapes."""
    phase("8 Dia-1.6B: prefix_attention, tiny models cuda against cpu")
    import torch

    os.makedirs(MODEL_DIR, exist_ok=True)
    attention = dia_attention()
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
    return counts, attention


# ------------------------------------------------------------------ apps ---
# phase 9: the port's apps on the models phases 5-7 wrote
APPS_ORPHEUS_TOKENS = 280          # the cli's Orpheus request, as phase 5's
APPS_PROCESS_TIMEOUT = 600         # seconds, for each app run as its own process
# the perf_battery report (tts_tpu/apps/perf_battery.py's keys)
BATTERY_KEYS = {"model", "sentences", "mean_generation_ms", "median_generation_ms",
                "mean_codec_ms", "total_audio_seconds", "real_time_factor",
                "p50_time_to_first_audio_ms"}
PHONEMIZE_TEXTS = (HARVARD[0], "It's 42 degrees at 7:30, Dr. Smith.",
                   "The NASA probe sent 1,024 frames in 2026!")


def _kernel_counts() -> dict:
    return {k: c.launches for k, c in launch_counters().items()}


def _run_python(argv: list[str]) -> tuple[str, float]:
    """`python argv` as its own process from the repo root (its stderr
    passed through); returns (stdout, host seconds).  Fails on a non-zero
    exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=APPS_PROCESS_TIMEOUT)
    secs = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-4000:])
    check(proc.returncode == 0, f"python {' '.join(argv[:2])}: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout, secs


def _cli_stages(stdout: str) -> dict:
    """The cli's `<stage> = <value> ms` lines as {stage: value}."""
    out = {}
    for line in stdout.splitlines():
        key, sep, rest = line.partition(" = ")
        if sep and rest.endswith(" ms"):
            out[key] = float(rest[:-3])
    return out


def _run_cli(argv: list[str]) -> tuple[str, object, object]:
    """tts_tpu_torch.apps.cli.main(argv) in this process, its stdout echoed;
    returns (stdout, the runner, the response its generate returned).  The
    registry's runner_from_file is wrapped to record them; the cli calls
    nothing else differently."""
    import contextlib

    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.models import registry

    seen = {}
    load = registry.runner_from_file

    def recording_load(*args, **kw):
        runner = seen["runner"] = load(*args, **kw)
        generate = runner.generate

        def recording_generate(text, config=None):
            resp = seen["resp"] = generate(text, config)
            return resp
        runner.generate = recording_generate
        return runner

    registry.runner_from_file = recording_load
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        registry.runner_from_file = load
    print("  " + buf.getvalue().rstrip().replace("\n", "\n  "))
    check(rc == 0, f"cli {argv}: exit {rc}")
    return buf.getvalue(), seen["runner"], seen["resp"]


def _check_wav(path: str, rate: int, samples: int, label: str):
    with wave.open(path) as wf:
        check(wf.getframerate() == rate, f"{label}: rate {wf.getframerate()}, not {rate}")
        check(wf.getnframes() == samples > 0, f"{label}: {wf.getnframes()} samples in the "
              f"WAV, not {samples}")


def apps_quantize_parler(card: str) -> tuple[dict, dict]:
    """Write the f32 full-width Parler-TTS mini v1 and quantize it to Q8_0
    and Q4_0 by `python -m tts_tpu_torch.apps.quantize`; the printed counts
    must be the Parler rule's for the file.  Returns ({qtype: path},
    metrics)."""
    from tts_tpu_torch.apps import quantize
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler
    from tts_tpu_torch.core.gguf import GGMLType, GGUFFile

    f32 = os.path.join(MODEL_DIR, "parler_mini_v1_f32_seed0.gguf")
    t0 = time.perf_counter()
    write_random_parler(f32, seed=0, qtype="F32", **PARLER_MINI_V1)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(f32)
    print(f"[{card}] wrote {os.path.relpath(f32, ROOT)}: {size / 1e9:.3f} GB in "
          f"{write_s:.1f} host s")
    metrics = {"f32_gb": size / 1e9, "f32_write_host_s": write_s}
    with GGUFFile(f32) as f:
        rule = quantize._QUANTIZABLE[f.architecture]
        rows = [(n, t.ggml_type, t.n_elements, t.shape[-1]) for n, t in f.tensors.items()]
    paths = {}
    for qtype in QTYPES:
        params = quantize.QuantizationParams(quantize.VALID_TYPES[qtype])
        n_quant = sum(1 for name, ggml_type, n, last in rows
                      if ggml_type == GGMLType.F32 and rule(name, params)
                      and n % 32 == 0 and last % 32 == 0)
        check(n_quant == PARLER_LAYERS * PARLER_LINEARS, f"the Parler rule quantizes {n_quant} "
              f"tensors, not the {PARLER_LINEARS} decoder linears per layer")
        out = os.path.join(MODEL_DIR, f"parler_mini_v1_f32_to_{qtype[:2].lower()}.gguf")
        stdout, secs = _run_python(["-m", "tts_tpu_torch.apps.quantize", "--model-path", f32,
                                    "--quantized-model-path", out, "--quantized-type", qtype])
        want = f"quantized={n_quant} f16=0 passthrough={len(rows) - n_quant} -> {out}"
        check(stdout.strip() == want, f"quantize {qtype} printed {stdout.strip()!r}, not "
              f"{want!r}")
        print(f"[{card}] quantize {qtype}: {stdout.strip().split(' -> ')[0]}, "
              f"{os.path.getsize(out) / 1e9:.3f} GB in {secs:.1f} host s (a process of its "
              f"own: interpreter and torch import, read, quantize, write)")
        metrics[f"quantize_{qtype}_host_s"] = secs
        metrics[f"{qtype}_gb"] = os.path.getsize(out) / 1e9
        paths[qtype] = out
    os.remove(f32)
    return paths, metrics


def apps_cli_parler(card: str, path: str, qtype: str,
                    t5_path: str | None) -> tuple[dict, dict]:
    """The cli in this process on a quantized Parler: one request of
    PARLER_MAX_TOKENS rows, and with `t5_path` a second one after
    --conditional-prompt.  Launches exact: the format's GEMV 192 per row
    (8 quantized linears in each of 24 layers; the default quantize keeps
    the cross-attention k/v dense, so the cross-KV and the T5 encoding run
    no kernel), prefix_attention 24 per row and its GEMM 192 per prefill;
    everything else 0."""
    import torch

    wav = os.path.join(MODEL_DIR, f"apps_parler_{qtype}.wav")
    base = ["--model-path", path, "--prompt", PARLER_TEXTS[0], "--save-path", wav,
            "--max-tokens", str(PARLER_MAX_TOKENS), "--seed", "0"]
    runs = [("plain", base)]
    if t5_path:
        runs.append(("conditional-prompt", base + ["--conditional-prompt", PARLER_DESCRIPTION,
                                                   "--text-encoder-path", t5_path]))
    for kernel in launch_counters().values():
        kernel.launches = 0
    rows, metrics, audio = 0, {}, {}
    for label, argv in runs:
        stdout, runner, resp = _run_cli(argv)
        stages = _cli_stages(stdout)
        steps, frames = resp.timings["decode_steps"], resp.timings["frames"]
        check(stages["decode_steps"] == steps == PARLER_MAX_TOKENS,
              f"cli {qtype} {label}: {steps} rows")
        check(stages["frames"] == frames and len(resp.audio) == 512 * frames,
              f"cli {qtype} {label}: {len(resp.audio)} samples for {frames} frames")
        check(resp.timings["prompt_tokens"] in parler_gemm_lengths(),
              f"cli {qtype} {label}: prefill M={resp.timings['prompt_tokens']} was not checked "
              f"in phase 3")
        _check_wav(wav, 44100, len(resp.audio), f"cli {qtype} {label}")
        check(f"wrote {len(resp.audio)} samples" in stdout, f"cli {qtype} {label}: no wrote line")
        check(bool(np.isfinite(resp.audio).all()) and float(np.abs(resp.audio).max()) > 0,
              f"cli {qtype} {label}: non-finite or silent audio")
        key = "wq4" if qtype == "Q4_0" else "wq"
        layer = runner.params["layers"][0]
        check(all(key in layer[n] for n in ("sa_q", "ca_q", "fc1", "fc2"))
              and "w" in layer["ca_k"] and "w" in layer["ca_v"],
              f"cli {qtype}: linears not as the quantize rule left them")
        rtf = float(next(line for line in stdout.splitlines()
                         if line.startswith("rtf = ")).split()[2])
        dec_s = resp.timings["decode_ms"] / 1e3
        metrics[label] = {"rtf_incl_load": rtf, "decode_rows_per_s": steps / dec_s,
                          "rows": steps, "audio_s": resp.duration_s,
                          "load_s": runner.load_timings.get("total_s")}
        print(f"[{card}] cli Parler {qtype} {label}: {steps} rows at {steps / dec_s:.1f} rows/s, "
              f"{resp.duration_s:.3f} s of audio, rtf {rtf:.4f} (the cli's line: host wall of "
              f"main() incl. model load {runner.load_timings.get('total_s', 0):.2f} s; the "
              f"kernels were built in phase 2)")
        rows += steps
        audio[label] = resp.audio
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    if t5_path:
        check(not (audio["plain"].shape == audio["conditional-prompt"].shape
                   and np.array_equal(audio["plain"], audio["conditional-prompt"])),
              "cli: the conditional prompt did not change the audio")
    counts = _kernel_counts()
    per = PARLER_LAYERS * PARLER_LINEARS
    gemv, gemm = PATH_KERNELS[qtype]
    want = {k: 0 for k in counts}
    want[gemv], want[gemm] = per * rows, per * len(runs)
    want["prefix_attention"] = PARLER_LAYERS * rows
    print(f"launches over the cli's Parler {qtype} runs ({rows} rows, {len(runs)} prefills): "
          f"{counts}")
    check(counts == want, f"cli Parler {qtype}: launches {counts}, not {want}")
    return counts, metrics


def apps_cli_orpheus(card: str, path: str) -> tuple[dict, dict]:
    """The cli in this process on phase 5's Orpheus-3B Q4_0 with --vad,
    APPS_ORPHEUS_TOKENS tokens sampled (the sequential loop): launches
    exact against the forwards it ran, as in phase 5."""
    from tts_tpu_torch.runtime.vad import trim_silence

    kind, payload = REQUESTS[0]
    wav = os.path.join(MODEL_DIR, "apps_orpheus_q4.wav")
    forwards, restore = orpheus_forwards()
    for kernel in launch_counters().values():
        kernel.launches = 0
    try:
        stdout, runner, resp = _run_cli(["--model-path", path, "--prompt", payload["input"],
                                         "--voice", payload["voice"], "--save-path", wav,
                                         "--max-tokens", str(APPS_ORPHEUS_TOKENS), "--seed", "0",
                                         "--vad"])
    finally:
        counts = _kernel_counts()
        restore()
    steps = resp.timings["decode_steps"]
    check(steps == APPS_ORPHEUS_TOKENS and len(resp.audio) == (steps // 7) * 4 * 512,
          f"cli Orpheus: {len(resp.audio)} samples for {steps} tokens")
    check(resp.timings["prompt_tokens"] in prompt_lengths(),
          f"cli Orpheus: prefill M={resp.timings['prompt_tokens']} was not checked in phase 3")
    trimmed = trim_silence(resp.audio, 24000)
    _check_wav(wav, 24000, len(trimmed), "cli Orpheus --vad")
    check(f"wrote {len(trimmed)} samples" in stdout, "cli Orpheus: no wrote line")
    check(dict(forwards) == {"prefill": 1, "step": steps - 1},
          f"cli Orpheus: forwards {dict(forwards)} for {steps} tokens")
    per = LAYERS * LINEARS_PER_LAYER
    want = {k: 0 for k in counts}
    want.update(qgemv_int4=(per + 1) * (steps - 1) + 1, qgemm_int4=per,
                flash_decode=LAYERS * (steps - 1))
    print(f"launches over the cli's Orpheus Q4_0 run ({steps} tokens, forwards "
          f"{dict(forwards)}): {counts}")
    check(counts == want, f"cli Orpheus: launches {counts}, not {want}")
    rtf = float(next(line for line in stdout.splitlines()
                     if line.startswith("rtf = ")).split()[2])
    dec_s = resp.timings["decode_ms"] / 1e3
    metrics = {"rtf_incl_load": rtf, "decode_tok_per_s": steps / dec_s, "tokens": steps,
               "audio_s": resp.duration_s, "vad_kept_s": len(trimmed) / 24000,
               "load_s": runner.load_timings.get("total_s")}
    print(f"[{card}] cli Orpheus-3B Q4_0 --vad: {steps} tokens at {steps / dec_s:.1f} tok/s, "
          f"{resp.duration_s:.3f} s of audio, {len(trimmed) / 24000:.3f} s kept by the VAD, rtf "
          f"{rtf:.4f} (host wall of main() incl. model load {metrics['load_s']:.2f} s)")
    return counts, metrics


def apps_cli_process(card: str, path: str) -> dict:
    """`python -m tts_tpu_torch.apps.cli` as its own process on the Q4_0
    Parler (default --device cuda): exit 0, the rtf line and the WAV."""
    wav = os.path.join(MODEL_DIR, "apps_parler_process.wav")
    stdout, secs = _run_python(["-m", "tts_tpu_torch.apps.cli", "--model-path", path,
                                "--prompt", PARLER_TEXTS[0], "--save-path", wav,
                                "--max-tokens", str(PARLER_MAX_TOKENS), "--seed", "0"])
    print("  " + stdout.rstrip().replace("\n", "\n  "))
    stages = _cli_stages(stdout)
    rtf_lines = [line for line in stdout.splitlines() if line.startswith("rtf = ")]
    check(len(rtf_lines) == 1, "python -m tts_tpu_torch.apps.cli printed no rtf line")
    check(stages.get("decode_steps") == PARLER_MAX_TOKENS, f"cli process: {stages}")
    _check_wav(wav, 44100, 512 * int(stages["frames"]), "cli process")
    rtf = float(rtf_lines[0].split()[2])
    # what a fresh process pays before any model work, inside main() (which
    # imports torch lazily, as JAX's cli imports jax): the torch import and
    # the CUDA context
    probe, _ = _run_python(["-c", "import time; t0 = time.perf_counter(); import torch; "
                            "t1 = time.perf_counter(); torch.zeros(1, device='cuda'); "
                            "torch.cuda.synchronize(); print(t1 - t0, time.perf_counter() - t1)"])
    import_s, cuda_s = map(float, probe.split())
    print(f"[{card}] python -m tts_tpu_torch.apps.cli (Parler Q4_0): rtf {rtf:.4f} (main()'s host "
          f"wall over the audio: the torch import, the CUDA context, the model load, the "
          f"request), {secs:.1f} host s for the whole process; a fresh process's torch import "
          f"takes {import_s:.2f} host s and its first CUDA tensor {cuda_s:.2f} host s")
    return {"rtf_incl_load": rtf, "process_host_s": secs, "torch_import_host_s": import_s,
            "cuda_init_host_s": cuda_s}


def apps_battery(card: str) -> tuple[dict, dict]:
    """perf_battery's JSON line on phase 6's Kokoro-82M and on its Q8_0 by
    the port's quantize: 30 sentences, warmup 1; the five kernels launch 0
    times."""
    from tts_tpu_torch.apps import perf_battery, quantize

    f32 = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    q8 = os.path.join(MODEL_DIR, "kokoro82m_q8_seed0.gguf")
    t0 = time.perf_counter()
    stats = quantize.quantize_gguf(f32, q8, quantize.QuantizationParams(
        quantize.VALID_TYPES["Q8_0"]))
    print(f"[{card}] quantize Kokoro-82M Q8_0 in this process: {stats}, "
          f"{time.perf_counter() - t0:.1f} host s")
    check(stats["quantized"] > 0, "Kokoro Q8_0: nothing quantized")
    for kernel in launch_counters().values():
        kernel.launches = 0
    import contextlib

    reports = {}
    for name, path in (("f32", f32), ("Q8_0", q8)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = perf_battery.main(["--model-path", path, "--json", "--warmup", "1"])
        lines = buf.getvalue().splitlines()
        check(rc == 0 and len(lines) == 1, f"perf_battery {name}: exit {rc}, {len(lines)} lines")
        report = json.loads(lines[0])
        check(set(report) == BATTERY_KEYS, f"perf_battery {name}: keys {sorted(report)}")
        check(report["sentences"] == 30 and math.isfinite(report["real_time_factor"])
              and report["real_time_factor"] > 0, f"perf_battery {name}: {report}")
        print(f"[{card}] perf_battery Kokoro-82M {name}: {lines[0]}")
        reports[name] = report
    counts = _kernel_counts()
    check(not any(counts.values()), f"the battery launched {counts}")
    return counts, reports


def apps_phonemize(card: str):
    """apps/phonemize.py on the Kokoro GGUF prints what the runner's own
    phonemizer gives."""
    import contextlib

    from tts_tpu_torch.apps import phonemize
    from tts_tpu_torch.models.registry import runner_from_file

    path = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    runner = runner_from_file(path, device="cuda")
    for text in PHONEMIZE_TEXTS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = phonemize.main(["--phonemizer-path", path, "--prompt", text])
        want = runner.phonemizer.text_to_phonemes(text)
        check(rc == 0 and buf.getvalue() == want + "\n",
              f"phonemize {text!r}: {buf.getvalue()!r}, runner {want!r}")
        print(f"phonemize {text!r} -> {want!r} (= the runner's phonemizer)")


def apps(card: str, orpheus_q4: str) -> dict:
    """Phase 9; returns the launch counts of each app path."""
    phase("9 apps: quantize, cli, perf_battery, phonemize")
    import torch

    t5 = os.path.join(MODEL_DIR, "flan_t5_large_f16_seed0.gguf")
    check(os.path.exists(t5) and os.path.exists(orpheus_q4), "phase 9 needs phases 5 and 7's "
          "models")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    summary = {"card": card}
    counts = {}
    paths, summary["quantize"] = apps_quantize_parler(card)
    counts["apps_Q4_0"], summary["cli_Q4_0"] = apps_cli_parler(card, paths["Q4_0"], "Q4_0", t5)
    counts["apps_Q8_0"], summary["cli_Q8_0"] = apps_cli_parler(card, paths["Q8_0"], "Q8_0", None)
    counts["apps_orpheus"], summary["cli_orpheus"] = apps_cli_orpheus(card, orpheus_q4)
    summary["cli_process"] = apps_cli_process(card, paths["Q4_0"])
    counts["apps_kokoro"], summary["battery"] = apps_battery(card)
    apps_phonemize(card)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    print(json.dumps({"apps": summary}))
    return counts


# ---------------------------------------------------------------- phase 10 ---
TRAIN_BATCH = (8, 128)             # examples x tokens of a trainer step, trailing pads
TRAIN_CHECK_BATCH = (2, 32)        # the step held to the CPU
TRAIN_STEPS = 5
TRAIN_LR = 1e-4                    # the trainer's default (optax.adam's in the JAX package); at
                                   # 1e-3 the loss swings (1.51, 0.019, 6.63, ...) and Adam turns
                                   # gradients that are ~0 in f32 (ALBERT's q_w) into lr-sized
                                   # steps in noise-given directions, so tp = 2 and tp = 1 part
TRAIN_LOSS_TOL = 1e-4              # the step's loss, cuda against cpu (f32, TF32 off)
TRAIN_GRAD_TOL = 1e-3              # its gradients, of each tensor's peak
TRAIN_TP_RTOL = 1e-5               # tp = 2 losses against tp = 1, same card, TF32 off
TP_TOKENS = 70                     # tokens of each tp = 2 request and of the decode bracket
TP_LINEARS = 7                     # q, k, v, o, gate, up, down: fusion is undone under TP
# the tp = 2 prompts whose prefill logits are held to the unsharded runner's;
# the first also drives the requests and the decode brackets
TP_TEXTS = ("A tensor-parallel request on one card.", HARVARD[3], HARVARD[6])
TP_TEXT = TP_TEXTS[0]
TP_LOGIT_TOL = 5e-2                # tp = 2 logits against unsharded, of their peak (bf16 x)
TP_ROUNDS = 3                      # unsharded and tp = 2 decode brackets, alternately


def _train_batch(model, shape, seed: int):
    """A padded batch at Kokoro-82M's vocabulary: row 0 full, the others
    cut at random lengths past half; the voice pack's prosody rows; target
    durations of 1-12 frames per token, as a teacher's vary by phoneme (a
    constant target is fit in a few steps, and the loss then measures
    residuals: at 5 frames it fell to 1% of its start in 4 steps)."""
    B, T = shape
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, T))
    lengths = rng.integers(T // 2, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    pack = model.params["voices"]["af_heart"].float().cpu().numpy()
    rows = pack[np.minimum(np.maximum(lengths - 3, 0), len(pack) - 1)]
    style = rows[:, cfg.style_half_size:2 * cfg.style_half_size].copy()
    return tokens, mask, style, rng.integers(1, 13, (B, T)).astype(np.float32)


def _trainer_step_grads(model, device, batch) -> tuple[float, dict]:
    """One trainer step on a (1, 1) mesh of `device`: its loss and the
    gradients of five leaves across the graph (none of them zero in exact
    arithmetic, as ALBERT's k_b is)."""
    import torch

    from tts_tpu_torch.parallel.mesh import make_mesh
    from tts_tpu_torch.parallel.training import DurationTrainer

    trainer = DurationTrainer(model.cfg, make_mesh(devices=[torch.device(device)]), TRAIN_LR)
    params, opt = trainer.init(model.params)
    _, _, loss = trainer.train_step(params, opt, *batch)
    L, dp = params["albert"]["layers"][0], params["dp"]
    leaves = {"albert v_w": L["v_w"][0], "albert ffn_out_w": L["ffn_out_w"][0],
              "dp encode_w": dp["encode_w"],
              "duration lstm w_hh": dp["duration_lstm"]["fwd"]["w_hh"],
              "duration_proj_w": dp["duration_proj_w"]}
    return float(loss), {k: v.grad.float().cpu() for k, v in leaves.items()}


def parallel_trainer(card: str) -> tuple[dict, dict]:
    """Phase 10 (a): the duration trainer at Kokoro-82M's widths (phase 6's
    GGUF), TF32 off: one step on cuda held to the same step on the CPU,
    then TRAIN_STEPS steps at mesh (1, 1) and (1, 2) = [cuda:0, cuda:0];
    returns (the five kernels' launches over those steps, summary)."""
    import torch

    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models.kokoro import KokoroModel
    from tts_tpu_torch.parallel.mesh import make_mesh
    from tts_tpu_torch.parallel.training import DurationTrainer

    path = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    check(os.path.exists(path), "phase 10 needs phase 6's Kokoro-82M")
    with GGUFFile(path) as f:
        cpu_model = KokoroModel.from_gguf(f, "cpu")
        model = KokoroModel.from_gguf(f, "cuda")
    batch = _train_batch(model, TRAIN_CHECK_BATCH, seed=10)
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = _trainer_step_grads(cpu_model, "cpu", batch)
    cpu_s = time.perf_counter() - t0
    loss_gpu, grads_gpu = _trainer_step_grads(model, "cuda", batch)
    errs = {k: ((grads_gpu[k] - g).abs().max().item(), g.abs().max().item())
            for k, g in grads_cpu.items()}
    print(f"trainer step at {TRAIN_CHECK_BATCH}: loss cuda {loss_gpu!r}, cpu {loss_cpu!r} "
          f"(cpu step {cpu_s:.2f} s); gradient max error / peak: "
          + ", ".join(f"{k} {e:.2e} / {p:.2e}" for k, (e, p) in errs.items()))
    check(abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_TOL * abs(loss_cpu),
          f"trainer loss cuda {loss_gpu} against cpu {loss_cpu}")
    check(all(e <= TRAIN_GRAD_TOL * p for e, p in errs.values()),
          f"trainer gradients cuda against cpu: {errs}")
    del cpu_model

    batch = _train_batch(model, TRAIN_BATCH, seed=11)
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    cuda0 = torch.device("cuda", 0)
    runs = {}
    for tp in (1, 2):
        trainer = DurationTrainer(model.cfg, make_mesh(tp, tp=tp, devices=[cuda0] * tp),
                                  TRAIN_LR)
        params, opt = trainer.init(model.params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            _, _, loss = trainer.train_step(params, opt, *batch)
            losses.append(float(loss))                  # reads the loss: synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        runs[f"tp{tp}"] = {"losses": losses, "ms_per_step": ms,
                           "ms_per_step_warm": float(np.mean(ms[1:])),
                           "peak_mib_over_params": peak / 2**20}
        print(f"trainer mesh (1, {tp}) on {card}: {TRAIN_BATCH[0]} x {TRAIN_BATCH[1]} tokens, "
              f"losses {losses}, ms per step {[round(m, 1) for m in ms]} (warm mean "
              f"{runs[f'tp{tp}']['ms_per_step_warm']:.1f}), peak memory {peak / 2**20:.0f} MiB "
              f"over the params")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"trainer tp={tp}: the loss did not fall: {losses}")
        del params, opt
    counts = {k: c.launches for k, c in counters.items()}
    check(not any(counts.values()), f"the trainer launched a kernel of the port: {counts}")
    rel = np.abs(np.subtract(runs["tp2"]["losses"], runs["tp1"]["losses"])) / np.abs(
        runs["tp1"]["losses"])
    print(f"trainer tp = 2 against tp = 1: largest relative loss difference {rel.max():.2e}")
    check(rel.max() <= TRAIN_TP_RTOL, f"trainer tp=2 losses against tp=1: {rel}")
    del model
    return counts, runs


def _greedy_stream(runner, ids, n: int) -> tuple[list, float]:
    """The prefill's token and n - 1 sequential greedy steps after it:
    (tokens, decode tok/s)."""
    import torch

    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.runtime.api import GenerationConfig

    config = GenerationConfig(sample=False, seed=0, max_tokens=n)
    with torch.inference_mode():
        _, first, _, state, max_steps = runner._prefill(ids, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = tor.orpheus_decode_loop(runner.params, runner.cfg, first, len(ids),
                                         max_steps - 1, runner._cache, None, state,
                                         do_sample=False)
        torch.cuda.synchronize()
    return [int(first[0])] + got, len(got) / (time.perf_counter() - t0)


def _step_logits(runner, ids, stream, i: int):
    """The logits from which the runner's sequential greedy loop chose
    stream[i]: the prompt's prefill, then decode steps along stream[:i]."""
    import torch

    from tts_tpu_torch.models import orpheus as tor

    dev = runner.device
    with torch.inference_mode():
        logits = tor.orpheus_prefill(runner.params, runner.cfg, torch.tensor(ids, device=dev),
                                     runner._cache)
        for j, tok in enumerate(stream[:i]):
            logits = tor.orpheus_decode_step(
                runner.params, runner.cfg, torch.tensor([tok], device=dev),
                torch.tensor([len(ids) + j], dtype=torch.int32, device=dev), runner._cache)
    return logits.float()


def parallel_orpheus(card: str, runner, q4_path: str) -> tuple[dict, dict]:
    """Phase 10 (b): phase 5's Orpheus-3B Q8_0 params cut over tp = 2 on
    [cuda:0, cuda:0] by make_tp_context; a greedy (speculative) and a
    sampled request through the tensor-parallel runner, launches exact;
    prefill logits of TP_TEXTS against the unsharded runner's, beside a
    planted fault that the tolerance must catch; greedy tokens against the
    unsharded runner's up to near-ties, and decode tok/s of both in
    alternating rounds; Q4_0 stays at tp = 1.  Returns (launches, summary)."""
    import torch

    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.parallel.mesh import Mesh, Shards, tree_map
    from tts_tpu_torch.runtime.api import GenerationConfig

    cuda0 = torch.device("cuda", 0)
    mesh = Mesh([cuda0, cuda0], ("tp",))
    base_mib = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    tp = tor.OrpheusRunner(runner.cfg, runner.params, runner.tokenizer, runner.snac,
                           mesh=mesh)
    torch.cuda.synchronize()
    print(f"make_tp_context: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**20 - base_mib:.0f} MiB of shards and cache "
          f"beside the unsharded runner's")
    L = tp.params["layers"][0]
    shapes = {n: [tuple(s["wq"].shape) for s in L[n]] for n in ("q", "k", "o", "gate", "down")}
    shapes["head"] = [tuple(s["wq"].shape) for s in tp.params["head"]]
    want = {"q": (HIDDEN, HQ * HS // 2), "k": (HIDDEN, HKV * HS // 2), "o": (HQ * HS // 2, HIDDEN),
            "gate": (HIDDEN, FFN // 2), "down": (FFN // 2, HIDDEN), "head": (HIDDEN, 78848)}
    print(f"shards per linear: {shapes}")
    check(tp.cfg.tp == 2 and all(v == [want[k]] * 2 for k, v in shapes.items()),
          f"tp = 2 shards: {shapes}")
    check(isinstance(tp._cache, Shards) and len(tp._cache) == 2
          and all(c["k"].shape[1] == HKV // 2 for c in tp._cache),
          "the KV cache is not split by KV heads")

    forwards, restore = orpheus_forwards()
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    try:
        t0 = time.perf_counter()
        greedy = tp.generate(TP_TEXT, GenerationConfig(sample=False, seed=0,
                                                       max_tokens=TP_TOKENS))
        greedy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampled = tp.generate(TP_TEXT, GenerationConfig(seed=1, top_k=50, max_tokens=TP_TOKENS))
        sampled_s = time.perf_counter() - t0
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        restore()
    for name, resp, wall in (("greedy", greedy, greedy_s), ("sampled", sampled, sampled_s)):
        steps = resp.timings["decode_steps"]
        check(bool(np.isfinite(resp.audio).all()) and len(resp.audio) == (steps // 7) * 2048 > 0,
              f"tp = 2 {name}: {len(resp.audio)} samples for {steps} tokens")
        print(f"tp = 2 {name:7s} wall {wall * 1e3:8.1f} ms  {steps} tokens, decode "
              f"{steps / (resp.timings['decode_ms'] / 1e3):6.1f} tok/s")
    per_layer = TP_LINEARS * 2
    print(f"launches over the tp = 2 requests (forwards {dict(forwards)}): {counts}")
    check(forwards["step"] > 0 and forwards["verify"] > 0 and forwards["prefill"] == 2,
          f"forwards {dict(forwards)}")
    check(counts["qgemv_int8"] == (LAYERS * per_layer + 2) * forwards["step"]
          + 2 * forwards["prefill"],
          f"qgemv_int8 launched {counts['qgemv_int8']}, not 28 * 7 * 2 + 2 = 394 per decode "
          f"step and 2 (the head's shards) per prefill: {dict(forwards)}")
    check(counts["qgemm_int8"] == LAYERS * per_layer * forwards["prefill"]
          + (LAYERS * per_layer + 2) * forwards["verify"],
          f"qgemm_int8 launched {counts['qgemm_int8']}, not 392 per prefill and 394 per "
          f"verify window: {dict(forwards)}")
    check(counts["flash_decode"] == 2 * LAYERS * forwards["step"],
          f"flash_decode launched {counts['flash_decode']}, not 56 per decode step")
    check(counts["qgemv_int4"] == counts["qgemm_int4"] == 0, f"int4 launched: {counts}")

    # prefill logits of each prompt, tp = 2 against unsharded; beside them
    # a yardstick, the unsharded runner with only its qkv / gateup fusion
    # undone (the same products, other K splits), and a control, tp = 2
    # with a planted fault: every row-parallel linear (o, down) drops its
    # last shard's partial product
    real = tor._tp_qlinear

    def dropped(x, shards, *, col):
        if not col:
            x = x.clone()
            x[:, -(x.shape[-1] // len(shards)):] = 0
        return real(x, shards, col=col)

    with torch.inference_mode():
        unfused = tree_map(torch.Tensor.contiguous,
                           tor._unfuse_for_tp(runner.params, runner.cfg))
    unfused = types.SimpleNamespace(params=unfused, cfg=runner.cfg, device=runner.device,
                                    _cache=runner._cache)
    prompts = []
    for text in TP_TEXTS:
        ids = runner._prompt_ids(text, GenerationConfig())
        check(len(ids) in prompt_lengths([{"input": text}]),
              f"tp = 2 prefill M={len(ids)} was not checked in phase 3")
        base = _step_logits(runner, ids, [], 0)
        tor._tp_qlinear = dropped
        try:
            fault = _step_logits(tp, ids, [], 0)
        finally:
            tor._tp_qlinear = real
        prompts.append({"prompt_tokens": len(ids), "peak": base.abs().max().item(),
                        "tp2": (_step_logits(tp, ids, [], 0) - base).abs().max().item(),
                        "unfused": (_step_logits(unfused, ids, [], 0) - base).abs().max().item(),
                        "planted_fault": (fault - base).abs().max().item()})
        p = prompts[-1]
        print(f"prefill logits, {len(ids)} tokens (peak {p['peak']:.3e}): tp = 2 differs by "
              f"{p['tp2']:.3e} = {p['tp2'] / p['peak']:.2%} of the peak, the unsharded runner "
              f"unfused by {p['unfused'] / p['peak']:.2%}, tp = 2 with the planted fault by "
              f"{p['planted_fault'] / p['peak']:.2%} (tol {TP_LOGIT_TOL:.0%})")
        check(p["tp2"] <= TP_LOGIT_TOL * p["peak"],
              f"tp = 2 prefill logits differ by {p['tp2']} (peak {p['peak']})")
        check(p["planted_fault"] > TP_LOGIT_TOL * p["peak"],
              f"the planted fault passes the tp = 2 logit tolerance: {p}")
    del unfused

    # sequential greedy decode of TP_TEXT, unsharded and tp = 2 alternately
    ids = runner._prompt_ids(TP_TEXT, GenerationConfig())
    streams, rates = {}, {"unsharded": [], "tp2": []}
    for _ in range(TP_ROUNDS):
        for key, r in (("unsharded", runner), ("tp2", tp)):
            toks, rate = _greedy_stream(r, ids, TP_TOKENS)
            check(streams.setdefault(key, toks) == toks, f"{key}: greedy tokens changed")
            rates[key].append(rate)
    base, got = streams["unsharded"], streams["tp2"]
    part = next((i for i, (a, b) in enumerate(zip(base, got)) if a != b), len(base))
    summary = {"decode_tok_per_s": rates, "tokens": len(base), "first_part": part,
               "prefill_logits": prompts}
    if part < len(base):
        # the logits each loop computed for token `part` (the kernels give
        # the same bits again): where the unsharded choice a and tp's b
        # part, a's lead over b is at most twice the runners' difference
        lb, lt = (_step_logits(r, ids, base, part) for r in (runner, tp))
        gap = (lb[base[part]] - lb[got[part]]).item()
        diff = (lb - lt).abs().max().item()
        peak = lb.abs().max().item()
        summary.update(part_gap=gap, part_logit_diff=diff)
        print(f"tp = 2 greedy parts from the unsharded runner at token {part}: top-2 gap "
              f"{gap:.3e}, logits differ by up to {diff:.3e} there (peak {peak:.3e})")
        check(gap <= 2 * diff and diff <= TP_LOGIT_TOL * peak,
              f"tp = 2 greedy token {part} is not a near-tie: gap {gap}, logit difference {diff}")
    check(len(got) == len(base), f"tp = 2 decoded {len(got)} tokens, unsharded {len(base)}")
    print(f"greedy sequential decode, {len(base)} tokens, {TP_ROUNDS} rounds alternately on "
          f"{card}: unsharded {[round(x, 1) for x in rates['unsharded']]} tok/s, tp = 2 "
          f"{[round(x, 1) for x in rates['tp2']]} tok/s; tokens equal up to token {part}")
    del tp
    gc.collect()
    torch.cuda.empty_cache()

    q4 = runner_from_file(q4_path, mesh=mesh)
    check(q4.cfg.tp == 1 and "wq4" in q4.params["layers"][0]["qkv"],
          f"Q4_0 over tp = 2: cfg.tp {q4.cfg.tp}, not kept whole")
    print("Q4_0 over tp = 2: cfg.tp == 1, fused and whole on cuda:0 (the int4 row-parallel "
          "split is excluded)")
    del q4
    return counts, summary


def parallel_server(card: str) -> dict:
    """Phase 10 (c): --data-parallel serves a Kokoro-82M request from its one
    replica on this card; --tensor-parallel 2 raises on one card.  Returns
    the five kernels' launches over the request."""
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers

    path = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    state = ServerState({"kokoro82m": path}, _kokoro_config(), 2, device="cuda",
                        data_parallel=True)
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    counters = launch_counters()
    for kernel in counters.values():
        kernel.launches = 0
    try:
        t0 = time.perf_counter()
        status, body, ctype = _post(srv.server_address[1], {"input": HARVARD[0]})
        wall = time.perf_counter() - t0
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    check(status == 200 and ctype == "audio/wav", f"data-parallel: HTTP {status} {ctype}")
    with wave.open(io.BytesIO(body)) as wf:
        n = wf.getnframes()
        check(wf.getframerate() == 24000 and n > 0, f"data-parallel: {n} samples")
    replicas = {key: r.model.device for key, r in state._runners.items()}
    check(replicas == {("kokoro82m", 0): torch.device("cuda", 0)},
          f"data-parallel replicas: {replicas}")
    check(not any(counts.values()), f"the Kokoro replica launched a kernel: {counts}")
    print(f"--data-parallel on {card}: one replica {replicas}, a Kokoro-82M request in "
          f"{wall * 1e3:.1f} ms, {n / 24000:.3f} s of audio")
    try:
        ServerState({"kokoro82m": path}, _kokoro_config(), 1, device="cuda",
                    tensor_parallel=2)
    except ValueError as e:
        check("tensor_parallel=2 needs at least 2 devices; 1 visible" in str(e), str(e))
        print(f"--tensor-parallel 2 on one card raises: {e}")
    else:
        check(False, "--tensor-parallel 2 on one card did not raise")
    return counts


def parallel(card: str, orpheus_q8, q4_path: str) -> dict:
    """Phase 10; returns the launch counts of each of its paths."""
    phase("10 parallel: the duration trainer, Orpheus-3B at tp = 2, the server's replicas")
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = {}
    try:
        counts["trainer"], trainer = parallel_trainer(card)
        counts["tp_Q8_0"], tp = parallel_orpheus(card, orpheus_q8, q4_path)
        counts["dp_kokoro"] = parallel_server(card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    print(json.dumps({"parallel": {"card": card, "trainer": trainer, "tp_Q8_0": tp}}))
    return counts


# ---------------------------------------------------------------- phase 11 ---
PARITY_ORPHEUS_TOKENS = 70         # --max-tokens of the Orpheus parity report
# the parts' expected launches per captured call, and the parity reports'
# verdicts, are held exactly; the native codecs bit for bit


def _host_s(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


NATIVE_SWEEP_BLOCKS = (1024, 4096, 16384, 65536, 131072, 262144, 786432)  # Q8_0 blocks
NATIVE_SWEEP_THREADS = (1, 2, 4, 8, 16)
# the block counts that split to_numpy's per-tensor times (Kokoro-82M's block-coded
# tensors hold 800-49,152 blocks, Parler's up to 1,028,096)
NATIVE_BINS = (4096, 65536, 262144)


def native_sweep(card: str) -> dict:
    """Host ms of the library's Q8_0 dequant by block count and thread count
    (the best of 5 calls, each into a new output array, as to_numpy's are),
    beside the numpy codec's and the thread count `native._threads` picks
    there: what core/native.py's VALUES_PER_THREAD is chosen from."""
    import ctypes

    from tts_tpu_torch.core import native, quant

    lib = native.get_lib()
    check(lib is not None, "core/native.py: the codec library did not build or load")
    x = np.random.default_rng(0).standard_normal(max(NATIVE_SWEEP_BLOCKS) * 32)
    raw = np.frombuffer(native.quant_q8_0(x.astype(np.float32)), np.uint8)
    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)

    def best_ms(fn, reps: int = 5) -> float:
        return min(_host_s(fn)[1] for _ in range(reps)) * 1e3

    def call(n: int, threads: int):
        out = np.empty(n, np.float32)
        lib.ggufc_dequant_q8_0(raw.ctypes.data_as(u8), out.ctypes.data_as(f32), n, threads)

    print(f"[{card}] native Q8_0 dequant sweep, host ms (best of 5), CPUs "
          f"{len(os.sched_getaffinity(0))} of os.cpu_count() {os.cpu_count()}; threads "
          f"{' / '.join(map(str, NATIVE_SWEEP_THREADS))} | numpy | threads picked, ms:")
    sweep = {}
    for blocks in NATIVE_SWEEP_BLOCKS:
        n = blocks * 32
        row = {th: best_ms(lambda: call(n, th)) for th in NATIVE_SWEEP_THREADS}
        numpy_ms = best_ms(lambda: quant.dequantize_q8_0(raw[: blocks * 34], n), 3)
        picked, picked_ms = native._threads(n), best_ms(lambda: native.dequant_q8_0(raw, n))
        print(f"  {blocks:>7} blocks: {' / '.join(f'{ms:.3f}' for ms in row.values())} | "
              f"{numpy_ms:.3f} | {picked}, {picked_ms:.3f}")
        sweep[blocks] = {"threads_ms": row, "numpy_ms": numpy_ms, "picked": picked,
                         "picked_ms": picked_ms}
    return sweep


def _bin(blocks: int) -> str:
    lo = 0
    for hi in NATIVE_BINS:
        if blocks < hi:
            return f"{lo}-{hi - 1}"
        lo = hi
    return f">={lo}"


def last_native(card: str, orpheus_paths: dict) -> dict:
    """Phase 11 (a): core/native.py builds into build/ and loads; its
    dequants and quant_q8_0 give the numpy codecs' bits on one full-width
    Orpheus-3B Q8_0 and one Q4_0 tensor; the library's sweep by block and
    thread count; to_numpy over every tensor of phase 9's Kokoro-82M Q8_0
    and quantized Parler files with the library and with the numpy codecs
    alone (host seconds, arrays bit-equal)."""
    from tts_tpu_torch.core import native, quant
    from tts_tpu_torch.core.gguf import GGUFFile

    lib, secs = _host_s(native.get_lib)
    check(lib is not None, "core/native.py: the codec library did not build or load")
    built = sorted(f for f in os.listdir(native.BUILD_DIR) if f.startswith("libggufc_"))
    print(f"[{card}] native codecs: {built} in build/, built and loaded in {secs:.2f} host s")
    summary = {"build_host_s": secs}
    name = "orpheus.layers.0.mlp.gate_proj"
    for qtype, path in orpheus_paths.items():
        with GGUFFile(path) as f:
            t = f.tensors[name]
            raw, n = t.raw(), t.n_elements
            numpy_fn = quant.dequantize_q8_0 if qtype == "Q8_0" else quant.dequantize_q4_0
            native_fn = native.dequant_q8_0 if qtype == "Q8_0" else native.dequant_q4_0
            got, s_native = _host_s(lambda: native_fn(raw, n))
            want, s_numpy = _host_s(lambda: numpy_fn(raw, n))
        check(np.array_equal(got, want), f"native dequant {qtype}: not the numpy codec's bits")
        line = (f"{name} {qtype} ({n:,} values): dequant native {s_native:.3f} s, numpy "
                f"{s_numpy:.3f} s, bit-equal")
        summary[f"dequant_{qtype}"] = {"native_s": s_native, "numpy_s": s_numpy}
        if qtype == "Q8_0":
            q_native, s_qn = _host_s(lambda: native.quant_q8_0(want))
            q_numpy, s_qp = _host_s(lambda: quant.quantize_q8_0(want))
            check(q_native == q_numpy, "native quant_q8_0: not the numpy codec's bytes")
            line += f"; quant_q8_0 native {s_qn:.3f} s, numpy {s_qp:.3f} s, byte-equal"
            summary["quant_Q8_0"] = {"native_s": s_qn, "numpy_s": s_qp}
        print(f"[{card}] {line}")
    summary["sweep"] = native_sweep(card)
    for label, path in (("kokoro82m_q8", "kokoro82m_q8_seed0.gguf"),
                        ("parler_q8", "parler_mini_v1_f32_to_q8.gguf"),
                        ("parler_q4", "parler_mini_v1_f32_to_q4.gguf")):
        path = os.path.join(MODEL_DIR, path)
        check(os.path.exists(path), f"phase 11 needs phase 9's {os.path.basename(path)}")
        summary[f"to_numpy_{label}"] = to_numpy_times(card, label, path)
    return summary


def to_numpy_times(card: str, label: str, path: str) -> dict:
    """to_numpy over every tensor of `path`, with the library and with the
    numpy codecs alone: host seconds in all and, for the block-coded
    tensors, by block count (NATIVE_BINS); the arrays bit-equal."""
    from tts_tpu_torch.core.gguf import GGMLType, GGUFFile

    coded_types = (GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q8_0, GGMLType.BF16)
    secs = {"library": 0.0, "numpy": 0.0}
    bins = {}
    with GGUFFile(path) as f:
        for j, t in enumerate(f.tensors.values()):
            coded = t.ggml_type in coded_types
            plain = (lambda: t.to_numpy_plain().reshape(t.shape)) if coded else t.to_numpy
            # every other tensor takes the numpy codecs first: neither side
            # always meets the file's pages cold
            if j % 2:
                want, s_np = _host_s(plain)
                got, s_lib = _host_s(t.to_numpy)
            else:
                got, s_lib = _host_s(t.to_numpy)
                want, s_np = _host_s(plain)
            check(np.array_equal(got, want), f"{label} {t.name}: to_numpy with the "
                  f"library differs from the numpy codecs")
            secs["library"] += s_lib
            secs["numpy"] += s_np
            if coded:
                b = bins.setdefault(_bin(-(-t.n_elements // 32)), [0, 0.0, 0.0])
                b[0] += 1
                b[1] += s_lib
                b[2] += s_np
        n = len(f.tensors)
    n_coded = sum(b[0] for b in bins.values())
    print(f"[{card}] to_numpy over {label} ({n} tensors, {n_coded} block-coded): "
          f"{secs['library']:.3f} host s with the library, {secs['numpy']:.3f} with the "
          f"numpy codecs alone ({secs['numpy'] / max(secs['library'], 1e-9):.2f}x), "
          f"bit-equal; block-coded by blocks (tensors: library / numpy s): " + "; ".join(
              f"{k} ({c}: {a:.4f} / {b:.4f})" for k, (c, a, b) in bins.items()))
    return {**secs, "by_blocks": bins}


def _parity_main(path: str, js: str, argv: list[str]) -> tuple[dict, str, float]:
    """tts_tpu_torch.tools.parity_report.main([path, "--json", js, *argv])
    in this process; returns (its report, its stdout, host seconds)."""
    import contextlib

    from tts_tpu_torch.tools import parity_report

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = parity_report.main([path, "--json", js, *argv])
    secs = time.perf_counter() - t0
    check(rc == 0, f"parity_report {path} {argv}: exit {rc}")
    with open(js) as f:
        return json.load(f), buf.getvalue(), secs


def last_parity(card: str, path: str, label: str, max_tokens: int, want,
                float_ref: bool = False) -> tuple[dict, dict]:
    """Phase 11 (b): `tts_tpu_torch.tools.parity_report.main` on `path`
    (--device cuda by default): once saving its 16-bit WAV, once against a
    WAV of that audio, which must give MATCH.  Each run's launches are held
    to `want(report)` exactly, every counter set to 0 just before it.
    `float_ref`: as the first run saves its 16-bit WAV, the same audio
    array is also written as 32-bit float, and that file is the second
    run's reference (the 16-bit file clips audio past +-1).  Returns (the
    first run's launch counts, the second run's report)."""
    from tts_tpu_torch.tools import parity_report
    from tts_tpu_torch.utils.audio import read_wav, write_wav

    wav = os.path.join(MODEL_DIR, f"parity_{label}.wav")
    ref = os.path.join(MODEL_DIR, f"parity_{label}_f32.wav") if float_ref else wav
    tail = ["--max-tokens", str(max_tokens)] if max_tokens else []

    def save_both(out, audio, sample_rate, *a, **kw):
        write_wav(out, audio, sample_rate, *a, **kw)
        if out == wav:
            write_wav(ref, audio, sample_rate, bit_depth=32)

    counts = None
    for i, extra in enumerate((["--save-wav", wav], ["--ref-wav", ref])):
        js = os.path.join(MODEL_DIR, f"parity_{label}_{i}.json")
        for kernel in launch_counters().values():
            kernel.launches = 0
        if i == 0 and float_ref:
            parity_report.write_wav = save_both
        try:
            report, stdout, secs = _parity_main(path, js, [*extra, *tail])
        finally:
            parity_report.write_wav = write_wav
        run = _kernel_counts()
        print("  " + stdout.rstrip().replace("\n", "\n  "))
        expected = want(report)
        print(f"[{card}] parity_report {label} run {i + 1} ({secs:.1f} host s): launches {run}")
        check(run == expected, f"parity_report {label}: launches {run}, not {expected}")
        if i == 0 and float_ref:
            check(os.path.exists(ref), f"parity_report {label}: no 32-bit copy of {wav}")
            peak = report["audio"]["peak"]
            saved, _ = read_wav(wav)
            print(f"[{card}] parity_report {label}: the served audio peaks at {peak:.3e}, its "
                  f"16-bit WAV at {np.abs(saved).max():.4f}{' (clipped)' if peak > 1 else ''};"
                  f" the reference is the same audio array as 32-bit float")
        counts = counts or run
    vs = report["vs_reference"]
    check(vs.get("verdict") == "MATCH", f"parity_report {label}: {vs}")
    return counts, report


def last_modules(card: str, orpheus_q8, orpheus_paths: dict) -> dict:
    """Phase 11; returns the launch counts of each parity report's path."""
    phase("11 the last modules: native codecs, parity_report, the Orpheus step breakdown")
    import torch

    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models.kokoro import KokoroConfig
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig
    from tts_tpu_torch.tools import orpheus_step_breakdown as sb

    summary = {"card": card, "native": last_native(card, orpheus_paths)}
    counts = {}
    kokoro = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    with GGUFFile(kokoro) as f:
        upsample = KokoroConfig.from_gguf_kv(f.kv).up_sampling_factor
    zero = {k: 0 for k in launch_counters()}
    counts["parity_kokoro"], report = last_parity(card, kokoro, "kokoro", 0, lambda r: zero,
                                                  float_ref=True)
    st, au = report["stages"], report["audio"]
    check(st["total_frames"] * upsample == au["samples"] > 0,
          f"parity Kokoro: {st['total_frames']} frames of durations, {au['samples']} samples "
          f"served ({upsample} per frame)")
    summary["parity_kokoro"] = {"verdict": report["vs_reference"]["verdict"],
                                "corr": report["vs_reference"]["pcm_correlation"],
                                "frames": st["total_frames"], "peak": au["peak"]}

    # the sequential route, whose steps run the GEMV and flash_decode (a
    # greedy request takes the speculative loop otherwise)
    per = LAYERS * LINEARS_PER_LAYER
    forwards, restore = orpheus_forwards()

    def orpheus_want(report):
        steps = report["stages"]["n_tokens"] - 1
        check(report["stages"]["n_tokens"] == PARITY_ORPHEUS_TOKENS
              and forwards == {"prefill": 1, "step": steps},
              f"parity Orpheus: {report['stages']['n_tokens']} tokens, forwards {dict(forwards)}")
        forwards.clear()
        return dict(zero, qgemv_int4=(per + 1) * steps + 1, qgemm_int4=per,
                    flash_decode=LAYERS * steps)

    os.environ["TTS_TPU_NO_SPEC"] = "1"
    try:
        counts["parity_orpheus_Q4_0"], report = last_parity(
            card, orpheus_paths["Q4_0"], "orpheus_q4", PARITY_ORPHEUS_TOKENS, orpheus_want)
    finally:
        del os.environ["TTS_TPU_NO_SPEC"]
        restore()
    summary["parity_orpheus_Q4_0"] = {"verdict": report["vs_reference"]["verdict"],
                                      "corr": report["vs_reference"]["pcm_correlation"],
                                      "step0_argmax": report["stages"]["step0_logits"]["argmax"]}

    q4 = runner_from_file(orpheus_paths["Q4_0"], device="cuda")
    q4.generate("A request that makes the cache.", GenerationConfig(sample=False, max_tokens=8))
    summary["breakdown"] = {}
    for qtype, runner in (("Q8_0", orpheus_q8), ("Q4_0", q4)):
        t0 = time.perf_counter()
        results = sb.breakdown(runner.params, runner.cfg, runner._cache)
        sb.print_breakdown(results, f"[{card}] Orpheus-3B {qtype}")
        print(f"  ({time.perf_counter() - t0:.1f} host s)")
        summary["breakdown"][qtype] = results
    del q4
    torch.cuda.empty_cache()
    print(json.dumps({"last_modules": summary}))
    return counts


# ---------------------------------------------------------------- phase 12 ---
# seconds, for bench_torch.py as its own process: above its DEADLINE_S, so
# that it prints its line before this kill
BENCH_TIMEOUT = 600


def bench(card: str) -> dict:
    """Phase 12: bench_torch.py as its own process on phase 6's Kokoro-82M
    (BENCH_KOKORO_GGUF, so nothing is rewritten); its last line must parse,
    with its kernel smoke passed (the CUDA qgemm_int8 launched once),
    complete, cold_buckets 0 and value > 0.  Returns the line."""
    phase("12 bench_torch.py: the Kokoro-82M Harvard battery as its own process")
    import torch

    path = os.path.join(MODEL_DIR, "kokoro82m_seed0.gguf")
    check(os.path.exists(path), "phase 12 needs phase 6's Kokoro-82M")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT,
                          env=dict(os.environ, BENCH_KOKORO_GGUF=path))
    secs = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-4000:])
    lines = proc.stdout.strip().splitlines()
    check(bool(lines), f"bench_torch.py printed nothing (exit {proc.returncode})")
    try:
        line = json.loads(lines[-1])
    except ValueError:
        line = None
    check(isinstance(line, dict), f"bench_torch.py: its last line is not JSON: {lines[-1]!r}")
    print(json.dumps({"bench_torch": line}))
    print(f"[{card}] bench_torch.py: exit {proc.returncode} in {secs:.1f} host s")
    check(proc.returncode == 0 and line.get("kernel_smoke") == "passed"
          and line.get("complete") is True and line.get("cold_buckets") == 0
          and (line.get("value") or 0) > 0, f"bench_torch.py: exit {proc.returncode}, {line}")
    return line


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
    counts, orpheus_q8 = {}, None
    for qtype in QTYPES:
        counts[qtype], runner = server(paths[qtype], qtype)
        if qtype == "Q8_0":
            orpheus_q8 = runner         # phase 10 cuts its params over tp = 2
        del runner
    counts["kokoro"] = kokoro()
    parler_counts, parler_rows = parler()
    counts.update(parler_counts)
    dia_counts, dia_rows = dia()
    counts.update(dia_counts)
    results.append(prefix_attention_record(parler_rows + dia_rows))
    counts.update(apps(card, paths["Q4_0"]))
    counts.update(parallel(card, orpheus_q8, paths["Q4_0"]))
    counts.update(last_modules(card, orpheus_q8, paths))
    del orpheus_q8
    bench(card)
    for r in results:
        path = next((q for q, ks in PATH_KERNELS.items() if r["name"] in ks),
                    "parler_Q4_0" if r["name"] == "prefix_attention" else QTYPES[0])
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
