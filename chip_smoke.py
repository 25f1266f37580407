#!/usr/bin/env python3
"""Smoke test of tts_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that its
server answers requests from a full-width Orpheus-3B Q8_0 model.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):
  1. environment: versions, the card's name and power limit; no card -> exit 1
  2. build: nvcc of tts_tpu_torch/csrc into build/, with ptxas register/spill lines
  3. kernels against their plain PyTorch versions at the Orpheus-3B shapes,
     with device times (CUDA graphs replayed plain, kernel, kernel, plain)
     and achieved GB/s
  4. model: a seeded random full-width Orpheus-3B Q8_0 GGUF (28 layers, F16
     embedding, full-width SNAC) written under smoke_models/; a tiny model's
     CUDA forward checked against the port's CPU (plain) forward
  5. server: the port's server on cuda answers 3 /v1/audio/speech requests
     (2 sampled, 1 greedy); launch counts show the kernels served them
The line before the last is a JSON object of per-kernel results; the last is
{"ok": true, "device": {...}}.  It imports only tts_tpu_torch, which shares
the jax-free host modules of tts_tpu (GGUF reader and writer, tokenizer,
runner API, HTTP handler) by import, and it fails if jax was imported.
"""

from __future__ import annotations

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
# tts_tpu/__init__.py, run by the shared imports, would otherwise import jax
# (where it is installed) to set up the JAX compile cache
os.environ["TTS_TPU_NO_COMPILE_CACHE"] = "1"
MODEL_DIR = os.path.join(ROOT, "smoke_models")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_ROTATE_BYTES = 128 << 20        # > 2x the 50 MB L2: weights come from HBM
# Orpheus-3B (tts_tpu/models/orpheus.py OrpheusConfig defaults)
LAYERS, HIDDEN, HQ, HKV, HS, FFN, VOCAB = 28, 3072, 24, 8, 128, 8192, 156940
S_CACHE = 3584                     # (1024 + 2100) padded to the 512 chunk
GEMV_SHAPES = {"qkv": (3072, 5120), "o": (3072, 3072), "gateup": (3072, 16384),
               "down": (8192, 3072), "lm_head": (3072, 157696)}
GEMM_SHAPES = {k: GEMV_SHAPES[k] for k in ("qkv", "gateup", "down", "lm_head")}
LINEARS_PER_LAYER = 4              # fused qkv, o, fused gateup, down
GEMV_TOL = GEMM_TOL = 1e-4         # same f32 sums in another order
FLASH_TOL = 4e-3                   # bf16(p) against chunk vs running max: <= 2^-9
TINY_TOL = 1e-2                    # tiny model logits, CUDA vs CPU (see phase 4)
TINY = dict(n_layers=2, hidden=256, heads=4, kv_heads=2, head_dim=128, ffn=512, vocab=VOCAB,
            snac_embd=96, snac_channels=(48, 24, 12, 6))


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


def plain_vs_kernel(plain, kernel, iters=(3, 20)):
    """Device ms per call of plain and kernel, each captured in a CUDA graph
    and replayed plain, kernel, kernel, plain; each side's time is the mean
    of its two replays."""
    gp, gk = _graph(plain, iters[0]), _graph(kernel, iters[1])
    p1 = _replay_ms(gp, iters[0])
    k1 = _replay_ms(gk, iters[1])
    k2 = _replay_ms(gk, iters[1])
    p2 = _replay_ms(gp, iters[0])
    return (p1 + p2) / 2, (k1 + k2) / 2


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


def rotating_q8(K, N, device, seed):
    """Enough copies of a random int8 [K, N] weight with f16 scales that
    cycling through them exceeds the L2 cache, as the decode step's 3.5 GB
    of weights does."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    copies = max(1, math.ceil(L2_ROTATE_BYTES / (K * N)))
    ws = [(torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8),
           (torch.rand((K // 32, N), generator=g, device=device) * 2e-3 + 1e-4).half())
          for _ in range(copies)]
    return ws


def kernels():
    phase("3 kernels against plain")
    import torch

    from tts_tpu_torch.ops import attention as ta
    from tts_tpu_torch.ops import qmatmul as tq

    dev = torch.device("cuda")
    results = []

    def record(name, source, replaces, rows):
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": max(r["abs"] for r in rows),
                        "max_rel_err": max(r["rel"] for r in rows),
                        "ms": sum(r["ms"] for r in rows),
                        "plain_ms": sum(r["plain_ms"] for r in rows),
                        "shapes": [r["shape"] for r in rows]})

    rows = []
    for i, (name, (K, N)) in enumerate(GEMV_SHAPES.items()):
        ws = rotating_q8(K, N, dev, i)
        x = torch.randn((1, K), device=dev)
        a, r = rel_err(tq.qgemv_int8(x, *ws[0]), tq.qgemv_int8_plain(x, *ws[0]))
        plain_ms, ms = plain_vs_kernel(lambda j: tq.qgemv_int8_plain(x, *ws[j % len(ws)]),
                                       lambda j: tq.qgemv_int8(x, *ws[j % len(ws)]))
        gbs = (K * N + K // 32 * N * 2) / (ms * 1e-3) / 1e9
        print(f"qgemv_int8 {name:8s} K={K:5d} N={N:6d}  rel_err {r:.2e} (tol {GEMV_TOL:.0e})  "
              f"kernel {ms * 1e3:8.1f} us  plain {plain_ms * 1e3:9.1f} us  "
              f"{gbs:7.1f} GB/s = {gbs * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")
        check(r < GEMV_TOL, f"qgemv_int8 {name}: rel err {r} >= {GEMV_TOL}")
        rows.append({"shape": f"{name} M=1 K={K} N={N}", "abs": a, "rel": r, "ms": ms,
                     "plain_ms": plain_ms})
        del ws
    record("qgemv_int8", "tts_tpu_torch/csrc/qmatmul.cu", "tts_tpu/ops/qmatmul.py:144", rows)

    rows = []
    for i, (name, (K, N)) in enumerate(GEMM_SHAPES.items()):
        ws = rotating_q8(K, N, dev, 100 + i)
        for M in (8, 32):
            x = torch.randn((M, K), device=dev)
            a, r = rel_err(tq.qgemm_int8(x, *ws[0]), tq.qgemm_int8_plain(x, *ws[0]))
            plain_ms, ms = plain_vs_kernel(lambda j: tq.qgemm_int8_plain(x, *ws[j % len(ws)]),
                                           lambda j: tq.qgemm_int8(x, *ws[j % len(ws)]),
                                           iters=(3, 10))
            tflops = 2 * M * K * N / (ms * 1e-3) / 1e12
            gbs = (K * N + K // 32 * N * 2) / (ms * 1e-3) / 1e9
            print(f"qgemm_int8 {name:8s} M={M:2d} K={K:5d} N={N:6d}  rel_err {r:.2e} "
                  f"(tol {GEMM_TOL:.0e})  kernel {ms * 1e3:8.1f} us  plain {plain_ms * 1e3:9.1f} us"
                  f"  {tflops:5.2f} TFLOP/s  {gbs:7.1f} GB/s")
            check(r < GEMM_TOL, f"qgemm_int8 {name} M={M}: rel err {r} >= {GEMM_TOL}")
            rows.append({"shape": f"{name} M={M} K={K} N={N}", "abs": a, "rel": r, "ms": ms,
                         "plain_ms": plain_ms})
        del ws
    record("qgemm_int8", "tts_tpu_torch/csrc/qmatmul.cu", "tts_tpu/ops/qmatmul.py:134", rows)

    rows = []
    g = torch.Generator(device=dev).manual_seed(7)
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
        kind = "int8" if quant else "bf16"
        for pos in (0, 511, 512, 2047, 3583):
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
            a, r = rel_err(ta.flash_decode(q, k, v, pos_t, ks, vs), want)
            plain_ms, ms = plain_vs_kernel(
                lambda j: ta.flash_decode_plain(q, k, v, pos, ks, vs),
                lambda j: ta.flash_decode(q, k, v, pos_t, ks, vs))
            nbytes = (pos + 1) * HKV * (2 * HS * k.element_size() + (8 if quant else 0))
            gbs = nbytes / (ms * 1e-3) / 1e9
            print(f"flash_decode {kind} pos={pos:4d}  rel_err {r:.2e} (tol {FLASH_TOL:.0e})  "
                  f"kernel {ms * 1e3:7.1f} us  plain {plain_ms * 1e3:8.1f} us  {gbs:7.1f} GB/s")
            check(r < FLASH_TOL, f"flash_decode {kind} pos={pos}: rel err {r} >= {FLASH_TOL}")
            rows.append({"shape": f"{kind} Hq={HQ} Hkv={HKV} S={S_CACHE} pos={pos}", "abs": a,
                         "rel": r, "ms": ms, "plain_ms": plain_ms})
    record("flash_decode", "tts_tpu_torch/csrc/attention.cu", "tts_tpu/ops/attention.py:30",
           rows)
    torch.cuda.synchronize()
    return results


def tiny_cuda_vs_cpu():
    """A 2-layer hs=128 Q8_0 model: prefill and 8 teacher-forced decode
    logits on cuda (kernels) against the CPU (plain versions, which the CPU
    tests hold to the JAX package).  bf16 activations round differently
    when an f32 sum differs in its last bit (port vs JAX on the CPU: ~4e-3
    of max|logit|), so the bound is 1e-2 of max|logit|."""
    import torch

    from tts_tpu_torch.convert.builder_orpheus import write_random_q8_orpheus
    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.models.registry import runner_from_file

    path = write_random_q8_orpheus(os.path.join(MODEL_DIR, "tiny_q8_seed0.gguf"), seed=0,
                                   **TINY)
    ids = torch.tensor([128259, 128000, 72, 105, 128009, 128260, 128261, 128257])
    forced = [128300 + 97 * i for i in range(8)]
    logits = {}
    for dev in ("cuda", "cpu"):
        r = runner_from_file(path, device=dev)
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
    print(f"tiny model cuda vs cpu: 9 logit rows, max abs diff {a:.3e}, rel {r:.2e} "
          f"(tol {TINY_TOL:.0e}), argmax agrees on {same}/9")
    check(bool(torch.isfinite(logits["cuda"]).all()), "tiny model: non-finite logits on cuda")
    check(r < TINY_TOL, f"tiny model: cuda vs cpu logits rel diff {r} >= {TINY_TOL}")


def model():
    phase("4 model")
    os.makedirs(MODEL_DIR, exist_ok=True)
    tiny_cuda_vs_cpu()
    from tts_tpu_torch.convert.builder_orpheus import ORPHEUS_3B, write_random_q8_orpheus

    path = os.path.join(MODEL_DIR, "orpheus3b_q8_seed0.gguf")
    t0 = time.perf_counter()
    write_random_q8_orpheus(path, seed=0, **ORPHEUS_3B)
    print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path) / 1e9:.2f} GB "
          f"in {time.perf_counter() - t0:.1f} s (host)")
    return path


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/audio/speech",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def server(path: str):
    phase("5 server")
    import torch

    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.ops import attention as ta
    from tts_tpu_torch.ops import qmatmul as tq
    from tts_tpu_torch.runtime.api import GenerationConfig

    torch.cuda.reset_peak_memory_stats()
    state = ServerState({"orpheus3b": path}, GenerationConfig(top_k=50), 1, device="cuda")
    t0 = time.perf_counter()
    runner, _ = state._get_runner("orpheus3b")
    print(f"model load: {time.perf_counter() - t0:.1f} s  "
          + "  ".join(f"{k} {v:.1f}" for k, v in runner.load_timings.items()))
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
    requests = [
        ("sampled", {"input": "Hello from the port, this is a first test.", "voice": "zoe",
                     "max_tokens": 280, "seed": 1}),
        ("sampled", {"input": "A second sampled request, with the server's sampling.",
                     "voice": "leo", "max_tokens": 280, "seed": 2}),
        ("greedy", {"input": "And a greedy one to finish.", "max_tokens": 280,
                    "sample": False}),
    ]
    for kernel in (tq.qgemv_int8, tq.qgemm_int8, ta.flash_decode):
        kernel.launches = 0
    try:
        for kind, payload in requests:
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
            dec_s = resp.timings["decode_ms"] / 1e3
            print(f"{kind:7s} wall {wall * 1e3:8.1f} ms  prefill {resp.timings['prefill_ms']:7.1f}"
                  f" ms  decode {steps} tok in {dec_s * 1e3:8.1f} ms = {steps / dec_s:6.1f} tok/s"
                  f"  codec {resp.timings['codec_ms']:6.1f} ms  audio {n / 24000:.3f} s  "
                  f"RTF {wall / (n / 24000):.3f}")
    finally:
        srv.shutdown()
        srv.server_close()
        stop_workers(state)
    tokens = sum(r.timings["decode_steps"] for r in responses)
    steps = sum(r.timings["decode_steps"] - 1 for r in responses)
    counts = {"qgemv_int8": tq.qgemv_int8.launches, "qgemm_int8": tq.qgemm_int8.launches,
              "flash_decode": ta.flash_decode.launches}
    print(f"launches over {len(responses)} requests ({tokens} tokens): {counts}")
    check(len(responses) == 3, f"{len(responses)} responses")
    check(all(v > 0 for v in counts.values()), f"a kernel was never launched: {counts}")
    check(counts["qgemv_int8"] >= (LAYERS * LINEARS_PER_LAYER + 1) * steps,
          f"qgemv_int8 launched {counts['qgemv_int8']} < (28 * 4 + 1) * {steps} decode steps")
    check(counts["flash_decode"] >= LAYERS * steps,
          f"flash_decode launched {counts['flash_decode']} < 28 * {steps} decode steps")
    check(counts["qgemm_int8"] >= LAYERS * LINEARS_PER_LAYER * len(responses),
          f"qgemm_int8 launched {counts['qgemm_int8']} < one prefill per request")
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def main() -> int:
    card = environment()
    import torch

    build()
    results = kernels()
    path = model()
    counts = server(path)
    for r in results:
        r["launches"] = counts[r["name"]]
    check("jax" not in sys.modules, "jax was imported")
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
