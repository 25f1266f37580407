"""A temporary checkout for the CPU tests: the benchmark's folder copied,
BENCHMARK.json with tiny configurations of each model (the published
architecture at test widths; the DAC's strides kept, so a frame is still
512 samples) and short traffic, and the program linked in beside it."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_DAC = {"latent": 32, "decoder_dim": 48, "channels": [24, 12, 8, 4], "strides": [8, 8, 4, 2],
            "n_heads": 9, "codebook_size": 1024, "codebook_dim": 8}
TINY = {
    "parler": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
               "ffn_dim": 128, "max_position_embeddings": 512, "max_generation_size": 256,
               "prompt_vocab_size": 64, "text_encoder_hidden_size": 64, "description_tokens": 8},
    "dia": {"encoder_n_layer": 2, "encoder_n_embd": 64, "encoder_n_head": 4,
            "encoder_head_dim": 16, "encoder_n_hidden": 128, "decoder_n_layer": 2,
            "decoder_n_embd": 64, "decoder_gqa_query_heads": 4, "decoder_kv_heads": 2,
            "decoder_gqa_head_dim": 16, "decoder_n_hidden": 128, "decoder_cross_query_heads": 4,
            "decoder_cross_head_dim": 16, "text_length": 256, "audio_length": 256},
}
TRAFFIC = {
    "closed": {"loop": "closed", "response_format": "wav", "audio_s": [0.2, 0.4], "block": 4,
               "blocks": 8},
    "open": {"loop": "open", "response_format": "pcm", "audio_s": [0.2, 0.4], "rate_per_s": 2.0},
}
# the limits at these sizes: the sound runs of the tests read logit gaps up to
# 0.004 and audio errors up to 3e-5 on the CPU; the fp8 control 0.036-0.2
TINY_LIMITS = {"logit_gap": 0.02, "audio_err": 0.001}
CONFIG_FILES = {"parler": "parler-tts-mini-v1-q4_0.json", "dia": "dia-1.6b-q4_0.json"}


def make(root: str, models=("parler", "dia"), loops=("closed",)) -> str:
    """A checkout under root with cells <model>-<loop>; returns root."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "tts_tpu_torch"), os.path.join(root, "tts_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for m in models:
        with open(os.path.join(BENCH, "configs", CONFIG_FILES[m])) as f:
            cfg = json.load(f)
        cfg.update(TINY[m])
        cfg["dac"] = copy.deepcopy(TINY_DAC)
        cfg["correct_limits"] = dict(TINY_LIMITS)
        name = f"{m}-tiny"
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"], "file": path,
                                 "reduced": sorted(TINY[m]) + ["dac"], "why": "test"})
        for loop in loops:
            with open(os.path.join(root, "benchmark", "traffic", f"tiny-{loop}.json"), "w") as f:
                json.dump(TRAFFIC[loop], f)
            bench["workloads"].append({"name": f"{m}-{loop}", "config": name,
                                       "traffic": f"tiny-{loop}", "chips": 1, "why": "test"})
    cells = [w["name"] for w in bench["workloads"]]
    for group in ("end_to_end", "per_layer"):
        for metric in bench[group]:
            metric.pop("workloads", None)
            if metric["name"] in ("ttfa_p90_ms", "rtf_p90", "ttfa_p50_ms"):
                metric["workloads"] = [c for c in cells if c.endswith("open")]
            elif metric["name"] != "setup_s":
                metric["workloads"] = [c for c in cells if c.endswith("closed")]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root: str, cell: str, seed: int = 7, seconds: float = 3.0, trace: int = 0,
        control: int = 0, env: dict | None = None, timeout: float = 600):
    """run.py in the checkout on the CPU: (exit code, result or None, stderr)."""
    e = {**os.environ, "BENCH_TEST_DEVICE": "cpu", **(env or {})}
    e.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", str(trace),
                          "--control", str(control)],
                         cwd=root, env=e, capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out.returncode, result, out.stderr
