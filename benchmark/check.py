"""The reference check of a benchmark run: what the timed path served,
judged by the plain reference of its model (reference/<model>.py), in a
process of its own that imports nothing of the program.

    python benchmark/check.py --run-dir D --workload W --seed N [--control 1]

It reads the run's weights file (the raw GGUF both sides read), the
sampled requests (check_in.json), the rows the server decoded for them
(served.npz) and the 16-bit audio the client received (pcm<i>.npy), and
prints one JSON line: {"numbers": {...}, "control": {...}, "guard_ok"}.

- logit_gap: over the sampled top_k = 1 requests (the argmax on the
  sampled route), the widest gap by which a served token's logit lies
  below the reference's best at its position, the reference teacher-forced
  over the prompt and the served rows (covers the prefill or encoder and
  the decode step).
- audio_err: over the sampled requests, the relative RMS difference
  between the audio served and the reference's audio for the served rows
  (the DAC's decode of their frames), rounded to 16 bits as served (covers
  the DAC, whole or windowed).
With --control 1 it also reads the same numbers for the reference at the
next precision down from the configuration's in the program's place: fp8
activations and keys / values where the program states bf16 (the token the
control puts first at each position, its gap in the float32 logits), and
TF32 convolutions where it states float32."""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import numpy as np  # noqa: E402

from benchlib import gguf, guard, spec, weights  # noqa: E402

FAIL = 1e30     # a number that no limit passes (a mismatch the check cannot read)


def pcm16(x: np.ndarray) -> np.ndarray:
    """Audio as the server sends it: clipped to [-1, 1], 16-bit."""
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).astype(np.float64)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1.0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the reference check of a benchmark run")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from reference import common

    common.strict_f32()
    bench = spec.load_bench()
    cfg = spec.config(bench, spec.workload(bench, args.workload)["config"])
    ref = spec.module("reference", cfg["model"])
    with open(os.path.join(args.run_dir, "check_in.json")) as f:
        items = json.load(f)["items"]
    served = np.load(os.path.join(args.run_dir, "served.npz"))
    path = weights.cached(os.path.join(spec.ROOT, "build", "bench", "weights"), cfg, args.seed)
    reader = gguf.Reader(path) if os.path.exists(path) else None
    dev = args.device
    numbers, control = {"logit_gap": None, "audio_err": None}, {}
    with torch.no_grad():
        params = ref.load(reader, cfg, dev)
        # a model with no tokens to judge (its reference reads no logits) leaves
        # logit_gap unread: a configuration that limits it then fails
        for it in (i for i in items if i["logits"] and hasattr(ref, "logits")):
            rows = served[str(it["seed"])]
            logits, n_prompt = ref.logits(params, cfg, it, rows)
            if n_prompt != it["T"]:
                print(f"request {it['i']}: the reference's prompt has {n_prompt} tokens, "
                      f"the program's {it['T']}", file=sys.stderr)
                g = FAIL
            else:
                g = common.gap(logits, torch.from_numpy(rows).to(dev)).max().item()
            numbers["logit_gap"] = max(numbers["logit_gap"] or 0.0, g)
            if args.control:
                low, _ = ref.logits(params, cfg, it, rows, act=common.fp8)
                c = common.gap(logits, low.argmax(-1)).max().item()
                control["logit_gap"] = max(control.get("logit_gap", 0.0), c)
            del logits
        for it in (i for i in items if i["audio"]):
            rows = served[str(it["seed"])] if str(it["seed"]) in served else None
            want = pcm16(ref.audio(params, cfg, it, rows).cpu().numpy())
            got = np.load(os.path.join(args.run_dir, f"pcm{it['i']}.npy")).astype(np.float64)
            if len(got) != len(want) or len(got) != it["samples"]:
                print(f"request {it['i']}: {len(got)} samples served, the reference makes "
                      f"{len(want)}, {it['samples']} asked", file=sys.stderr)
                err = FAIL
            else:
                err = rel_err(got, want)
                if args.control:
                    torch.backends.cudnn.allow_tf32 = True
                    low = pcm16(ref.audio(params, cfg, it, rows).cpu().numpy())
                    common.strict_f32()
                    control["audio_err"] = max(control.get("audio_err", 0.0), rel_err(low, want))
            numbers["audio_err"] = max(numbers["audio_err"] or 0.0, err)
    if reader is not None:
        reader.close()
    ok = guard.check("the reference check", extra=(guard.PROGRAM,))
    print(json.dumps({"numbers": numbers, "control": control, "guard_ok": ok}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
