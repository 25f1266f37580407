#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, run once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

This process is the load generator and imports no torch.  It starts the
server's process (server_child.py: the program under test, on the card),
which makes the weights from the seed, builds the port's HTTP server and
warms it; here one request per (format, top_k) of the cell's traffic warms
the HTTP path; set-up ends there.  Then the window: the traffic
(benchlib/traffic.py) for --seconds, timed on the host clock; requests
still due are waited for up to DRAIN_S past its close.  After the server's
process has written what it served and exited, the reference check
(check.py, its own process) judges the served tokens and audio.  The
cell's metrics are then read, each by metrics/<name>.py: end-to-end ones
with --trace 0, per-layer ones with --trace 1 (which also profiles a slice
of the window in the server's process).

The last line on stdout is one JSON object: correct, attempted, failed,
metrics, device (and with --trace 1 busy_s, window_s and breakdown), and
`check`, each number compared with its limit, which the last lines on
stderr repeat.  With --control 1 the numbers judged are the control's (the
reference one precision down in the program's place), by the same limits,
so a sound control comes out not correct.  No card, too few cards, a
forbidden import (jax, jaxlib, flax, tts_tpu) in any of the three
processes, or a failed reading: exit 1 and no result line."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import numpy as np  # noqa: E402

from benchlib import client, guard, spec, traffic  # noqa: E402
from benchlib import trace as tracing  # noqa: E402

ROOT = spec.ROOT
RUNS = os.path.join(ROOT, "build", "bench", "runs")
DRAIN_S = 60.0            # how long past the window a request due in it is waited for
SETUP_LIMIT_S = 1150.0    # a first run in a checkout builds the kernels
CHECK_LIMIT_S = 300.0
WARM_FRAMES = 120         # a warm request: two and a half streamed chunks


class Failure(Exception):
    """The run cannot report: no result line, exit 1."""


class Server:
    """The server's process, driven over its stdin/stdout."""

    def __init__(self, args, run_dir: str, device: str, max_frames: int):
        env = dict(os.environ)
        env.update(TORCH_EXTENSIONS_DIR=os.path.join(ROOT, "build", "bench", "torch_extensions"),
                   TRITON_CACHE_DIR=os.path.join(ROOT, "build", "bench", "triton"),
                   USE_FLAX="0", USE_JAX="0", OMP_NUM_THREADS=env.get("OMP_NUM_THREADS", "4"))
        self.log_path = os.path.join(run_dir, "server.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(BENCH_DIR, "server_child.py"),
             "--workload", args.workload, "--seed", str(args.seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace),
             "--max-frames", str(max_frames), "--run-dir", run_dir, "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True,
            cwd=ROOT, env=env)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def reply(self, timeout: float) -> dict:
        try:
            line = self.lines.get(timeout=timeout)
        except queue.Empty:
            line = None
        if line is None:
            raise Failure(f"the server's process gave no answer (exit {self.proc.poll()})")
        return json.loads(line)

    def cmd(self, obj: dict, timeout: float = 120.0) -> dict:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()
        return self.reply(timeout)

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.log.close()

    def tail(self, n: int = 4000) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()[-n:]


def run_window(reqs: list, tr: dict, port: int, seconds: float, t0: float) -> list:
    """Send the traffic; returns one client record per request sent."""
    t1 = t0 + seconds
    timeout = seconds + DRAIN_S
    out = []
    if tr["loop"] == "closed":
        for r in reqs:
            now = time.perf_counter()
            if now >= t1:
                break
            res = client.send(port, r["body"], timeout)
            out.append({**r, **res, "due_abs": res["t_sent"] if r["due"] is None else t0})
        return out
    results: dict = {}

    def go(r):
        results[r["i"]] = client.send(port, r["body"], timeout)

    threads = []
    for r in reqs:
        delay = t0 + r["due"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=go, args=(r,), daemon=True)
        th.start()
        threads.append((r, th))
    deadline = t1 + DRAIN_S
    for r, th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
        res = results.get(r["i"]) or {"t_sent": None, "t_first": None, "t_done": None,
                                      "status": None, "pcm": b"", "error": "not done in time"}
        out.append({**r, **res, "due_abs": t0 + r["due"]})
    return out


def pick(rng: random.Random, pool: list, n: int) -> list:
    """n of pool drawn with rng, always with the one that has the most frames."""
    if not pool:
        return []
    longest = max(pool, key=lambda r: r["frames"])
    rest = [r for r in pool if r is not longest]
    return [longest] + rng.sample(rest, min(n - 1, len(rest)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one benchmark cell, run once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the reference at a lower precision in the program's "
                        "place (the correctness control; never part of a measured run)")
    p.add_argument("--rate", type=float, default=None,
                   help="offer this rate (requests/s) instead of the cell's: the knee sweep "
                        "(sweep.py), never a measured run")
    args = p.parse_args(argv)
    device = os.environ.get("BENCH_TEST_DEVICE", "cuda")

    bench = spec.load_bench()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    tr = spec.traffic(cell)
    if args.rate is not None:
        tr["rate_per_s"] = args.rate
    model = spec.module("models", cfg["model"])
    reqs = traffic.schedule(tr, model, args.seed, args.seconds)
    run_dir = os.path.join(RUNS, args.workload)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)

    server = Server(args, run_dir, device, max(r["frames"] for r in reqs))
    try:
        ready = server.reply(SETUP_LIMIT_S)
        t_ready = time.perf_counter()
        port = ready["port"]
        warm = {}
        longest = max(reqs, key=lambda r: len(r["body"]["input"]))["body"]["input"]
        for r in reqs:
            key = (r["body"]["response_format"], r["top_k"])
            if key not in warm:
                body = {**r["body"], "input": longest,
                        "max_tokens": model.max_tokens(WARM_FRAMES)}
                warm[key] = client.send(port, body, SETUP_LIMIT_S)
                if warm[key]["error"]:
                    raise Failure(f"warm request {key} failed: {warm[key]['error']}")
        setup_s = time.perf_counter() - T_PROCESS
        print(f"setup: {setup_s:.3f} s (the server's process: start {ready['start_s']:.3f} s, "
              f"weights {ready['weights_s']:.3f} s, the port's import {ready['import_s']:.3f} s, "
              f"load and warm-up {ready['load_and_warm_s']:.3f} s; warm requests "
              f"{time.perf_counter() - t_ready:.3f} s)", file=sys.stderr)

        t0 = time.perf_counter() + 0.05
        server.cmd({"cmd": "window", "t0": t0})
        time.sleep(max(0.0, t0 - time.perf_counter()))
        sent = run_window(reqs, tr, port, args.seconds, t0)
        server.cmd({"cmd": "end"}, timeout=600)
        server.close()
    except Failure as e:
        server.close()
        print(f"run failed: {e}\n--- server log (end) ---\n{server.tail()}", file=sys.stderr)
        return 1
    except BaseException:
        server.close()
        raise
    if server.proc.returncode not in (0, None):
        print(f"the server's process exited {server.proc.returncode}\n{server.tail()}",
              file=sys.stderr)
        return 1
    with open(os.path.join(run_dir, "server.json")) as f:
        served = json.load(f)

    # ---- outcomes
    for r in sent:
        pcm = np.frombuffer(r.pop("pcm"), "<i2")
        rec = served["served"].get(str(r["body"]["seed"]))
        r["served"] = rec
        r["ok"] = (r["error"] is None and r["status"] == 200 and rec is not None
                   and len(pcm) == r["samples"])
        r["_pcm"] = pcm
    with open(os.path.join(run_dir, "requests.json"), "w") as f:
        json.dump([{k: r[k] for k in ("i", "due_abs", "t_sent", "t_first", "t_done", "ok",
                                      "audio_s", "frames", "top_k")} | {"t0": t0}
                   for r in sent], f)
    late = [r["t_sent"] - r["due_abs"] for r in sent if r["due"] is not None and r["t_sent"]]
    if late:
        print(f"generator: {len(late)} requests sent, at most {max(late) * 1e3:.3f} ms "
              f"after they were due", file=sys.stderr)

    # ---- the reference check, on a sample drawn from the seed
    rng = random.Random(args.seed ^ 0x5EED)
    done = [r for r in sent if r["ok"]]
    greedy = pick(rng, [r for r in done if r["top_k"] == 1], 2)
    audio = pick(rng, done, 2)
    in_greedy, in_audio = {id(r) for r in greedy}, {id(r) for r in audio}
    items = []
    for r in {id(r): r for r in greedy + audio}.values():
        np.save(os.path.join(run_dir, f"pcm{r['i']}.npy"), r["_pcm"])
        items.append({"i": r["i"], "seed": r["body"]["seed"], "text": r["body"]["input"],
                      "max_tokens": r["body"]["max_tokens"], "top_k": r["top_k"],
                      "T": r["served"]["T"], "frames": r["frames"], "samples": r["samples"],
                      "logits": id(r) in in_greedy, "audio": id(r) in in_audio})
    with open(os.path.join(run_dir, "check_in.json"), "w") as f:
        json.dump({"workload": args.workload, "items": items}, f)
    t_check = time.perf_counter()
    chk = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "check.py"),
                          "--run-dir", run_dir, "--workload", args.workload, "--seed",
                          str(args.seed), "--device", device, "--control", str(args.control)],
                         capture_output=True, text=True, cwd=ROOT, timeout=CHECK_LIMIT_S)
    if chk.returncode != 0:
        print(f"the check failed (exit {chk.returncode})\n{chk.stderr[-4000:]}", file=sys.stderr)
        return 1
    numbers = json.loads(chk.stdout.strip().splitlines()[-1])
    print(f"check: {len(items)} requests judged in {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    judged = numbers["control"] if args.control else numbers["numbers"]
    if args.control:
        print(f"control run: judging the control's numbers; the program's read "
              f"{numbers['numbers']}", file=sys.stderr)
    check = {name: {"value": judged.get(name), "limit": limit}
             for name, limit in cfg["correct_limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in check.values())

    # ---- metrics
    t1 = t0 + args.seconds
    ctx = {"requests": sent, "t0": t0, "t1": t1, "drain_s": DRAIN_S, "setup_s": setup_s, "cfg": cfg,
           "model": model, "server": served, "trace": None}
    device_info = {**ready["device"], "memory_peak_bytes": served["memory_peak_bytes"]}
    if args.trace:
        sl = served.get("slice")
        if sl is None:
            print("the traced slice never started: no decode row came after it was armed",
                  file=sys.stderr)
            return 1
        ops = tracing.load(os.path.join(run_dir, "trace.json"))
        os.remove(os.path.join(run_dir, "trace.json"))
        ctx["trace"] = tracing.summarize(ops, sl["t_off"] - sl["t_on"], sl["ns_on"],
                                         served["spans"])
        ctx["slice"] = sl
        print(f"trace: a slice of {sl['rows']} decode rows and {len(sl['prompts'])} prefills, "
              f"{ctx['trace']['window_s']:.3f} s, {len(ops)} device operations", file=sys.stderr)
        device_info.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
    metrics = {}
    try:
        for m in spec.metrics_for(bench, cell, bool(args.trace)):
            v = spec.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    except ValueError as e:
        print(f"a reading failed: {e}", file=sys.stderr)
        return 1

    ok = guard.check("the load generator") and served["guard_ok"] and numbers["guard_ok"]
    if not ok:
        return 1
    attempted = len(sent)
    failed = sum(not r["ok"] for r in sent)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["check"] = check
    for name, c in check.items():
        print(f"check: {name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
