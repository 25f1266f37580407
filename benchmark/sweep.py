#!/usr/bin/env python3
"""The knee sweep of an open-loop cell: the cell's traffic at each offered
rate, on several seeds, one run.py run each, and whether the backlog grew
through the window.

    python3 benchmark/sweep.py --workload parler-chat --seconds S \\
        --seeds N1 N2 N3 --rates 1.2 1.4 ...

The backlog at a moment is the requests due by then less those completed.
It grows when its least-squares slope over the window, times the window,
exceeds GROWTH requests: a queue fed faster than it is served grows all
through the window, while below that its excursions come and go.  The knee
is the highest rate at which it grew on none of the seeds, nor at any lower
rate swept; a cell's fixed rate is 0.8 of the knee, found once and written
into cells/<cell>.json.  Prints one line per run and a JSON line with all
of them, each with the server's utilization (the share of the time to the
last completion in which a request was in service, one at a time) and the
share of the requests due in the window that completed in it."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
GROWTH = 2.0
STEP_S = 0.25


def backlog(reqs: list, t0: float, seconds: float) -> list[float]:
    """The backlog every STEP_S seconds of the window."""
    dues = sorted(r["due_abs"] for r in reqs)
    dones = sorted(r["t_done"] if r["ok"] else float("inf") for r in reqs)
    out, t = [], t0
    while t <= t0 + seconds:
        out.append(sum(d <= t for d in dues) - sum(d <= t for d in dones))
        t += STEP_S
    return out


def slope(values: list) -> float:
    """Least-squares slope of values sampled every STEP_S seconds, per second."""
    n = len(values)
    xs = [i * STEP_S for i in range(n)]
    mx, my = sum(xs) / n, sum(values) / n
    return (sum((x - mx) * (y - my) for x, y in zip(xs, values))
            / sum((x - mx) ** 2 for x in xs))


def one(workload: str, seed: int, seconds: float, rate: float) -> dict:
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          workload, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", "0", "--rate", str(rate)],
                         capture_output=True, text=True, cwd=ROOT)
    if out.returncode != 0:
        print(f"rate {rate} seed {seed}: run.py failed\n{out.stderr[-2000:]}", file=sys.stderr)
        return {"rate": rate, "seed": seed, "failed": True}
    result = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "build", "bench", "runs", workload, "requests.json")) as f:
        reqs = json.load(f)
    t0 = reqs[0]["t0"]
    growth = slope(backlog(reqs, t0, seconds)) * seconds
    busy, free = 0.0, t0
    for r in sorted((r for r in reqs if r["ok"]), key=lambda r: r["t_done"]):
        busy += r["t_done"] - max(free, r["t_sent"])
        free = r["t_done"]
    due = [r for r in reqs if r["due_abs"] <= t0 + seconds]
    in_time = sum(r["ok"] and r["t_done"] <= t0 + seconds for r in due)
    return {"rate": rate, "seed": seed, "attempted": result["attempted"],
            "failed": result["failed"], "correct": result["correct"],
            "backlog_growth": growth, "grows": growth > GROWTH,
            "completed_share": in_time / len(due), "utilization": busy / (free - t0),
            **{k: v["value"] for k, v in result["metrics"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the knee sweep of an open-loop cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    rows = []
    for rate in args.rates:
        for seed in args.seeds:
            rows.append(one(args.workload, seed, args.seconds, rate))
            print(" ".join(f"{k}={v}" for k, v in rows[-1].items()), flush=True)
    grew = {r["rate"] for r in rows if r.get("failed") or r["grows"]}
    knee = None
    for rate in sorted(args.rates):
        if rate in grew:
            break
        knee = rate
    print(json.dumps({"workload": args.workload, "knee": knee, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
