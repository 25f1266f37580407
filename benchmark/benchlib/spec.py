"""What `BENCHMARK.json` names, found by name in the benchmark's own folders.

A cell (`workloads` entry) names a configuration and a traffic mix.  Each is
a file of its own: `configs/<file>` (as the configuration entry gives it),
`traffic/<traffic>.json`, and optionally `cells/<cell>.json`, whose keys
override the mix's for that cell alone (an offered rate found for one
model).  The configuration's `model` key names `models/<model>.py` (sizes,
weights, work counts, hooks) and `reference/<model>.py`; each metric is
`metrics/<name>.py`.  Adding any of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, with its BENCHMARK.json entry under `entry`."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                out = json.load(f)
            out["entry"] = c
            return out
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(cell: dict) -> dict:
    """The mix's parameters, with the cell's own overrides applied."""
    with open(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")) as f:
        out = json.load(f)
    override = os.path.join(BENCH_DIR, "cells", f"{cell['name']}.json")
    if os.path.exists(override):
        with open(override) as f:
            out.update(json.load(f)["traffic"])
    return out


def module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, imported by path (names may hold '-' or '.')."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    key = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (trace on):
    those that list the cell, or list no cells at all."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]
