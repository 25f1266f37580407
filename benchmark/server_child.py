"""The server's process of a benchmark run: the program under test.

    python benchmark/server_child.py --workload W --seed N --seconds S --trace 0|1
                                     --max-frames F --run-dir D [--device cuda]

Started by run.py, which drives it over stdin/stdout (one JSON object a
line) and sends the load over HTTP.  Set-up, in order: the configuration's
weights from the seed (benchlib/weights.py, cached in the checkout per
seed); the port's `ServerState` and `make_server` with the server's own
default flags; the port's `warmup` at a short token cap; the model's own `warm`
(models/<m>.py: the DAC at the run's longest frame count); in a traced run one empty profile (the
profiler's first start is slow).  It then prints {"ready": ...} and serves.

Commands on stdin: {"cmd": "window", "t0": perf} resets the records and,
in a traced run, arms the profiler for the slice of the window (`Slice`);
{"cmd": "end"} writes what was served and recorded into the run directory;
{"cmd": "quit"} stops the server.

What it records, around the program's own functions (models/<m>.py
`install_hooks`, and here the runner, the captured step and the DAC):
each request's prompt length and decoded rows, spans on the wall clock
(prefill or encode, decode, dac, request), and the rows and prefills
inside the traced slice."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the benchmark's own modules, then the checkout's root, where the program is
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import numpy as np  # noqa: E402

from benchlib import guard, spec  # noqa: E402

ROOT = spec.ROOT
CACHE = os.path.join(ROOT, "build", "bench")
WARM_TOKENS = 48            # the port's warmup at a short cap (random weights never stop)
# the idle time around the profiler's start and stop, outside the slice: without
# it the trace lost the kernels of the first decode step after the start
SETTLE_S = 0.02
TRACE_AT = 0.4              # the traced slice starts at the first request from here on
TRACE_S = 1.0               # ... and lasts this long (the profiler's trace of a Parler
                            # second holds ~250,000 kernels)


class Slice:
    """The traced part of the window: the profiler runs from the start of
    the first request at or after `start_at` (before its prefill or
    encoder) to the first decode-row boundary at or after `length` seconds
    later (or the window's end), each edge after a device sync, counting
    the rows and prefills it holds.  A narrate request decodes for 2.7 s or
    more, so there the slice is one request's prefill and its first second
    of decode rows, never a boundary between requests."""

    def __init__(self, sync):
        self.sync, self.state, self.prof = sync, "off", None
        self.rows, self.prompts = 0, []
        self.t_on = self.t_off = self.ns_on = None

    def arm(self, start_at: float, length: float):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.start_at, self.length, self.state = start_at, length, "armed"

    def _stop(self):
        self.sync()
        self.t_off = time.perf_counter()
        time.sleep(SETTLE_S)
        self.prof.stop()
        self.state = "done"

    def request(self):
        if self.state == "armed" and time.perf_counter() >= self.start_at:
            self.sync()
            self.prof.start()
            time.sleep(SETTLE_S)
            self.t_on, self.ns_on, self.state = time.perf_counter(), time.time_ns(), "on"

    def boundary(self):
        if self.state == "on" and time.perf_counter() >= self.t_on + self.length:
            self._stop()

    def row(self):
        if self.state == "on":
            self.rows += 1

    def prefill(self, n: int):
        if self.state == "on":
            self.prompts.append(n)

    def finish(self):
        if self.state == "on":
            self._stop()


class Recorder:
    """What the program served, keyed by each request's seed."""

    def __init__(self, sync):
        self.slice = Slice(sync)
        self.reset()

    def reset(self):
        self.served, self.current, self.spans = {}, None, []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def begin(self, config):
        self.slice.request()
        self.current = {"seed": config.seed, "top_k": config.top_k, "T": None, "rows": [],
                        "t0": time.perf_counter()}

    def end(self):
        cur, self.current = self.current, None
        if cur is not None:
            cur["t1"] = time.perf_counter()
            self.served[cur["seed"]] = cur

    def prefill(self, n: int):
        if self.current is not None:
            self.current["T"] = n
        self.slice.prefill(n)

    def rows(self, rows):
        if self.current is not None:
            self.current["rows"].append(np.asarray(rows, np.int32))

    def wrap_runner(self, cls):
        rec, generate, stream = self, cls.generate, getattr(cls, "generate_stream", None)

        def gen(runner, text, config=None):
            rec.begin(config)
            try:
                with rec.span("request"):
                    return generate(runner, text, config)
            finally:
                rec.end()

        def gen_stream(runner, text, config=None, *args, **kw):
            rec.begin(config)
            t0 = time.time_ns()
            try:
                yield from stream(runner, text, config, *args, **kw)
            finally:
                rec.spans.append(("request", t0, time.time_ns()))
                rec.end()

        cls.generate = gen
        if stream is not None:
            cls.generate_stream = gen_stream

    def wrap_step(self, cls):
        sl, run = self.slice, cls.run

        def step_run(step):
            sl.boundary()
            run(step)
            sl.row()

        cls.run = step_run

    def wrap_dac(self, cls):
        rec, decode = self, cls.decode

        def dac_decode(dac, codes):
            with rec.span("dac"):
                return decode(dac, codes)

        cls.decode = dac_decode


def say(obj: dict):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--max-frames", type=int, required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    bench = spec.load_bench()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    model = spec.module("models", cfg["model"])

    import torch

    device = args.device
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"server: the cell needs {cell['chips']} card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        sync = torch.cuda.synchronize
        # the precision the configuration states (PyTorch's defaults let cuDNN
        # run float32 convolutions in TF32)
        torch.backends.cuda.matmul.allow_tf32 = cfg["allow_tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]
    else:
        sync = lambda: None  # noqa: E731
    t_w = time.perf_counter()
    start_s = t_w - T_PROCESS
    path = model.model_path(cfg, args.seed, os.path.join(CACHE, "weights"), device)
    weights_s = time.perf_counter() - t_w
    if device == "cuda":
        torch.cuda.empty_cache()

    from tts_tpu_torch.apps import server as srv
    from tts_tpu_torch.codecs.dac import DACDecoder
    from tts_tpu_torch.runtime.api import GenerationConfig
    from tts_tpu_torch.runtime.step_graph import CapturedStep

    import_s = time.perf_counter() - t_w - weights_s

    fault = os.environ.get("BENCH_TEST_FAULT")
    if fault:           # tests only: a fault planted under the hooks (tests/faults.py)
        spec.module("tests", "faults").plant(fault)
    rec = Recorder(sync)
    rec.wrap_runner(model.install_hooks(rec))
    rec.wrap_step(CapturedStep)
    rec.wrap_dac(DACDecoder)

    # the server's own defaults, as `python -m tts_tpu_torch.apps.server` sets them
    a = srv.build_parser().parse_args(["--model-path", path, "--device", device])
    default = GenerationConfig(voice=a.voice, temperature=a.temperature, top_k=a.topk,
                               top_p=a.top_p, repetition_penalty=a.repetition_penalty)
    models = {path[5:]: path} if path.startswith("test:") else srv.discover_models(path)
    state = srv.ServerState(models, default, a.n_parallelism,
                            request_timeout=a.request_timeout, device=device)
    t_l = time.perf_counter()
    if not srv.warmup(state, dataclasses.replace(default, max_tokens=WARM_TOKENS)):
        return 4
    if hasattr(model, "warm"):
        runner, lock = state._get_runner(state.default_model)
        with lock:
            model.warm(runner, args.max_frames)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()
    sync()
    warm_s = time.perf_counter() - t_l
    server = srv.make_server(state, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    say({"ready": True, "port": server.server_address[1], "start_s": start_s,
         "weights_s": weights_s, "import_s": import_s, "load_and_warm_s": warm_s,
         "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                    "count": cell["chips"]}})

    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "window":
            rec.reset()
            if args.trace:
                rec.slice.arm(cmd["t0"] + TRACE_AT * args.seconds, TRACE_S)
            say({"ok": True})
        elif cmd["cmd"] == "end":
            rec.slice.finish()
            sync()
            out = {"served": {}, "spans": rec.spans, "guard_ok": guard.check("the server"),
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if device == "cuda" else 0)}
            tokens = {}
            for seed, r in rec.served.items():
                rows = np.concatenate(r["rows"]) if r["rows"] else np.zeros((0, 9), np.int32)
                tokens[str(seed)] = rows
                out["served"][str(seed)] = {"T": r["T"], "rows": len(rows), "top_k": r["top_k"],
                                            "t0": r["t0"], "t1": r["t1"]}
            np.savez(os.path.join(args.run_dir, "served.npz"), **tokens)
            sl = rec.slice
            if sl.state == "done":
                sl.prof.export_chrome_trace(os.path.join(args.run_dir, "trace.json"))
                out["slice"] = {"rows": sl.rows, "prompts": sl.prompts, "t_on": sl.t_on,
                                "t_off": sl.t_off, "ns_on": sl.ns_on}
            with open(os.path.join(args.run_dir, "server.json"), "w") as f:
                json.dump(out, f)
            say({"ok": True})
        elif cmd["cmd"] == "quit":
            break
    server.shutdown()
    srv.stop_workers(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
