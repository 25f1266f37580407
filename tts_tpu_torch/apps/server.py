"""tts-server on the port: the OpenAI-compatible speech REST API, with runners
loaded by `tts_tpu_torch` onto `--device`.

    python -m tts_tpu_torch.apps.server --model-path model.gguf --device cuda

The port's own copy of `tts_tpu/apps/server.py` (the same endpoints, request
fields, error JSON and headers):
  POST /v1/audio/speech            {input, model?, voice?, temperature?,
                                    top_k?, top_p?, repetition_penalty?,
                                    max_tokens?, sample?, seed?,
                                    response_format? (wav|wave|aiff|pcm)}
  POST /v1/audio/conditional-prompt {prompt, text_encoder_path}
  GET  /v1/models                  OpenAI-style model list
  GET  /v1/audio/voices            {model: [voices...]}
  GET  /health                     {"status":"ok"}
  GET  /                           minimal index page

A task queue feeds a pool of worker threads that share one runner per model
(its KV cache makes generation single-flight, under the runner's lock).
--data-parallel commits one replica per visible card and worker w drives
replica w % n; --tensor-parallel N cuts each replica over N distinct cards
(Orpheus; one replica unless --data-parallel), and raises where fewer are
visible.  --warmup loads the default model and synthesizes the JAX
server's three graded prompts and one streamed first chunk before serving:
on the port that builds the kernels, captures the Orpheus decode graph of
the default sampling key and meets the codecs' shapes, so none of that
lands on a client's request.  The JAX warmup's bucket pinning
(`freeze_warm_buckets`) has nothing to pin here: the port runs exact
shapes, with no bucket ladder.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tts_tpu_torch.apps.web_ui import INDEX_HTML
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError
from tts_tpu_torch.utils import trace
from tts_tpu_torch.utils.audio import encode_aiff, encode_wav


def error_json(message: str, etype: str = "invalid_request_error", code: int = 400):
    return code, {"error": {"message": message, "type": etype, "code": code}}


class ServerState:
    """Task queue + worker pool; runners come from `runner_from_file` on
    `device`.  All workers share one runner per model, serialized by its
    lock; different models run concurrently, and host-side JSON/WAV work
    overlaps device compute.  With data_parallel (or tensor_parallel > 1)
    the runners are replicas on the visible cards instead
    (`parallel.serving.replica_meshes`): one per (model, card or tp group),
    worker w driving replica w % n."""

    def __init__(self, model_paths: dict[str, str], default_config: GenerationConfig,
                 n_parallelism: int = 1, request_timeout: float = 1800.0,
                 device="cuda", data_parallel: bool = False, tensor_parallel: int = 1):
        self.model_paths = model_paths
        self.default_model = next(iter(model_paths))
        self.default_config = default_config
        self.request_timeout = request_timeout
        self.device = device
        self._targets = None
        if data_parallel or tensor_parallel > 1:
            from tts_tpu_torch.parallel.serving import replica_meshes
            self._targets = replica_meshes(tensor_parallel, None if data_parallel else 1)
        self.tasks: queue.Queue = queue.Queue()
        self.results: dict[str, dict] = {}
        self.abandoned: set[str] = set()      # ids whose submitter timed out
        self.results_cv = threading.Condition()
        self._runners: dict = {}
        self._runner_locks: dict = {}
        self._cache_lock = threading.Lock()
        self.workers = []
        for wid in range(max(n_parallelism, 1)):
            w = threading.Thread(target=self._worker_loop, args=(wid,), daemon=True)
            w.start()
            self.workers.append(w)

    def _get_runner(self, model: str, wid: int = 0):
        """The runner worker `wid` drives for `model`, and its lock; each
        loads at most once: the model's one shared runner, or under data
        parallelism the replica (model, wid % n) on its card or tp group."""
        key = model if self._targets is None else (model, wid % len(self._targets))
        with self._cache_lock:
            lock = self._runner_locks.setdefault(key, threading.Lock())
        with lock:
            if key not in self._runners:
                if isinstance(key, tuple):
                    from tts_tpu_torch.parallel.serving import load_replica
                    self._runners[key] = load_replica(
                        self.model_paths[model], self.default_config, self._targets[key[1]])
                else:
                    self._runners[key] = runner_from_file(
                        self.model_paths[model], self.default_config, device=self.device)
        return self._runners[key], lock

    @contextlib.contextmanager
    def _serve(self, lock, task):
        """Hold the runner's lock for `task`: its `wait` span (the handler's)
        ends once the lock is held, and its `service` span runs while it is."""
        with lock:
            task.get("wait", trace.NOOP).end()
            with trace.span("service", parent=task.get("span", trace.NOOP)) as service:
                yield service

    def _worker_loop(self, wid: int = 0):
        while True:
            task = self.tasks.get()
            if task is None:
                return
            result = {"success": False, "message": "unknown error"}
            t0 = time.perf_counter()
            try:
                runner, lock = self._get_runner(task["model"], wid)
                if task["kind"] == "tts_stream":
                    # a runner with generate_stream (Kokoro) sends each chunk
                    # as it is made; the others send the whole utterance
                    chunks, cancel = task["chunks"], task["cancel"]
                    try:
                        with self._serve(lock, task) as service:
                            if hasattr(runner, "generate_stream"):
                                for piece in runner.generate_stream(task["prompt"],
                                                                    task["config"]):
                                    if cancel.is_set():
                                        break  # client gone / timed out
                                    service.stamp("t_first_ns")
                                    chunks.put(piece)
                            else:
                                audio = runner.generate(task["prompt"], task["config"]).audio
                                service.stamp("t_first_ns")
                                chunks.put(audio)
                        result = {"success": True}
                    finally:
                        chunks.put(None)          # end-of-stream sentinel
                elif task["kind"] == "tts":
                    with self._serve(lock, task) as service:
                        resp = runner.generate(task["prompt"], task["config"])
                        service.stamp("t_first_ns")
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    result = {"success": True, "audio": resp.audio,
                              "sample_rate": resp.sample_rate,
                              "wall_ms": wall_ms,
                              "rtf": (wall_ms / 1e3 / resp.duration_s
                                      if resp.duration_s else None),
                              "timings": resp.timings}
                elif task["kind"] == "voices":
                    voices = {}
                    for m in self.model_paths:
                        r, l = self._get_runner(m, wid)
                        with l:
                            voices[m] = r.list_voices()
                    result = {"success": True, "voices": voices}
                elif task["kind"] == "conditional":
                    with lock:
                        runner.update_conditional_prompt(
                            task["text_encoder_path"], task["prompt"])
                    result = {"success": True}
            except TTSError as e:
                result = {"success": False, "message": str(e), "user_error": True}
            except Exception as e:  # worker must survive any failure
                result = {"success": False, "message": f"{type(e).__name__}: {e}"}
            if "chunks" in task:
                continue  # streaming tasks deliver through their chunk queue
            with self.results_cv:
                if task["id"] in self.abandoned:
                    self.abandoned.discard(task["id"])  # nobody is waiting
                else:
                    self.results[task["id"]] = result
                    self.results_cv.notify_all()

    def submit(self, task: dict, timeout: float | None = None) -> dict:
        timeout = timeout or self.request_timeout
        if "id" not in task:
            task["id"] = uuid.uuid4().hex
        self.tasks.put(task)
        with self.results_cv:
            ok = self.results_cv.wait_for(lambda: task["id"] in self.results,
                                          timeout=timeout)
            if not ok:
                # the worker drops the late result instead of leaking it
                self.abandoned.add(task["id"])
                return {"success": False, "message": "request timed out"}
            return self.results.pop(task["id"])


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            print(f"[srv] {self.address_string()} {fmt % args}", file=sys.stderr)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                return json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return None

        def do_GET(self):
            if self.path == "/health":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                models = [{"id": m, "object": "model", "owned_by": "tts_tpu"}
                          for m in state.model_paths]
                self._send_json(200, {"object": "list", "data": models})
            elif self.path == "/v1/audio/voices":
                result = state.submit({"kind": "voices", "model": state.default_model})
                if result["success"]:
                    self._send_json(200, result["voices"])
                else:
                    self._send_json(*error_json(result["message"], "server_error", 500))
            elif self.path == "/":
                self._send(200, INDEX_HTML, "text/html")
            else:
                self._send_json(*error_json("not found", "invalid_request_error", 404))

        def do_POST(self):
            if self.path == "/v1/audio/speech":
                self.handle_tts()
            elif self.path == "/v1/audio/conditional-prompt":
                self.handle_conditional()
            else:
                self._send_json(*error_json("not found", "invalid_request_error", 404))

        def handle_tts(self):
            """One speech request inside its `http` span (from the parsed body
            to the last byte written), whose request id is the task's id."""
            data = self._read_json()
            t_req, rid = time.perf_counter_ns(), uuid.uuid4().hex
            http = trace.span("http", request=rid, start_ns=t_req)
            try:
                self._tts(data, rid, http, t_req)
            finally:
                http.end()

        def _tts(self, data, rid: str, http, t_req: int):
            if data is None or not isinstance(data.get("input"), str):
                self._send_json(*error_json(
                    "the 'input' field is required for tts generation and must "
                    "be passed as a string."))
                return
            if not data["input"]:
                self._send_json(*error_json("the 'input' field must be a non empty string"))
                return
            fmt = data.get("response_format", "wav")
            if fmt not in ("wav", "wave", "aiff", "pcm"):
                self._send_json(*error_json(
                    "Currently 'wav', 'aiff' and 'pcm' (streaming) are the only "
                    "supported formats for the 'response_format' field.",
                    "not_supported_error"))
                return
            model = data.get("model", state.default_model)
            if model not in state.model_paths:
                self._send_json(*error_json(f"Invalid Model: {model}"))
                return
            d = state.default_config
            try:
                cfg = GenerationConfig(
                    temperature=float(data.get("temperature", d.temperature)),
                    top_k=int(data.get("top_k", d.top_k)),
                    top_p=float(data.get("top_p", d.top_p)),
                    repetition_penalty=float(data.get("repetition_penalty",
                                                      d.repetition_penalty)),
                    voice=data.get("voice", d.voice),
                    max_tokens=int(data.get("max_tokens", d.max_tokens)),
                    sample=bool(data.get("sample", d.sample)),
                    seed=int(data["seed"]) if data.get("seed") is not None else d.seed,
                )
            except (TypeError, ValueError) as e:
                self._send_json(*error_json(f"invalid sampling parameter: {e}"))
                return
            if fmt == "pcm":
                self.stream_pcm(model, data["input"], cfg, rid, http, t_req)
                return
            result = state.submit({"id": rid, "kind": "tts", "model": model,
                                   "prompt": data["input"], "config": cfg, "span": http,
                                   "wait": trace.span("wait", parent=http)})
            if not result["success"]:
                code = 400 if result.get("user_error") else 500
                self._send_json(*error_json(result["message"], "server_error", code))
                return
            if fmt == "aiff":
                body = encode_aiff(result["audio"], result["sample_rate"])
                ctype = "audio/aiff"
            else:
                body = encode_wav(result["audio"], result["sample_rate"])
                ctype = "audio/wav"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if result.get("wall_ms") is not None:
                self.send_header("X-Generation-Time-Ms", f"{result['wall_ms']:.1f}")
            if result.get("rtf") is not None:
                self.send_header("X-RTF", f"{result['rtf']:.4f}")
            self.end_headers()
            self.wfile.write(body)
            rtf = result.get("rtf")
            print(f"[srv] tts done: model={model} wall={result.get('wall_ms', 0):.1f} ms "
                  f"rtf={rtf if rtf is None else round(rtf, 4)} "
                  f"timings={result.get('timings')}", file=sys.stderr)

        def stream_pcm(self, model: str, prompt: str, cfg: GenerationConfig, rid: str,
                       http, t_req: int):
            """Chunked-transfer stream of 16-bit little-endian PCM; the first
            chunk arrives at time-to-first-audio.  `cancel` stops the
            worker's generation if the client goes or a chunk times out.
            The `ttfa=` line reads the clock readings of the `http` span."""
            chunks: queue.Queue = queue.Queue()
            cancel = threading.Event()
            state.tasks.put({"id": rid, "kind": "tts_stream", "model": model,
                             "prompt": prompt, "config": cfg, "chunks": chunks,
                             "cancel": cancel, "span": http,
                             "wait": trace.span("wait", parent=http)})
            self.send_response(200)
            self.send_header("Content-Type", "audio/pcm")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            t_first = None
            n_samples = 0
            status = "done"
            try:
                while True:
                    try:
                        piece = chunks.get(timeout=state.request_timeout)
                    except queue.Empty:
                        status = "timeout"
                        break
                    if piece is None:
                        break
                    if t_first is None:
                        t_first = time.perf_counter_ns()
                        http.set("t_first_ns", t_first)
                    n_samples += len(piece)
                    pcm = (np.clip(piece, -1, 1) * 32767).astype("<i2").tobytes()
                    if pcm:
                        self.wfile.write(f"{len(pcm):X}\r\n".encode())
                        self.wfile.write(pcm)
                        self.wfile.write(b"\r\n")
                if status == "done":
                    self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                status = "client disconnected"
            finally:
                if status != "done":
                    cancel.set()
            t_end = time.perf_counter_ns()
            http.set("samples", n_samples)
            http.end(t_end)
            ttfa_ms = None if t_first is None else (t_first - t_req) / 1e6
            print(f"[srv] stream {status}: ttfa={ttfa_ms and round(ttfa_ms, 1)} ms "
                  f"samples={n_samples} wall={(t_end - t_req) / 1e6:.1f} ms", file=sys.stderr)

        def handle_conditional(self):
            data = self._read_json() or {}
            if not isinstance(data.get("prompt"), str) or not data.get("text_encoder_path"):
                self._send_json(*error_json(
                    "'prompt' and 'text_encoder_path' are required"))
                return
            result = state.submit({"kind": "conditional", "model": state.default_model,
                                   "prompt": data["prompt"],
                                   "text_encoder_path": data["text_encoder_path"]})
            if result["success"]:
                self._send_json(200, {"status": "ok"})
            else:
                code = 400 if result.get("user_error") else 500
                self._send_json(*error_json(result["message"], "server_error", code))

    return Handler


def wrap_ssl(server, cert_file: str, key_file: str) -> str:
    """Serve HTTPS when a PEM cert+key pair is given.  Returns the URL scheme."""
    if not cert_file and not key_file:
        return "http"
    if not (cert_file and key_file):
        raise SystemExit("--ssl-file-cert and --ssl-file-key must be "
                         "passed together")
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    server.socket = ctx.wrap_socket(server.socket, server_side=True)
    print(f"Running with SSL: key = {key_file}, cert = {cert_file}",
          file=sys.stderr)
    return "https"


def discover_models(path: str) -> dict[str, str]:
    if os.path.isdir(path):
        out = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".gguf"):
                out[os.path.splitext(name)[0]] = os.path.join(path, name)
        if not out:
            raise SystemExit(f"no .gguf files found in {path}")
        return out
    name = os.path.splitext(os.path.basename(path))[0] or path
    return {name: path}


def make_server(state: ServerState, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """The HTTP server of `state` (port 0 picks a free port); the caller runs
    `serve_forever` and, when done, `shutdown` and `stop_workers(state)`."""
    return ThreadingHTTPServer((host, port), make_handler(state))


def stop_workers(state: ServerState, timeout: float = 60.0):
    """End the state's worker threads once their queued tasks are done."""
    for _ in state.workers:
        state.tasks.put(None)
    for w in state.workers:
        w.join(timeout=timeout)


# the JAX server's warm prompts: graded lengths, then the first one streamed
WARM_PROMPTS = (
    "Warm up.",
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "A longer warmup utterance exercises the larger frame buckets: "
    "it spans several clauses and phrases, so the shape ladder the "
    "server will use for typical requests is compiled before the "
    "first client request ever arrives.",
)


def warmup(state: ServerState, config: GenerationConfig) -> bool:
    """--warmup: the default model synthesizes WARM_PROMPTS with `config`
    through the task queue, then streams the first prompt's first chunk
    (a runner with generate_stream) under its lock; each failure prints
    `warmup FAILED: ...` and the last line is `warmup ok` or `warmup
    FAILED`, on stderr.  Returns True if every prompt succeeded."""
    print("warming up (model load, kernel build, decode graph capture)...", file=sys.stderr)
    ok = True
    for wp in WARM_PROMPTS:
        result = state.submit({"kind": "tts", "model": state.default_model,
                               "prompt": wp, "config": config})
        ok = ok and result["success"]
        if not result["success"]:
            print(f"warmup FAILED: {result['message']}", file=sys.stderr)
    runner, lock = state._get_runner(state.default_model)
    if hasattr(runner, "generate_stream"):
        with lock:
            for _ in runner.generate_stream(WARM_PROMPTS[0], config):
                break
    print(f"warmup {'ok' if ok else 'FAILED'}", file=sys.stderr)
    return ok


def build_parser() -> argparse.ArgumentParser:
    """The JAX server's flags, plus --device."""
    p = argparse.ArgumentParser(prog="tts-server (torch)", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", "-mp", required=True,
                   help="GGUF file, directory of GGUF files, or test:dummy")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--n-parallelism", "-np", type=int, default=1,
                   help="worker threads (sharing one runner per model unless "
                        "--data-parallel)")
    p.add_argument("--data-parallel", action="store_true",
                   help="commit one model replica per visible card and route "
                        "workers across them")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="shard each replica over this many distinct cards (Orpheus)")
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--top-p", "-tp", type=float, default=1.0)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--request-timeout", type=float, default=1800.0,
                   help="seconds to wait for a generation (a first request without "
                        "--warmup may pay the model load, the kernel build and a graph "
                        "capture)")
    p.add_argument("--warmup", action="store_true",
                   help="load the default model and synthesize a short "
                        "utterance before serving")
    p.add_argument("--ssl-file-cert", "-sfc", default="",
                   help="local path to the PEM encoded ssl cert")
    p.add_argument("--ssl-file-key", "-sfk", default="",
                   help="local path to the PEM encoded ssl private key")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    default_config = GenerationConfig(
        voice=args.voice, temperature=args.temperature, top_k=args.topk,
        top_p=args.top_p, repetition_penalty=args.repetition_penalty)
    if args.model_path.startswith("test:"):
        models = {args.model_path[5:]: args.model_path}
    else:
        models = discover_models(args.model_path)
    state = ServerState(models, default_config, args.n_parallelism,
                        request_timeout=args.request_timeout, device=args.device,
                        data_parallel=args.data_parallel,
                        tensor_parallel=args.tensor_parallel)
    if args.warmup:
        warmup(state, default_config)
    server = make_server(state, args.host, args.port)
    scheme = wrap_ssl(server, args.ssl_file_cert, args.ssl_file_key)
    print(f"tts-server (torch, {args.device}) listening on {scheme}://{args.host}:"
          f"{args.port} (models: {', '.join(models)})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)


if __name__ == "__main__":
    main()
