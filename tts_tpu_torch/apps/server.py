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
Not carried over: the multi-chip replicas (--data-parallel), tensor
parallelism and the warmup's bucket pinning; the port serves one device.
"""

from __future__ import annotations

import argparse
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
from tts_tpu_torch.utils.audio import encode_aiff, encode_wav


def error_json(message: str, etype: str = "invalid_request_error", code: int = 400):
    return code, {"error": {"message": message, "type": etype, "code": code}}


class ServerState:
    """Task queue + worker pool; runners come from `runner_from_file` on
    `device`.  All workers share one runner per model, serialized by its
    lock; different models run concurrently, and host-side JSON/WAV work
    overlaps device compute."""

    def __init__(self, model_paths: dict[str, str], default_config: GenerationConfig,
                 n_parallelism: int = 1, request_timeout: float = 1800.0,
                 device="cuda", data_parallel: bool = False, tensor_parallel: int = 1):
        if data_parallel or tensor_parallel > 1:
            raise NotImplementedError(
                "tts_tpu_torch serves one device: --data-parallel and "
                "--tensor-parallel > 1 are not ported yet")
        self.model_paths = model_paths
        self.default_model = next(iter(model_paths))
        self.default_config = default_config
        self.request_timeout = request_timeout
        self.device = device
        self.tasks: queue.Queue = queue.Queue()
        self.results: dict[str, dict] = {}
        self.abandoned: set[str] = set()      # ids whose submitter timed out
        self.results_cv = threading.Condition()
        self._runners: dict = {}
        self._runner_locks: dict = {}
        self._cache_lock = threading.Lock()
        self.workers = []
        for _ in range(max(n_parallelism, 1)):
            w = threading.Thread(target=self._worker_loop, daemon=True)
            w.start()
            self.workers.append(w)

    def _get_runner(self, model: str):
        """The model's shared runner and its lock; loads at most once."""
        with self._cache_lock:
            lock = self._runner_locks.setdefault(model, threading.Lock())
        with lock:
            if model not in self._runners:
                self._runners[model] = runner_from_file(
                    self.model_paths[model], self.default_config, device=self.device)
        return self._runners[model], lock

    def _worker_loop(self):
        while True:
            task = self.tasks.get()
            if task is None:
                return
            result = {"success": False, "message": "unknown error"}
            t0 = time.perf_counter()
            try:
                runner, lock = self._get_runner(task["model"])
                if task["kind"] == "tts_stream":
                    # a runner with generate_stream (Kokoro) sends each chunk
                    # as it is made; the others send the whole utterance
                    chunks, cancel = task["chunks"], task["cancel"]
                    try:
                        with lock:
                            if hasattr(runner, "generate_stream"):
                                for piece in runner.generate_stream(task["prompt"],
                                                                    task["config"]):
                                    if cancel.is_set():
                                        break  # client gone / timed out
                                    chunks.put(piece)
                            else:
                                chunks.put(runner.generate(task["prompt"],
                                                           task["config"]).audio)
                        result = {"success": True}
                    finally:
                        chunks.put(None)          # end-of-stream sentinel
                elif task["kind"] == "tts":
                    with lock:
                        resp = runner.generate(task["prompt"], task["config"])
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
                        r, l = self._get_runner(m)
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
            data = self._read_json()
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
                self.stream_pcm(model, data["input"], cfg)
                return
            result = state.submit({"kind": "tts", "model": model,
                                   "prompt": data["input"], "config": cfg})
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

        def stream_pcm(self, model: str, prompt: str, cfg: GenerationConfig):
            """Chunked-transfer stream of 16-bit little-endian PCM; the first
            chunk arrives at time-to-first-audio.  `cancel` stops the
            worker's generation if the client goes or a chunk times out."""
            chunks: queue.Queue = queue.Queue()
            cancel = threading.Event()
            t_req = time.perf_counter()
            state.tasks.put({"id": uuid.uuid4().hex, "kind": "tts_stream", "model": model,
                             "prompt": prompt, "config": cfg, "chunks": chunks,
                             "cancel": cancel})
            self.send_response(200)
            self.send_header("Content-Type", "audio/pcm")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            ttfa_ms = None
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
                    if ttfa_ms is None:
                        ttfa_ms = (time.perf_counter() - t_req) * 1e3
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
            wall = time.perf_counter() - t_req
            print(f"[srv] stream {status}: ttfa={ttfa_ms and round(ttfa_ms, 1)} ms "
                  f"samples={n_samples} wall={wall * 1e3:.1f} ms", file=sys.stderr)

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="tts-server (torch)", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", "-mp", required=True,
                   help="GGUF file, directory of GGUF files, or test:dummy")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--n-parallelism", "-np", type=int, default=1,
                   help="worker threads (sharing one runner per model)")
    p.add_argument("--data-parallel", action="store_true", help="not ported yet")
    p.add_argument("--tensor-parallel", type=int, default=1, help="not ported yet")
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--top-p", "-tp", type=float, default=1.0)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--request-timeout", type=float, default=1800.0)
    p.add_argument("--ssl-file-cert", "-sfc", default="",
                   help="local path to the PEM encoded ssl cert")
    p.add_argument("--ssl-file-key", "-sfk", default="",
                   help="local path to the PEM encoded ssl private key")
    args = p.parse_args(argv)

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
