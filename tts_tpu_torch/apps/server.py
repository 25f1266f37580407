"""tts-server on the port: the OpenAI-compatible speech API of
`tts_tpu.apps.server` (its request handler, task queue and worker pool are
shared by import), with runners loaded by `tts_tpu_torch` onto `--device`.

    python -m tts_tpu_torch.apps.server --model-path model.gguf --device cuda
"""

from __future__ import annotations

import argparse
import sys
import threading
from http.server import ThreadingHTTPServer

from tts_tpu.apps import server as _base
from tts_tpu.apps.server import discover_models, make_handler, wrap_ssl
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime.api import GenerationConfig


class ServerState(_base.ServerState):
    """The JAX server's task queue and workers; runners come from the port's
    `runner_from_file` on `device`.  One runner per model, shared by the
    workers under its lock."""

    def __init__(self, model_paths: dict[str, str], default_config: GenerationConfig,
                 n_parallelism: int = 1, request_timeout: float = 1800.0,
                 device="cuda", data_parallel: bool = False, tensor_parallel: int = 1):
        if data_parallel or tensor_parallel > 1:
            raise NotImplementedError(
                "tts_tpu_torch serves one device: --data-parallel and "
                "--tensor-parallel > 1 are not ported yet")
        self.device = device
        super().__init__(model_paths, default_config, n_parallelism, request_timeout)

    def _get_runner(self, model: str, wid: int = 0):
        with self._cache_lock:
            lock = self._runner_locks.setdefault(model, threading.Lock())
        with lock:
            if model not in self._runners:
                self._runners[model] = runner_from_file(
                    self.model_paths[model], self.default_config, device=self.device)
        return self._runners[model], lock


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
    p = argparse.ArgumentParser(prog="tts-server (torch)", description=__doc__)
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
    p.add_argument("--ssl-file-cert", "-sfc", default="")
    p.add_argument("--ssl-file-key", "-sfk", default="")
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
