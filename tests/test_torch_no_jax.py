"""The port runs where JAX is not installed: in a fresh interpreter with every
`import jax` made to fail, import each module of tts_tpu_torch (and the
server app), then load the tiny Q8_0 model and synthesize on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    sys.modules["jaxlib"] = None
    import dataclasses, importlib, pkgutil
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tts_tpu_torch
    import tts_tpu_torch.apps.server
    for m in pkgutil.walk_packages(tts_tpu_torch.__path__, "tts_tpu_torch."):
        importlib.import_module(m.name)
    from torch_tiny import CTX, GEN, write_tiny_q8_orpheus
    from tts_tpu.runtime.api import GenerationConfig
    from tts_tpu_torch.models.registry import runner_from_file
    path = write_tiny_q8_orpheus(sys.argv[1], head_rows=4096)
    r = runner_from_file(str(path), device="cpu")
    r.cfg = dataclasses.replace(r.cfg, max_context_length=CTX, max_generation_size=GEN)
    resp = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, top_k=50))
    loaded = sorted(m for m, v in sys.modules.items()
                    if m.split(".")[0] in ("jax", "jaxlib") and v is not None)
    print("AUDIO", len(resp.audio), bool(np.isfinite(resp.audio).all()), "JAX", loaded)
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "tiny.gguf")],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("AUDIO"))
    assert line == f"AUDIO {(15 // 7) * 4 * 512} True JAX []", line
