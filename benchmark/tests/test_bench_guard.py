"""The import guard: the port alone passes; JAX or the JAX package fails,
compared by whole top-level names; the references also refuse the port."""

from __future__ import annotations

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def _found(setup: str, extra: str = "()") -> str:
    code = (f"import sys, types; sys.path[:0] = [{BENCH!r}, {REPO!r}]\n{setup}\n"
            f"from benchlib import guard\nprint(','.join(guard.found({extra})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_the_port_alone_passes():
    assert _found("import tts_tpu_torch.apps.server, tts_tpu_torch.models.parler") == ""


def test_a_planted_jax_package_fails():
    assert _found("import tts_tpu_torch; sys.modules['tts_tpu'] = types.ModuleType('tts_tpu')"
                  ) == "tts_tpu"
    assert _found("sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')") == "jax"


def test_the_references_refuse_the_port():
    assert _found("import tts_tpu_torch", "extra=(guard.PROGRAM,)") == "tts_tpu_torch"
