"""The port's import surface against the JAX package's: each `__init__`
re-exports its counterpart's names (less the omissions the port records),
the names the port renamed exist on both sides, importing a subpackage
builds no kernel, and the port's public constructors run on the card
unless the caller asks for the CPU."""

import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import tts_tpu_torch  # noqa: E402
from tts_tpu_torch.runtime.api import TTSError  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", "codecs", "core", "models", "ops", "parallel", "runtime", "text", "utils"]
# "jax.module.name -> port.module.name" lines of the port's docstring
RENAMED = re.findall(r"^\s+(tts_tpu\.[\w.]+) -> (tts_tpu_torch\.[\w.]+)$",
                     tts_tpu_torch.__doc__, re.M)


def _resolve(dotted: str):
    module, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def _public(module) -> set:
    return {n for n in vars(module) if not n.startswith("_")
            and not isinstance(vars(module)[n], type(sys))}


@pytest.mark.parametrize("package", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_port_reexports_the_jax_names(package):
    """Every public name of the JAX `__init__` imports from the port's, but
    a name whose JAX function is listed as renamed; a re-exported name is
    the object its module defines."""
    jax_mod = importlib.import_module("tts_tpu" + (f".{package}" if package else ""))
    port_mod = importlib.import_module("tts_tpu_torch" + (f".{package}" if package else ""))
    renamed = {jax for jax, _ in RENAMED}
    missing = {n for n in _public(jax_mod) - _public(port_mod)
               if f"{getattr(jax_mod, n).__module__}.{n}" not in renamed}
    assert not missing, f"tts_tpu_torch.{package} lacks {sorted(missing)}"
    for n in _public(jax_mod) & _public(port_mod):
        obj = getattr(port_mod, n)
        if callable(obj) and hasattr(obj, "__module__"):
            assert obj.__module__.startswith("tts_tpu_torch"), (n, obj.__module__)


def test_ops_records_lstm_as_left_out():
    import tts_tpu_torch.ops as ops

    assert not callable(getattr(ops, "lstm", None)) and "lstm" in ops.__doc__
    assert ("tts_tpu.ops.lstm.lstm", "tts_tpu_torch.ops.lstm.bilstm") in RENAMED


def test_renamed_list_covers_the_six_names():
    assert {jax.rsplit(".", 1)[1] for jax, _ in RENAMED} == {
        "pack_linear", "quantized_matmul_ref", "gqa_decode_attention_dyn", "frame_signal",
        "generation_forward", "lstm"}


@pytest.mark.parametrize("jax_name,port_name", RENAMED, ids=[j for j, _ in RENAMED])
def test_renamed_names_exist_on_both_sides(jax_name, port_name):
    assert callable(_resolve(jax_name)), jax_name
    assert callable(_resolve(port_name)), port_name


IMPORT_SCRIPT = """
import tts_tpu_torch.ops._ext as ext

def refuse(*a, **k):
    raise AssertionError("a kernel build ran at import")

ext._build = refuse
ext.load = refuse
import importlib, pkgutil
import tts_tpu_torch
for m in pkgutil.walk_packages(tts_tpu_torch.__path__, "tts_tpu_torch."):
    importlib.import_module(m.name)
from tts_tpu_torch.ops import *  # noqa
from tts_tpu_torch.core import native
print("IMPORTED", native.get_lib.__name__)
"""


def test_importing_every_subpackage_builds_nothing():
    """In a fresh interpreter with `_ext._build` and `_ext.load` made to
    raise, every module of the port imports."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED get_lib" in proc.stdout


def _t5(tmp_path):
    from tts_tpu_torch.convert.builder_t5 import write_t5_gguf
    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models.t5 import T5Runner

    with GGUFFile(str(write_t5_gguf(tmp_path / "t5.gguf", out_size=32))) as f:
        return T5Runner.from_gguf(f)


def _kokoro(tmp_path):
    from tts_tpu_torch.convert.builder_kokoro import KokoroDims, write_kokoro_gguf
    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models.kokoro import KokoroModel

    with GGUFFile(str(write_kokoro_gguf(tmp_path / "k.gguf", KokoroDims.tiny()))) as f:
        return KokoroModel.from_gguf(f)


def _snac(tmp_path):
    import numpy as np

    from tts_tpu_torch.codecs.snac import SNACDecoder
    from tts_tpu_torch.convert.builder_codecs import build_snac_tensors

    tensors, kv = build_snac_tensors(np.random.default_rng(0))
    return SNACDecoder.from_tensors(tensors, kv)


def _dac(tmp_path):
    import numpy as np

    from tts_tpu_torch.codecs.dac import DACDecoder
    from tts_tpu_torch.convert.builder_codecs import build_dac_tensors

    tensors, kv = build_dac_tensors(np.random.default_rng(0))
    return DACDecoder.from_tensors(tensors, kv)


@pytest.mark.parametrize("make", [_t5, _kokoro, _snac, _dac],
                         ids=["T5Runner.from_gguf", "KokoroModel.from_gguf",
                              "SNACDecoder.from_tensors", "DACDecoder.from_tensors"])
def test_constructors_default_to_the_card(tmp_path, monkeypatch, make):
    """With no device given they load onto cuda; with no card that raises
    TTSError, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TTSError, match="no CUDA device"):
        make(tmp_path)


def _public_functions():
    """(qualified name, function) of every public function of the port's
    modules and every public method (and constructor) of their classes."""
    import inspect
    import pkgutil

    for info in pkgutil.walk_packages(tts_tpu_torch.__path__, "tts_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != module.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{module.__name__}.{name}", obj
            elif inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    if attr.startswith("_") and attr != "__init__":
                        continue
                    fn = getattr(member, "__func__", member)
                    if inspect.isfunction(fn):
                        yield f"{module.__name__}.{name}.{attr}", fn


def test_no_public_function_defaults_device_to_the_cpu():
    """A caller that gives no device runs on the card: no public function
    or method of the port has a `device` parameter whose default is the
    CPU (they take None, which `runtime.api.card_device` makes cuda)."""
    import inspect

    with_device, cpu = [], []
    for name, fn in _public_functions():
        param = inspect.signature(fn).parameters.get("device")
        if param is None:
            continue
        with_device.append(name)
        if str(param.default).split(":")[0] == "cpu":
            cpu.append(name)
    assert not cpu, f"device defaults to the CPU in {cpu}"
    # the walk reaches the loaders, caches and constructors that take a device
    for name in ("tts_tpu_torch.ops.sampling.init_state",
                 "tts_tpu_torch.models.kokoro.KokoroModel.__init__",
                 "tts_tpu_torch.models.kokoro.KokoroModel.from_gguf",
                 "tts_tpu_torch.models.orpheus.init_kv_cache",
                 "tts_tpu_torch.models.registry.runner_from_file"):
        assert name in with_device, name
