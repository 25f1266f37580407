"""The port's native GGUF codecs (tts_tpu_torch.core.native, native/ggufc
compiled into build/) against the port's numpy codecs and the JAX
package's (`tts_tpu.core.quant`) on the same bytes; `GGUFTensor.to_numpy`
with and without the library; concurrent first builds; no compiler.

The JAX package's own native module and its `to_numpy` on quantized
tensors are not called here: they run `make` in native/ggufc, whose one
output file concurrent test workers race on."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

from tts_tpu.core import quant as jquant  # noqa: E402
from tts_tpu_torch.core import gguf as tgguf  # noqa: E402
from tts_tpu_torch.core import native  # noqa: E402
from tts_tpu_torch.core import quant as tquant  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_TYPES = ["Q4_0", "Q5_0", "Q8_0"]
# whole blocks, partial last blocks, and a size the library splits over threads
SIZES = [4096, 95, 4001, 2 * native.VALUES_PER_THREAD + 95]


@pytest.fixture(scope="module")
def lib():
    """The library as the port builds it (skips where no g++ is found: the
    fallback is tested below)."""
    if native.get_lib() is None:
        pytest.skip("no C++ compiler: core/native.py falls back to the numpy codecs")
    return native


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("qtype", BLOCK_TYPES)
def test_dequant_is_bit_equal_to_both_numpy_codecs(lib, qtype, n):
    x = np.random.default_rng(n).standard_normal(-(-n // 32) * 32).astype(np.float32)
    raw = np.frombuffer(getattr(jquant, f"quantize_{qtype.lower()}")(x), np.uint8)
    got = getattr(lib, f"dequant_{qtype.lower()}")(raw, n)
    assert got.dtype == np.float32 and got.shape == (n,)
    for codecs in (tquant, jquant):
        want = getattr(codecs, f"dequantize_{qtype.lower()}")(raw, n)[:n]
        np.testing.assert_array_equal(got, want, err_msg=codecs.__name__)


@pytest.mark.parametrize("dtype", ["F16", "BF16"])
def test_half_to_f32_is_bit_equal(lib, dtype):
    x = np.random.default_rng(1).standard_normal(5001).astype(np.float32) * 100
    x[:4] = [0.0, -0.0, np.inf, 6e-8]
    if dtype == "F16":
        half = x.astype(np.float16)
        got, want = lib.f16_to_f32(half.view(np.uint8), x.size), half.astype(np.float32)
    else:
        bits = (x.view(np.uint32) >> 16).astype(np.uint16)
        got = lib.bf16_to_f32(bits.view(np.uint8), x.size)
        want = (bits.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1.0, 5e-4])
def test_quant_q8_0_gives_both_numpy_codecs_bytes(lib, scale):
    """Including blocks whose scale is an f16 subnormal."""
    x = (np.random.default_rng(2).standard_normal(4096) * scale).astype(np.float32)
    got = lib.quant_q8_0(x)
    assert got == tquant.quantize_q8_0(x) == jquant.quantize_q8_0(x)


def test_dequant_refuses_too_few_bytes(lib):
    raw = np.zeros(33, np.uint8)
    with pytest.raises(ValueError, match="fewer than"):
        lib.dequant_q8_0(raw, 32)


def _gguf(path):
    rng = np.random.default_rng(3)
    w = tgguf.GGUFWriter(path)
    w.add_kv("general.architecture", "test")
    for t in ("F32", "F16", "BF16", "Q8_0", "Q5_0", "Q4_0"):
        w.add_tensor(t.lower(), rng.standard_normal((48, 64)).astype(np.float32),
                     tgguf.GGMLType[t])
    w.write()
    return path


def test_to_numpy_with_the_library_equals_without(lib, tmp_path, monkeypatch):
    path = _gguf(str(tmp_path / "t.gguf"))
    calls = []
    call = native._call
    monkeypatch.setattr(native, "_call", lambda name, *a: calls.append(name) or call(name, *a))
    with tgguf.GGUFFile(path) as f:
        with_lib = {n: t.to_numpy() for n, t in f.tensors.items()}
        assert sorted(calls) == ["ggufc_bf16_to_f32", "ggufc_dequant_q4_0",
                                 "ggufc_dequant_q5_0", "ggufc_dequant_q8_0"]
        monkeypatch.setattr(native, "get_lib", lambda: None)
        without = {n: t.to_numpy() for n, t in f.tensors.items()}
        plain = {n: t.to_numpy_plain().reshape(t.shape) for n, t in f.tensors.items()
                 if n not in ("f32", "f16")}
    for name, arr in with_lib.items():
        assert arr.shape == (48, 64) and arr.dtype == np.float32
        np.testing.assert_array_equal(arr, without[name], err_msg=name)
        if name in plain:
            np.testing.assert_array_equal(arr, plain[name], err_msg=name)


def test_without_a_compiler_to_numpy_uses_numpy_codecs(tmp_path, monkeypatch):
    """No g++ on PATH and an empty build dir: available() is false, nothing
    is written there, and to_numpy still gives the numpy codecs' values."""
    path = _gguf(str(tmp_path / "t.gguf"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    assert not native.available() and not os.path.exists(tmp_path / "build")
    with tgguf.GGUFFile(path) as f:
        for name, t in f.tensors.items():
            want = (t.to_numpy_plain().reshape(t.shape) if name not in ("f32", "f16")
                    else t.raw().view(np.float32 if name == "f32" else np.float16)
                    .reshape(t.shape).astype(np.float32))
            np.testing.assert_array_equal(t.to_numpy(), want, err_msg=name)


FAKE_GXX = """#!/bin/sh
# a compiler that writes part of its output and fails
while [ $# -gt 0 ]; do
    if [ "$1" = "-o" ]; then echo half > "$2"; fi
    shift
done
echo "g++: internal compiler error" >&2
exit 1
"""


@pytest.mark.parametrize("failure", ["exits 1", "times out", "cannot start"])
def test_a_failed_compile_falls_back(tmp_path, monkeypatch, failure):
    """g++ failing, timing out or not starting: no library and no partial
    file are left, available() is false, and to_numpy still gives the
    numpy codecs' values."""
    path = _gguf(str(tmp_path / "t.gguf"))
    build = tmp_path / "build"
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text(FAKE_GXX)
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    if failure != "exits 1":
        def run(cmd, **kw):
            with open(cmd[cmd.index("-o") + 1], "wb") as f:
                f.write(b"half")
            if failure == "times out":
                raise subprocess.TimeoutExpired(cmd, kw["timeout"])
            raise PermissionError(13, "Permission denied", cmd[0])
        monkeypatch.setattr(native.subprocess, "run", run)
    assert native._build(str(build)) is None
    assert os.listdir(build) == ["libggufc.lock"]
    assert not native.available()
    with tgguf.GGUFFile(path) as f:
        for name, t in f.tensors.items():
            if name not in ("f32", "f16"):
                np.testing.assert_array_equal(t.to_numpy(), t.to_numpy_plain().reshape(t.shape),
                                              err_msg=name)


def test_threads_follow_the_size():
    """One thread below VALUES_PER_THREAD values, one more for each further
    VALUES_PER_THREAD, at most the CPUs the process may use and 16."""
    per = native.VALUES_PER_THREAD
    cpus = min(len(os.sched_getaffinity(0)), 16)
    assert native._threads(0) == native._threads(per - 1) == native._threads(2 * per - 1) == 1
    assert native._threads(2 * per) == min(2, cpus)
    assert native._threads(100 * per) == cpus


BUILD_SCRIPT = """
import sys
import numpy as np
from tts_tpu_torch.core import native
native.BUILD_DIR = sys.argv[1]
lib = native.get_lib()
zeros = lib is not None and native.dequant_q8_0(np.zeros(34, np.uint8), 32).tolist()
print("LOADED", zeros == [0.0] * 32)
"""


def test_concurrent_first_builds_leave_one_library(lib, tmp_path):
    """Four processes calling get_lib() at once on an empty build dir: one
    library file and no partial ones are left, and all four load it."""
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, build], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    assert all(out.strip() == "LOADED True" for out, _ in outs), outs
    files = sorted(os.listdir(build))
    assert [f for f in files if f.endswith(".so")] == [os.path.basename(
        native._build(build))] and not [f for f in files if f.endswith(".tmp")], files
