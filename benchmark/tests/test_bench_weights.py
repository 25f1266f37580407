"""The benchmark's weight writer: its files load through the port's
loaders at tiny sizes, and its reader reads back what the port reads."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402
from benchlib import gguf, spec, weights  # noqa: E402
from tts_tpu_torch.core.gguf import GGUFFile  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(2)


def tiny_cfg(model: str) -> dict:
    import copy
    import json

    with open(os.path.join(tiny.BENCH, "configs", tiny.CONFIG_FILES[model])) as f:
        cfg = json.load(f)
    cfg.update(tiny.TINY[model])
    cfg["dac"] = copy.deepcopy(tiny.TINY_DAC)
    cfg["entry"] = {"name": f"{model}-tiny"}
    return cfg


@pytest.mark.parametrize("model", ["parler", "dia"])
def test_a_written_file_loads_and_serves_through_the_port(tmp_path, model):
    cfg = tiny_cfg(model)
    adapter = spec.module("models", model)
    path = adapter.model_path(cfg, 2**31 + 5, str(tmp_path), "cpu")
    assert path == weights.cached(str(tmp_path), cfg, 2**31 + 5)
    # one file per configuration: a new seed replaces it
    assert adapter.model_path(cfg, 6, str(tmp_path), "cpu") != path
    assert not os.path.exists(path)
    runner = runner_from_file(adapter.model_path(cfg, 6, str(tmp_path), "cpu"),
                              GenerationConfig(), device="cpu")
    frames = 12
    resp = runner.generate("the birch canoe", GenerationConfig(
        max_tokens=adapter.max_tokens(frames), seed=3, top_k=50))
    assert len(resp.audio) == adapter.samples(frames, "") == frames * 512
    assert np.isfinite(resp.audio).all()


def test_the_same_seed_gives_the_same_file(tmp_path):
    cfg = tiny_cfg("parler")
    kv, plan = spec.module("models", "parler").plan(cfg)
    a, b = str(tmp_path / "a.gguf"), str(tmp_path / "b.gguf")
    weights.make(a, kv, plan, 2**31 + 99, "cpu")
    weights.make(b, kv, plan, 2**31 + 99, "cpu")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_the_reader_reads_what_the_port_reads(tmp_path):
    cfg = tiny_cfg("dia")
    path = spec.module("models", "dia").model_path(cfg, 21, str(tmp_path), "cpu")
    ours = gguf.Reader(path)
    with GGUFFile(path) as theirs:
        assert ours.kv["dia.decoder.layers"] == theirs.kv["dia.decoder.layers"]
        for name in ("dia.decoder.layers.0.gate", "dia.decoder.heads.3",
                     "audio_encoder.initial.weight", "dia.encoder.norm"):
            gt, shape, raw = ours.raw(name)
            want = theirs.tensors[name].to_numpy(np.float32)
            if gt == gguf.Q4_0:
                got = weights.q4_dequant(raw, shape, "cpu").numpy()
            else:
                got = raw.view(np.float16 if gt == gguf.F16 else np.float32).reshape(shape)
            np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    ours.close()
