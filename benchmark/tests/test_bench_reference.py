"""The plain references held to the port at tiny sizes, on the same file:
Parler-TTS's teacher-forced logits against the port's prefill and decode
steps, Dia's encoder and CFG-merged logits against the port's, and the DAC
against the port's decoder.  The port keeps the KV cache and the GEMV
inputs in bf16 on quantized checkpoints, so logits agree to bf16's
rounding (2^-8 of a value, summed over the layers): 3% of the logits'
spread; the encoder and the DAC run f32 on both sides."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchlib import gguf, spec  # noqa: E402
from reference import common, dac as dac_ref  # noqa: E402
from test_bench_weights import tiny_cfg  # noqa: E402
from tts_tpu_torch.models import dia as port_dia, parler as port_parler  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(2)
TEXT = "The birch canoe slid on the smooth planks."


def _load(tmp_path, model, seed=4):
    cfg = tiny_cfg(model)
    path = spec.module("models", model).model_path(cfg, seed, str(tmp_path), "cpu")
    runner = runner_from_file(path, GenerationConfig(), device="cpu")
    ref = spec.module("reference", model)
    return cfg, runner, ref, ref.load(gguf.Reader(path), cfg, "cpu")


def _close(got, want, rel):
    got, want = got.double(), want.double()
    assert (got - want).abs().max().item() <= rel * want.std().item()


def test_parler_reference_matches_the_port(tmp_path):
    common.strict_f32()
    cfg, runner, ref, p = _load(tmp_path, "parler")
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1024, (12, 9)).astype(np.int32)
    want, T = ref.logits(p, cfg, {"text": TEXT}, rows)
    ids = runner._prompt_ids(TEXT)
    assert T == len(ids)
    ins = ref.input_rows(rows, 9, 1025, 1024)
    c = runner.cfg
    with torch.inference_mode():
        cache = port_parler.init_kv_cache(c, "cpu")
        port_parler.parler_prefill(runner.params, c, torch.tensor(ids), cache, runner.cross_kv)
        got = torch.stack([port_parler._rows_logits(runner.params, c,
                                                    torch.from_numpy(ins[t:t + 1]), T + t,
                                                    cache, runner.cross_kv)[0]
                           for t in range(len(rows))])
    _close(got, want, 0.03)


def test_dia_reference_matches_the_port(tmp_path):
    common.strict_f32()
    cfg, runner, ref, p = _load(tmp_path, "dia")
    ids = ref.prompt_bytes(TEXT)
    assert ids == port_dia.tokenize_dia_sentence(TEXT, runner.cfg)
    c = runner.cfg
    tokens = torch.zeros((2, c.max_encoder_context_length), dtype=torch.long)
    tokens[0, :len(ids)] = torch.tensor(ids)
    with torch.inference_mode():
        enc = port_dia.dia_encode(runner.params, c, tokens, len(ids))
    _close(enc, ref.encode(p, cfg, ids), 1e-4)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1024, (30, 9)).astype(np.int32)
    item = {"text": TEXT, "max_tokens": 31}          # the drain starts at step 16
    want, n = ref.logits(p, cfg, item, rows)
    assert n == len(ids)
    ins = ref.input_rows(cfg, rows, 31)
    assert (ins[-1] >= 1024).any()                    # EOS / PAD fed in the drain
    with torch.inference_mode():
        cross = port_dia.dia_cross_kv(runner.params, c, enc, len(ids))
        cache = port_dia.init_dia_cache(c, "cpu")
        got = torch.stack([port_dia._dia_rows(runner.params, c, torch.from_numpy(ins[t:t + 1]),
                                              t, cache, cross)[0] for t in range(len(rows))])
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(got))
    _close(got[finite], want[finite], 0.03)


@pytest.mark.parametrize("model", ["parler", "dia"])
def test_dac_reference_matches_the_port(tmp_path, model):
    common.strict_f32()
    cfg, runner, ref, p = _load(tmp_path, model, seed=9)
    codes = np.random.default_rng(2).integers(0, 1024, (20, 9)).astype(np.int32)
    got = torch.from_numpy(runner.dac.decode(codes))
    _close(got, dac_ref.decode(p["dac"], codes), 1e-4)
