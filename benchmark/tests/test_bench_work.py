"""The work counts behind step_mfu and qmatmul_roofline, held to hand counts
at tiny shapes, and the call counts to the port's layer structure."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchlib import roofline, spec  # noqa: E402
from test_bench_weights import tiny_cfg  # noqa: E402


def test_q4_matmul_bound():
    # x [2, 64] bf16, Q4_0 [64, 32] (18 bytes a block of 32), out [2, 32] bf16
    assert roofline.q4_matmul(2, 64, 32) == (2 * 2 * 64 * 32, 64 * 32 / 32 * 18 + 2 * 64 * 2
                                             + 2 * 32 * 2)
    assert roofline.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_parler_row_work_by_hand():
    cfg = tiny_cfg("parler")       # 2 layers, hidden 64, FFN 128, 9 heads of 1088, 8 tokens
    flops, nbytes = spec.module("models", "parler").row_work(cfg, pos=10)
    w = 2 * (6 * 64 * 64 + 2 * 64 * 128)                     # Q4_0 weights a row
    io = 2 * (6 * (64 + 64) + (64 + 128) + (128 + 64)) * 2   # bf16 x in, y out
    kv = 2 * 2 * (11 + 8) * 64 * 2                           # self (11 keys) + cross (8), K and V
    heads = 9 * 64 * 1088
    assert flops == 2 * w + 2 * 4 * 64 * (11 + 8) + 2 * heads
    assert nbytes == w * 18 / 32 + io + kv + 2 * 64 * 2 + heads * 2 + 9 * 64 * 2


def test_dia_step_work_by_hand():
    cfg = tiny_cfg("dia")     # 2 layers, hidden 64, 4 query / 2 kv heads of 16, FFN 128, ctx 256
    flops, nbytes = spec.module("models", "dia").row_work(cfg, pos=4)
    w = 2 * (64 * 64 * 4 + 64 * 32 * 2 + 3 * 64 * 128)
    io = 2 * 2 * 2 * (4 * (64 + 64) + 2 * (64 + 32) + 3 * (64 + 128))
    heads = 9 * 64 * 1028
    assert flops == 2 * 2 * w + 2 * 2 * 4 * 4 * 16 * (5 + 256) + 2 * 2 * heads
    kv = 2 * 2 * 2 * (5 * 2 + 256 * 4) * 16 * 2 + 2 * 2 * 2 * 2 * 16 * 2
    assert nbytes == w * 18 / 32 + io + kv + heads * 2 + 9 * 64 * 18 / 32


@pytest.mark.parametrize("model,per_row,per_prompt", [("parler", 192, 192), ("dia", 162, 36)])
def test_call_counts_of_the_published_configs(model, per_row, per_prompt):
    import json

    with open(os.path.join(spec.BENCH_DIR, "configs", {"parler": "parler-tts-mini-v1-q4_0.json",
                                                      "dia": "dia-1.6b-q4_0.json"}[model])) as f:
        cfg = json.load(f)
    m = spec.module("models", model)
    want = m.qmatmul_expected(cfg, 3, [40, 50])
    assert want["gemv" if model == "parler" else "gemm"] == 3 * per_row + (
        0 if model == "parler" else 2 * per_prompt)
    assert m.qmatmul_bound_s(cfg, 3, [40, 50]) > m.qmatmul_bound_s(cfg, 2, [40, 50]) > 0
