"""Dia-1.6B for the benchmark: request sizes, the random weights' plan, the
work of a decode step and of the quantized matmuls, and the hooks that
record what the program served.

Sizes: max_tokens N runs N - 1 steps (the EOS drain ends a step short of
the cap) and un-weaves the delay pattern (0, 8, ..., 15) into N - 16 DAC
frames.  Every step runs the conditional and the unconditional row
together (classifier-free guidance), so each linear is a GEMM at M = 2."""

from __future__ import annotations

import numpy as np

from benchlib import codec, roofline, weights
from benchlib.roofline import BF16

DELAY_FRAMES = 16


def max_tokens(frames: int) -> int:
    return frames + DELAY_FRAMES


def samples(frames: int, text: str) -> int:
    """16-bit samples a request of `frames` DAC frames returns."""
    return frames * 512


def model_path(cfg: dict, seed: int, cache_dir: str, device) -> str:
    """The weights of `seed` as a GGUF file (made on `device` if not cached)."""
    return weights.ensure(cache_dir, cfg, seed, plan(cfg), device)


def warm(runner, frames: int):
    """Set-up: the DAC once at the run's longest frame count, so that no
    request of the window grows the allocator's pool."""
    runner.dac.decode(np.zeros((frames, runner.dac.cfg.n_heads), np.int32))


def dims(cfg: dict) -> dict:
    return dict(Le=cfg["encoder_n_layer"], De=cfg["encoder_n_embd"], He=cfg["encoder_n_head"],
                Fe=cfg["encoder_n_hidden"], L=cfg["decoder_n_layer"], D=cfg["decoder_n_embd"],
                Hq=cfg["decoder_gqa_query_heads"], Hkv=cfg["decoder_kv_heads"],
                hs=cfg["decoder_gqa_head_dim"], F=cfg["decoder_n_hidden"], C=cfg["channels"],
                V=cfg["tgt_vocab_size"], SV=cfg["src_vocab_size"], ctx=cfg["text_length"],
                G=cfg["audio_length"])


# ------------------------------------------------------------------ weights
def plan(cfg: dict) -> tuple[dict, list]:
    d = dims(cfg)
    De, D, hs, C, V = d["De"], d["D"], d["hs"], d["C"], d["V"]
    A = V - 4                                       # audio codes: EOS, PAD, BOS follow
    kv = {"general.architecture": "dia", "dia.encoder.layers": d["Le"],
          "dia.decoder.layers": d["L"], "dia.encoder.hidden_size": De,
          "dia.decoder.hidden_size": D, "dia.encoder.attn_heads": d["He"],
          "dia.decoder.attn_heads": d["Hq"], "dia.decoder.query_heads": d["Hq"] // d["Hkv"],
          "dia.attn_head_size": hs, "dia.decoder.output_heads": C,
          "dia.decoder.output_vocab_size": V, "dia.decoder.audio_vocab_size": A,
          "dia.eos_token_id": A, "dia.pad_token_id": A + 1, "dia.bos_token_id": A + 2,
          "dia.encoder.max_context_length": d["ctx"], "dia.decoder.max_generation_size": d["G"],
          "dia.max_delay": max(cfg["delay_pattern"]), "dia.cfg_scale": float(cfg["cfg_scale"])}
    dac_kv, dac_plan = codec.plan(cfg["dac"])
    kv.update(dac_kv)
    q = d["He"] * hs
    p = [("dia.encoder.embedding", (d["SV"], De), "q4", 1.0),
         ("dia.encoder.norm", (De,), "ones", None)]
    for i in range(d["Le"]):
        pre = f"dia.encoder.layers.{i}"
        p += [(f"{pre}.q_proj", (q, De), "q4", 0.02), (f"{pre}.k_proj", (q, De), "q4", 0.02),
              (f"{pre}.v_proj", (q, De), "q4", 0.02), (f"{pre}.o_proj", (De, q), "q4", 0.02),
              (f"{pre}.pre_sa_norm", (De,), "ones", None),
              (f"{pre}.post_sa_norm", (De,), "ones", None),
              (f"{pre}.gate", (d["Fe"], De), "q4", 0.02), (f"{pre}.up", (d["Fe"], De), "q4", 0.02),
              (f"{pre}.wo", (De, d["Fe"]), "q4", 0.02)]
    p.append(("dia.decoder.norm", (D,), "ones", None))
    for i in range(C):
        p.append((f"dia.decoder.embeddings.{i}", (A + 3, D), "q4", 1.0 / C))
        # the EOS row and the ids past it (which the merge masks) 10x smaller
        p.append((f"dia.decoder.heads.{i}", (V, D), "f16", (0.1, A, 0.1)))
    Dq, Dkv = d["Hq"] * hs, d["Hkv"] * hs
    for i in range(d["L"]):
        pre = f"dia.decoder.layers.{i}"
        p += [(f"{pre}.self_q_proj", (Dq, D), "q4", 0.02),
              (f"{pre}.self_k_proj", (Dkv, D), "q4", 0.02),
              (f"{pre}.self_v_proj", (Dkv, D), "q4", 0.02),
              (f"{pre}.self_o_proj", (D, Dq), "q4", 0.02),
              (f"{pre}.cross_q_proj", (Dq, D), "q4", 0.02),
              (f"{pre}.cross_k_proj", (Dq, De), "q4", 0.02),
              (f"{pre}.cross_v_proj", (Dq, De), "q4", 0.02),
              (f"{pre}.cross_o_proj", (D, Dq), "q4", 0.02),
              (f"{pre}.pre_sa_norm", (D,), "ones", None),
              (f"{pre}.pre_ca_norm", (D,), "ones", None),
              (f"{pre}.pre_mlp_norm", (D,), "ones", None),
              (f"{pre}.gate", (d["F"], D), "q4", 0.02), (f"{pre}.up", (d["F"], D), "q4", 0.02),
              (f"{pre}.wo", (D, d["F"]), "q4", 0.02)]
    return kv, p + dac_plan


# --------------------------------------------------------------------- work
def _step_linears(d: dict) -> list[tuple[int, int]]:
    """(K, N) of a step's quantized linears in one layer: self q, k, v, o,
    cross q, o (the cross K/V are made once per request), gate, up, wo."""
    D, Dq, Dkv, F = d["D"], d["Hq"] * d["hs"], d["Hkv"] * d["hs"], d["F"]
    return [(D, Dq), (D, Dkv), (D, Dkv), (Dq, D), (D, Dq), (Dq, D), (D, F), (D, F), (F, D)]


def row_work(cfg: dict, pos: int) -> tuple[float, float]:
    """(flops, bytes) of the decode step at position pos for the CFG pair,
    from the shapes and the format: the Q4_0 linears at M = 2, GQA
    self-attention over the live prefix of pos + 1 keys (bf16 K/V), the
    cross-attention over the encoder's full context (bf16 K/V: Dia's
    cross-attention is unmasked, so every context position is read), the 9
    heads (bf16) and the 9 embedding rows (Q4_0), each byte once."""
    d = dims(cfg)
    L, D, hs, C, V, ctx = d["L"], d["D"], d["hs"], d["C"], d["V"], d["ctx"]
    flops = nbytes = 0.0
    for K, N in _step_linears(d):
        f, b = roofline.q4_matmul(2, K, N)
        flops, nbytes = flops + L * f, nbytes + L * b
    n = pos + 1
    flops += L * 2 * 4.0 * d["Hq"] * hs * (n + ctx)
    nbytes += L * 2 * 2 * (n * d["Hkv"] + ctx * d["Hq"]) * hs * BF16
    nbytes += L * 2 * 2 * d["Hkv"] * hs * BF16          # this step's K/V written
    flops += 2 * 2.0 * C * D * V
    nbytes += C * D * V * BF16 + C * D * roofline.Q4_0_BYTES_PER_WEIGHT
    return flops, nbytes


def row_bound_s(cfg: dict, pos: int) -> float:
    return roofline.bound_s(*row_work(cfg, pos))


def qmatmul_expected(cfg: dict, rows: int, prompts: list[int]) -> dict:
    """Kernel launches a span holds: 162 GEMMs a step, 36 a request (the
    cross-KV at M = 2 x the context)."""
    d = dims(cfg)
    return {"gemv": 0, "gemm": d["L"] * len(_step_linears(d)) * rows + 2 * d["L"] * len(prompts)}


def qmatmul_bound_s(cfg: dict, rows: int, prompts: list[int]) -> float:
    d = dims(cfg)
    t = rows * d["L"] * sum(roofline.q4_matmul_bound_s(2, K, N) for K, N in _step_linears(d))
    cross = roofline.q4_matmul_bound_s(2 * d["ctx"], d["De"], d["Hq"] * d["hs"])
    return t + len(prompts) * 2 * d["L"] * cross


def decode_positions(rec: dict) -> range:
    """Positions of a served request's decode steps: from 0 (the encoder
    holds the prompt)."""
    return range(rec["rows"])


# -------------------------------------------------------------------- hooks
def install_hooks(rec):
    """Record what the program serves (in the server's process): the prompt's
    byte count at each cross-KV, each decode loop's rows, spans."""
    from tts_tpu_torch.models import dia as Dm

    encode, cross, loop = Dm.dia_encode, Dm.dia_cross_kv, Dm.dia_decode_loop

    def dia_encode(*args, **kw):
        with rec.span("encode"):
            return encode(*args, **kw)

    def dia_cross_kv(params, cfg, enc_states, n_valid):
        with rec.span("cross_kv"):
            out = cross(params, cfg, enc_states, n_valid)
        rec.prefill(int(n_valid))
        return out

    def dia_decode_loop(*args, **kw):
        with rec.span("decode"):
            out = loop(*args, **kw)
        rec.rows(out[0])
        return out

    Dm.dia_encode, Dm.dia_cross_kv, Dm.dia_decode_loop = dia_encode, dia_cross_kv, dia_decode_loop
    return Dm.DiaRunner
