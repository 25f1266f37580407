"""Parler-TTS (mini v1) for the benchmark: request sizes, the random weights'
plan, the work of a decode row and of the quantized matmuls, and the hooks
that record what the program served.

Sizes: a sampled request runs exactly max_tokens rows (the random heads
never emit EOS) and un-weaves the BOS-delay staircase of 9 codebooks into
rows - 8 DAC frames."""

from __future__ import annotations

import numpy as np

from benchlib import codec, roofline, weights
from benchlib.roofline import BF16

DELAY_ROWS = 8            # the staircase: head h starts h rows late


def max_tokens(frames: int) -> int:
    return frames + DELAY_ROWS


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
    return dict(L=cfg["num_hidden_layers"], D=cfg["hidden_size"],
                H=cfg["num_attention_heads"], F=cfg["ffn_dim"], C=cfg["num_codebooks"],
                V=cfg["vocab_size"], A=cfg["audio_vocab_size"], P=cfg["max_position_embeddings"],
                G=cfg["max_generation_size"], PV=cfg["prompt_vocab_size"],
                E=cfg["text_encoder_hidden_size"], S=cfg["description_tokens"])


# ------------------------------------------------------------------ weights
def unigram_kv(n: int) -> dict:
    tokens = ["<unk>", "</s>", " "] + [chr(ord("a") + i) for i in range(26)]
    tokens += [f"<extra{i}>" for i in range(len(tokens), n)]
    return {"tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.full(n, -1.0, np.float32),
            "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.eos_token_id": 1}


def plan(cfg: dict) -> tuple[dict, list]:
    d = dims(cfg)
    L, D, F, C, V, A, E = d["L"], d["D"], d["F"], d["C"], d["V"], d["A"], d["E"]
    kv = {"general.architecture": "parler-tts",
          "parler-tts.decoder.num_hidden_layers": L, "parler-tts.decoder.hidden_size": D,
          "parler-tts.decoder.attention.head_count": d["H"],
          "parler-tts.decoder.output_heads": C, "parler-tts.decoder.out_vocab_size": V,
          "parler-tts.decoder.audio_vocab_size": A, "parler-tts.decoder.context_length": d["P"],
          "parler-tts.decoder.max_generation": d["G"],
          "parler-tts.decoder.encode_length": d["S"],
          "audio.bos_token_id": A + 1, "audio.eos_token_id": A}
    dac_kv, dac_plan = codec.plan(cfg["dac"])
    kv.update(dac_kv)
    kv.update(unigram_kv(d["PV"]))
    p = [("decoder.embed_prompts", (d["PV"], D), "f16", 1.0),
         ("decoder.positional_embed", (d["P"], D), "f16", 0.1),
         ("decoder.text_encoding", (d["S"], E), "f32", 0.1),
         ("decoder.layer_norm.weight", (D,), "ones", None),
         ("decoder.layer_norm.bias", (D,), "zeros", None)]
    for i in range(C):
        p.append((f"decoder.embed_tokens.{i}.weight", (A + 2, D), "f16", 1.0 / C))
        p.append((f"decoder.lm_heads.{i}.weight.head", (V, D), "f16", (0.1, A, 0.1)))
    for l in range(L):
        pre = f"decoder.layers.{l}"
        for n in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            p.append((f"{pre}.{n}.weight", (D,), "ones", None))
            p.append((f"{pre}.{n}.bias", (D,), "zeros", None))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            p.append((f"{pre}.self_attn.{n}.weight", (D, D), "q4", 0.02))
        p.append((f"{pre}.encoder_attn.q_proj.weight", (D, D), "q4", 0.02))
        p.append((f"{pre}.encoder_attn.k_proj.weight", (D, E), "q4", 0.02))
        p.append((f"{pre}.encoder_attn.v_proj.weight", (D, E), "q4", 0.02))
        p.append((f"{pre}.encoder_attn.out_proj.weight", (D, D), "q4", 0.02))
        p.append((f"{pre}.fc1.weight", (F, D), "q4", 0.02))
        p.append((f"{pre}.fc2.weight", (D, F), "q4", 0.02))
    return kv, p + dac_plan


# --------------------------------------------------------------------- work
def _row_linears(d: dict) -> list[tuple[int, int]]:
    """(K, N) of a row's quantized linears in one layer: self q, k, v, o,
    cross q, o (the cross K/V are precomputed), fc1, fc2."""
    D, F = d["D"], d["F"]
    return [(D, D)] * 6 + [(D, F), (F, D)]


def row_work(cfg: dict, pos: int) -> tuple[float, float]:
    """(flops, bytes) of the decode row at position pos, from the shapes and
    the format: the Q4_0 linears, self-attention over the live prefix of
    pos + 1 keys (bf16 K/V), cross-attention over the description's
    tokens (bf16 K/V), the 9 heads (bf16) and the 9 embedding rows (F16),
    each byte once."""
    d = dims(cfg)
    L, D, C, V, S = d["L"], d["D"], d["C"], d["V"], d["S"]
    flops = nbytes = 0.0
    for K, N in _row_linears(d):
        f, b = roofline.q4_matmul(1, K, N)
        flops, nbytes = flops + L * f, nbytes + L * b
    n = pos + 1
    flops += L * 4.0 * D * (n + S)                 # q.K and w.V, self and cross
    nbytes += L * 2 * (n + S) * D * BF16            # K and V read once
    nbytes += L * D * BF16                          # this row's K/V written
    flops += 2.0 * C * D * V
    nbytes += C * D * V * BF16 + C * D * 2
    return flops, nbytes


def row_bound_s(cfg: dict, pos: int) -> float:
    return roofline.bound_s(*row_work(cfg, pos))


def qmatmul_expected(cfg: dict, rows: int, prompts: list[int]) -> dict:
    """Kernel launches a span holds: 192 GEMVs a row, 192 GEMMs a prefill."""
    n = dims(cfg)["L"] * len(_row_linears(dims(cfg)))
    return {"gemv": n * rows, "gemm": n * len(prompts)}


def qmatmul_bound_s(cfg: dict, rows: int, prompts: list[int]) -> float:
    """The least time of those calls: each from its (M, K, N)."""
    d = dims(cfg)
    lin = _row_linears(d)
    t = rows * d["L"] * sum(roofline.q4_matmul_bound_s(1, K, N) for K, N in lin)
    for T in prompts:
        t += d["L"] * sum(roofline.q4_matmul_bound_s(T, K, N) for K, N in lin)
    return t


def decode_positions(rec: dict) -> range:
    """Positions of a served request's decode rows: after its prompt."""
    return range(rec["T"], rec["T"] + rec["rows"])


# -------------------------------------------------------------------- hooks
def install_hooks(rec):
    """Record what the program serves (in the server's process): the
    prompt's length at each prefill, each decode loop's rows, spans."""
    from tts_tpu_torch.models import parler as P

    prefill, loop = P.parler_prefill, P.parler_decode_loop

    def parler_prefill(params, cfg, tokens, cache, cross_kv):
        with rec.span("prefill"):
            out = prefill(params, cfg, tokens, cache, cross_kv)
        rec.prefill(int(tokens.shape[0]))
        return out

    def parler_decode_loop(*args, **kw):
        with rec.span("decode"):
            out = loop(*args, **kw)
        rec.rows(out[0])
        return out

    P.parler_prefill, P.parler_decode_loop = parler_prefill, parler_decode_loop
    return P.ParlerRunner
