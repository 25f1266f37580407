"""Tiny Orpheus, Parler and Dia GGUFs and the Parler and Dia tests' shared
helpers, for the port's tests (no jax import at module level).

Orpheus: Q8_0 or Q4_0 linears at small but kernel-eligible widths: head
size 128 (the flash-decode kernels need it), output dims multiples of 256,
input dims multiples of 64 (the int4 nibble split), 2 layers, a
156,940-row embedding (prompt frame token ids index it), and
build_snac_tensors' tiny SNAC.  Parler: see `write_tiny_parler`; Dia:
`write_tiny_dia`."""

from __future__ import annotations

import numpy as np

TINY = dict(n_layers=2, hidden=256, heads=4, kv_heads=2, head_dim=128, ffn=512)
# a short cache: max_context 64 + max_gen 448 = 512, one 512-position chunk
CTX, GEN = 64, 448
QTYPES = ("Q8_0", "Q4_0")


def orpheus_logits_along(params, cfg, prompt, stream):
    """Teacher-forced logits [len(stream), vocab] of the port's sequential
    path: row 0 from the prompt's prefill, row i from the decode step of
    stream[i - 1] after it."""
    import torch

    from tts_tpu_torch.models import orpheus as to

    cache = to.init_kv_cache(cfg, "cpu")
    rows = [to.orpheus_prefill(params, cfg, torch.tensor(prompt), cache)]
    for i, tok in enumerate(stream[:-1]):
        rows.append(to.orpheus_decode_step(params, cfg, torch.tensor([tok]),
                                           torch.tensor([len(prompt) + i], dtype=torch.int32),
                                           cache))
    return torch.stack(rows)


def orpheus_verify_logits_along(params, cfg, prompt, stream, width: int = 8):
    """Teacher-forced logits [len(stream), vocab] of the port on the
    speculative loop's path: row 0 from the prompt's prefill, then
    `width`-token verify forwards along stream[:-1], whose lm_head is the
    M = 8 GEMM (f32 x) where a sequential step's is the GEMV (x rounded to
    bf16)."""
    import torch

    from tts_tpu_torch.models import orpheus as to

    cache = to.init_kv_cache(cfg, "cpu")
    rows = [to.orpheus_prefill(params, cfg, torch.tensor(prompt), cache)[None]]
    T = len(prompt)
    for i in range(0, len(stream) - 1, width):
        toks = torch.tensor(stream[i:min(i + width, len(stream) - 1)])
        positions = torch.arange(T + i, T + i + len(toks), dtype=torch.int32)
        x = to._orpheus_body(params, cfg, toks, positions, cache, start=T + i)
        rows.append(to._head_logits(x, params, cfg))
    return torch.cat(rows)


def write_tiny_orpheus(path, seed: int = 0, head_rows: int | None = None,
                       qtype: str = "Q8_0"):
    """Float weights from the JAX package's builder, quantized to `qtype` by
    its GGUF writer.  head_rows cuts the lm_head (and the vocab) to its first
    rows: the JAX package's interpret-mode kernels then decode in
    milliseconds instead of half a second per token.  None keeps the real
    156,940 (padded to 1024)."""
    from tts_tpu.convert.builder_orpheus import build_orpheus_tensors
    from tts_tpu.core.gguf import GGMLType, GGUFWriter

    rng = np.random.default_rng(seed)
    tensors, kv = build_orpheus_tensors(rng, **TINY)
    if head_rows is not None:
        tensors["orpheus.lm_head"] = tensors["orpheus.lm_head"][:head_rows]
        kv["orpheus.vocab_size"] = head_rows
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        quant = name.endswith(("_proj", "lm_head"))
        w.add_tensor(name, arr, GGMLType[qtype] if quant else None)
    w.write()
    return path


# Parler: 2 layers, hidden 256, 4 heads of 64, FFN 512; the JAX builder's
# 512-position context, 64 decode steps, 12-row encoding of width 64 and DAC
TINY_PARLER = dict(n_layers=2, hidden=256, heads=4, ffn=512)
PARLER_QTYPES = ("dense", "Q8_0", "Q4_0")


def write_tiny_parler(root, qtype: str = "dense"):
    """The tiny Parler under directory `root`, by the JAX package's builder:
    dense (f32), or quantized by its quantize tool to Q8_0 or Q4_0, the
    cross-attention k/v too (--quantize-cross-attn-kv).  Returns the path."""
    import pathlib

    from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
    from tts_tpu.convert.builder_parler import write_parler_gguf
    from tts_tpu.core.gguf import GGMLType

    dense = pathlib.Path(root) / "tiny_parler_dense.gguf"
    if not dense.exists():
        write_parler_gguf(dense, **TINY_PARLER)
    if qtype == "dense":
        return str(dense)
    path = pathlib.Path(root) / f"tiny_parler_{qtype}.gguf"
    if not path.exists():
        quantize_gguf(str(dense), str(path),
                      QuantizationParams(GGMLType[qtype], quantize_cross_attn_kv=True))
    return str(path)



def parler_models(path):
    """(jax cfg, jax params, port cfg, port params) of one Parler GGUF by
    each package's reader and loader, the cache dtype switched to bf16 on
    quantized files as each package's runner loader does."""
    import dataclasses

    from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile
    from tts_tpu.models import parler as jp
    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models import parler as tp

    with JaxGGUFFile(path) as f:
        jcfg = jp.ParlerConfig.from_gguf_kv(f.kv)
        jparams = jp.load_parler_params(dict(f.tensors), jcfg)
        if jp.parler_params_quantized(jparams):
            jcfg = dataclasses.replace(jcfg, kv_dtype="bfloat16")
    with GGUFFile(path) as f:
        tcfg = tp.ParlerConfig.from_gguf_kv(f.kv)
        tparams = tp.load_parler_params(dict(f.tensors), tcfg, "cpu")
        if tp.parler_params_quantized(tparams):
            tcfg = dataclasses.replace(tcfg, kv_dtype="bfloat16")
    return jcfg, jparams, tcfg, tparams


# Greedy choices are compared up to numerical ties: on quantized models a
# decode step's GEMV rounds its f32 input to bf16, and an f32 sum that
# differs in its last bit between the packages (or between the GEMV and the
# verify's GEMM, or where JAX's int4 product keeps x in f32 at K = 256) can
# flip that rounding; the logits, spanning about +-0.2, then differ by up
# to ~1e-3.  Where the other side's token is within PARLER_TIE of the best
# logit, rounding decides and either is right.
PARLER_TIE = 2e-3


def staircase_inputs(cfg, rows):
    """The sequential loop's input row before each of `rows` [n, 9] (the
    all-BOS row, then each emitted row through the BOS delays and EOS
    pinning)."""
    from tts_tpu_torch.models import parler as tp

    state = tp.init_loop_state(cfg)
    ins = []
    for i, row in enumerate(rows):
        ins.append(state[0])
        eos = state[1] | (row == cfg.eos_token_id)
        state = (tp._next_row(cfg, row, eos, i + 1), eos, i + 1)
    return np.stack(ins)


def port_logits_along(cfg, params, ids, ins, width: int = 1):
    """Port logits [n, 9, vocab] teacher-forced along input rows `ins` after
    the prompt `ids`'s prefill, `width` rows per forward."""
    import torch

    from tts_tpu_torch.models import parler as tp

    cache = tp.init_kv_cache(cfg, "cpu")
    cross = tp.precompute_cross_kv(params, cfg)
    tp.parler_prefill(params, cfg, torch.tensor(ids), cache, cross)
    return torch.cat([tp._rows_logits(params, cfg, torch.from_numpy(ins[i:i + width]),
                                      len(ids) + i, cache, cross)
                      for i in range(0, len(ins), width)])


def first_part(logits, want, tie: float = PARLER_TIE) -> tuple[int, float]:
    """The first row where the argmax of `logits` [n, 9, vocab] differs from
    `want` [n, 9] (n if none), and the top-2 gap of a differing head there;
    asserts every difference is a near-tie (within `tie`)."""
    import torch

    want = torch.from_numpy(np.asarray(want, np.int64))
    agree = logits.argmax(-1) == want
    gap = logits.max(-1).values - logits.gather(-1, want[..., None])[..., 0]
    assert bool((agree | (gap < tie)).all()), f"non-tie disagreement, gaps {gap[~agree]}"
    rows = (~agree).any(-1).nonzero()
    if not len(rows):
        return len(want), float("inf")
    r = int(rows[0])
    top2 = logits[r].topk(2, dim=-1).values
    return r, float((top2[:, 0] - top2[:, 1])[~agree[r]].min())


# Dia: 2 encoder and 2 decoder layers, hidden 256 on both sides, 4 query and 2
# KV heads of 128, FFN 512: every decoder linear's output is a multiple of
# 256, so the JAX package's pack_linear (which keeps a linear dense unless
# out % 256 == 0) and the port's linear_format quantize the same set; the
# JAX builder's 128-byte context, 64 decode positions and tiny DAC
TINY_DIA = dict(enc_layers=2, dec_layers=2, enc_hidden=256, dec_hidden=256, enc_heads=4,
                dec_heads=4, query_heads=2, head_size=128, ffn=512)
DIA_QTYPES = ("dense", "Q8_0", "Q4_0")


def write_tiny_dia(root, qtype: str = "dense"):
    """The tiny Dia under directory `root`, by the JAX package's builder:
    dense (f32), or quantized by its quantize tool to Q8_0 or Q4_0 (its Dia
    rule: the encoder, the embeddings and the decoder linears; not the
    norms, the heads or the DAC).  Returns the path."""
    import pathlib

    from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
    from tts_tpu.convert.builder_dia import write_dia_gguf
    from tts_tpu.core.gguf import GGMLType

    dense = pathlib.Path(root) / "tiny_dia_dense.gguf"
    if not dense.exists():
        write_dia_gguf(str(dense), **TINY_DIA)
    if qtype == "dense":
        return str(dense)
    path = pathlib.Path(root) / f"tiny_dia_{qtype}.gguf"
    if not path.exists():
        quantize_gguf(str(dense), str(path), QuantizationParams(GGMLType[qtype]))
    return str(path)


def dia_models(path):
    """(jax cfg, jax params, port cfg, port params) of one Dia GGUF by each
    package's reader and loader, the caches switched to bf16 on quantized
    files as each package's runner loader does."""
    import dataclasses

    from tts_tpu.core.gguf import GGUFFile as JaxGGUFFile
    from tts_tpu.models import dia as jd
    from tts_tpu_torch.core.gguf import GGUFFile
    from tts_tpu_torch.models import dia as td

    with JaxGGUFFile(path) as f:
        jcfg = jd.DiaConfig.from_gguf_kv(f.kv)
        jparams = jd.load_dia_params(dict(f.tensors), jcfg)
        if jd.dia_params_quantized(jparams):
            jcfg = dataclasses.replace(jcfg, kv_dtype="bfloat16")
    with GGUFFile(path) as f:
        tcfg = td.DiaConfig.from_gguf_kv(f.kv)
        tparams = td.load_dia_params(dict(f.tensors), tcfg, "cpu")
        if td.dia_params_quantized(tparams):
            tcfg = dataclasses.replace(tcfg, kv_dtype="bfloat16")
    return jcfg, jparams, tcfg, tparams
