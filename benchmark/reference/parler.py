"""Plain float32 PyTorch Parler-TTS decoder (Parler-TTS mini v1's
architecture), teacher-forced over a served request.

From the published description (parler-tts's ParlerTTSForConditionalGeneration
with a precomputed description encoding): learned positional embeddings;
per layer a pre-norm (layer norm with bias) causal self-attention, a
pre-norm cross-attention over the description's keys and values, and a
pre-norm tanh-GELU FFN, every projection biasless; a final layer norm and
one head per codebook.  The prompt's tokens embed through the prompt
embedding at positions 0..T-1; decode row t (position T + t) sums the 9
codebooks' embeddings of its input row, which follows the BOS-delay
staircase: codebook h reads BOS until row h, then the token it emitted a
row before, pinned to EOS once it has emitted EOS.  No cache, no kernels:
one causal forward over prompt and rows together.  Departures: none in the
mathematics; the description encoding is the file's random one (no T5)."""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from reference import dac
from reference.common import keep, tensor


def load(reader, cfg: dict, device) -> dict:
    L, C = cfg["num_hidden_layers"], cfg["num_codebooks"]

    def t(name):
        return tensor(reader, name, device)

    p = {"prompt": t("decoder.embed_prompts"), "pos": t("decoder.positional_embed"),
         "enc": t("decoder.text_encoding"), "norm": (t("decoder.layer_norm.weight"),
                                                    t("decoder.layer_norm.bias")),
         "embeds": [t(f"decoder.embed_tokens.{i}.weight") for i in range(C)],
         "heads": torch.stack([t(f"decoder.lm_heads.{i}.weight.head") for i in range(C)]),
         "layers": [], "vocab": reader.kv["tokenizer.ggml.tokens"],
         "unk": reader.kv["tokenizer.ggml.unknown_token_id"],
         "eos_text": reader.kv["tokenizer.ggml.eos_token_id"], "dac": dac.load(reader, cfg, device)}
    for l in range(L):
        pre = f"decoder.layers.{l}"
        p["layers"].append({
            "ln1": (t(f"{pre}.self_attn_layer_norm.weight"), t(f"{pre}.self_attn_layer_norm.bias")),
            "q": t(f"{pre}.self_attn.q_proj.weight"), "k": t(f"{pre}.self_attn.k_proj.weight"),
            "v": t(f"{pre}.self_attn.v_proj.weight"), "o": t(f"{pre}.self_attn.out_proj.weight"),
            "ln2": (t(f"{pre}.encoder_attn_layer_norm.weight"),
                    t(f"{pre}.encoder_attn_layer_norm.bias")),
            "cq": t(f"{pre}.encoder_attn.q_proj.weight"),
            "ck": t(f"{pre}.encoder_attn.k_proj.weight"),
            "cv": t(f"{pre}.encoder_attn.v_proj.weight"),
            "co": t(f"{pre}.encoder_attn.out_proj.weight"),
            "ln3": (t(f"{pre}.final_layer_norm.weight"), t(f"{pre}.final_layer_norm.bias")),
            "fc1": t(f"{pre}.fc1.weight"), "fc2": t(f"{pre}.fc2.weight")})
    return p


def prompt_ids(p: dict, text: str) -> list[int]:
    """The prompt's token ids under the file's unigram vocabulary, whose
    known tokens are single characters of equal score: a leading space and
    runs of spaces made one; each known character its token; each run of
    unknown characters one unknown token; then the text EOS."""
    ids = {tok.replace("▁", " "): i for i, tok in enumerate(p["vocab"])}
    unk = p["unk"]
    out: list[int] = []
    for ch in " " + re.sub(r"\s{2,}", " ", text):
        tid = ids.get(ch, unk)
        if not (tid == unk and out and out[-1] == unk):
            out.append(tid)
    return out + [p["eos_text"]]


def input_rows(rows: np.ndarray, C: int, bos: int, eos: int) -> np.ndarray:
    """The staircase inputs of the rows a request emitted: row 0 is all
    BOS; row t reads, for codebook h < t, its token of row t - 1 (EOS once
    it has emitted EOS), else BOS."""
    S = len(rows)
    seen = np.maximum.accumulate(rows == eos, axis=0)
    ins = np.full((S, C), bos, np.int64)
    for t in range(1, S):
        h = np.arange(C) < t
        ins[t, h] = np.where(seen[t - 1], eos, rows[t - 1])[h]
    return ins


def _ln(x, wb):
    return F.layer_norm(x, x.shape[-1:], wb[0], wb[1], 1e-5)


def _attend(q, k, v, H, mask=None):
    """q [n, D], k/v [m, D] -> [n, D], scaled by 1/sqrt(head size)."""
    hs = q.shape[-1] // H
    qh, kh, vh = (z.reshape(z.shape[0], H, hs).transpose(0, 1) for z in (q, k, v))
    s = qh @ kh.transpose(1, 2) / math.sqrt(hs)
    if mask is not None:
        s = s + mask
    return (torch.softmax(s, -1) @ vh).transpose(0, 1).reshape(q.shape[0], -1)


def logits(p: dict, cfg: dict, item: dict, rows: np.ndarray, act=keep) -> tuple[torch.Tensor, int]:
    """Per-row, per-codebook logits [S, 9, vocab] of the rows a request
    emitted, and the prompt's length.  `act` rounds every linear's input and
    every key and value (the identity: float32; `common.fp8`: the control)."""
    C, H = cfg["num_codebooks"], cfg["num_attention_heads"]
    A = cfg["audio_vocab_size"]
    ids = prompt_ids(p, item["text"])
    T, S = len(ids), len(rows)
    dev = p["pos"].device
    ins = torch.from_numpy(input_rows(rows, C, A + 1, A)).to(dev).clamp(max=A + 1)
    x = torch.cat([p["prompt"][torch.tensor(ids, device=dev)],
                   sum(p["embeds"][h][ins[:, h]] for h in range(C))]) + p["pos"][:T + S]
    n = T + S
    mask = torch.full((n, n), -1e9, device=dev).triu(1)
    for L in p["layers"]:
        h = act(_ln(x, L["ln1"]))
        k, v = act(h @ L["k"].T), act(h @ L["v"].T)
        x = x + act(_attend(h @ L["q"].T, k, v, H, mask)) @ L["o"].T
        h = act(_ln(x, L["ln2"]))
        enc = act(p["enc"])
        ck, cv = act(enc @ L["ck"].T), act(enc @ L["cv"].T)
        x = x + act(_attend(h @ L["cq"].T, ck, cv, H)) @ L["co"].T
        h = act(_ln(x, L["ln3"]))
        x = x + act(F.gelu(h @ L["fc1"].T, approximate="tanh")) @ L["fc2"].T
    x = act(_ln(x, p["norm"])[T:])
    return torch.einsum("sd,cvd->scv", x, p["heads"]), T


def frames(cfg: dict, rows: np.ndarray) -> np.ndarray:
    """The delay un-weave: frame i, codebook h is row i + h's token of h; a
    frame holding any id past the audio codes is dropped."""
    C, A = cfg["num_codebooks"], cfg["audio_vocab_size"]
    n = len(rows) - (C - 1)
    if n <= 0:
        return np.zeros((0, C), np.int64)
    f = np.stack([rows[h:h + n, h] for h in range(C)], axis=1)
    return f[(f < A).all(axis=1)]


def audio(p: dict, cfg: dict, item: dict, rows: np.ndarray) -> torch.Tensor:
    """The request's audio: the DAC's decode of the served rows' frames."""
    return dac.decode(p["dac"], frames(cfg, rows))
