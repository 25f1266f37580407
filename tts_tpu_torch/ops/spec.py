"""Speculative greedy decode: the token drafter of Orpheus (the JAX package
keeps it in `tts_tpu/models/orpheus.py` as `_ngram_drafts`), the row
drafter of the multi-head AR models (Parler, Dia) and the gate that sends a
request to the speculative loop.

Counterpart of `tts_tpu/ops/spec.py`.  Speculation is greedy only: greedy
decoding argmaxes the raw logits and reads no PRNG or penalty state, so the
rows a verify forward accepts are the sequential loop's.  The drafter works
on the host copy of the emitted rows, which the loop reads back once per
verify window anyway.
"""

from __future__ import annotations

import os

import numpy as np

# drafts per verify forward (greedy path only)
SPEC_K = 7


def spec_enabled(config) -> bool:
    """Greedy decode takes the speculative loop unless TTS_TPU_NO_SPEC is
    set (the JAX package reads the same variable); sampled decode stays
    sequential, so a seeded stream equals generate."""
    return not os.environ.get("TTS_TPU_NO_SPEC") and not config.sample


def ngram_drafts(out: np.ndarray, token: int, i: int, k: int) -> np.ndarray:
    """Prompt-lookup drafting over one token stream: find the most recent
    earlier occurrence of the last emitted 2-gram and propose the k tokens
    that followed it; else, once 7 tokens are out, the previous SNAC frame's
    (audio token streams are 7-periodic in head structure); else repeat the
    last token.  out [n]: tokens j < i are emitted, the rest fill; `token`
    is out[i - 1], or the prefill's token when i == 0.  Returns [k]."""
    n = out.shape[0]
    prev = out[i - 1] if i > 0 else token
    prev2 = out[i - 2] if i > 1 else token
    j = np.arange(n)
    # the 2-gram (prev2, prev) at (j - 1, j); the drafts start at j + 1 and
    # lie wholly inside the emitted rows
    match = (out == prev) & (np.roll(out, 1) == prev2)
    score = np.where(match & (j >= 1) & (j + 1 < max(i - 1, 0)), j + 1, 0)
    best = int(score.argmax())
    if score[best] == 0 and i < 7:
        return np.full(k, prev, out.dtype)
    src = best + 1 if score[best] > 0 else max(i - 7, 0)
    src = min(src, n - k)               # the start clamp of jax's dynamic_slice
    return out[src:src + k].copy()


def ngram_draft_rows(out: np.ndarray, i: int, k: int) -> np.ndarray:
    """Prompt-lookup drafting over emitted multi-head rows: find the most
    recent earlier row equal to the last emitted one and propose the k rows
    that followed it, else repeat the last row.  out [n, H]: rows j < i are
    emitted, rows >= i are fill.  Returns [k, H]."""
    n = out.shape[0]
    last = max(i - 1, 0)
    prev = out[last]
    j = np.arange(n)
    score = np.where((out == prev[None, :]).all(axis=1) & (j + 1 < last), j + 1, 0)
    best = int(score.argmax())
    if score[best] == 0:
        return np.broadcast_to(prev, (k, out.shape[1])).copy()
    src = min(best + 1, n - k)          # the start clamp of jax's dynamic_slice
    return out[src:src + k].copy()
