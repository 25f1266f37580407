"""Stage-trace helpers: summaries of logits that a runner records when its
`capture_trace` is set (prompt ids, step-0 logit statistics, the head of the
token stream, the first codec frames), enough to place a mismatch with a
reference in the front end, prefill, decode or codec.

The port's own copy of `tts_tpu/utils/trace.py`.
"""

from __future__ import annotations

import numpy as np


def logit_stats(row: np.ndarray, top: int = 5) -> dict:
    """Summary statistics of one logits row [V] (finite entries only:
    models mask invalid ids to -inf)."""
    row = np.asarray(row, np.float64)
    finite = row[np.isfinite(row)]
    order = np.argsort(row)[::-1][:top]
    return {
        "min": float(finite.min()) if len(finite) else 0.0,
        "max": float(finite.max()) if len(finite) else 0.0,
        "mean": float(finite.mean()) if len(finite) else 0.0,
        "argmax": int(row.argmax()),
        "top_ids": [int(i) for i in order],
        "top_logits": [round(float(row[i]), 4) for i in order],
    }


def multihead_logit_stats(mat: np.ndarray) -> dict:
    """Per-head argmax and head 0's detail for [H, V] logits (Parler's
    parallel codebook heads)."""
    mat = np.asarray(mat, np.float64)
    return {
        "per_head_argmax": [int(i) for i in mat.argmax(axis=-1)],
        "head0": logit_stats(mat[0]),
    }
