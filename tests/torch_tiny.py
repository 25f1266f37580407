"""A tiny Q8_0 Orpheus GGUF shared by the port's tests (no jax import).

Widths are small but kernel-eligible: head size 128 (the flash-decode
kernels need it), output dims multiples of 256, 2 layers, a 156,940-row
embedding (prompt frame token ids index it), and build_snac_tensors' tiny SNAC."""

from __future__ import annotations

import numpy as np

TINY = dict(n_layers=2, hidden=256, heads=4, kv_heads=2, head_dim=128, ffn=512)
# a short cache: max_context 64 + max_gen 448 = 512, one 512-position chunk
CTX, GEN = 64, 448


def write_tiny_q8_orpheus(path, seed: int = 0, head_rows: int | None = None):
    """head_rows cuts the lm_head (and the vocab) to its first rows: the JAX
    package's interpret-mode kernels then decode in milliseconds instead of
    half a second per token.  None keeps the real 156,940 (padded to 1024)."""
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
        w.add_tensor(name, arr, GGMLType.Q8_0 if quant else None)
    w.write()
    return path
