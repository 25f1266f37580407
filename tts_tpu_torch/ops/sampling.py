"""On-device multi-head sampling over a [heads, vocab] tile: consecutive-repeat
penalty, temperature, top-k, bisection top-p, then a categorical draw.

Counterpart of `tts_tpu/ops/sampling.py`; `filtered_probs` computes the same
distribution.  Draws come from an explicit `torch.Generator` on the logits'
device, so a seeded sampled request is reproducible within this package but
does not give the tokens `jax.random.categorical` gives for the same seed.
Greedy decoding (`do_sample=False`) is the argmax, identical in both.

State is a dict {"last": int32 [H], "count": int32 [H]}.
"""

from __future__ import annotations

import torch


def init_state(n_heads: int, device="cpu") -> dict:
    return {"last": torch.full((n_heads,), -1, dtype=torch.int32, device=device),
            "count": torch.zeros((n_heads,), dtype=torch.int32, device=device)}


def filtered_probs(logits: torch.Tensor, state: dict, *, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0,
                   use_top_p: bool = True) -> torch.Tensor:
    """logits [H, V] -> the post-filter distribution [H, V] that
    `sample_tokens` draws from."""
    H, V = logits.shape
    logits = logits.float()
    pen = torch.pow(float(repetition_penalty), state["count"].float())     # [H]
    onehot_last = (torch.arange(V, device=logits.device)[None, :]
                   == state["last"][:, None].long()).float()
    logits = logits * (1.0 + onehot_last * (1.0 / pen - 1.0)[:, None])
    logits = logits / temperature

    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)

    probs = torch.softmax(logits, dim=-1)

    if use_top_p:
        # nucleus without a sort: the cutoff is the largest threshold t with
        # sum(probs >= t) >= top_p, found by 30 bisection steps
        lo = torch.zeros((H, 1), device=logits.device)
        hi = probs.amax(-1, keepdim=True)
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
            ge = mass >= top_p
            lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
        probs = torch.where(probs >= lo, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True)
    return probs


def sample_tokens(generator: torch.Generator | None, logits: torch.Tensor, state: dict, *,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                  repetition_penalty: float = 1.0, do_sample: bool = True,
                  use_top_p: bool = True):
    """logits [H, V] -> (tokens [H] int32, new_state), all on the device.
    A sampled draw is Gumbel-max over log(probs) with uniforms from
    `generator`; greedy is the argmax (`generator` may be None)."""
    if do_sample:
        probs = filtered_probs(logits, state, temperature=temperature, top_k=top_k,
                               top_p=top_p, repetition_penalty=repetition_penalty,
                               use_top_p=use_top_p)
        u = torch.rand(probs.shape, generator=generator, device=probs.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        tokens = torch.argmax(torch.log(probs + 1e-30) + gumbel, dim=-1)
    else:
        tokens = torch.argmax(logits.float(), dim=-1)
    tokens = tokens.to(torch.int32)
    count = torch.where(tokens == state["last"], state["count"] + 1, 1).to(torch.int32)
    return tokens, {"last": tokens, "count": count}
