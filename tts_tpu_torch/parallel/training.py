"""Sharded training step (dp x tp) for fine-tuning, counterpart of
`tts_tpu/parallel/training.py`: duration distillation on Kokoro's
predictor (L2 on the pre-round duration sums), the package's only
training path.

Sharding layout, as in the JAX package:
  batch                      -> split over dp (each dp row takes B / dp examples)
  ALBERT q/k/v weights       -> (None, "tp")  (output features: whole heads per shard)
  ALBERT output weight       -> ("tp", None)  (input features: partial sums)
  FFN in / out               -> (None, "tp") / ("tp", None)
  everything else            -> replicated

One controller drives the mesh (`parallel/mesh.py`).  The master copy of a
replicated leaf lives on the mesh's lead device, and shard j of a split
leaf on the lead row's j-th device; dp row i reads each leaf through
`.to(device)`, so autograd sums every row's gradient into the master (the
dp all-reduce).  The ALBERT layer is Kokoro's own (`kokoro._albert_layer`,
which reads a plain tensor as one shard): a row-parallel product's partial
sums are added on the row's lead device, and its bias once, after the sum.

The optimizer is `torch.optim.Adam` with optax.adam's defaults (betas 0.9,
0.999; eps 1e-8 added outside the square root, as optax adds it).  The
trained leaves are plain tensors, not views of cuDNN's flat LSTM buffer
(the inference loader's form): Adam updates them in place, and cuDNN
compacts a copy of each direction's weights per call.  The LSTMs' b_hh
stays zero and untrained: the JAX package's LSTM has one bias, which b_ih
holds.  Not ported: jit's `donate_argnums` (the step updates in place).
"""

from __future__ import annotations

import torch

from tts_tpu_torch.models import kokoro as kk
from tts_tpu_torch.parallel.mesh import Mesh, Shards, named, place, tree_map


def kokoro_param_specs(params) -> dict:
    """The spec tree (see `mesh.Sharding`) of Kokoro params under a (dp, tp)
    mesh."""
    specs = tree_map(lambda _: (), params)
    for layer_specs in specs["albert"]["layers"]:
        for n in ("q_w", "k_w", "v_w", "ffn_w"):
            layer_specs[n] = (None, "tp")
        for n in ("q_b", "k_b", "v_b", "ffn_b"):
            layer_specs[n] = ("tp",)
        for n in ("o_w", "ffn_out_w"):
            layer_specs[n] = ("tp", None)
    return specs


def shard_params(params, mesh: Mesh):
    """Place the param tree with its tp shardings.  Returns (params, specs)."""
    specs = kokoro_param_specs(params)
    return tree_map(lambda x, s: place(x, named(mesh, *s)), params, specs), specs


def _row_view(tree, devices: list):
    """The leaves as dp row `devices` reads them: a replicated leaf on the
    row's lead device, shard j of a split leaf on its j-th device."""
    if isinstance(tree, Shards):
        return Shards(x.to(d) for x, d in zip(tree, devices))
    if isinstance(tree, dict):
        return {k: _row_view(v, devices) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_row_view(v, devices) for v in tree]
    return tree.to(devices[0])


def _leaves(tree) -> list:
    """The trained leaves: every tensor and shard, but the LSTMs' b_hh."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() if k != "b_hh" for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class DurationTrainer:
    """Duration-distillation fine-tuning of Kokoro's predictor over a mesh."""

    def __init__(self, cfg: kk.KokoroConfig, mesh: Mesh, learning_rate: float = 1e-4):
        self.cfg = cfg
        self.mesh = mesh
        self.learning_rate = learning_rate

    def init(self, params):
        """Shard params over the mesh (fresh leaves: the caller's stay as
        they are) and build the optimizer that updates them, the step's
        opt_state."""
        params, _ = shard_params(params, self.mesh)
        params = tree_map(lambda x: x.detach().clone(), params)
        leaves = _leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return params, opt

    def loss(self, params, tokens, mask, style, target) -> torch.Tensor:
        """The mean over the global batch of each example's
        sum(((sums - target) * mask)^2) / max(sum(mask), 1), on the lead
        device.  Batch arrays [B, ...] (numpy or tensors) split over dp."""
        dp = self.mesh.shape["dp"]
        B = len(tokens)
        if B % dp:
            raise ValueError(f"a batch of {B} does not split over dp={dp}")
        rows = torch.as_tensor(tokens).long().chunk(dp), *(
            torch.as_tensor(a).float().chunk(dp) for a in (mask, style, target))
        total = None
        for i, (tok, m, st, tgt) in enumerate(zip(*rows)):
            devices = list(self.mesh.devices[i])
            lead = devices[0]
            tok, m, st, tgt = (a.to(lead) for a in (tok, m, st, tgt))
            albert = _row_view(params["albert"], devices)
            x = kk._albert_embed(albert, tok)
            key_bias = kk._key_bias(m)
            for _ in range(self.cfg.n_recurrence):
                for L in albert["layers"]:
                    x = kk._albert_layer(x, L, self.cfg, key_bias)
            sums, _ = kk.duration_tail(_row_view(params["dp"], devices), x, st,
                                       kk.trailing_lengths(m))
            per = ((sums - tgt) * m).square().sum(-1) / m.sum(-1).clamp(min=1.0)
            row = per.sum().to(self.mesh.lead)
            total = row if total is None else total + row
        return total / B

    def train_step(self, params, opt_state, tokens, mask, style, target):
        """One step: returns (params, opt_state, loss), params updated in place."""
        opt_state.zero_grad(set_to_none=True)
        loss = self.loss(params, tokens, mask, style, target)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()
