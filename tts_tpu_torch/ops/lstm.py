"""Bidirectional LSTM on cuDNN, counterpart of `tts_tpu/ops/lstm.py`.

The JAX package runs its LSTMs as a `lax.scan`; here one call of
`torch._VF.lstm` (cuDNN on the card, ATen's LSTM on the CPU) runs both
directions.  Both use the gate order i, f, g, o and the cell
c' = f*c + i*g, h' = o*tanh(c').

The GGUF layout is 8 tensors per direction ({prefix}.weights.{0..7},
{prefix}.biases.{0..7}; reverse_* for the backward direction): input-hidden
at even indices, hidden-hidden at odd, in gate order.  `pack_lstm_params`
concatenates them into cuDNN's [4H, in] / [4H, H] layout (the JAX package's
is its transpose) and sums the two biases as the JAX package does: `b_ih`
holds the sum and `b_hh` is zero, so both packages add the same f32 bias.

The JAX package's `mask` passes the carry through at masked steps, so
with a trailing pad every valid step equals an unpadded run.  The port
takes each example's valid length instead and runs packed sequences,
which gives the valid steps the same values (and zeros past them).  A mask
that is not a trailing pad has no counterpart here: the caller raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from tts_tpu_torch.core.device import card_device


def pack_lstm_params(tensors: dict, prefix: str, reverse: bool = False,
                     device=None) -> dict:
    """8 GGUF LSTM tensors (numpy) -> {"w_ih" [4H, in], "w_hh" [4H, H],
    "b_ih" [4H] (both biases summed), "b_hh" [4H] (zeros)}, f32 on `device`."""
    device = card_device(device)
    wkey = "reverse_weights" if reverse else "weights"
    bkey = "reverse_biases" if reverse else "biases"

    def get(name):
        return np.asarray(tensors[name], np.float32)

    w_ih = np.concatenate([get(f"{prefix}.{wkey}.{2 * g}") for g in range(4)], axis=0)
    w_hh = np.concatenate([get(f"{prefix}.{wkey}.{2 * g + 1}") for g in range(4)], axis=0)
    b = np.concatenate([get(f"{prefix}.{bkey}.{2 * g}") + get(f"{prefix}.{bkey}.{2 * g + 1}")
                        for g in range(4)], axis=0)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("w_ih", w_ih), ("w_hh", w_hh), ("b_ih", b), ("b_hh", np.zeros_like(b)))}


def _weights(fwd: dict, bwd: dict) -> list:
    return [p[k] for p in (fwd, bwd) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]


def flatten_bilstm(fwd: dict, bwd: dict) -> None:
    """On the card, move the eight weights into one buffer in cuDNN's layout
    (in place: the tensors become views of it), as nn.LSTM's
    flatten_parameters does, so cuDNN reads them there on every call
    instead of compacting a copy.  On the CPU it does nothing."""
    w = _weights(fwd, bwd)
    if w[0].device.type != "cuda" or not torch.backends.cudnn.is_acceptable(w[0]):
        return
    hidden, in_size = fwd["w_hh"].shape[1], fwd["w_ih"].shape[1]
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(w, 4, in_size, 2, hidden, 0, 1, False, True)


def bilstm(x: torch.Tensor, fwd: dict, bwd: dict, lengths=None) -> torch.Tensor:
    """[B, T, C_in] -> [B, T, 2H] (or [T, C_in] -> [T, 2H]): the forward
    direction's outputs, then the backward direction's, both from zero state.  `lengths` [B] (host ints),
    if given, are the examples' valid prefixes: each runs over its own
    steps alone, and the outputs past them are zero.  cuDNN's backward
    needs a forward run with train=True, so the forward takes it whenever
    autograd records (the trainer); under inference_mode it does not."""
    if x.ndim == 2:
        return bilstm(x[None], fwd, bwd)[0]
    hidden = fwd["w_hh"].shape[1]
    h0 = x.new_zeros(2, x.shape[0], hidden)
    weights, train = _weights(fwd, bwd), torch.is_grad_enabled()
    if lengths is None:
        out, _, _ = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, train, True, True)
        return out
    packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
    data, _, _ = torch._VF.lstm(packed.data, packed.batch_sizes, (h0, h0), weights, True, 1,
                                0.0, train, True)
    out, _ = pad_packed_sequence(packed._replace(data=data), batch_first=True,
                                 total_length=x.shape[1])
    return out
