"""Length-masked LSTM recurrences.

Counterpart of ``e2e_asr_tpu/ops/rnn.py``. Weights are dicts
``{"wx": [D, 4H], "wh": [H, 4H], "b": [4H]}`` in gate order i,f,g,o (the
JAX ``LSTMWeights`` fields). ``bidir`` keeps the JAX package's layout: both
directions ride as 2B rows of one recurrence, the backward rows in flipped
time, carries freeze where the mask is 0 and outputs there are zero
(``_masked_scan``). The recurrence itself is ``ops/rnn_cuda.py``: when
autograd records (grad enabled and an input needs grad), the training
forward and the backward kernel through ``lstm_bidir_train``; otherwise
the inference kernel ``lstm_bidir_fwd`` (each the hand-written kernel on
CUDA tensors).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_bidir_fwd, lstm_bidir_train

LSTMWeights = Dict[str, torch.Tensor]


def lstm_cell(
    xw_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, wh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. xw_t = x_t @ Wx + b precomputed. Returns (h', c')."""
    gates = xw_t + h @ wh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def bidir(
    x: torch.Tensor, x_len: torch.Tensor, w_fwd: LSTMWeights, w_bwd: LSTMWeights
) -> torch.Tensor:
    """[B, T, D] -> [B, T, 2H] (fwd ++ bwd), zero past x_len."""
    b, t, _ = x.shape
    mask = (torch.arange(t, device=x.device)[:, None] < x_len[None, :]).float()  # [T, B]
    wx = torch.stack([w_fwd["wx"], w_bwd["wx"]])
    wh = torch.stack([w_fwd["wh"], w_bwd["wh"]])
    bias = torch.stack([w_fwd["b"], w_bwd["b"]])
    train = torch.is_grad_enabled() and any(a.requires_grad for a in (x, wx, wh, bias))
    run = lstm_bidir_train if train else lstm_bidir_fwd
    ys = run(x.transpose(0, 1), mask, wx, wh, bias)  # [T, 2B, H]
    y_f = ys[:, :b].transpose(0, 1)
    y_b = torch.flip(ys[:, b:], dims=[0]).transpose(0, 1)
    return torch.cat([y_f, y_b], dim=-1)
