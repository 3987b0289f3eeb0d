"""Length-masked LSTM and GRU recurrences.

Counterpart of ``e2e_asr_tpu/ops/rnn.py``. Weights are dicts
``{"wx": [D, GH], "wh": [H, GH], "b": [GH]}`` in gate order i,f,g,o for an
LSTM (G = 4) and r,z,n for a GRU (G = 3), the JAX ``LSTMWeights`` fields. ``bidir`` keeps the JAX package's layout: both
directions ride as 2B rows of one recurrence, the backward rows in flipped
time, carries freeze where the mask is 0 and outputs there are zero
(``_masked_scan``). The recurrence itself is ``ops/rnn_cuda.py``, by one of
two kernel pairs (``bidir``'s ``impl``): with the input projection inside
the kernel, when autograd records (grad enabled and an input needs grad)
the training forward and the backward kernel through ``lstm_bidir_train``,
otherwise the inference kernel ``lstm_bidir_fwd``; or ``lstm_seq`` over
projections computed outside (each the hand-written kernel on CUDA
tensors). ``lstm`` is one direction over a padded batch (the LM's
layers and one-direction encoder layers), through ``lstm_seq`` with one
direction.

GRU layers (``gru``, ``bidir(cell="gru")``) have no TPU kernel: the JAX
package runs them as its ``lax.scan`` under every ``rnn_impl``. The port
runs the same recurrence as a loop over time steps of plain operations, on
the card too (captured in the CUDA graphs of the train step, validation
and decode with everything else), autograd giving its backward.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from e2e_asr_tpu_torch.models.layers import sigmoid
from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_bidir_fwd, lstm_bidir_train, lstm_seq

LSTMWeights = Dict[str, torch.Tensor]


def lstm_cell(
    xw_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, wh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. xw_t = x_t @ Wx + b precomputed. Returns (h', c')."""
    gates = xw_t + h @ wh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    h_new = sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def cell_of(module: str) -> str:
    """A config's ``module`` (LSTM or GRU, any case) -> "lstm" or "gru"."""
    if module.upper() not in ("LSTM", "GRU"):
        raise ValueError(f"recurrent module must be LSTM or GRU, got '{module}'")
    return module.lower()


def gru_cell(xw_t: torch.Tensor, h: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """One GRU step in the JAX package's formulation: the whole bias is on
    the input side (in xw_t = x_t @ Wx + b), n = tanh(xn + r * (h @ Wh_n));
    cuDNN's GRU equals it only with its b_hh at zero. Returns h'."""
    return _gru_update(xw_t, h @ wh, h)


def _gru_update(xw_t: torch.Tensor, hw: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU step from xw_t and hw = h @ Wh."""
    xr, xz, xn = xw_t.chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = sigmoid(xr + hr)
    z = sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _masked_gru(xw: torch.Tensor, mask: torch.Tensor, hidden) -> torch.Tensor:
    """xw [T, R, 3H] time-major, mask [T, R] bool, ``hidden(h) -> h Wh``
    -> ys [T, R, H]: the state frozen and the output zero where the mask is
    false (the JAX ``_masked_scan``)."""
    h = xw.new_zeros((xw.shape[1], xw.shape[2] // 3))
    ys = []
    for t in range(xw.shape[0]):
        h2 = _gru_update(xw[t], hidden(h), h)
        m = mask[t][:, None]
        h = torch.where(m, h2, h)
        ys.append(torch.where(m, h2, 0.0))
    return torch.stack(ys)


def gru(x: torch.Tensor, x_len: torch.Tensor, w: LSTMWeights) -> torch.Tensor:
    """[B, T, D] -> [B, T, H], one direction, zero past x_len; the weights
    cast to x's type. The JAX ``gru`` also returns the final state and takes
    ``reverse`` and ``h0``, which no caller uses."""
    dt = x.dtype
    mask = torch.arange(x.shape[1], device=x.device)[:, None] < x_len[None, :]  # [T, B]
    xw = x.transpose(0, 1) @ w["wx"].to(dt) + w["b"].to(dt)  # [T, B, 3H]
    wh = w["wh"].to(dt)
    return _masked_gru(xw, mask, lambda h: h @ wh).transpose(0, 1)


def _bidir_gru(x: torch.Tensor, x_len: torch.Tensor, w_fwd: LSTMWeights, w_bwd: LSTMWeights) -> torch.Tensor:
    """The JAX ``bidir`` of GRU cells: both directions as 2B rows of one
    recurrence, the backward rows in flipped time, each direction's h Wh a
    batched product with its own weights."""
    b, t, _ = x.shape
    dt = x.dtype
    mask = torch.arange(t, device=x.device)[:, None] < x_len[None, :]  # [T, B]
    xt = x.transpose(0, 1)
    xw_f = xt @ w_fwd["wx"].to(dt) + w_fwd["b"].to(dt)
    xw_b = torch.flip(xt @ w_bwd["wx"].to(dt) + w_bwd["b"].to(dt), dims=[0])
    wh = torch.stack([w_fwd["wh"], w_bwd["wh"]]).to(dt)  # [2, H, 3H]
    hdim = wh.shape[1]
    ys = _masked_gru(torch.cat([xw_f, xw_b], dim=1), torch.cat([mask, torch.flip(mask, dims=[0])], dim=1),
                     lambda h: torch.bmm(h.reshape(2, b, hdim), wh).reshape(2 * b, -1))
    y_f = ys[:, :b].transpose(0, 1)
    y_b = torch.flip(ys[:, b:], dims=[0]).transpose(0, 1)
    return torch.cat([y_f, y_b], dim=-1)


IMPLS = ("auto", "pallas", "pallas_xw")


def bidir(
    x: torch.Tensor, x_len: torch.Tensor, w_fwd: LSTMWeights, w_bwd: LSTMWeights,
    cell: str = "lstm", impl: str = "auto",
) -> torch.Tensor:
    """[B, T, D] -> [B, T, 2H] (fwd ++ bwd), zero past x_len.

    ``cell="gru"`` runs the GRU recurrence (plain operations, whatever
    ``impl`` says, as the JAX package runs it); the rest is the LSTM's.

    ``impl`` (the JAX package's value names): ``pallas`` is the
    fused-projection kernel pair (x @ Wx inside the kernel); ``pallas_xw``
    computes xw = x @ Wx + b for both directions as one matmul outside, flips
    the backward direction in time and runs the ``lstm_seq`` kernel pair over
    it, autograd giving dx, dWx and db from the matmul; ``auto`` is an alias
    of ``pallas_xw`` and no route of its own. On CPU tensors each route runs
    its kernels' plain versions. A bfloat16 x runs both routes in bfloat16
    storage (the weights cast to it; ``rnn_cuda``'s rounding points, which
    are the TPU kernels'), float32 in float32.

    The alias rests on one layer's forward + backward on an NVIDIA H100 80GB
    HBM3 at 700 W (chip_smoke.py, ``layer_routes``), lstm_seq route against
    fused-projection route: D=40 (T=816, B=32, H=256) 36.9 vs 55.9 ms;
    D=80 (same) 37.3 vs 56.0; D=512 (T=408, B=32, H=256) 20.1 vs 32.5; D=640
    (T=204, B=16, H=320) 8.1 vs 12.1; D=1280 (same) 8.6 vs 16.0 (two runs
    differ by about 1%). The matmul outside runs at the library's rate while
    the kernels' own projection and products (dx, dWx) run on the CUDA cores,
    and that outweighs writing and reading xw [T, 2B, 4H] at every width
    measured."""
    if impl not in IMPLS:
        raise ValueError(f"bidir impl must be one of {IMPLS}, got '{impl}'")
    if cell == "gru":
        return _bidir_gru(x, x_len, w_fwd, w_bwd)
    if cell != "lstm":
        raise ValueError(f"bidir cell must be lstm or gru, got '{cell}'")
    if impl == "auto":
        impl = "pallas_xw"
    b, t, _ = x.shape
    dt = x.dtype  # the weights are cast to it, as the JAX bidir casts them
    mask = (torch.arange(t, device=x.device)[:, None] < x_len[None, :]).float()  # [T, B]
    wh = torch.stack([w_fwd["wh"], w_bwd["wh"]]).to(dt)
    if impl == "pallas_xw":
        h4 = wh.shape[2]
        xw = x.transpose(0, 1) @ torch.cat([w_fwd["wx"], w_bwd["wx"]], dim=1).to(dt) + torch.cat(
            [w_fwd["b"], w_bwd["b"]]).to(dt)  # [T, B, 2 * 4H]
        xw = torch.cat([xw[..., :h4], torch.flip(xw[..., h4:], dims=[0])], dim=1)  # [T, 2B, 4H]
        mask2 = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1)
        ys = lstm_seq(xw, mask2, wh)
    else:
        wx = torch.stack([w_fwd["wx"], w_bwd["wx"]]).to(dt)
        bias = torch.stack([w_fwd["b"], w_bwd["b"]]).to(dt)
        train = torch.is_grad_enabled() and any(a.requires_grad for a in (x, wx, wh, bias))
        run = lstm_bidir_train if train else lstm_bidir_fwd
        ys = run(x.transpose(0, 1), mask, wx, wh, bias)  # [T, 2B, H]
    y_f = ys[:, :b].transpose(0, 1)
    y_b = torch.flip(ys[:, b:], dims=[0]).transpose(0, 1)
    return torch.cat([y_f, y_b], dim=-1)


def lstm(x: torch.Tensor, x_len: torch.Tensor, w: LSTMWeights) -> torch.Tensor:
    """[B, T, D] -> [B, T, H], one direction, zero past x_len.

    xw = x @ Wx + b for every step is one matmul outside the recurrence (as
    the JAX ``lstm`` hoists it), computed time-major, the weights cast to
    x's type (float32 or bfloat16 storage); the recurrence is
    ``lstm_seq`` with one direction: on CUDA tensors the kernel pair (a
    shape it refuses raises, e.g. H not a multiple of 8 or above 1024), on
    CPU tensors their plain versions. The JAX ``lstm`` also returns the
    final carry (h_T, c_T) and takes ``reverse``, ``h0`` and ``c0``: the LM
    uses none of them, so they are left out."""
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[:, None] < x_len[None, :]).float()  # [T, B]
    dt = x.dtype
    xw = x.transpose(0, 1) @ w["wx"].to(dt) + w["b"].to(dt)  # [T, B, 4H]
    return lstm_seq(xw, mask, w["wh"].to(dt)[None]).transpose(0, 1)
