"""Bidirectional LSTM layer kernels (csrc/lstm_bidir.cu, csrc/lstm_bidir_bwd.cu)
beside their plain PyTorch versions, and the autograd function that joins
the training forward to the backward.

Replaces the TPU kernel ``e2e_asr_tpu/ops/rnn_pallas.py`` ``lstm_seq_fused``
(forward and backward, its ``custom_vjp``). All versions take x [T, B, D]
(shared by both directions), mask [T, B] f32, wx [2, D, 4H], wh [2, H, 4H],
b [2, 4H]; ys [T, 2B, H] has rows [0, B) for the forward direction in
original time and rows [B, 2B) for the backward direction in kernel time
(flip over T to get original time). Carries freeze where mask = 0, outputs
are zeroed there, and the initial state is zero. Masks are contiguous
prefix runs per utterance (the backward reads h_prev from ys, which equals
the h carry wherever a step is valid under that contract). The kernels
split the hidden units over a cluster of 8 blocks, so they take H a
multiple of 8.
"""

from __future__ import annotations

from typing import Tuple

import torch

from e2e_asr_tpu_torch import cuda_build


def _kernel_time_inputs(x, mask, wx, b):
    """xw [T, 2B, 4H] (projections + bias) and m [T, 2B] bool, both rows in
    kernel time (the backward direction's time flipped)."""
    xw_f = x @ wx[0] + b[0]
    xw_b = torch.flip(x @ wx[1] + b[1], dims=[0])
    xw = torch.cat([xw_f, xw_b], dim=1)
    m = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1) > 0
    return xw, m


def lstm_bidir_fwd_train_plain(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the kernels' recurrence as a loop over T. Returns ys,
    the c carry after each step c [T, 2B, H] and the gate activations acts
    [T, 2B, 4H] (i, f, g, o)."""
    t, bsz, _ = x.shape
    h_dim = wh.shape[1]
    xw, m = _kernel_time_inputs(x, mask, wx, b)
    h = x.new_zeros((2 * bsz, h_dim))
    c = x.new_zeros((2 * bsz, h_dim))
    ys = x.new_empty((t, 2 * bsz, h_dim))
    cs = x.new_empty((t, 2 * bsz, h_dim))
    acts = x.new_empty((t, 2 * bsz, 4 * h_dim))
    for k in range(t):
        gates = xw[k] + torch.bmm(h.view(2, bsz, h_dim), wh).view(2 * bsz, -1)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        c2 = f * c + i * g
        h2 = o * torch.tanh(c2)
        mk = m[k][:, None]
        h = torch.where(mk, h2, h)
        c = torch.where(mk, c2, c)
        ys[k] = torch.where(mk, h2, 0.0)
        cs[k] = c
        acts[k] = torch.cat([i, f, g, o], dim=-1)
    return ys, cs, acts


def lstm_bidir_fwd_plain(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Plain version of the inference kernel: ys only."""
    return lstm_bidir_fwd_train_plain(x, mask, wx, wh, b)[0]


def _check_layer(x, mask, wx, wh, name, b=None):
    """Checks the layer's inputs (the bias where given); returns T, B, D, H."""
    for a, an in ((x, "x"), (mask, "mask"), (wx, "wx"), (wh, "wh"), (b, "b")):
        if a is not None:
            cuda_build.check_cuda(a, f"{name} {an}")
    t, bsz, d = x.shape
    h_dim = wh.shape[1]
    if wx.shape != (2, d, 4 * h_dim) or wh.shape != (2, h_dim, 4 * h_dim) or (
        b is not None and b.shape != (2, 4 * h_dim)
    ):
        raise ValueError(f"{name}: bad weight shapes {wx.shape} {wh.shape} "
                         f"{None if b is None else b.shape}")
    if mask.shape != (t, bsz):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} != {(t, bsz)}")
    if h_dim % 8 != 0 or h_dim > 1024:
        raise ValueError(f"{name}: hidden dim {h_dim} is not a multiple of 8 up to 1024")
    return t, bsz, d, h_dim


def lstm_bidir_fwd(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Inference forward: plain version on CPU tensors; the CUDA kernel on
    CUDA tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_fwd_plain(x, mask, wx, wh, b)
    x, mask, wx, wh, b = (a.contiguous() for a in (x, mask, wx, wh, b))
    t, bsz, d, h_dim = _check_layer(x, mask, wx, wh, "lstm_bidir_fwd", b)
    ys = torch.empty((t, 2 * bsz, h_dim), dtype=torch.float32, device=x.device)
    cuda_build.launch("lstm_bidir", "e2e_lstm_bidir_fwd", x, mask, wx, wh, b, ys, t, bsz, d, h_dim)
    lstm_bidir_fwd.launches += 1
    return ys


lstm_bidir_fwd.launches = 0


def lstm_bidir_fwd_train(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward (ys, c, acts): plain version on CPU tensors; the
    kernel's training variant on CUDA tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_fwd_train_plain(x, mask, wx, wh, b)
    x, mask, wx, wh, b = (a.contiguous() for a in (x, mask, wx, wh, b))
    t, bsz, d, h_dim = _check_layer(x, mask, wx, wh, "lstm_bidir_fwd_train", b)
    ys = torch.empty((t, 2 * bsz, h_dim), dtype=torch.float32, device=x.device)
    cs = torch.empty_like(ys)
    acts = torch.empty((t, 2 * bsz, 4 * h_dim), dtype=torch.float32, device=x.device)
    cuda_build.launch("lstm_bidir", "e2e_lstm_bidir_fwd_train", x, mask, wx, wh, b, ys, cs, acts,
                      t, bsz, d, h_dim)
    lstm_bidir_fwd_train.launches += 1
    return ys, cs, acts


lstm_bidir_fwd_train.launches = 0


def lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy):
    """Plain version of the backward: the explicit reverse sweep (not
    autograd) giving the gate gradients, then the products. Returns dx
    [T, B, D], dwx [2, D, 4H], dwh [2, H, 4H], db [2, 4H]."""
    t, bsz, _ = x.shape
    h_dim = wh.shape[1]
    m = (torch.cat([mask, torch.flip(mask, dims=[0])], dim=1) > 0).to(x.dtype)[..., None]
    dh = x.new_zeros((2 * bsz, h_dim))
    dc = x.new_zeros((2 * bsz, h_dim))
    dg = x.new_empty((t, 2 * bsz, 4 * h_dim))
    zeros = x.new_zeros((2 * bsz, h_dim))
    for k in range(t - 1, -1, -1):
        i, f, g, o = acts[k].chunk(4, dim=-1)
        tc = torch.tanh(c[k])
        c_prev = c[k - 1] if k > 0 else zeros
        dh2 = m[k] * (dy[k] + dh)
        dc2 = m[k] * dc + dh2 * o * (1.0 - tc * tc)
        dgates = torch.cat([
            dc2 * g * i * (1.0 - i),
            dc2 * c_prev * f * (1.0 - f),
            dc2 * i * (1.0 - g * g),
            dh2 * tc * o * (1.0 - o),
        ], dim=-1)
        dg[k] = dgates
        dh = (1.0 - m[k]) * dh + torch.bmm(dgates.view(2, bsz, -1), wh.transpose(1, 2)).view(2 * bsz, -1)
        dc = (1.0 - m[k]) * dc + dc2 * f
    dg_f = dg[:, :bsz]
    dg_b = torch.flip(dg[:, bsz:], dims=[0])  # original time
    dx = dg_f @ wx[0].T + dg_b @ wx[1].T
    x2 = x.reshape(t * bsz, -1)
    dwx = torch.stack([x2.T @ dg_f.reshape(t * bsz, -1), x2.T @ dg_b.reshape(t * bsz, -1)])
    h_prev = torch.cat([x.new_zeros((1, 2 * bsz, h_dim)), ys[:-1]], dim=0)
    dwh = torch.stack([
        h_prev[:, d * bsz:(d + 1) * bsz].reshape(t * bsz, -1).T
        @ dg[:, d * bsz:(d + 1) * bsz].reshape(t * bsz, -1)
        for d in range(2)
    ])
    db = dg.reshape(t, 2, bsz, -1).sum(dim=(0, 2))
    return dx, dwx, dwh, db


def lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy):
    """Backward: plain version on CPU tensors; the CUDA kernels on CUDA
    tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)
    x, mask, wx, wh, ys, c, acts, dy = (a.contiguous() for a in (x, mask, wx, wh, ys, c, acts, dy))
    t, bsz, d, h_dim = _check_layer(x, mask, wx, wh, "lstm_bidir_bwd")
    for a, an, shape in ((ys, "ys", (t, 2 * bsz, h_dim)), (c, "c", (t, 2 * bsz, h_dim)),
                         (acts, "acts", (t, 2 * bsz, 4 * h_dim)), (dy, "dy", (t, 2 * bsz, h_dim))):
        cuda_build.check_cuda(a, f"lstm_bidir_bwd {an}")
        if a.shape != shape:
            raise ValueError(f"lstm_bidir_bwd: {an} {tuple(a.shape)} != {shape}")
    dev = x.device
    dg = torch.empty((t, 2 * bsz, 4 * h_dim), dtype=torch.float32, device=dev)
    dx = torch.empty((t, bsz, d), dtype=torch.float32, device=dev)
    dwx = torch.empty((2, d, 4 * h_dim), dtype=torch.float32, device=dev)
    dwh = torch.empty((2, h_dim, 4 * h_dim), dtype=torch.float32, device=dev)
    db = torch.empty((2, 4 * h_dim), dtype=torch.float32, device=dev)
    cuda_build.launch("lstm_bidir_bwd", "e2e_lstm_bidir_bwd", x, mask, wx, wh, ys, c, acts, dy,
                      dg, dx, dwx, dwh, db, t, bsz, d, h_dim)
    lstm_bidir_bwd.launches += 1
    return dx, dwx, dwh, db


lstm_bidir_bwd.launches = 0


class LSTMBidirFn(torch.autograd.Function):
    """ys = the layer's forward, with the backward above (the counterpart of
    ``lstm_seq_fused.defvjp``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, mask, wx, wh, b):
        ys, c, acts = lstm_bidir_fwd_train(x, mask, wx, wh, b)
        ctx.save_for_backward(x, mask, wx, wh, ys, c, acts)
        return ys

    @staticmethod
    def backward(ctx, dy):
        x, mask, wx, wh, ys, c, acts = ctx.saved_tensors
        dx, dwx, dwh, db = lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy.contiguous())
        return dx, None, dwx, dwh, db


def lstm_bidir_train(x, mask, wx, wh, b) -> torch.Tensor:
    """Differentiable ys through the training forward and the backward."""
    return LSTMBidirFn.apply(x, mask, wx, wh, b)
