"""CTC loss kernel (csrc/ctc_loss.cu) beside its plain PyTorch version,
and the autograd function of the CTC loss.

Replaces the TPU kernel ``e2e_asr_tpu/ops/ctc_pallas.py``
``ctc_loss_pallas`` (its lattice ``_kernel`` and its ``custom_vjp``). All
versions take log_probs [B, T, V] f32, labels [B, L] (0-padded; blank is
0), input_len [B] and label_len [B]; input_len is clamped to T.

- ``ctc_lattice_plain``: the semantics-defining alpha/beta lattice, the raw
  nll [B] (1e30 where no alignment exists) and gamma [B, T, S] = alpha +
  beta - logZ over the S = 2L+1 lattice states (d nll / d lp_ext =
  -exp(gamma)).
- ``ctc_lattice`` (the kernel on CUDA tensors) and ``ctc_lattice_grad_plain``
  (its plain version: the lattice above, then -exp(gamma) routed to the
  vocabulary by a one-hot product, as the TPU package's ``_bwd``): the raw
  nll and G [B, T, V] = d nll / d log_probs for a unit upstream gradient,
  zero on rows with no alignment. The kernel's G repeats bitwise (no
  atomics), and its wrapper never synchronises with the host: the kernel
  checks the labels itself (a device-side assert).
- ``CTCLossFn``: the loss with G saved by the forward; its backward is one
  product, G times the upstream gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from e2e_asr_tpu_torch import cuda_build

NEG = -1.0e30
BIG = 1.0e29  # nll above this means "no alignment"


def extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, 2L+1] blank-interleaved lattice labels (blank = 0)."""
    b, l = labels.shape
    ext = labels.new_zeros((b, 2 * l + 1))
    ext[:, 1::2] = labels
    return ext


def _lse(*xs: torch.Tensor) -> torch.Tensor:
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    m_safe = torch.clamp(m, min=NEG)
    s = sum(torch.exp(x - m_safe) for x in xs)
    return torch.where(m > NEG / 2, m_safe + torch.log(s), NEG)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[..., s] = x[..., s-n] (n > 0, right) or x[..., s+|n|] (left), NEG-filled."""
    out = torch.full_like(x, NEG)
    if n > 0:
        out[..., n:] = x[..., :-n]
    else:
        out[..., :n] = x[..., -n:]
    return out


def ctc_lattice_plain(
    log_probs: torch.Tensor, labels: torch.Tensor, input_len: torch.Tensor, label_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: alpha as a loop over T, then beta backwards, with the
    kernel's freeze semantics."""
    b, t_len, _ = log_probs.shape
    ext = extend_labels(labels.long())
    s = ext.shape[1]
    lp = log_probs.float().gather(2, ext[:, None, :].expand(b, t_len, s))  # [B, T, S]
    sidx = torch.arange(s, device=log_probs.device)[None, :]
    prev2 = torch.cat([ext.new_zeros((b, 2)), ext[:, :-2]], dim=1)
    skip = (sidx >= 2) & (ext != 0) & (ext != prev2)
    inlen = torch.clamp(input_len.long(), max=t_len)[:, None]
    lablen = label_len.long()[:, None]
    end = 2 * lablen

    gamma = lp.new_empty((b, t_len, s))
    alpha = torch.where((sidx == 0) | ((sidx == 1) & (lablen > 0)), lp[:, 0], NEG)
    gamma[:, 0] = torch.where(inlen > 0, alpha, NEG)
    for t in range(1, t_len):
        new = _lse(alpha, _shift(alpha, 1), torch.where(skip, _shift(alpha, 2), NEG)) + lp[:, t]
        live = t < inlen
        gamma[:, t] = torch.where(live, new, NEG)
        alpha = torch.where(live, new, alpha)

    pick_end = alpha.gather(1, end)
    pick_pre = torch.where(lablen > 0, alpha.gather(1, torch.clamp(end - 1, min=0)), NEG)
    log_z = _lse(pick_end, pick_pre)  # [B, 1]
    nll = -log_z[:, 0]

    beta = torch.where((sidx == end) | ((sidx == end - 1) & (lablen > 0)), 0.0, NEG).to(lp.dtype)
    beta_init = beta
    skip_at_s2 = _shift(torch.where(skip, 0.0, NEG).to(lp.dtype), -2)
    gamma[:, t_len - 1] = torch.where(
        inlen == t_len, gamma[:, t_len - 1] + beta_init - log_z, gamma[:, t_len - 1]
    )
    for t in range(t_len - 2, -1, -1):
        bt = beta + lp[:, t + 1]
        new_beta = _lse(bt, _shift(bt, -1), _shift(bt, -2) + skip_at_s2)
        beta = torch.where(t <= inlen - 2, new_beta, beta_init)
        gamma[:, t] = torch.where(t <= inlen - 1, gamma[:, t] + beta - log_z, gamma[:, t])
    return nll, gamma


def ctc_lattice_grad_plain(
    log_probs: torch.Tensor, labels: torch.Tensor, input_len: torch.Tensor, label_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ctc_lattice``: the raw nll [B] and G [B, T, V],
    -exp(gamma) routed to the vocabulary, zero where no alignment exists."""
    nll, gamma = ctc_lattice_plain(log_probs, labels, input_len, label_len)
    ext = extend_labels(labels.long())
    onehot = (ext[:, :, None] == torch.arange(log_probs.shape[2], device=ext.device)).to(gamma.dtype)
    g = torch.where((nll <= BIG)[:, None, None], -torch.exp(gamma), 0.0)
    return nll, torch.einsum("bts,bsv->btv", g, onehot)


def _plan(t_len: int, v: int, l_max: int) -> Tuple[int, int, int]:
    """(threads a block, rows a tile or 0 for all rows resident, shared memory
    bytes) from the kernel's own layout; raises where a row does not fit.
    Needs the built library, not the card."""
    key = (t_len, v, l_max)
    if key not in _plans:
        out = torch.zeros(3, dtype=torch.int32)
        cuda_build.launch("ctc_loss", "e2e_ctc_loss_plan", t_len, v, l_max, out)
        threads, tr, smem = out.tolist()
        if smem < 0:
            raise ValueError(f"ctc_lattice: V = {v} and L = {l_max} leave no room for one row of "
                             "log_probs in shared memory")
        _plans[key] = (threads, tr, smem)
    return _plans[key]


_plans: dict = {}
_INDEX_TYPES = (torch.int32, torch.int64)


def ctc_lattice(
    log_probs: torch.Tensor, labels: torch.Tensor, input_len: torch.Tensor, label_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw nll [B] and G [B, T, V] = d nll / d log_probs: plain version on
    CPU tensors; the CUDA kernel on CUDA tensors. Labels outside [0, V) and
    label lengths outside [0, L] are refused: by a ValueError on the CPU, by
    the kernel's device-side assert on the card (the CUDA route does not
    synchronise with the host)."""
    b, t_len, v = log_probs.shape
    if cuda_build.use_plain(log_probs):
        if labels.numel() and bool(
            (labels < 0).any() | (labels >= v).any() | (label_len < 0).any()
            | (label_len > labels.shape[1]).any()
        ):
            raise ValueError(f"ctc_lattice: labels outside [0, {v}) or label lengths outside "
                             f"[0, {labels.shape[1]}]")
        return ctc_lattice_grad_plain(log_probs, labels, input_len, label_len)
    lp = log_probs.contiguous()
    cuda_build.check_cuda(lp, "ctc_lattice log_probs")
    labels, input_len, label_len = (a.contiguous() for a in (labels, input_len, label_len))
    for a, name in ((labels, "labels"), (input_len, "input_len"), (label_len, "label_len")):
        if a.device != lp.device or a.dtype not in _INDEX_TYPES:
            raise ValueError(f"ctc_lattice: {name} must be int32 or int64 on {lp.device}, got "
                             f"{a.dtype} on {a.device}")
    if labels.dim() != 2 or labels.shape[0] != b or input_len.shape != (b,) or label_len.shape != (b,):
        raise ValueError(f"ctc_lattice: batch {b} vs labels {tuple(labels.shape)}, "
                         f"lengths {tuple(input_len.shape)} {tuple(label_len.shape)}")
    l_max = labels.shape[1]
    threads, tr, smem = _plan(t_len, v, l_max)
    nll = torch.empty((b,), dtype=torch.float32, device=lp.device)
    grad = torch.empty((b, t_len, v), dtype=torch.float32, device=lp.device)
    work = torch.empty((2, b, t_len, 2 * l_max + 1), dtype=torch.float32, device=lp.device)
    cuda_build.launch("ctc_loss", "e2e_ctc_loss", lp, labels, input_len, label_len,
                      int(labels.dtype == torch.int64), int(input_len.dtype == torch.int64),
                      int(label_len.dtype == torch.int64), nll, grad, work, b, t_len, v, l_max,
                      threads, tr, smem)
    ctc_lattice.launches += 1
    return nll, grad


ctc_lattice.launches = 0


class CTCLossFn(torch.autograd.Function):
    """Per-utterance CTC nll [B] with the analytic gradient, zero for
    utterances with no alignment (which report +inf)."""

    @staticmethod
    def forward(ctx, log_probs, input_len, labels, label_len):
        raw, grad = ctc_lattice(log_probs, labels, input_len, label_len)
        ctx.save_for_backward(grad)
        return torch.where(raw > BIG, torch.inf, raw)

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return grad * ct[:, None, None], None, None, None
