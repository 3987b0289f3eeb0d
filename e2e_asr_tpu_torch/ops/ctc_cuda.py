"""CTC lattice kernel (csrc/ctc_loss.cu) beside its plain PyTorch version,
and the autograd function of the CTC loss.

Replaces the TPU kernel ``e2e_asr_tpu/ops/ctc_pallas.py``
``ctc_loss_pallas`` (its lattice ``_kernel`` and its ``custom_vjp``). Both
versions take log_probs [B, T, V] f32, labels [B, L] (0-padded; blank is 0),
input_len [B] and label_len [B], and return the raw nll [B] (1e30 where no
alignment exists) and gamma [B, T, S] = alpha + beta - logZ over the
S = 2L+1 lattice states, so that d nll / d lp_ext = -exp(gamma). input_len
is clamped to T. The gradient's route from the lattice back to the
vocabulary is ``scatter_add_`` in PyTorch (``CTCLossFn.backward``), as the
TPU package leaves it to XLA: on CUDA tensors its sums over the repeated
blank states come in no fixed order (float rounding differs from run to
run at ~1e-7 relative).
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


def ctc_lattice(
    log_probs: torch.Tensor, labels: torch.Tensor, input_len: torch.Tensor, label_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version on CPU tensors; the CUDA kernel on CUDA tensors.
    Labels outside [0, V) and label lengths outside [0, L] are refused (the
    kernel indexes log_probs and its shared lattice with them)."""
    b, t_len, v = log_probs.shape
    if labels.numel() and bool(
        (labels < 0).any() | (labels >= v).any() | (label_len < 0).any()
        | (label_len > labels.shape[1]).any()
    ):
        raise ValueError(f"ctc_lattice: labels outside [0, {v}) or label lengths outside "
                         f"[0, {labels.shape[1]}]")
    if cuda_build.use_plain(log_probs):
        return ctc_lattice_plain(log_probs, labels, input_len, label_len)
    lp = log_probs.contiguous()
    cuda_build.check_cuda(lp, "ctc_lattice log_probs")
    labels = labels.to(torch.int32).contiguous()
    inlen = torch.clamp(input_len, max=t_len).to(torch.int32).contiguous()
    lablen = label_len.to(torch.int32).contiguous()
    for a, name in ((labels, "labels"), (inlen, "input_len"), (lablen, "label_len")):
        cuda_build.check_cuda(a, f"ctc_lattice {name}", torch.int32)
    if labels.shape[0] != b or inlen.shape != (b,) or lablen.shape != (b,):
        raise ValueError(f"ctc_lattice: batch {b} vs labels {tuple(labels.shape)}, "
                         f"lengths {tuple(inlen.shape)} {tuple(lablen.shape)}")
    s = 2 * labels.shape[1] + 1
    nll = torch.empty((b,), dtype=torch.float32, device=lp.device)
    gamma = torch.empty((b, t_len, s), dtype=torch.float32, device=lp.device)
    cuda_build.launch("ctc_loss", "e2e_ctc_lattice", lp, labels, inlen, lablen, nll, gamma,
                      b, t_len, v, labels.shape[1])
    ctc_lattice.launches += 1
    return nll, gamma


ctc_lattice.launches = 0


class CTCLossFn(torch.autograd.Function):
    """Per-utterance CTC nll [B] with the analytic gradient -exp(gamma),
    zero for utterances with no alignment (which report +inf)."""

    @staticmethod
    def forward(ctx, log_probs, input_len, labels, label_len):
        raw, gamma = ctc_lattice(log_probs, labels, input_len, label_len)
        ctx.save_for_backward(gamma, raw, labels)
        ctx.vocab = log_probs.shape[2]
        return torch.where(raw > BIG, torch.inf, raw)

    @staticmethod
    def backward(ctx, ct):
        gamma, raw, labels = ctx.saved_tensors
        b, t_len, s = gamma.shape
        ok = (raw <= BIG)[:, None, None]
        g = torch.where(ok, -torch.exp(gamma), 0.0) * ct[:, None, None]
        ext = extend_labels(labels.long())[:, None, :].expand(b, t_len, s)
        grad = gamma.new_zeros((b, t_len, ctx.vocab)).scatter_add_(2, ext, g)
        return grad, None, None, None
