"""CTC loss (negative log-likelihood per utterance).

Counterpart of ``e2e_asr_tpu/ops/ctc.py``. Blank is 0, the per-utterance
loss is the sum over the label sequence (``reduction='none'``), and an
utterance with no alignment (too few frames for its labels) gives +inf
unless ``zero_infinity``.

- ``ctc_forward_scan``: the semantics-defining alpha recursion as a loop
  over T; gradients by autograd through the loop. The tests use it as a
  reference.
- ``ctc_loss``: the loss the training step uses: ``ops/ctc_cuda.py``
  ``CTCLossFn``, the alpha/beta lattice with its analytic gradient (the
  hand-written kernel on CUDA tensors, its plain version on CPU tensors).
"""

from __future__ import annotations

import torch

from e2e_asr_tpu_torch.ops.ctc_cuda import NEG, CTCLossFn, extend_labels

__all__ = ["extend_labels", "ctc_forward_scan", "ctc_loss"]


def _lse(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe))
    return torch.where(m > NEG / 2, out, NEG)


def _shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[..., s] -> x[..., s-n] with NEG fill."""
    return torch.cat([torch.full_like(x[..., :n], NEG), x[..., :-n]], dim=-1)


def ctc_forward_scan(
    log_probs: torch.Tensor, input_len: torch.Tensor, labels: torch.Tensor, label_len: torch.Tensor
) -> torch.Tensor:
    """Per-utterance CTC nll [B] (+inf where no alignment exists).

    log_probs [B, T, V] log-softmax outputs, input_len [B], labels [B, L]
    (0-padded), label_len [B]."""
    b, t, _ = log_probs.shape
    ext = extend_labels(labels.long())
    s = ext.shape[1]
    lp_ext = log_probs.gather(2, ext[:, None, :].expand(b, t, s))  # [B, T, S]
    sidx = torch.arange(s, device=log_probs.device)[None, :]
    prev2 = torch.cat([ext.new_zeros((b, 2)), ext[:, :-2]], dim=1)
    allow_skip = (sidx >= 2) & (ext != 0) & (ext != prev2)
    lablen = label_len.long()[:, None]
    alpha = torch.where((sidx == 0) | ((sidx == 1) & (lablen > 0)), lp_ext[:, 0], NEG)
    for tt in range(1, t):
        a3 = torch.where(allow_skip, _shift_right(alpha, 2), NEG)
        new = _lse(alpha, _shift_right(alpha, 1), a3) + lp_ext[:, tt]
        alpha = torch.where((tt < input_len)[:, None], new, alpha)
    end = 2 * lablen
    a_end = alpha.gather(1, end)[:, 0]
    a_pre = torch.where(lablen[:, 0] > 0, alpha.gather(1, torch.clamp(end - 1, min=0))[:, 0], NEG)
    m = torch.maximum(a_end, a_pre)
    m_safe = torch.clamp(m, min=NEG)
    ll = torch.where(
        m > NEG / 2, m_safe + torch.log(torch.exp(a_end - m_safe) + torch.exp(a_pre - m_safe)), -torch.inf
    )
    return -ll


def ctc_loss(
    log_probs: torch.Tensor,
    input_len: torch.Tensor,
    labels: torch.Tensor,
    label_len: torch.Tensor,
    zero_infinity: bool = False,
) -> torch.Tensor:
    """Batched CTC nll [B], log_probs batch-major [B, T, V] as in the JAX
    package (not the [T, B, V] of ``torch.nn.CTCLoss``)."""
    nll = CTCLossFn.apply(log_probs, input_len, labels, label_len)
    if zero_infinity:
        nll = torch.where(torch.isfinite(nll), nll, 0.0)
    return nll
