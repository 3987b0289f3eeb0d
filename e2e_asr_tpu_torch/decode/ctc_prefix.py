"""Vectorized CTC prefix scoring for beam search.

Counterpart of ``e2e_asr_tpu/decode/ctc_prefix.py``. The Watanabe prefix
forward variables r^n / r^b of every (batch, beam, candidate) triple are
advanced over encoder time at once, in log space:

    phi_g(t)   = r^b(g,t) (+ r^n(g,t) unless cand == last(g))
    r^n(h,t)   = (r^n(h,t-1) + phi_g(t-1)) * p_t(c)
    r^b(h,t)   = (r^b(h,t-1) + r^n(h,t-1)) * p_t(blank)
    psi(h)     = sum_t phi_g(t-1) * p_t(c)        (prefix probability)
    psi(g+eos) = r^n(g,T) + r^b(g,T)              (full-sequence probability)

Per-utterance lengths freeze the recursion at t >= enc_len. The scores and
the eos score are ``decode/ctc_prefix_cuda.py`` ``prefix_scores_fused`` (the
hand-written kernel, one launch, on CUDA tensors; on CPU tensors its plain
version, the serial loop of ``prefix_scores_scan`` over the streams of
``recursion_inputs``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import (  # noqa: F401 (re-exported)
    NEG,
    eos_score,
    prefix_scores_fused,
    recursion_inputs,
)


def init_empty_prefix(ctc_lp: torch.Tensor, enc_len: torch.Tensor, beam: int) -> torch.Tensor:
    """Forward variables of the empty prefix: r^b(t) = prod of blanks,
    r^n = NEG. Returns [B, W, T, 2] (replicated over beams)."""
    b, t, _ = ctc_lp.shape
    lp_blank = ctc_lp[:, :, 0]
    valid = torch.arange(t, device=ctc_lp.device)[None, :] < enc_len[:, None]
    r_b = torch.cumsum(torch.where(valid, lp_blank, 0.0), dim=1)
    last = torch.gather(r_b, 1, torch.clamp(enc_len - 1, min=0)[:, None].long())
    r_b = torch.where(valid, r_b, last)
    r_n = torch.full_like(r_b, NEG)
    r = torch.stack([r_n, r_b], dim=-1)  # [B, T, 2]
    return r[:, None].expand(b, beam, t, 2).contiguous()


def prefix_scores(
    ctc_lp: torch.Tensor,
    enc_len: torch.Tensor,
    r_g: torch.Tensor,
    last_tok: torch.Tensor,
    cand: torch.Tensor,
    prefix_is_empty: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score K candidate extensions for every live hypothesis.

    ctc_lp: [B, T, V] CTC log-softmax; enc_len: [B]; r_g: [B, W, T, 2]
    forward vars of the current prefixes; last_tok: [B, W] last emitted
    token (ignored when prefix_is_empty); cand: [B, W, K] candidate ids.
    Returns (psi [B, W, K], r_h [B, W, K, T, 2]).
    """
    psi, r_h, _ = prefix_scores_fused(ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty)
    return psi, r_h
