"""Greedy (beam 1) decoding for validation-time error rates.

Counterpart of ``e2e_asr_tpu/decode/greedy.py``: the attention head runs
free (argmax fed back) for ``max_step`` steps, and the CTC head is argmaxed
frame by frame (repeats and blanks are collapsed by the tokenizer).
"""

from __future__ import annotations

from typing import Tuple

import torch

from e2e_asr_tpu_torch.config import ModelConfig
from e2e_asr_tpu_torch.models import asr as asr_mod


@torch.no_grad()
def greedy_decode(
    params, cfg: ModelConfig, feat: torch.Tensor, feat_len: torch.Tensor, max_step: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_step], align [B, max_step, H, S])."""
    enc, enc_len = asr_mod.encode(params, cfg, feat, feat_len)
    mem, carry = asr_mod.init_carry(params, cfg, enc, enc_len)
    toks, aligns = [], []
    for _ in range(max_step):
        logits, align, _, carry = asr_mod.attend_and_step(params, cfg, mem, carry, carry.prev_tok)
        tok = torch.argmax(logits, -1)
        carry = carry._replace(prev_tok=tok)
        toks.append(tok)
        aligns.append(align)
    return torch.stack(toks, 1), torch.stack(aligns, 1)


@torch.no_grad()
def ctc_greedy_decode(
    params, cfg: ModelConfig, feat: torch.Tensor, feat_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-wise argmax of the CTC head: (ids [B, S], enc_len [B]), ids
    zero past enc_len."""
    enc, enc_len = asr_mod.encode(params, cfg, feat, feat_len)
    ids = torch.argmax(asr_mod.ctc_log_probs(params, enc), -1)
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < enc_len[:, None]
    return torch.where(mask, ids, 0), enc_len
