"""Greedy (beam 1) decoding for validation-time error rates.

Counterpart of ``e2e_asr_tpu/decode/greedy.py``: the attention head runs
free (argmax fed back) for ``max_step`` steps, and the CTC head is argmaxed
frame by frame (repeats and blanks are collapsed by the tokenizer).

The JAX decode is one ``lax.scan``. Here the loop writes each step's token
(and alignment) into buffers allocated before it, reads nothing back and
bakes in no number but ``max_step``, so that the whole loop is captured as
one CUDA graph with the rest of a dev batch's validation
(``training/step.py`` ``Trainer.eval_device``, ``training/eval_graph.py``):
one replay a dev batch, of ``max_step`` steps of ~40 kernels each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import ModelConfig
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.models import plugin as plugin_mod


@torch.no_grad()
def greedy_decode(
    params, cfg: ModelConfig, feat: torch.Tensor, feat_len: torch.Tensor, max_step: int,
    keep_align: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (tokens [B, max_step], align [B, max_step, H, S], or None
    without ``keep_align``). With ``emb_reg.fuse`` > 0 the argmax is the
    plugin's fused log-probs'."""
    enc, enc_len = asr_mod.encode(params, cfg, feat, feat_len)
    mem, carry = asr_mod.init_carry(params, cfg, enc, enc_len)
    toks = torch.empty((enc.shape[0], max_step), dtype=torch.long, device=enc.device)
    aligns = None
    fuse = "emb_reg" in params and cfg.emb_reg.fuse > 0
    for t in range(max_step):
        logits, align, hidden, carry = asr_mod.attend_and_step(params, cfg, mem, carry, carry.prev_tok)
        if fuse:
            logits = plugin_mod.fused_log_probs(params["emb_reg"], cfg.emb_reg, logits, hidden)
        tok = torch.argmax(logits, -1)
        carry = carry._replace(prev_tok=tok)
        toks[:, t] = tok
        if keep_align:
            if aligns is None:
                aligns = align.new_empty((align.shape[0], max_step, *align.shape[1:]))
            aligns[:, t] = align
    return toks, aligns


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
