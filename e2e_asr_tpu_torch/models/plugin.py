"""Embedding-regularizer plugin (``model.emb_reg``).

Counterpart of ``e2e_asr_tpu/models/plugin.py``: the speller's hidden state
is projected into a target-embedding space, a cosine loss against the gold
token's embedding joins the training loss (``emb_reg.weight``), and fused
decoding mixes the embedding-similarity distribution into the output
softmax (``emb_reg.fuse``). The table is a ``.npy`` [vocab, dim] file
(``emb_reg.src``) or, without one, a seeded random table; its rows are
normalised once at init. It stays in the parameter tree (and so in the
optimizer's lists and the checkpoints); ``freeze`` stops its gradient.

The plugin computes in float32 from the hidden states, as the JAX package
casts them, whatever the step's compute type.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from e2e_asr_tpu_torch.config import EmbRegConfig
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params


def emb_reg_init(gen: torch.Generator, dec_dim: int, vocab: int, cfg: EmbRegConfig) -> Params:
    """{"proj": dense [dec_dim, E], "table": [vocab, E] rows of unit norm}:
    the table read from ``cfg.src`` (normalised in float32 numpy, as the JAX
    package does) or drawn from ``gen`` (N(0, 1) / sqrt(E), E = ``cfg.dim``
    or the speller's width)."""
    if cfg.src:
        table = np.load(cfg.src).astype(np.float32)
        if table.shape[0] != vocab:
            raise ValueError(f"emb_reg table {cfg.src} has {table.shape[0]} rows, the vocabulary {vocab}")
        table = torch.from_numpy(table / (np.linalg.norm(table, axis=1, keepdims=True) + 1e-8)).to(gen.device)
    else:
        dim = cfg.dim or dec_dim
        table = torch.randn((vocab, dim), generator=gen, device=gen.device) / math.sqrt(dim)
        table = table / (torch.linalg.vector_norm(table, dim=1, keepdim=True) + 1e-8)
    return {"proj": L.dense_init(gen, dec_dim, table.shape[1]), "table": table}


def predict_embedding(p: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Speller hidden [.., H] (float32) -> unit-norm predicted embedding [.., E]."""
    e = L.dense(p["proj"], hidden)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)


def emb_reg_sums(p: Params, cfg: EmbRegConfig, hidden: torch.Tensor, targets: torch.Tensor,
                 target_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of 1 - cos over the valid tokens, their count): the numerator
    and denominator of ``emb_reg_loss``, apart so that a data-parallel step
    divides by the global count. hidden [B, L, H], targets [B, L]."""
    table = p["table"].detach() if cfg.freeze else p["table"]
    pred = predict_embedding(p, hidden.float())  # [B, L, E]
    cos = torch.sum(pred * table[targets.long()], -1)
    mask = (torch.arange(targets.shape[1], device=targets.device)[None, :] < target_len[:, None]).float()
    return torch.sum((1.0 - cos) * mask), mask.sum()


def emb_reg_loss(p: Params, cfg: EmbRegConfig, hidden: torch.Tensor, targets: torch.Tensor,
                 target_len: torch.Tensor) -> torch.Tensor:
    """Mean (1 - cos) between predicted and gold embeddings over the valid
    tokens (``compute_loss`` takes the sums apart, to divide by the global
    count)."""
    num, den = emb_reg_sums(p, cfg, hidden, targets, target_len)
    return num / torch.clamp(den, min=1)


def fused_log_probs(p: Params, cfg: EmbRegConfig, char_logits: torch.Tensor,
                    hidden: torch.Tensor) -> torch.Tensor:
    """Fused decoding: (1 - fuse) * log_softmax(char logits) + fuse *
    log_softmax(cos-similarity to every table row / temperature), in
    float32; the plain char log-probs at ``fuse`` 0. The table takes no
    gradient here."""
    lp_char = torch.log_softmax(char_logits.float(), -1)
    if cfg.fuse <= 0:
        return lp_char
    pred = predict_embedding(p, hidden.float())
    sim = pred @ p["table"].detach().T / max(cfg.temperature, 1e-6)
    return (1.0 - cfg.fuse) * lp_char + cfg.fuse * torch.log_softmax(sim, -1)
