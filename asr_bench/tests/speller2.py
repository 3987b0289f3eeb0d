"""A test-only architecture: the default listener, CTC head and attention,
and a speller of two LSTM layers as the program's plain route runs one
(``models/decoder.py``): layer 0 on [emb, ctx], layer 1 on layer 0's h, the
attention query from the top layer's h of the step before, the output from
the top layer. The program's fused scan takes one layer only, so its
training step draws the loop's sampled feedback on every device.

It imports the default module's shared pieces and replaces the speller's
(``asr_bench/reference/model.py`` lists the interface).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from asr_bench import weights
from asr_bench.reference import model as M
from asr_bench.reference.model import ctc_log_probs, enc_dim, encode, utterance_flops  # noqa: F401

CELLS = ["dec.l0", "dec.l1"]


def leaves(model: dict, feat_dim: int, vocab: int) -> List[weights.Leaf]:
    h = model["decoder"]["dim"]
    return (M.front_leaves(model, feat_dim, vocab) + weights.lstm(CELLS[0], h + enc_dim(model), h)
            + weights.lstm(CELLS[1], h, h) + weights.dense("dec.char", h, vocab))


def port_tree(flat: M.W, model: dict) -> dict:
    return M.tree(flat, model, CELLS)


def speller_setup(w: M.W, model: dict, enc: torch.Tensor, enc_len: torch.Tensor, pr: M.Precision) -> dict:
    if model["decoder"]["layer"] != len(CELLS):
        raise ValueError("this architecture holds a speller of two LSTM layers")
    return M.attention_setup(w, model, enc, enc_len, pr)


def speller_state(w: M.W, mem: dict) -> Tuple[torch.Tensor, ...]:
    """(h0, c0, h1, c1, alignment) before <sos>."""
    shape = (mem["enc"].shape[0], w["dec.l0.wh"].shape[0])
    return tuple(mem["enc"].new_zeros(shape) for _ in range(4)) + (mem["prev"],)


def speller_step(w: M.W, mem: dict, tok: torch.Tensor, state: Tuple[torch.Tensor, ...], pr: M.Precision
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    h0, c0, h1, c1, prev = state
    emb = w["embed"][tok]
    q = M.mm(pr, h1, w["att.proj_q.w"]) + w["att.proj_q.b"]
    ctx, align = M.attend(w, mem, q, prev, pr)
    g = lambda n, k: w[f"{n}.{k}"]  # noqa: E731
    h0, c0 = M.lstm_cell(pr, torch.cat([emb, ctx], -1), h0, c0, g(CELLS[0], "wx"), g(CELLS[0], "wh"), g(CELLS[0], "b"))
    h1, c1 = M.lstm_cell(pr, h0, h1, c1, g(CELLS[1], "wx"), g(CELLS[1], "wh"), g(CELLS[1], "b"))
    logits = pr.store(M.mm(pr, h1, w["dec.char.w"]) + w["dec.char.b"])
    return logits, tuple(pr.store(x) for x in (h0, c0, h1, c1, align))


def feedback(model: dict, device) -> str:
    return "exponential"


def speller_step_flops(model: dict, vocab: int, feat_len: int) -> float:
    """The default's step and the second layer's products and cell."""
    h = model["decoder"]["dim"]
    return M.speller_step_flops(model, vocab, feat_len) + 2 * (h + h) * 4 * h + 12 * h
