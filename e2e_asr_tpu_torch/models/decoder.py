"""Speller decoder: stacked LSTM / GRU cells + character projection.

Counterpart of ``e2e_asr_tpu/models/decoder.py``. The state is an explicit
(h, c) pair of [layers, B, H] tensors that the beam loop and the
teacher-forced loop thread through; a GRU speller passes its c through
unchanged, as the JAX one does, so that the state keeps one shape for both
cells (the beam graph's state buffers among them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import DecoderConfig
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params
from e2e_asr_tpu_torch.ops.rnn import cell_of, gru_cell, lstm_cell

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c) each [layers, B, H]


def decoder_init(gen: torch.Generator, in_dim: int, vocab: int, cfg: DecoderConfig) -> Params:
    gates = 4 if cell_of(cfg.module) == "lstm" else 3
    cells = []
    d = in_dim
    for _ in range(cfg.layer):
        cells.append(L.lstm_init(gen, d, cfg.dim, gates))
        d = cfg.dim
    return {"cells": cells, "char": L.dense_init(gen, cfg.dim, vocab)}


def init_state(b: int, cfg: DecoderConfig, device: torch.device,
               dtype: torch.dtype = torch.float32) -> State:
    z = torch.zeros((cfg.layer, b, cfg.dim), device=device, dtype=dtype)
    return (z, z)


def query_of(state: State, cfg: DecoderConfig) -> torch.Tensor:
    """The attention query [B, H]: the hidden state of the layer that
    ``cfg.query_layer`` names, ``top`` (the JAX package's) or ``first``
    (ESPnet's)."""
    if cfg.query_layer == "top":
        return state[0][-1]
    if cfg.query_layer == "first":
        return state[0][0]
    raise ValueError(f"decoder.query_layer must be top or first, got '{cfg.query_layer}'")


def step(
    params: Params, cfg: DecoderConfig, state: State, x: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
):
    """One decode step. x: [B, in_dim] = [char_emb; context]. In training,
    dropout at ``cfg.dropout`` follows each layer.

    Returns (char_logits [B, vocab], hidden [B, H], new_state)."""
    is_lstm = cell_of(cfg.module) == "lstm"
    h_all, c_all = state
    hs, cs = [], []
    inp = x
    for i, w in enumerate(params["cells"]):
        dt = inp.dtype  # the weights are cast to the input's type
        xw = inp @ w["wx"].to(dt) + w["b"].to(dt)
        if is_lstm:
            h_new, c_new = lstm_cell(xw, h_all[i], c_all[i], w["wh"].to(dt))
        else:
            h_new, c_new = gru_cell(xw, h_all[i], w["wh"].to(dt)), c_all[i]
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
        inp = L.dropout(inp, cfg.dropout, generator, train)
    logits = L.dense(params["char"], inp)
    return logits, inp, (torch.stack(hs), torch.stack(cs))
