"""RNN language model: LM training and shallow fusion in the beam search.

Counterpart of ``e2e_asr_tpu/models/lm.py``: embedding (optionally tied to
the output through a projection back to the embedding width), dropout, an
n-layer LSTM or GRU, a linear output. ``apply_seq`` runs a whole batch of
token sequences (training and perplexity), each LSTM layer through
``ops/rnn.py`` ``lstm`` (the ``lstm_seq`` kernel pair with one direction on
the card), each GRU layer through ``gru`` (its plain recurrence, as the JAX
package scans it); ``step`` advances one token for every hypothesis of the
beam search (a GRU layer's c passes through unchanged).

The parameter tree is the one ``convert.params_from_jax`` makes of the JAX
``lm_init`` pytree: ``embed.table`` [V, E], ``cells`` a list of
``{"wx": [D, 4H], "wh": [H, 4H], "b": [4H]}`` (gate order i,f,g,o, forget
bias 1), and ``out`` {"w": [H, V], "b": [V]} or, with ``emb_tying``,
``out_proj`` {"w": [H, E], "b": [E]}. A GRU's cells are
``{"wx": [D, 3H], "wh": [H, 3H], "b": [3H]}`` (gates r,z,n).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params
from e2e_asr_tpu_torch.ops import rnn as rnn_ops
from e2e_asr_tpu_torch.ops.rnn import cell_of, gru_cell, lstm_cell

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c) each [layers, B, H]


def lm_init(gen: torch.Generator, vocab: int, cfg: LMConfig, device: torch.device) -> Params:
    """Seeded weights, drawn from ``gen`` (on its own device) and placed on
    ``device``: one seed gives the same LM on the CPU and on the card."""
    gates = 4 if cell_of(cfg.module) == "lstm" else 3
    p: Params = {"embed": L.embedding_init(gen, vocab, cfg.emb_dim)}
    cells = []
    d = cfg.emb_dim
    for _ in range(cfg.n_layers):
        cells.append(L.lstm_init(gen, d, cfg.dim, gates))
        d = cfg.dim
    p["cells"] = cells
    if cfg.emb_tying:
        p["out_proj"] = L.dense_init(gen, cfg.dim, cfg.emb_dim)
    else:
        p["out"] = L.dense_init(gen, cfg.dim, vocab)
    return convert.params_to(p, device)


def _output(p: Params, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.emb_tying:
        return L.dense(p["out_proj"], h) @ p["embed"]["table"].T
    return L.dense(p["out"], h)


def init_state(b: int, cfg: LMConfig, device: torch.device) -> State:
    z = torch.zeros((cfg.n_layers, b, cfg.dim), device=device)
    return (z, z)


def apply_seq(
    params: Params, cfg: LMConfig, tokens: torch.Tensor, lens: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
) -> torch.Tensor:
    """[B, L] token ids -> [B, L, V] logits. In training, dropout at
    ``cfg.dropout`` follows the embedding and each layer, drawn from
    ``generator``. Outputs past a row's length are those of zero hidden
    states (the layers' outputs are zero there)."""
    run = rnn_ops.lstm if cell_of(cfg.module) == "lstm" else rnn_ops.gru
    x = L.embed(params["embed"], tokens)
    x = L.dropout(x, cfg.dropout, generator, train)
    for w in params["cells"]:
        x = run(x, lens, w)
        x = L.dropout(x, cfg.dropout, generator, train)
    return _output(params, cfg, x)


def step(params: Params, cfg: LMConfig, tok: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """One token for every row: [B] ids -> ([B, V] log-probs, new state).
    The operations run in the JAX ``step``'s order (x Wx + b, then the cell
    adds h Wh), so that fused beams match it token for token. No host
    synchronisation."""
    is_lstm = cell_of(cfg.module) == "lstm"
    x = L.embed(params["embed"], tok)
    h_all, c_all = state
    hs, cs = [], []
    for i, w in enumerate(params["cells"]):
        xw = x @ w["wx"] + w["b"]
        if is_lstm:
            h, c = lstm_cell(xw, h_all[i], c_all[i], w["wh"])
        else:
            h, c = gru_cell(xw, h_all[i], w["wh"]), c_all[i]
        hs.append(h)
        cs.append(c)
        x = h
    return torch.log_softmax(_output(params, cfg, x), -1), (torch.stack(hs), torch.stack(cs))
