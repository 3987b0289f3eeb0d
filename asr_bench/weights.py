"""Weights from the seed: the recogniser's and the RNN-LM's, drawn on the
device in two calls (one uniform, one normal buffer) and cut into leaves.

Each leaf is named as the reference names it (the recogniser's by its
architecture module's ``leaves``, ``asr_bench/reference/model.py`` by
default; the LM's by ``lm_names``) and scaled as the recipe's layers
initialise: uniform in +-1/sqrt(fan-in) (a dense layer's input width, a
convolution's taps times input channels, an LSTM's hidden width), the LSTM
forget gates' bias 1, the location bias 0, embedding tables normal /
sqrt(width). The module's ``port_tree`` and ``port_lm_tree`` nest the same
tensors into the program's parameter trees.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# name, shape, law ("u" uniform, "uf" uniform with the forget gates' quarter 1, "n" normal, "zero"), scale
Leaf = Tuple[str, Tuple[int, ...], str, float]


def lstm(name: str, d: int, h: int) -> List[Leaf]:
    s = 1.0 / math.sqrt(h)
    return [(f"{name}.wx", (d, 4 * h), "u", s), (f"{name}.wh", (h, 4 * h), "u", s), (f"{name}.b", (4 * h,), "uf", s)]


def dense(name: str, d_in: int, d_out: int, bias: bool = True) -> List[Leaf]:
    s = 1.0 / math.sqrt(d_in)
    return [(f"{name}.w", (d_in, d_out), "u", s)] + ([(f"{name}.b", (d_out,), "u", s)] if bias else [])


def lm_names(lm: dict, vocab: int) -> List[Leaf]:
    """The tied RNN-LM's leaves: embedding, LSTM layers, output projection."""
    out: List[Leaf] = [("lm.embed", (vocab, lm["emb_dim"]), "n", 1.0 / math.sqrt(lm["emb_dim"]))]
    d = lm["emb_dim"]
    for i in range(lm["n_layers"]):
        out += lstm(f"lm.l{i}", d, lm["dim"])
        d = lm["dim"]
    return out + dense("lm.out_proj", lm["dim"], lm["emb_dim"])


def draw(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves' float32 tensors from ``seed`` on ``device``: one uniform
    and one normal draw for all of them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    buf = {"u": ("u", "uf"), "n": ("n",)}
    size = {k: sum(math.prod(s) for _, s, law, _ in leaves if law in laws) for k, laws in buf.items()}
    draws = {"u": torch.rand(size["u"], generator=gen, device=device).mul_(2.0).sub_(1.0),
             "n": torch.randn(size["n"], generator=gen, device=device)}
    out, at = {}, {"u": 0, "n": 0}
    for name, shape, law, scale in leaves:
        if law == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        k, n = law[0], math.prod(shape)
        out[name] = (draws[k][at[k]:at[k] + n] * scale).view(shape)
        at[k] += n
        if law == "uf":
            out[name][shape[0] // 4:shape[0] // 2] = 1.0
    return out


def port_lm_tree(flat: Dict[str, torch.Tensor], n_layers: int) -> dict:
    """The program's RNN-LM tree (``models/lm.py``) over ``flat``'s tensors."""
    g = flat.__getitem__
    return {"embed": {"table": g("lm.embed")},
            "cells": [{"wx": g(f"lm.l{i}.wx"), "wh": g(f"lm.l{i}.wh"), "b": g(f"lm.l{i}.b")} for i in range(n_layers)],
            "out_proj": {"w": g("lm.out_proj.w"), "b": g("lm.out_proj.b")}}
