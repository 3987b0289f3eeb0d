"""Weights from the seed: the recogniser's and the RNN-LM's, drawn on the
device in two calls (one uniform, one normal buffer) and cut into leaves.

Each leaf is named as the reference names it (``asr_names``, ``lm_names``)
and scaled as the recipe's layers initialise: uniform in +-1/sqrt(fan-in)
(a dense layer's input width, a convolution's taps times input channels, an
LSTM's hidden width), the LSTM forget gates' bias 1, the location bias 0,
embedding tables normal / sqrt(width). ``port_tree`` nests the same tensors
into the program's parameter tree.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# name, shape, law ("u" uniform, "uf" uniform with the forget gates' quarter 1, "n" normal, "zero"), scale
Leaf = Tuple[str, Tuple[int, ...], str, float]


def _lstm(name: str, d: int, h: int) -> List[Leaf]:
    s = 1.0 / math.sqrt(h)
    return [(f"{name}.wx", (d, 4 * h), "u", s), (f"{name}.wh", (h, 4 * h), "u", s), (f"{name}.b", (4 * h,), "uf", s)]


def _dense(name: str, d_in: int, d_out: int, bias: bool = True) -> List[Leaf]:
    s = 1.0 / math.sqrt(d_in)
    return [(f"{name}.w", (d_in, d_out), "u", s)] + ([(f"{name}.b", (d_out,), "u", s)] if bias else [])


def asr_names(model: dict, feat_dim: int, vocab: int) -> List[Leaf]:
    """The recogniser's leaves: VGG prenet, BiLSTM layers with projections,
    CTC head, embedding, location-aware attention, one-layer LSTM speller."""
    enc, att, dec = model["encoder"], model["attention"], model["decoder"]
    out: List[Leaf] = []
    for i, (ci, co) in enumerate(((1, 64), (64, 64), (64, 128), (128, 128))):
        ci = feat_dim // 40 if i == 0 else ci
        s = 1.0 / math.sqrt(9 * ci)
        out += [(f"enc.conv{i + 1}.w", (co, ci, 3, 3), "u", s), (f"enc.conv{i + 1}.b", (co,), "u", s)]
    d = 128 * ((40 // 2) // 2) if feat_dim % 40 == 0 else None
    if d is None:
        raise ValueError("the VGG prenet here takes a multiple of 40 features")
    for i, h in enumerate(enc["dim"]):
        out += _lstm(f"enc.l{i}.fwd", d, h) + _lstm(f"enc.l{i}.bwd", d, h) + _dense(f"enc.l{i}.proj", 2 * h, 2 * h)
        d = 2 * h
    out += _dense("ctc", d, vocab)
    out += [("embed", (vocab, dec["dim"]), "n", 1.0 / math.sqrt(dec["dim"]))]
    dk, k, p = att["dim"], att["loc_kernel_num"], 2 * att["loc_kernel_size"] + 1
    out += _dense("att.proj_q", dec["dim"], dk) + _dense("att.proj_k", d, dk, bias=False)
    out += [("att.loc_conv.w", (k, 1, p), "u", 1.0 / math.sqrt(p)), ("att.loc_conv.b", (k,), "u", 1.0 / math.sqrt(p))]
    out += _dense("att.loc_proj", k, dk, bias=False)
    out += [("att.loc_v", (1, dk), "u", 1.0 / math.sqrt(dk)), ("att.loc_b", (dk,), "zero", 0.0)]
    out += _lstm("dec", dec["dim"] + d, dec["dim"]) + _dense("dec.char", dec["dim"], vocab)
    return out


def lm_names(lm: dict, vocab: int) -> List[Leaf]:
    """The tied RNN-LM's leaves: embedding, LSTM layers, output projection."""
    out: List[Leaf] = [("lm.embed", (vocab, lm["emb_dim"]), "n", 1.0 / math.sqrt(lm["emb_dim"]))]
    d = lm["emb_dim"]
    for i in range(lm["n_layers"]):
        out += _lstm(f"lm.l{i}", d, lm["dim"])
        d = lm["dim"]
    return out + _dense("lm.out_proj", lm["dim"], lm["emb_dim"])


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


def port_tree(flat: Dict[str, torch.Tensor], n_layers: int) -> dict:
    """The program's parameter tree (``models/asr.py``) over ``flat``'s tensors."""
    g = flat.__getitem__
    lstm = lambda n: {"wx": g(n + ".wx"), "wh": g(n + ".wh"), "b": g(n + ".b")}  # noqa: E731
    dense = lambda n: {"w": g(n + ".w"), "b": g(n + ".b")}  # noqa: E731
    return {
        "encoder": {
            "prenet": {f"conv{i}": dense(f"enc.conv{i}") for i in range(1, 5)},
            "layers": [{"fwd": lstm(f"enc.l{i}.fwd"), "bwd": lstm(f"enc.l{i}.bwd"), "proj": dense(f"enc.l{i}.proj")}
                       for i in range(n_layers)],
        },
        "ctc": dense("ctc"),
        "embed": {"table": g("embed")},
        "attention": {"proj_q": dense("att.proj_q"), "proj_k": {"w": g("att.proj_k.w")},
                      "loc_conv": dense("att.loc_conv"), "loc_proj": {"w": g("att.loc_proj.w")},
                      "loc_v": g("att.loc_v"), "loc_b": g("att.loc_b")},
        "decoder": {"cells": [lstm("dec")], "char": dense("dec.char")},
    }


def port_lm_tree(flat: Dict[str, torch.Tensor], n_layers: int) -> dict:
    """The program's RNN-LM tree (``models/lm.py``) over ``flat``'s tensors."""
    g = flat.__getitem__
    return {"embed": {"table": g("lm.embed")},
            "cells": [{"wx": g(f"lm.l{i}.wx"), "wh": g(f"lm.l{i}.wh"), "b": g(f"lm.l{i}.b")} for i in range(n_layers)],
            "out_proj": {"w": g("lm.out_proj.w"), "b": g("lm.out_proj.b")}}
