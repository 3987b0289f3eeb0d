"""The ESPnet joint CTC/attention RNN recogniser of the LibriSpeech recipe
(Watanabe et al., "ESPnet: End-to-End Speech Processing Toolkit",
arXiv:1804.00015; ``egs/librispeech/asr1``, ``conf/tuning/train_rnn.yaml``),
written from its equations in plain PyTorch:

- listener (``etype: vggblstm``): ``VGG2L`` with one input channel over the
  features, [B, 1, T, D]: 3x3 convolutions 64, 64, a 2x2 max pool in ceil
  mode, 128, 128, another, each convolution followed by ReLU; the output
  [channel, freq] a frame (128 x ceil(ceil(D / 2) / 2) wide), lengths
  ceil(ceil(T / 2) / 2); then the BLSTM layers (``elayers`` x ``eunits`` a
  direction, no projection between them: ESPnet's ``RNN``, one
  ``nn.LSTM``), and one ``Linear(2 eunits -> eprojs)`` with tanh over the
  top layer (``RNN.l_last``), padding zeroed;
- CTC head: ``Linear(eprojs -> V)`` and log-softmax;
- location-aware attention (``AttLoc``): energies g . tanh(W_enc h + W_dec
  z + W_att conv(a_prev)) over the frames, align = softmax(scaling x
  energies), ctx = align . h;
- speller: ``dlayers`` LSTM cells of ``dunits``, layer 0 on [emb; ctx],
  layer l on layer l - 1's new h; the attention query is layer 0's h of the
  step before (ESPnet's ``z_list[0]``), the output ``Linear(dunits -> V)``
  of the top layer's new h.

Departures from ESPnet, each the program's (the parameter tree it trains):

- one bias an LSTM gate where ESPnet's cells add two (b_ih + b_hh: the same
  function);
- three additive constants inside the attention's tanh (the query
  projection's bias, the location convolution's bias through its
  projection, and ``att.loc_b``) where ESPnet has one (``mlp_enc``'s bias):
  a redundant bias, the same function; no bias on the energies' vector
  (ESPnet's ``gvec`` bias, which the softmax cancels); the scaling 2.0 as
  the temperature 0.5;
- the features: 80 log-mel bins, where the recipe's front end adds 3
  pitch features (``fbank_pitch``: 83 a frame, VGG2L 2,688 wide); the
  program computes no pitch;
- padded frames' energies -1e9 before the softmax (ESPnet: -inf);
- the loss (``asr_bench/reference/train.py``, shared): the attention head's
  cross-entropy a token and the CTC head's nll over the label length, each
  averaged over the batch, where ESPnet multiplies the token mean by the
  mean length and sums the CTC nll over the batch; Adadelta's rho 0.9 (the
  program's) where ESPnet passes 0.95;
- the convolutions see the batch as padded by the program's buckets (a
  frame past an utterance's end is zero), where ESPnet pads to the longest
  utterance of its batch.

It imports the default module's shared pieces (``Precision``, the BiLSTM,
the attention, the LSTM cell, the CTC head; ``asr_bench/reference/model.py``
lists the interface).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from asr_bench import weights
from asr_bench.reference import model as M
from asr_bench.reference.model import ctc_log_probs  # noqa: F401

CELLS = ["dec.l0", "dec.l1"]
STEP_WEIGHTS = ("att.proj_q.w", "dec.l0.wx", "dec.l0.wh", "dec.l1.wx", "dec.l1.wh", "dec.char.w")
CONVS = ((1, 64), (64, 64), (64, 128), (128, 128))


def _ceil_half(n):
    return (n + 1) // 2


def enc_dim(model: dict) -> int:
    return model["encoder"]["out_proj"]


def vgg2l_dim(feat_dim: int) -> int:
    return 128 * _ceil_half(_ceil_half(feat_dim))


def leaves(model: dict, feat_dim: int, vocab: int) -> List[weights.Leaf]:
    """VGG2L, the BLSTM layers, the output projection, the CTC head, the
    embedding, the attention, the speller's cells and its output."""
    enc, att, dec = model["encoder"], model["attention"], model["decoder"]
    h, e = dec["dim"], enc_dim(model)
    out: List[weights.Leaf] = []
    for i, (ci, co) in enumerate(CONVS):
        s = 1.0 / math.sqrt(9 * ci)
        out += [(f"enc.conv{i + 1}.w", (co, ci, 3, 3), "u", s), (f"enc.conv{i + 1}.b", (co,), "u", s)]
    d = vgg2l_dim(feat_dim)
    for i, hl in enumerate(enc["dim"]):
        out += weights.lstm(f"enc.l{i}.fwd", d, hl) + weights.lstm(f"enc.l{i}.bwd", d, hl)
        d = 2 * hl
    out += weights.dense("enc.out_proj", d, e) + weights.dense("ctc", e, vocab)
    out += [("embed", (vocab, h), "n", 1.0 / math.sqrt(h))]
    dk, k, p = att["dim"], att["loc_kernel_num"], 2 * att["loc_kernel_size"] + 1
    out += weights.dense("att.proj_q", h, dk) + weights.dense("att.proj_k", e, dk, bias=False)
    out += [("att.loc_conv.w", (k, 1, p), "u", 1.0 / math.sqrt(p)), ("att.loc_conv.b", (k,), "u", 1.0 / math.sqrt(p))]
    out += weights.dense("att.loc_proj", k, dk, bias=False)
    out += [("att.loc_v", (1, dk), "u", 1.0 / math.sqrt(dk)), ("att.loc_b", (dk,), "zero", 0.0)]
    return (out + weights.lstm(CELLS[0], h + e, h) + weights.lstm(CELLS[1], h, h)
            + weights.dense("dec.char", h, vocab))


def port_tree(flat: M.W, model: dict) -> dict:
    """The program's tree (``models/asr.py``: prenet ``vgg2l``, layers
    without ``proj``, the encoder's ``out_proj``)."""
    g = flat.__getitem__
    cell = lambda n: {"wx": g(n + ".wx"), "wh": g(n + ".wh"), "b": g(n + ".b")}  # noqa: E731
    lin = lambda n: {"w": g(n + ".w"), "b": g(n + ".b")}  # noqa: E731
    return {
        "encoder": {
            "prenet": {f"conv{i}": lin(f"enc.conv{i}") for i in range(1, 5)},
            "layers": [{"fwd": cell(f"enc.l{i}.fwd"), "bwd": cell(f"enc.l{i}.bwd")}
                       for i in range(len(model["encoder"]["dim"]))],
            "out_proj": lin("enc.out_proj"),
        },
        "ctc": lin("ctc"),
        "embed": {"table": g("embed")},
        "attention": {"proj_q": lin("att.proj_q"), "proj_k": {"w": g("att.proj_k.w")},
                      "loc_conv": lin("att.loc_conv"), "loc_proj": {"w": g("att.loc_proj.w")},
                      "loc_v": g("att.loc_v"), "loc_b": g("att.loc_b")},
        "decoder": {"cells": [cell(n) for n in CELLS], "char": lin("dec.char")},
    }


def _bilstm_fp8(pr: M.Precision, x: torch.Tensor, lens: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``model._bilstm_loop`` (the float8 control's recurrence) with Wh
    rounded once a sweep, where it rounds it once a step: the same values,
    without a copy of Wh a step kept for the backward (at H 1024 and ~700
    frames those copies overflow the card)."""
    b, t, _ = x.shape
    mask = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    outs = []
    for (wx, wh, bias), order in ((fwd, range(t)), (bwd, range(t - 1, -1, -1))):
        xw = pr.store(M.mm(pr, x, wx) + bias)
        whq = pr.q(wh)
        h = x.new_zeros((b, wh.shape[0]))
        c = torch.zeros_like(h)
        ys = [None] * t
        for s in order:
            gi, gf, gg, go = (xw[:, s] + pr.q(h) @ whq).chunk(4, -1)
            c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h2 = torch.sigmoid(go) * torch.tanh(c2)
            m = mask[:, s, None]
            h, c = torch.where(m, pr.store(h2), h), torch.where(m, pr.store(c2), c)
            ys[s] = torch.where(m, h, 0.0)
        outs.append(torch.stack(ys, 1))
    return torch.cat(outs, -1)


def encode(w: M.W, model: dict, feat: torch.Tensor, feat_len: torch.Tensor, pr: M.Precision
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VGG2L, the BLSTM layers, tanh of the output projection; padding zero."""
    enc = model["encoder"]
    if (enc["prenet"] != "vgg2l" or enc["module"] != "LSTM" or not enc["bidirection"] or any(enc["proj"])
            or any(enc["layer_norm"]) or any(r != 1 for r in enc["sample_rate"]) or not enc["out_proj"]):
        raise ValueError("the reference holds ESPnet's VGG2L + BLSTM listener with one output projection")
    h = pr.store(feat[:, None])
    h = pr.store(M._conv(pr, w, "enc.conv2", pr.store(M._conv(pr, w, "enc.conv1", h))))
    h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    h = pr.store(M._conv(pr, w, "enc.conv4", pr.store(M._conv(pr, w, "enc.conv3", h))))
    h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    b, c, t, f = h.shape
    x = h.permute(0, 2, 1, 3).reshape(b, t, c * f)
    lens = _ceil_half(_ceil_half(feat_len))
    mask = (torch.arange(t, device=x.device)[None, :] < lens[:, None])[..., None]
    for i in range(len(enc["dim"])):
        g = lambda k: w[f"enc.l{i}.{k}"]  # noqa: E731
        run = _bilstm_fp8 if pr.mode == "fp8" else M.bilstm
        x = pr.store(run(pr, x, lens, (g("fwd.wx"), g("fwd.wh"), g("fwd.b")), (g("bwd.wx"), g("bwd.wh"), g("bwd.b"))))
    x = torch.where(mask, pr.store(torch.tanh(M.mm(pr, x, w["enc.out_proj.w"]) + w["enc.out_proj.b"])), 0.0)
    return x, torch.clamp(lens, min=1)


def speller_setup(w: M.W, model: dict, enc: torch.Tensor, enc_len: torch.Tensor, pr: M.Precision) -> dict:
    dec = model["decoder"]
    if dec["layer"] != len(CELLS) or dec["module"] != "LSTM" or dec.get("query_layer") != "first":
        raise ValueError("this architecture holds a speller of two LSTM layers queried by the first")
    mem = M.attention_setup(w, model, enc, enc_len, pr)
    # the step's weights rounded through ``pr`` once, where ``model.mm``
    # rounds them at every step: the same values
    mem["wq"] = {n: pr.q(w[n]) for n in STEP_WEIGHTS}
    return mem


def speller_state(w: M.W, mem: dict) -> Tuple[torch.Tensor, ...]:
    """(h0, c0, h1, c1, alignment) before <sos>: zeros and the uniform
    alignment."""
    shape = (mem["enc"].shape[0], w["dec.l0.wh"].shape[0])
    return tuple(mem["enc"].new_zeros(shape) for _ in range(4)) + (mem["prev"],)


def speller_step(w: M.W, mem: dict, tok: torch.Tensor, state: Tuple[torch.Tensor, ...], pr: M.Precision
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The query from layer 0's h, ``attend``, layer 0 on [emb, ctx], layer 1
    on layer 0's new h, the logits from layer 1's."""
    h0, c0, h1, c1, prev = state
    wq = mem["wq"]
    emb = w["embed"][tok]
    q = pr.q(h0) @ wq["att.proj_q.w"] + w["att.proj_q.b"]
    ctx, align = M.attend(w, mem, q, prev, pr)
    h0, c0 = _cell(pr, torch.cat([emb, ctx], -1), h0, c0, wq, w, CELLS[0])
    h1, c1 = _cell(pr, h0, h1, c1, wq, w, CELLS[1])
    logits = pr.store(pr.q(h1) @ wq["dec.char.w"] + w["dec.char.b"])
    return logits, tuple(pr.store(x) for x in (h0, c0, h1, c1, align))


def _cell(pr: M.Precision, x, h, c, wq: dict, w: M.W, n: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model.lstm_cell`` over the rounded weights ``wq`` of cell ``n``."""
    gi, gf, gg, go = (pr.q(x) @ wq[n + ".wx"] + w[n + ".b"] + pr.q(h) @ wq[n + ".wh"]).chunk(4, -1)
    c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    return torch.sigmoid(go) * torch.tanh(c2), c2


def feedback(model: dict, device) -> str:
    """The program runs a two-layer speller as its Python loop on every
    device: one exponential draw [B, V] a position after the coins."""
    return "exponential"


def _frames(feat_len: int) -> int:
    return _ceil_half(_ceil_half(int(feat_len)))


def utterance_flops(model: dict, feat_dim: int, vocab: int, feat_len: int) -> float:
    """One utterance's VGG2L over its valid frames, each BLSTM layer's input
    and recurrent products and cell, the output projection, the key
    projection and the CTC head."""
    n, d2 = int(feat_len), _ceil_half(feat_dim)
    total = 2 * 9 * feat_dim * n * (1 * 64 + 64 * 64) + 2 * 9 * d2 * _ceil_half(n) * (64 * 128 + 128 * 128)
    d, valid, e = vgg2l_dim(feat_dim), _frames(n), enc_dim(model)
    for h in model["encoder"]["dim"]:
        total += 2 * valid * (2 * d * 4 * h + 2 * h * 4 * h + 12 * h)
        d = 2 * h
    total += 2 * valid * d * e
    return float(total + 2 * valid * e * (model["attention"]["dim"] + vocab))


def speller_step_flops(model: dict, vocab: int, feat_len: int) -> float:
    """One step of one hypothesis: q, the location conv and its projection,
    the energies and the context over the valid frames, both cells, the
    output."""
    att, h, e = model["attention"], model["decoder"]["dim"], enc_dim(model)
    dk, kk, p, s = att["dim"], att["loc_kernel_num"], 2 * att["loc_kernel_size"] + 1, _frames(feat_len)
    return float(2 * h * dk + s * (2 * p * kk + dk * (2 * kk + 4) + 2 * e) + 2 * (h + e + h) * 4 * h
                 + 2 * (h + h) * 4 * h + 24 * h + 2 * h * vocab)
