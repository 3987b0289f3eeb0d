"""The yardstick's arithmetic: the card's peaks, each operation's least work
from the problem's shapes, and the model FLOPs of a step.

An operation's (bytes, operations) count depends on its shapes and valid
lengths only, never on what implements it: bytes are each input read once
and each output written once at its storage type; operations what the
layer equations need at the valid lengths. The lstm_seq and speller-scan
counts are the program's own formulas as they stood when this benchmark was
written (``utils/profiling.py``), frozen here so that a change to the
program cannot move the yardstick; the attention-step and CTC-prefix counts
likewise. Model FLOPs count the forward's products and the elementwise work
the roofline counts count, times three for a training step (the backward
twice the forward), and nothing recomputed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at 700 W: bf16 on the tensor cores,
# float32 on the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

Work = Tuple[float, float]  # (bytes, operations)


def least_s(work: Work, dtype: str) -> float:
    """The least seconds the card needs for ``work`` at ``dtype``'s peak."""
    return max(work[0] / PEAK_BYTES, work[1] / PEAK_FLOPS[dtype])


def esize(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype]


# -------------------------------------------------------------- operations
def lstm_seq_fwd(t: int, b: int, h: int, valid: float, dirs: int, dtype: str) -> Work:
    """The recurrence's forward over T steps of dirs x B rows, ``valid`` the
    rows' summed lengths in one direction: xw [T, R, 4H], Wh and the mask
    read, ys, c and acts written; h Wh and ~12 elementwise operations a unit
    per valid row and step."""
    r, s = dirs * b, esize(dtype)
    return (s * (t * r * 4 * h + dirs * h * 4 * h + 2 * t * r * h) + 4 * (t * r + t * r * 4 * h),
            dirs * valid * (2 * h * 4 * h + 12 * h))


def lstm_seq_bwd(t: int, b: int, h: int, valid: float, dirs: int, dtype: str) -> Work:
    """The recurrence's backward: the mask, Wh, ys, c, acts and dy read;
    dxw and dWh written; dgates Wh^T, its share of dWh and ~20 elementwise
    operations a unit per valid row and step."""
    r, s = dirs * b, esize(dtype)
    return (s * (2 * dirs * h * 4 * h + 3 * t * r * h + t * r * 4 * h) + 4 * (t * r + t * r * 4 * h),
            dirs * valid * (16 * h * h + 20 * h))


def conv_taps(lens: Sequence[int], p: int) -> float:
    """Taps of a centred P-tap filter that fall inside [0, len), summed over
    the valid frames of every utterance."""
    r = (p - 1) // 2
    total = 0
    for n in lens:
        fr = np.arange(int(n))
        total += int((np.minimum(fr, r) + np.minimum(int(n) - 1 - fr, r) + 1).sum())
    return float(total)


def _scan_weights(dk, e, kk, p, h, emb, v, fwd):
    n = kk * p + h * dk + kk * dk + 2 * dk + (emb + e) * 4 * h + h * 4 * h + h * v
    return n + (dk + v * emb + 4 * h + v if fwd else 0)


def scan_fwd(b, s, dk, e, kk, p, h, emb, v, l, lens, dtype: str) -> Work:
    """The speller scan's forward over L steps of B utterances (``lens``
    their valid frames): k and v over the valid frames, the weights and ids
    read; logits, align, hidden and the residuals written; per step and
    utterance q, the gate product and the logits; per valid frame the
    location conv (taps on valid frames), the energies and the context."""
    sz = esize(dtype)
    nvalid = float(sum(int(n) for n in lens))
    return (sz * (nvalid * (dk + e) + _scan_weights(dk, e, kk, p, h, emb, v, True) + l * b * (v + s + 2 * h))
            + 4 * (l * b + l * b * (1 + 4 * h + dk + e)),
            l * 2 * (b * (h * dk + (emb + e + h) * 4 * h + h * v) + conv_taps(lens, p) * kk
                     + nvalid * (dk * (kk + 2) + e)))


def scan_bwd(b, s, dk, e, kk, p, h, emb, v, l, lens, dtype: str) -> Work:
    """The speller scan's backward sweep (the weight gradients summed outside
    it are not counted): the stored sequences, weights and cotangents read,
    dgates, dq, dfpre and dk written; per step dlogits Wout^T, dctx, dh, dq
    Wq^T; per valid frame dalign, one rebuild of the energies, dfpre, dWlp
    and ~12 elementwise operations a unit, the conv and its transpose over
    the taps on valid frames."""
    sz = esize(dtype)
    nvalid = float(sum(int(n) for n in lens))
    return (sz * (nvalid * (dk + e) + _scan_weights(dk, e, kk, p, h, emb, v, False) + l * b * (s + 2 * h)
                  + l * b * (v + s + h))
            + 4 * (l * b * (4 * h + dk + e) + l * b * (4 * h + dk + s * kk) + b * s * dk + b * 8 * (kk + 1) * dk),
            l * 2 * (b * (h * v + (e + h) * 4 * h + h * dk) + nvalid * (e + dk * (3 * kk + 6))
                     + 2 * conv_taps(lens, p) * kk))


def att_step(b: int, w: int, s: int, dk: int, e: int, kk: int, p: int, valid: float) -> Work:
    """One beam attention step (float32): q, prev align, the valid frames of k
    and v, the lengths and weights read, align and ctx written; per valid
    (beam, frame) the conv, the energies and the context."""
    return (4 * (b * w * dk + 2 * b * w * s + valid * (dk + e) + b + kk * p + kk * dk + 2 * dk + b * w * e),
            w * valid * (2 * p * kk + dk * (2 * kk + 4) + 2 * e) + b * w * s * 4)


def ctc_prefix(b: int, w: int, kc: int, t: int, v: int, valid: float) -> Work:
    """One beam step's CTC prefix and eos scores (float32): ctc log-probs and
    the parents' variables in, the candidates' variables and scores out;
    ~30 operations per valid (frame, candidate) cell."""
    n = b * w * kc
    return (4 * (b * t * v + b * w * t * 2 + 2 * t * n + n + b + b * w) + 8 * (n + b * w),
            30.0 * valid * w * kc)


# ------------------------------------------------------------- model FLOPs
def encoder_fwd_flops(model: dict, feat_dim: int, feat_lens: Sequence[int]) -> float:
    """The listener's forward at valid lengths: the VGG convolutions over the
    valid frames, each BiLSTM layer's input and recurrent products and cell,
    its projection."""
    ch = feat_dim // 40
    total = 0.0
    for n in feat_lens:
        n = int(n)
        total += 2 * 9 * 40 * n * (ch * 64 + 64 * 64) + 2 * 9 * 20 * (n // 2) * (64 * 128 + 128 * 128)
    d = 1280
    valid = float(sum(int(n) // 4 for n in feat_lens))
    for h in model["encoder"]["dim"]:
        total += 2 * valid * (2 * d * 4 * h + 2 * h * 4 * h + 12 * h) + valid * 2 * (2 * h) * (2 * h)
        d = 2 * h
    return total


def speller_step_flops(model: dict, enc_dim: int, vocab: int, valid_frames: float) -> float:
    """One speller step of one hypothesis over ``valid_frames`` encoder
    frames: q, the location conv and its projection, the energies, the
    context, the LSTM cell and the output."""
    att, h = model["attention"], model["decoder"]["dim"]
    dk, kk, p = att["dim"], att["loc_kernel_num"], 2 * att["loc_kernel_size"] + 1
    return (2 * h * dk + valid_frames * (2 * p * kk + dk * (2 * kk + 4) + 2 * enc_dim)
            + 2 * (h + enc_dim + h) * 4 * h + 12 * h + 2 * h * vocab)


def train_step_flops(model: dict, feat_dim: int, vocab: int, feat_lens: Sequence[int],
                     text_lens: Sequence[int]) -> float:
    """A training step's model FLOPs: three times the forward (encoder,
    key projection, CTC head, the speller over each utterance's tokens)."""
    e = 2 * model["encoder"]["dim"][-1]
    dk = model["attention"]["dim"]
    fwd = encoder_fwd_flops(model, feat_dim, feat_lens)
    for n, l in zip(feat_lens, text_lens):
        s = int(n) // 4
        if l <= 0:
            continue
        fwd += 2 * s * e * (dk + vocab) + int(l) * speller_step_flops(model, e, vocab, s)
    return 3.0 * fwd


def decode_flops(model: dict, lm: dict, feat_dim: int, vocab: int, beam: int, k_cand: int, use_lm: bool,
                 use_ctc: bool, feat_lens: Sequence[int], steps: Sequence[int]) -> float:
    """A decoded batch's model FLOPs: the encoder's forward, the key
    projection and CTC head, and per utterance and beam step (``steps``: the
    steps inside its window) the speller, the LM step and the CTC prefix
    scores of its hypotheses."""
    e = 2 * model["encoder"]["dim"][-1]
    dk = model["attention"]["dim"]
    total = encoder_fwd_flops(model, feat_dim, feat_lens)
    for n, st in zip(feat_lens, steps):
        s = int(n) // 4
        total += 2 * s * e * (dk + vocab)
        per = speller_step_flops(model, e, vocab, s)
        if use_lm:
            d, hl = lm["emb_dim"], lm["dim"]
            per += lm["n_layers"] * (2 * (d + hl) * 4 * hl + 12 * hl) + 2 * hl * d + 2 * d * vocab
        if use_ctc:
            per += 30.0 * s * k_cand
        total += int(st) * beam * per
    return total
