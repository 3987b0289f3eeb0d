"""Tracing, timing and roofline accounting on the card: the port's
counterpart of ``e2e_asr_tpu/utils/profiling.py``.

- ``trace(logdir)``: a ``torch.profiler`` trace (the CPU and, on the card,
  CUDA activity) written as a Chrome trace, the counterpart of the
  ``jax.profiler`` trace.
- ``time_fn(fn, *args)``: median seconds a call over three rounds; on the
  card each round is timed by CUDA events (``device_ms``: the calls queued
  behind a spin of the card, so that the host's issue of them does not
  pace a short program), on the CPU by the host clock.
- ``Roofline`` and ``bound_ms``: a time against the card's peaks.
- Each hand kernel's least work, ``(bytes, operations)``, as a function of
  its arguments' shapes (and, where the work depends on the data, of the
  valid lengths): ``log_mel_work``, ``lstm_seq_fwd_work`` /
  ``lstm_seq_bwd_work``, ``lstm_bidir_fwd_work`` / ``lstm_bidir_bwd_work``,
  ``ctc_work``, ``decoder_scan_fwd_work`` / ``decoder_scan_bwd_work``,
  ``att_step_work`` and ``prefix_work``; ``kernel_rooflines`` gathers them
  at a bucket's shapes. The counts depend on a kernel's shapes (and valid
  lengths), never on what implements it, so that a roofline share reads
  the same work before and after a kernel changes: one formula a function,
  in which the storage type changes only the element size (``bound_ms``
  takes the compute type's peak). Bytes: each input read once, each output
  written once, at its storage type; operations: what the function needs.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit: bf16 on the
# tensor cores, f32 on the CUDA cores (outside the tensor cores), HBM3.
# A card set below 700 W runs slower under load: a bound is against these.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12  # bytes per second

SPIN_CYCLES_PER_CALL = 400_000  # ~0.2 ms of the card's clock per queued call: above a wrapper's host time


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name ("float32", "bfloat16")."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def esize(dtype) -> int:
    """Bytes an element of ``dtype``."""
    return torch.empty((), dtype=as_dtype(dtype)).element_size()


def peak_flops(dtype=torch.float32) -> float:
    """The card's peak operations a second at ``dtype``: bf16 on the tensor
    cores, anything else at the f32 rate."""
    return PEAK_BF16_FLOPS if as_dtype(dtype) == torch.bfloat16 else PEAK_F32_FLOPS


def bound_ms(n_bytes: float, n_flops: float, dtype=torch.float32) -> Tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card takes to move
    ``n_bytes`` and do ``n_flops`` at ``dtype``'s peak, the larger of the two."""
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_flops / peak_flops(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ trace / timing
@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Record the body under ``torch.profiler`` (the CPU, and CUDA activity
    where a card is present) and write it as a Chrome trace,
    ``<logdir>/<name>.json`` (Perfetto / chrome://tracing). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def device_ms(fn: Callable, iters: int = 20, warmup: int = 1) -> float:
    """ms a call of ``fn`` on the card (CUDA events over ``iters`` calls),
    the calls queued behind a spin of the card long enough that the host's
    issue of them does not pace the card: device time, not launch rate (a
    function of many launches stays host-paced)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * iters)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, device=None) -> float:
    """Median seconds a call of ``fn(*args)`` over three rounds of ``iters``
    calls, after ``warmup`` calls. ``device``: where ``fn``'s work runs (by
    default the card where one is present, else the CPU). On the card each
    round is timed by CUDA events (``device_ms``); on the CPU by the host
    clock, the card (where present) synchronised around each round so that
    no queued work lands in it or escapes it."""
    cuda = torch.cuda.is_available()
    dev = torch.device(device if device is not None else "cuda" if cuda else "cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(3):
        if dev.type == "cuda":
            times.append(device_ms(lambda: fn(*args), iters, 0) / 1e3)
        else:
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            sync()
            times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


@dataclass
class Roofline:
    """A measured time against the card's peaks (``dtype_peak`` operations
    a second, ``hbm_peak`` bytes a second)."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    dtype_peak: float = PEAK_BF16_FLOPS
    hbm_peak: float = PEAK_HBM_BYTES

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def sol_compute(self) -> float:
        """Fraction of the compute speed of light."""
        return (self.flops / self.dtype_peak) / self.seconds if self.flops else 0.0

    @property
    def sol_memory(self) -> float:
        return (self.bytes_moved / self.hbm_peak) / self.seconds if self.bytes_moved else 0.0

    def report(self) -> str:
        parts = [f"{self.name}: {self.seconds*1e3:.2f} ms"]
        if self.flops:
            parts.append(f"{self.achieved_tflops:.1f} TFLOP/s ({100*self.sol_compute:.0f}% SoL)")
        if self.bytes_moved:
            parts.append(f"{100*self.sol_memory:.0f}% HBM SoL")
        bound = "compute" if self.sol_compute >= self.sol_memory else "memory"
        parts.append(f"{bound}-bound")
        return " | ".join(parts)


# ------------------------------------------------- each hand kernel's least work
def log_mel_work(a, b, n, win, n_fft):
    """(bytes, operations) of the log-mel function's least work on [b, n]
    waves: the wave in and the features out, the window and the mel bank's
    nonzeros read once; per frame DC removal, pre-emphasis and window (~5
    per sample), a real FFT of n_fft points (~2.5 n log2 n), power, the mel
    product and the log. The mel product counts the bank's nonzeros (2 nnz
    a frame, 492 of F x M = 257 x 40 at the flagship), as a sparse
    product's least work does, not the dense 2 F M. Counted as f32 work
    (the function's inputs and outputs are f32; the kernel's float64
    transform is its own choice)."""
    from e2e_asr_tpu_torch.ops import frontend as fe
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec

    shift = int(a.sample_rate * a.frame_shift / 1000)
    t, f, mel = fec.n_log_mel_frames(n, win, shift), n_fft // 2 + 1, a.feat_dim
    nnz = int(np.count_nonzero(fe.mel_filterbank(mel, n_fft, a.sample_rate, a.low_freq, a.high_freq)))
    return (4 * (b * n + win + nnz + b * t * mel),
            b * t * (5 * win + 2.5 * n_fft * math.log2(n_fft) + 3 * f + 2 * nnz + mel))


def lstm_seq_fwd_work(t, b, h, valid, dirs=2, dtype=torch.float32):
    """(bytes, operations) of the ``lstm_seq`` forward (training: c and acts
    written) over T steps of ``dirs`` x B rows, ``valid`` the sum of the
    rows' lengths in one direction: xw [T, R, 4H], Wh and the mask read
    once; ys, c and acts written once (ys, c, xw and Wh at the storage
    type; the mask and acts float32); per valid row and step h Wh and the
    cell's ~12 elementwise operations a unit."""
    r, s = dirs * b, esize(dtype)
    return (s * (t * r * 4 * h + dirs * h * 4 * h + 2 * t * r * h) + 4 * (t * r + t * r * 4 * h),
            dirs * valid * (2 * h * 4 * h + 12 * h))


def lstm_seq_bwd_work(t, b, h, valid, dirs=2, dtype=torch.float32):
    """(bytes, operations) of the ``lstm_seq`` backward: the mask, Wh, ys, c,
    acts and dy read once; dxw and dWh written once; per valid row and step
    dgates Wh^T, its share of dWh and ~20 elementwise operations a unit."""
    r, s = dirs * b, esize(dtype)
    return (s * (2 * dirs * h * 4 * h + 3 * t * r * h + t * r * 4 * h) + 4 * (t * r + t * r * 4 * h),
            dirs * valid * (16 * h * h + 20 * h))


def lstm_bidir_fwd_work(t, b, d, h, valid, train=False, dtype=torch.float32):
    """(bytes, operations) of the fused-projection BiLSTM forward: x [T, B,
    D], the mask, Wx, Wh and the bias read once; ys written once (with
    ``train`` also c and acts); the projection x Wx and, per valid row and
    step, h Wh and the cell, in both directions (the projection over the
    valid rows)."""
    s = esize(dtype)
    outs = 6 if train else 1  # ys (+ c, acts [4H]) a row, in units of H
    return (s * (t * b * d + 2 * d * 4 * h + 2 * h * 4 * h + 2 * 4 * h + t * 2 * b * h * outs) + 4 * t * b,
            2 * valid * 8 * h * d + 2 * valid * (2 * h * 4 * h + 12 * h))


def lstm_bidir_bwd_work(t, b, d, h, valid, dtype=torch.float32):
    """(bytes, operations) of the fused-projection BiLSTM backward: x, the
    mask, Wx, Wh, ys, c, acts and dy read once; dx, dWx, dWh and db written
    once; per valid row dx and dWx, per valid row and step the sweep's dgates
    Wh^T, dWh and its elementwise part, in both directions."""
    s = esize(dtype)
    return (s * (2 * t * b * d + 2 * 2 * d * 4 * h + 2 * 2 * h * 4 * h + 2 * 4 * h + t * 2 * b * h * 7) + 4 * t * b,
            2 * valid * 16 * h * d + 2 * valid * (16 * h * h + 20 * h))


def ctc_work(lp, labels, inlen, lablen):
    """(bytes, operations) of the CTC loss and gradient's least work, the
    same for the kernel and the library: log_probs, labels and lengths read
    once, nll and G [B, T, V] written once; ~30 operations per valid (t, s)
    cell for alpha and beta."""
    b, s_len = lp.shape[:2]
    return ((4 * lp.numel() + labels.element_size() * labels.numel() + inlen.element_size() * b
             + lablen.element_size() * b + 4 * (b + lp.numel())),
            30 * float((inlen.clamp(max=s_len) * (2 * lablen + 1)).sum()))


def conv_taps(lens: Sequence[int], p: int) -> float:
    """Taps of a centred P-tap filter that fall on frames inside [0, len),
    summed over the valid frames of every utterance."""
    r = (p - 1) // 2
    total = 0
    for n in (lens.tolist() if hasattr(lens, "tolist") else lens):
        fr = np.arange(int(n))
        total += int((np.minimum(fr, r) + np.minimum(n - 1 - fr, r) + 1).sum())
    return float(total)


def _scan_weights(dk, e, kk, p, h, emb, v, fwd):
    # taps, wq, (bq), wlp, locv, locb, (embed), wx, wh, (bl), wout, (bout):
    # the forward's fifteen arguments less k, v, the lengths and the
    # teacher ids; the backward's eight
    n = kk * p + h * dk + kk * dk + 2 * dk + (emb + e) * 4 * h + h * 4 * h + h * v
    return n + (dk + v * emb + 4 * h + v if fwd else 0)


def decoder_scan_fwd_work(b, s, dk, e, kk, p, h, emb, v, l, lens, dtype=torch.float32):
    """(bytes, operations) of the fused speller scan's forward over L steps
    of B utterances of S frames (``lens`` their valid lengths): k and v over
    the valid frames, the weights and the teacher ids read once; logits,
    align, hidden and the residuals (c, tokens, acts, q, ctx) written once;
    per step and utterance q, the gate product (embedding, context and h)
    and the logits, and per valid frame the conv (only its taps that fall on
    valid frames), the energies and the context. k, v, the weights, logits,
    align, hidden and c at the storage type; the ids, tokens, acts, q and
    ctx 4 bytes."""
    sz = esize(dtype)
    nvalid = float(sum(int(n) for n in lens))
    return (sz * (nvalid * (dk + e) + _scan_weights(dk, e, kk, p, h, emb, v, True) + l * b * (v + s + 2 * h))
            + 4 * (l * b + l * b * (1 + 4 * h + dk + e)),
            l * 2 * (b * (h * dk + (emb + e + h) * 4 * h + h * v) + conv_taps(lens, p) * kk
                     + nvalid * (dk * (kk + 2) + e)))


def decoder_scan_bwd_work(b, s, dk, e, kk, p, h, emb, v, l, lens, dtype=torch.float32):
    """(bytes, operations) of the fused speller scan's backward sweep alone
    (the weight gradients that are sums of per-step outer products run
    outside it): k and v (valid frames), the weights, the stored sequences
    and the three cotangents read once; dgates, dq, dfpre, dk and the
    partials written once; dlogits Wout^T, dctx and dh_lstm, dq Wq^T per
    utterance and step; per valid frame dalign = v . dctx, one rebuild of
    the tanh energies (f Wlp), dfpre = de Wlp^T, dWlp += f^T de and ~12
    elementwise operations per attention unit; the conv that rebuilds f and
    the transposed conv of dfpre over the taps that fall on valid frames.
    k, v, the weights, align, hidden, c and the cotangents at the storage
    type; acts, q, ctx and every output 4 bytes."""
    sz = esize(dtype)
    nvalid = float(sum(int(n) for n in lens))
    return (sz * (nvalid * (dk + e) + _scan_weights(dk, e, kk, p, h, emb, v, False) + l * b * (s + 2 * h)
                  + l * b * (v + s + h))
            + 4 * (l * b * (4 * h + dk + e) + l * b * (4 * h + dk + s * kk) + b * s * dk + b * 8 * (kk + 1) * dk),
            l * 2 * (b * (h * v + (e + h) * 4 * h + h * dk) + nvalid * (e + dk * (3 * kk + 6))
                     + 2 * conv_taps(lens, p) * kk))


def att_step_work(args):
    """(bytes, operations) of one beam attention step's least work on
    ``att_step_beam_loc``'s arguments: q, prev_att, the valid frames of k
    and v, the lengths and the weights read once, align and ctx written
    once; per valid (beam, frame) the conv, the energies and the context."""
    q, prev, k, v, alens, taps = args[:6]
    b, w, dk = q.shape
    s_len, e_dim, (kk, p) = prev.shape[2], v.shape[2], taps.shape
    nvalid = float(alens.sum())
    return (4 * (b * w * dk + 2 * b * w * s_len + nvalid * (dk + e_dim) + b + kk * p + kk * dk + 2 * dk
                 + b * w * e_dim),
            w * nvalid * (2 * p * kk + dk * (2 * kk + 4) + 2 * e_dim) + b * w * s_len * 4)


def prefix_work(pargs):
    """(bytes, operations) of the fused CTC prefix function's least work on
    ``prefix_scores_fused``'s arguments: ctc_lp and the parents' r_g in,
    the candidate and last-token ids, r_h, psi and psi_eos out; ~30
    operations per valid (t, column) cell."""
    ctc_lp, plens, r_g1, last1, cand1 = pargs[:5]
    b, w, kc = cand1.shape
    t_p, n_p = ctc_lp.shape[1], cand1.numel()
    return ((4 * (ctc_lp.numel() + r_g1.numel() + 2 * t_p * n_p + n_p + b + b * w)
             + 8 * (cand1.numel() + last1.numel())),
            30 * float(torch.clamp(plens, max=t_p).sum()) * w * kc)


# -------------------------------------------------------- at a bucket's shapes
def encoder_layers(cfg, t_frames: int):
    """[(frames, input width, hidden, directions, cell)] of the encoder's
    recurrent layers at a bucket of ``t_frames`` feature frames, and the
    frames and width of its output."""
    from e2e_asr_tpu_torch.models.encoder import infer_vgg_channels

    enc, mel = cfg.model.encoder, cfg.data.audio.feat_dim
    t = t_frames // 4 if enc.prenet in ("vgg", "cnn") else t_frames
    d = (128 * ((infer_vgg_channels(mel)[1] // 2) // 2) if enc.prenet == "vgg"
         else enc.dim[0] if enc.prenet == "cnn" else mel)
    dirs = 2 if enc.bidirection else 1
    out = []
    for i, h in enumerate(enc.dim):
        out.append((t, d, h, dirs, enc.module.lower()))
        d = dirs * h * (enc.sample_rate[i] if enc.sample_rate[i] > 1 and enc.sample_style == "concat" else 1)
        t //= enc.sample_rate[i]
    return out, t, d


def kernel_rooflines(cfg, b: int, t_frames: int, l_tokens: int, vocab: int,
                     dtype=torch.float32) -> Dict[str, Roofline]:
    """Each hand kernel's least work at a bucket: B utterances of
    ``t_frames`` feature frames and ``l_tokens`` tokens, every row at the
    bucket's full length (the shapes' upper reading of the data-dependent
    counts), as ``Roofline``s with ``seconds`` 0 for the caller to fill.

    - ``log_mel``: the frontend's function on [B, N] waves (``log_mel_work``:
      a real FFT a frame and the mel bank's nonzeros; the JAX package's
      ``stft`` entry counts a dense windowed DFT, 2 x 2 win F, and the dense
      mel product, 2 F M, a frame instead), at the f32 peak.
    - ``recurrence``: the JAX package's count of the pyramidal BiLSTM's
      forward (its ``kernel_rooflines`` ``recurrence`` entry, unchanged:
      both directions' input and hidden products; bytes the recurrent
      weights re-read each step), at the bf16 peak.
    - ``lstm_seq_fwd`` / ``lstm_seq_bwd`` (every LSTM layer),
      ``lstm_bidir_fwd`` / ``lstm_bidir_fwd_train`` / ``lstm_bidir_bwd``
      (the bidirectional ones): one train step's launches of each, summed
      over the layers; ``decoder_scan_fwd`` / ``decoder_scan_bwd``: one
      launch; all at ``dtype`` (the compute type) and its peak.
    - ``ctc_loss``: one launch, float32 (the CTC head's log-probs are).
    - ``att_step_beam_loc`` / ``prefix_recursion``: one beam step of the
      B utterances at the decode block's beam and candidates, S frames,
      float32 (decoding is)."""
    dtype = as_dtype(dtype)
    a, m = cfg.data.audio, cfg.model
    sr = a.sample_rate
    win = int(sr * a.frame_length / 1000)
    shift = int(sr * a.frame_shift / 1000)
    n_fft = 1 << (win - 1).bit_length()
    n = (t_frames - 1) * shift + win
    out: Dict[str, Roofline] = {}
    nb, nf = log_mel_work(a, b, n, win, n_fft)
    out["log_mel"] = Roofline("log_mel", 0.0, nf, nb, PEAK_F32_FLOPS)

    # the JAX package's recurrence count (e2e_asr_tpu/utils/profiling.py)
    mel = a.feat_dim
    enc = m.encoder
    t_enc = t_frames // 4  # post-VGG
    d_in = 128 * (mel // 4)
    lstm_flops = 0.0
    for i, h in enumerate(enc.dim):
        gates = 4 * h
        lstm_flops += b * t_enc * 2 * (2 * (d_in * gates + h * gates))  # bi
        d_in = 2 * h
        t_enc //= enc.sample_rate[i]
    lstm_bytes = 0.0
    for h in enc.dim:  # recurrent weights re-read per step is the floor
        lstm_bytes += 2 * (t_frames // 4) * (h * 4 * h) * 2
    out["recurrence"] = Roofline("pyramidal BiLSTM", 0.0, lstm_flops, lstm_bytes)

    peak = peak_flops(dtype)
    layers, s, e_dim = encoder_layers(cfg, t_frames)
    sums: Dict[str, list] = {}
    for t, d, h, dirs, cell in layers:
        if cell != "lstm":
            continue
        valid = t * b
        for name, work in (("lstm_seq_fwd", lstm_seq_fwd_work(t, b, h, valid, dirs, dtype)),
                           ("lstm_seq_bwd", lstm_seq_bwd_work(t, b, h, valid, dirs, dtype))):
            sums.setdefault(name, []).append(work)
        if dirs == 2:
            for name, work in (("lstm_bidir_fwd", lstm_bidir_fwd_work(t, b, d, h, valid, False, dtype)),
                               ("lstm_bidir_fwd_train", lstm_bidir_fwd_work(t, b, d, h, valid, True, dtype)),
                               ("lstm_bidir_bwd", lstm_bidir_bwd_work(t, b, d, h, valid, dtype))):
                sums.setdefault(name, []).append(work)
    for name, works in sums.items():
        out[name] = Roofline(name, 0.0, sum(w[1] for w in works), sum(w[0] for w in works), peak)

    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    full = lambda n_, v_: torch.full((n_,), v_, dtype=torch.int64)
    if m.ctc_weight > 0:
        nb, nf = ctc_work(meta(b, s, vocab), meta(b, l_tokens - 1, dt=torch.int64), full(b, s),
                          full(b, l_tokens - 1))
        out["ctc_loss"] = Roofline("ctc_loss", 0.0, nf, nb, PEAK_F32_FLOPS)
    att = m.attention
    if m.ctc_weight < 1 and att.mode == "location":
        kk, p = att.loc_kernel_num, 2 * att.loc_kernel_size + 1
        dims = (b, s, att.dim, e_dim, kk, p, m.decoder.dim, m.decoder.dim, vocab, l_tokens, [s] * b)
        for name, work in (("decoder_scan_fwd", decoder_scan_fwd_work(*dims, dtype)),
                           ("decoder_scan_bwd", decoder_scan_bwd_work(*dims, dtype))):
            out[name] = Roofline(name, 0.0, work[1], work[0], peak)
        w = cfg.decode.beam_size
        args = (meta(b, w, att.dim), meta(b, w, s), meta(b, s, att.dim), meta(b, s, e_dim), full(b, s),
                meta(kk, p))
        nb, nf = att_step_work(args)
        out["att_step_beam_loc"] = Roofline("att_step_beam_loc", 0.0, nf, nb, PEAK_F32_FLOPS)
    if m.ctc_weight > 0:
        w = cfg.decode.beam_size
        kc = min(vocab, max(w, int(w * cfg.decode.ctc_beam_ratio)))
        pargs = (meta(b, s, vocab), full(b, s), meta(b, w, s, 2), meta(b, w, dt=torch.int64),
                 meta(b, w, kc, dt=torch.int64))
        nb, nf = prefix_work(pargs)
        out["prefix_recursion"] = Roofline("prefix_recursion", 0.0, nf, nb, PEAK_F32_FLOPS)
    return out
