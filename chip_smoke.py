"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel from
   e2e_asr_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints
   the build time.
2. Holds every kernel against its plain PyTorch version, each with its
   stated tolerance, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call: the decode kernels
   at the flagship decode shapes (configs/libri/asr_example.yaml model,
   decode B=16, W=16), the training kernels (the LSTM's training forward
   and backward, the CTC lattice) at the flagship training shapes (B=16 in
   the 816-frame bucket: S=204 encoder frames, up to 199 CTC labels).
3. Drives the serving path: the flagship-width model from a fixed seed
   decodes 16 synthetic utterances in the 816-frame bucket (beam 16,
   ctc_weight 0.3, lm_weight 0) through ``bin/test_asr.Solver`` on the
   card, and checks that every decode kernel was launched in that run. The
   same batch is then decoded with the kernels and with the plain versions
   on the card and the top-beam scores must agree.
4. Drives the training path: the flagship at full width from seed-0
   weights trains TRAIN_STEPS steps (batch 16 in the 816-frame bucket of
   the synthetic train split) through ``bin/train_asr.Solver.exec`` and
   validates once on dev; every loss must be finite, no step skipped, and
   every training kernel launched in that run. Then one train step with
   the kernels and one with the plain versions, from the same weights,
   batch and random stream, must agree in loss, gradient norm and the
   updated parameters.
5. Prints a ``kernels`` JSON line, then the device JSON line last; the
   details go to ``--json`` (default e2e_asr_tpu_torch/_build/chip_smoke.json).

Exits non-zero, printing no result, without CUDA or without the package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from unittest import mock

import torch

# H100 SXM data-sheet peaks (dense, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth. Every kernel here computes in f32 on the CUDA cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
TRAIN_STEPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, rtol, atol, unreachable=None):
    """max abs / rel error and an allclose check; raises on mismatch.

    With ``unreachable`` (a log-domain floor), cells where the plain version
    is at or below it must be at or below it in the kernel too, and the
    error is measured over the other cells."""
    got = got.double()
    want = want.double()
    if unreachable is not None:
        low = want <= unreachable
        if not bool(torch.all(got[low] <= unreachable)):
            fail(f"{name}: a cell unreachable in the plain version is above {unreachable:g}")
        got, want = got[~low], want[~low]
    diff = (got - want).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / want.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    ok = bool(torch.all(diff <= atol + rtol * want.abs())) and bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (rtol {rtol}, atol {atol})")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def kernel_checks(dev, cfg, vocab):
    """Each kernel against its plain version at the flagship decode shapes."""
    from e2e_asr_tpu_torch.decode import ctc_prefix
    from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc
    from e2e_asr_tpu_torch.ops import att_step_cuda as asc
    from e2e_asr_tpu_torch.ops import frontend as fe
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec
    from e2e_asr_tpu_torch.ops import rnn_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    a = cfg.data.audio
    m = cfg.model
    b, w = cfg.decode.batch_size, cfg.decode.beam_size
    win = int(a.sample_rate * a.frame_length / 1000)
    shift = int(a.sample_rate * a.frame_shift / 1000)
    n_fft = fe.next_pow2(win)
    n = (816 - 1) * shift + win
    out = {}

    # ---- 1. log_mel: wav [B, N]
    print("[kernel] log_mel", flush=True)
    wav = 0.1 * torch.randn((b, n), generator=gen, device=dev)
    t = fec.n_log_mel_frames(n, win, shift)
    got = fec.log_mel(wav, a, win, shift, n_fft)
    want = fec.log_mel_plain(wav, a, win, shift, n_fft)
    err = compare("log_mel", got, want, rtol=1e-3, atol=2e-3)
    f, mel = n_fft // 2 + 1, a.feat_dim
    # the function's least work: wav in, features out, window and mel bank
    # read once; per frame DC removal, pre-emphasis and window (~5 per
    # sample), a real FFT of n_fft points (~2.5 n log2 n), power, the mel
    # product and the log
    nb = 4 * (b * n + win + f * mel + b * t * mel)
    nf = b * t * (5 * win + 2.5 * n_fft * math.log2(n_fft) + 3 * f + 2 * f * mel + mel)
    out["log_mel"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/log_mel.cu",
        replaces="e2e_asr_tpu/ops/frontend_pallas.py:151", max_abs_err=err,
        ms=time_ms(lambda: fec.log_mel(wav, a, win, shift, n_fft), 20),
        plain_ms=time_ms(lambda: fec.log_mel_plain(wav, a, win, shift, n_fft), 20),
        library_ms=None, bound=bound_ms(nb, nf),
        shapes=f"wav [{b},{n}] -> [{b},{t},{mel}]",
    )

    # ---- 2. lstm_bidir_fwd at both flagship input widths
    s_len = (t // 4)  # VGG prenet: 4x time downsample
    h = m.encoder.dim[0]
    lens = torch.randint(s_len // 2, s_len + 1, (b,), generator=gen, device=dev)
    lens[0] = s_len
    mask = (torch.arange(s_len, device=dev)[:, None] < lens[None, :]).float()
    bound_h = 1.0 / math.sqrt(h)
    entries = []
    for d in (1280, 2 * h):
        print(f"[kernel] lstm_bidir_fwd D={d}", flush=True)
        x = torch.tanh(torch.randn((s_len, b, d), generator=gen, device=dev))
        wx = (torch.rand((2, d, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
        wh = (torch.rand((2, h, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
        bias = (torch.rand((2, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
        args = (x, mask, wx, wh, bias)
        err = compare(f"lstm_bidir_fwd D={d}", rnn_cuda.lstm_bidir_fwd(*args),
                      rnn_cuda.lstm_bidir_fwd_plain(*args), rtol=1e-4, atol=1e-4)
        lstm = torch.nn.LSTM(d, h, bidirectional=True).to(dev)
        with torch.no_grad():
            for sfx, di in (("", 0), ("_reverse", 1)):
                getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[di].t())
                getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[di].t())
                getattr(lstm, f"bias_ih_l0{sfx}").copy_(bias[di])
                getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        valid_rows = 2 * float(lens.sum())
        nb = 4 * (s_len * b * d + s_len * b + 2 * d * 4 * h + 2 * h * 4 * h + 2 * 4 * h
                  + s_len * 2 * b * h)
        nf = valid_rows * (2 * (d + h) * 4 * h + 12 * h)
        with torch.no_grad():
            entries.append(dict(
                d=d, max_abs_err=err,
                ms=time_ms(lambda: rnn_cuda.lstm_bidir_fwd(*args), 10),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_bidir_fwd_plain(*args), 3, 1),
                library_ms=time_ms(lambda: lstm(x), 10), bound=bound_ms(nb, nf),
            ))
    out["lstm_bidir_fwd"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/lstm_bidir.cu",
        replaces="e2e_asr_tpu/ops/rnn_pallas.py:510",
        # one decode runs the D=1280 layer once and the D=640 layer three times
        max_abs_err=max(e["max_abs_err"] for e in entries),
        ms=(entries[0]["ms"] + 3 * entries[1]["ms"]) / 4,
        plain_ms=(entries[0]["plain_ms"] + 3 * entries[1]["plain_ms"]) / 4,
        library_ms=(entries[0]["library_ms"] + 3 * entries[1]["library_ms"]) / 4,
        bound=((entries[0]["bound"][0] + 3 * entries[1]["bound"][0]) / 4, entries[0]["bound"][1]),
        shapes=f"x [{s_len},{b},1280|{2 * h}], H {h} (ms = mean per layer of 1x1280 + 3x{2 * h})",
        per_width={str(e["d"]): {k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound")}
                   for e in entries},
    )

    # ---- 3. att_step_beam_loc: q [B, W, Dk], S encoder frames
    print("[kernel] att_step_beam_loc", flush=True)
    ac = m.attention
    dk, e_dim, kk, p = ac.dim, 2 * h, ac.loc_kernel_num, 2 * ac.loc_kernel_size + 1
    q = torch.randn((b, w, dk), generator=gen, device=dev)
    prev = torch.softmax(2.0 * torch.randn((b, w, s_len), generator=gen, device=dev), -1)
    k = torch.tanh(torch.randn((b, s_len, dk), generator=gen, device=dev))
    v = torch.tanh(torch.randn((b, s_len, e_dim), generator=gen, device=dev))
    taps = (torch.rand((kk, p), generator=gen, device=dev) * 2 - 1) / math.sqrt(p)
    wlp = (torch.rand((kk, dk), generator=gen, device=dev) * 2 - 1) / math.sqrt(kk)
    locv = (torch.rand((dk,), generator=gen, device=dev) * 2 - 1) / math.sqrt(dk)
    locb = 0.1 * torch.randn((dk,), generator=gen, device=dev)
    args = (q, prev, k, v, lens, taps, wlp, locv, locb, float(ac.temperature))
    got = asc.att_step_beam_loc(*args)
    want = asc.att_step_beam_loc_plain(*args)
    err = max(compare("att_step align", got[0], want[0], rtol=1e-4, atol=1e-6),
              compare("att_step ctx", got[1], want[1], rtol=1e-4, atol=1e-5))
    nvalid = float(lens.sum())
    nb = 4 * (b * w * dk + 2 * b * w * s_len + nvalid * (dk + e_dim) + b + kk * p + kk * dk
              + 2 * dk + b * w * e_dim)
    nf = w * nvalid * (2 * p * kk + dk * (2 * kk + 4) + 2 * e_dim) + b * w * s_len * 4
    out["att_step_beam_loc"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/att_step.cu",
        replaces="e2e_asr_tpu/ops/att_step_pallas.py:159", max_abs_err=err,
        ms=time_ms(lambda: asc.att_step_beam_loc(*args), 20),
        plain_ms=time_ms(lambda: asc.att_step_beam_loc_plain(*args), 20),
        library_ms=None, bound=bound_ms(nb, nf),
        shapes=f"q [{b},{w},{dk}], S {s_len}, E {e_dim}, taps [{kk},{p}]",
    )

    # ---- 4. prefix_recursion: [T, N], N = B*W*K
    print("[kernel] prefix_recursion", flush=True)
    k_cand = min(vocab, max(w, int(w * cfg.decode.ctc_beam_ratio)))
    logits = 3.0 * torch.randn((b, s_len, vocab), generator=gen, device=dev)
    logits[:, :, 0] += 2.0
    ctc_lp = torch.log_softmax(logits, -1)
    r_g0 = ctc_prefix.init_empty_prefix(ctc_lp, lens, w)
    cand0 = torch.randint(1, vocab, (b, w, k_cand), generator=gen, device=dev)
    last0 = torch.zeros((b, w), dtype=torch.long, device=dev)
    psi0, r_h0 = ctc_prefix.prefix_scores(ctc_lp, lens, r_g0, last0, cand0, True)
    r_g1 = r_h0[:, :, 0]  # parents that emitted one token: the general case
    last1 = cand0[:, :, 0]
    cand1 = torch.randint(1, vocab, (b, w, k_cand), generator=gen, device=dev)
    cand1[:, :, 1] = last1
    ins = ctc_prefix.recursion_inputs(ctc_lp, lens, r_g1, last1, cand1, False)
    got = cpc.prefix_recursion(*ins)
    want = cpc.prefix_recursion_plain(*ins)
    # cells unreachable in the plain version (NEG sums) must stay below the
    # NEG/2 guard of the log-sum-exp that consumes them
    err = max(compare(f"prefix_recursion {nm}", g, wt, rtol=1e-5, atol=2e-3,
                      unreachable=ctc_prefix.NEG / 2)
              for nm, g, wt in zip(("r_n", "r_b", "psi"), got, want))
    t_p, n_p = ins[0].shape
    # the function's least traffic: ctc_lp and the parents' r_g in, the
    # candidate and last-token ids, r_n, r_b and psi out; ~30 operations per
    # valid (t, column) cell
    nb = (4 * (ctc_lp.numel() + r_g1.numel() + 2 * t_p * n_p + n_p + b)
          + 8 * (cand1.numel() + last1.numel()))
    nf = 30 * float(ins[3].sum())
    out["prefix_recursion"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_prefix.cu",
        replaces="e2e_asr_tpu/decode/ctc_prefix_pallas.py:155", max_abs_err=err,
        ms=time_ms(lambda: cpc.prefix_recursion(*ins), 20),
        plain_ms=time_ms(lambda: cpc.prefix_recursion_plain(*ins), 3, 1),
        library_ms=None, bound=bound_ms(nb, nf), shapes=f"[T={t_p}, N={n_p}]",
    )
    return out


def _lstm_inputs(gen, dev, s_len, b, d, h, lens):
    mask = (torch.arange(s_len, device=dev)[:, None] < lens[None, :]).float()
    bound_h = 1.0 / math.sqrt(h)
    x = torch.tanh(torch.randn((s_len, b, d), generator=gen, device=dev))
    wx = (torch.rand((2, d, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
    wh = (torch.rand((2, h, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
    bias = (torch.rand((2, 4 * h), generator=gen, device=dev) * 2 - 1) * bound_h
    return x, mask, wx, wh, bias


def _cudnn_lstm(dev, wx, wh, bias):
    """torch.nn.LSTM (cuDNN) with the same weights: the library call."""
    d, h = wx.shape[1], wh.shape[1]
    lstm = torch.nn.LSTM(d, h, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, di in (("", 0), ("_reverse", 1)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[di].t())
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[di].t())
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(bias[di])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    return lstm


def _scaled(name, got, want, rtol):
    """compare with atol = rtol * max|want| (sums over many rows whose
    terms cancel)."""
    return compare(name, got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


def train_kernel_checks(dev, cfg, vocab):
    """The training kernels against their plain versions at the flagship
    training shapes: S = 204 encoder frames (816 / 4), B = 16, H = 320,
    D = 1280 (first layer) and 640 (the three others); CTC over the same
    S with labels up to the token bucket."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.ops import ctc_cuda, rnn_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    m = cfg.model
    b = cfg.data.corpus.batch_size
    s_len = 816 // 4
    h = m.encoder.dim[0]
    lens = torch.randint(s_len // 2, s_len + 1, (b,), generator=gen, device=dev)
    lens[0] = s_len
    vr = 2 * float(lens.sum())  # valid rows over both directions
    out = {}
    fwd, bwd = [], []
    for d in (1280, 2 * h):
        print(f"[kernel] lstm_bidir_fwd_train / lstm_bidir_bwd D={d}", flush=True)
        args = _lstm_inputs(gen, dev, s_len, b, d, h, lens)
        x, mask, wx, wh, bias = args
        with torch.no_grad():
            got = rnn_cuda.lstm_bidir_fwd_train(*args)
            want = rnn_cuda.lstm_bidir_fwd_train_plain(*args)
            err = max(compare(f"lstm_bidir_fwd_train D={d} {nm}", g, w, rtol=1e-4, atol=1e-4)
                      for nm, g, w in zip(("ys", "c", "acts"), got, want))
        lstm = _cudnn_lstm(dev, wx, wh, bias)
        xg = x.clone().requires_grad_()
        # bytes: the inference forward's, plus the residuals c [T, 2B, H]
        # and acts [T, 2B, 4H] written once
        io = 4 * (s_len * b * d + s_len * b + 2 * d * 4 * h + 2 * h * 4 * h + 2 * 4 * h
                  + s_len * 2 * b * h * 6)
        nf = vr * (2 * (d + h) * 4 * h + 12 * h)
        with torch.no_grad():
            f_ms = time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train(*args), 10)
            f_plain = time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train_plain(*args), 3, 1)
        fwd.append(dict(d=d, max_abs_err=err, ms=f_ms, plain_ms=f_plain,
                        library_ms=time_ms(lambda: lstm(xg), 10), bound=bound_ms(io, nf)))

        ys, c, acts = want
        dy = torch.randn(ys.shape, generator=gen, device=dev)
        with torch.no_grad():
            got = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
            want_b = rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)
            err = max(_scaled(f"lstm_bidir_bwd D={d} {nm}", g, w, 1e-4)
                      for nm, g, w in zip(("dx", "dWx", "dWh", "db"), got, want_b))
        # and the autograd function against autograd through the plain loop
        leaves = [a.clone().requires_grad_() for a in (x, wx, wh, bias)]
        auto = torch.autograd.grad(
            (rnn_cuda.lstm_bidir_fwd_plain(leaves[0], mask, *leaves[1:]) * dy).sum(), leaves)
        ours = torch.autograd.grad((rnn_cuda.lstm_bidir_train(leaves[0], mask, *leaves[1:]) * dy).sum(),
                                   leaves)
        err = max([err] + [_scaled(f"lstm_bidir_train D={d} autograd {nm}", g, w, 1e-4)
                           for nm, g, w in zip(("dx", "dWx", "dWh", "db"), ours, auto)])
        out_lib, _ = lstm(xg)
        dy_lib = torch.randn(out_lib.shape, generator=gen, device=dev)
        lib_in = [xg] + list(lstm.parameters())
        # bytes: x, mask, wx, wh, ys, c, acts, dy read once; dx, dWx, dWh,
        # db written once. Operations on the valid rows: the sweep's
        # dgates Wh^T and its elementwise part, dx, dWx and dWh
        io = 4 * (2 * s_len * b * d + s_len * b + 2 * 2 * d * 4 * h + 2 * 2 * h * 4 * h
                  + 2 * 4 * h + s_len * 2 * b * h * 7)
        nf = vr * (16 * h * d + 16 * h * h + 20 * h)
        with torch.no_grad():
            b_ms = time_ms(lambda: rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy), 10)
            b_plain = time_ms(lambda: rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy),
                              3, 1)
        bwd.append(dict(d=d, max_abs_err=err, ms=b_ms, plain_ms=b_plain,
                        library_ms=time_ms(lambda: torch.autograd.grad(out_lib, lib_in, dy_lib,
                                                                       retain_graph=True), 10),
                        bound=bound_ms(io, nf)))
        del lstm, out_lib, xg

    def layer_mean(entries, key):
        # one training step runs the D=1280 layer once and the D=640 layer three times
        return (entries[0][key] + 3 * entries[1][key]) / 4

    for name, entries, line, src in (
        ("lstm_bidir_fwd_train", fwd, 510, "lstm_bidir.cu"),
        ("lstm_bidir_bwd", bwd, 569, "lstm_bidir_bwd.cu"),
    ):
        out[name] = dict(
            route="cuda", source=f"e2e_asr_tpu_torch/csrc/{src}",
            replaces=f"e2e_asr_tpu/ops/rnn_pallas.py:{line}",
            max_abs_err=max(e["max_abs_err"] for e in entries),
            ms=layer_mean(entries, "ms"), plain_ms=layer_mean(entries, "plain_ms"),
            library_ms=layer_mean(entries, "library_ms"),
            bound=((entries[0]["bound"][0] + 3 * entries[1]["bound"][0]) / 4, entries[0]["bound"][1]),
            shapes=f"x [{s_len},{b},1280|{2 * h}], H {h} (ms = mean per layer of 1x1280 + 3x{2 * h})",
            per_width={str(e["d"]): {k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound")}
                       for e in entries},
        )

    # ---- CTC lattice: log_probs [B, S, V], labels [B, L] up to the token bucket
    print("[kernel] ctc_loss (lattice)", flush=True)
    l_max = cfg.data.corpus.token_buckets[-1] - 1  # <eos> is not a CTC label
    logits = 3.0 * torch.randn((b, s_len, vocab), generator=gen, device=dev)
    logits[:, :, 0] += 2.0
    lp = torch.log_softmax(logits, -1)
    lablen = torch.randint(l_max // 8, l_max // 3 + 1, (b,), generator=gen, device=dev)
    lablen[0] = l_max
    lablen[1] = 0  # no labels: the blank path only
    labels = torch.randint(1, vocab, (b, l_max), generator=gen, device=dev)
    labels = torch.where(torch.arange(l_max, device=dev)[None] < lablen[:, None], labels, 0)
    inlen = lens.clone()
    inlen[0] = l_max - 1  # fewer frames than labels: no alignment, +inf
    got = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)
    want = ctc_cuda.ctc_lattice_plain(lp, labels, inlen, lablen)
    ok = want[0] <= ctc_cuda.BIG
    if not torch.equal(got[0] <= ctc_cuda.BIG, ok) or bool(ok[0]) or not bool(ok[1:].all()):
        fail("ctc_loss: rows with no alignment differ between kernel and plain version")
    err = compare("ctc_loss nll", got[0][ok], want[0][ok], rtol=1e-5, atol=1e-3)

    def loss_grad():
        lp_g = lp.clone().requires_grad_()
        nll = ctc_cuda.CTCLossFn.apply(lp_g, inlen, labels, lablen)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(nll), nll, 0.0).sum(), lp_g)
        return g

    g_k = loss_grad()
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        g_p = loss_grad()
    err = max(err, compare("ctc_loss d nll / d log_probs", g_k, g_p, rtol=1e-4, atol=1e-4))
    if float(g_k[0].abs().max()) != 0.0:
        fail("ctc_loss: a row with no alignment has a gradient")
    targets = torch.cat([labels[i, :lablen[i]] for i in range(b)])
    lp_t = lp.transpose(0, 1).detach().requires_grad_()

    def library():
        nll = torch.nn.functional.ctc_loss(lp_t, targets, inlen, lablen, reduction="sum",
                                           zero_infinity=True)
        torch.autograd.grad(nll, lp_t)

    s_lat = 2 * l_max + 1
    # bytes: log_probs, labels and lengths read once, nll and gamma written
    # once; ~30 operations per valid (t, s) cell for alpha and beta
    io = 4 * (lp.numel() + labels.numel() + 2 * b + b + b * s_len * s_lat)
    nf = 30 * float((inlen * (2 * lablen + 1)).sum())
    out["ctc_loss"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_loss.cu",
        replaces="e2e_asr_tpu/ops/ctc_pallas.py:170", max_abs_err=err,
        ms=time_ms(lambda: ctc_cuda.ctc_lattice(lp, labels, inlen, lablen), 20),
        plain_ms=time_ms(lambda: ctc_cuda.ctc_lattice_plain(lp, labels, inlen, lablen), 3, 1),
        library_ms=time_ms(library, 10), bound=bound_ms(io, nf),
        loss_fwd_bwd_ms=time_ms(loss_grad, 10),
        shapes=f"log_probs [{b},{s_len},{vocab}], labels [{b},{l_max}] (S {s_lat}); "
               "ms: the lattice (nll + gamma); library_ms: F.ctc_loss forward + backward; "
               "loss_fwd_bwd_ms: CTCLossFn forward + backward",
    )
    return out


def train_phase(smi):
    """The training path through bin/train_asr.Solver on the card, then one
    train step with the kernels against one with the plain versions."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import smoke_train_solver
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc_cuda import ctc_lattice
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_bidir_bwd, lstm_bidir_fwd_train
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves

    solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_train"), SEED, TRAIN_STEPS)
    cfg = solver.config
    batch = next(solver.tr_set.epoch(0))
    if batch.wav.shape != (16, (816 - 1) * 160 + 400):
        fail(f"train batch has shape {batch.wav.shape}, expected 16 utterances in the 816 bucket")
    wrappers = {"log_mel": log_mel, "lstm_bidir_fwd_train": lstm_bidir_fwd_train,
                "lstm_bidir_bwd": lstm_bidir_bwd, "ctc_loss": ctc_lattice}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.time()
    solver.exec()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"train path launches: {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the training path")
    log = list(solver.step_log)
    if len(log) != TRAIN_STEPS:
        fail(f"{len(log)} training steps ran, expected {TRAIN_STEPS}")
    for rec in log:
        print(f"  step {rec['step']}: loss {rec['loss']:.4f} att {rec['att_loss']:.4f} "
              f"ctc {rec['ctc_loss']:.4f} gnorm {rec['grad_norm']:.3f} | {rec['audio_s']:.2f} audio-s "
              f"in {rec['wall_s']:.3f}s = {rec['audio_s'] / rec['wall_s']:.2f} audio-s/s on {smi}",
              flush=True)
        if not all(math.isfinite(rec[k]) for k in ("loss", "att_loss", "ctc_loss", "grad_norm")):
            fail(f"step {rec['step']}: a loss or the gradient norm is not finite")
        if rec["step_skipped"] != 0.0:
            fail(f"step {rec['step']} was skipped")
    dev_sum = solver.dev_summary
    print(f"  dev: {dev_sum}", flush=True)
    if not all(math.isfinite(v) for v in dev_sum.values()):
        fail("validation gave a non-finite number")
    steady = sorted(r["audio_s"] / r["wall_s"] for r in log[1:])
    rate = steady[len(steady) // 2]
    print(f"train e2e: median {rate:.2f} audio-s/s per step over steps 2-{TRAIN_STEPS} "
          f"(step 1 {log[0]['audio_s'] / log[0]['wall_s']:.2f}) on {smi} (flagship, B=16, 816 "
          f"bucket, seed-{SEED} weights); {TRAIN_STEPS} steps + validation {wall:.1f}s", flush=True)

    # ---- one step with the kernels, one with the plain versions
    dbatch = solver._put(batch)
    res = {}
    for mode in ("kernel", "plain"):
        params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
        trainer = Trainer(cfg)
        state = trainer.init_state(params)
        ctx = mock.patch.object(cuda_build, "use_plain", lambda x: True) if mode == "plain" else nullcontext()
        with ctx:
            t1 = time.time()
            m = trainer.train_step(state, dbatch, solver.step_generator(0))
            torch.cuda.synchronize()
            dt = time.time() - t1
        res[mode] = (float(m["loss"]), float(m["grad_norm"]),
                     [p.detach() for p in param_leaves(state.params)], dt)
    (lk, gk, pk, tk), (lp_, gp, pp, tp) = res["kernel"], res["plain"]
    loss_rel = abs(lk - lp_) / abs(lp_)
    gn_rel = abs(gk - gp) / abs(gp)
    p_err = max(float((a - c).abs().max()) for a, c in zip(pk, pp))
    print(f"train step kernel vs plain: loss {lk:.6f} vs {lp_:.6f} (rel {loss_rel:.2e}, tolerance "
          f"1e-4); grad_norm {gk:.6f} vs {gp:.6f} (rel {gn_rel:.2e}, tolerance 1e-3); updated params "
          f"max abs diff {p_err:.3e} (tolerance 1e-5; an Adadelta first step moves a parameter by at "
          f"most 3.2e-4); step {tk:.2f}s vs {tp:.2f}s", flush=True)
    if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and p_err <= 1e-5):
        fail("the kernel and plain train steps disagree")
    return dict(launches=launches, steps=log, dev=dev_sum, audio_s_per_s=rate, wall_s=wall,
                parity=dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err,
                            kernel_step_s=tk, plain_step_s=tp))


def main(json_path: str = "") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from e2e_asr_tpu_torch import cuda_build
        from e2e_asr_tpu_torch.bin.profile_decode import FLAGSHIP, smoke_solver
        from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import prefix_recursion
        from e2e_asr_tpu_torch.device import resolve_device
        from e2e_asr_tpu_torch.ops.att_step_cuda import att_step_beam_loc
        from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
        from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_bidir_fwd
        from e2e_asr_tpu_torch.training.step import Trainer  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    if not os.path.isfile(FLAGSHIP):
        fail(f"{FLAGSHIP} not found: run from the repository root")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device("cuda")
    t0 = time.time()
    logs = cuda_build.build_all()
    print(f"build: {time.time() - t0:.1f}s for {sorted(logs) or 'nothing (cached)'}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack frame" in line:
                print(f"  ptxas {name}: {line.strip()}")

    solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "smoke"), SEED)
    cfg = solver.config
    with torch.inference_mode():
        kern = kernel_checks(dev, cfg, solver.vocab_size)
    kern.update(train_kernel_checks(dev, cfg, solver.vocab_size))

    # ---- the serving path through the CLI's Solver, on the card
    batch = next(solver.eval_sets["dev"].epoch())
    if batch.wav.shape != (16, (816 - 1) * 160 + 400):
        fail(f"smoke batch has shape {batch.wav.shape}, expected 16 utterances in the 816 bucket")
    solver.decode_batch(batch.wav, batch.wav_len)  # warm-up (cuBLAS/cuDNN handles)
    torch.cuda.synchronize()
    wrappers = {"log_mel": log_mel, "lstm_bidir_fwd": lstm_bidir_fwd,
                "att_step_beam_loc": att_step_beam_loc, "prefix_recursion": prefix_recursion}
    for fn in wrappers.values():
        fn.launches = 0
    solver.exec()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"main path launches: {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the main path")
    st = solver.stats["dev"]
    rate = st["audio_sec"] / st["wall_s"]
    print(f"e2e: {st['utts']} utts, {st['audio_sec']:.2f} audio-s in {st['wall_s']:.3f}s wall = "
          f"{rate:.2f} audio-s/s on {smi} (decode B=16 W=16, seed-{SEED} weights, cer {st['cer']:.3f})")

    # ---- the same batch with kernels and with plain versions, on the card
    res_k = solver.decode_batch(batch.wav, batch.wav_len)
    t_p = time.time()
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        res_p = solver.decode_batch(batch.wav, batch.wav_len)
    torch.cuda.synchronize()
    print(f"plain-version decode of the batch: {time.time() - t_p:.2f}s", flush=True)
    sk, sp = res_k.scores[:, 0].double().cpu(), res_p.scores[:, 0].double().cpu()
    if res_k.tokens.shape != (16, 16, solver.max_step_for(batch.wav.shape[1])):
        fail(f"unexpected token shape {tuple(res_k.tokens.shape)}")
    if not (torch.isfinite(sk).all() and torch.isfinite(sp).all()):
        fail("non-finite top-beam scores")
    score_err = float(((sk - sp).abs() / sp.abs()).max())
    same = int((res_k.tokens[:, 0] == res_p.tokens[:, 0]).all(-1).sum())
    print(f"top-beam score max rel diff kernel vs plain: {score_err:.3e} (tolerance 1e-3); "
          f"identical top hypotheses {same}/16", flush=True)
    if score_err > 1e-3:
        fail("kernel decode and plain decode disagree on top-beam scores")
    # inputs and weights come from a seed and every kernel is deterministic,
    # so a differing top hypothesis is a fault, not a tie broken otherwise
    if same < 16:
        fail("kernel decode and plain decode differ in top hypotheses")

    # ---- the training path
    train = train_phase(smi)

    # launches: each kernel's count on its own path (log_mel: decode)
    path_launches = {**train["launches"], **launches}
    rows = []
    for name, kv in kern.items():
        rows.append({
            "name": name, "route": kv["route"], "source": kv["source"], "replaces": kv["replaces"],
            "launches": path_launches[name], "max_abs_err": kv["max_abs_err"], "ms": kv["ms"],
            "plain_ms": kv["plain_ms"], "bound_ms": kv["bound"][0], "bound_by": kv["bound"][1],
            "library_ms": kv["library_ms"], "shapes": kv["shapes"],
            **{k: kv[k] for k in ("per_width", "loss_fwd_bwd_ms") if k in kv},
        })
    out = json_path or os.path.join(cuda_build.BUILD_DIR, "chip_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": smi, "kernels": rows, "e2e_audio_s_per_s": rate, "e2e": st,
                   "top_score_rel_diff": score_err, "identical_top": same, "train": train},
                  f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="chip smoke run of the PyTorch/CUDA port")
    ap.add_argument("--json", default="", help="where to write the detailed JSON "
                    "(default: e2e_asr_tpu_torch/_build/chip_smoke.json)")
    main(ap.parse_args().json)
