"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--parent DIR] [--json PATH]

1. Prints the card's name and power limit, builds every CUDA kernel from
   e2e_asr_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints
   the build time.
2. Holds every kernel against its plain PyTorch version, each with its
   stated tolerance, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call: the decode kernels
   at the flagship decode shapes (configs/libri/asr_example.yaml model,
   decode B=16, W=16; the attention step also at S=764; both repeated
   bitwise and run once under the sync debug mode set to raise, each split
   by phase by its timing build; with ``--parent DIR``, a checkout of the parent commit, the CTC
   prefix side of a beam step is timed there and here in turns), the
   training kernels (the LSTM's training forward
   and backward, each one's two launches timed apart, their outputs
   repeated bitwise; the CTC
   loss, nll and gradient in one launch, checked for bitwise repeats and
   for no host synchronisation) at the flagship training shapes (B=16 in
   the 816-frame bucket: S=204 encoder frames, up to 199 CTC labels); the
   fused speller scan (forward in its three feedback modes, backward, and
   its autograd function) at B=16, S=204, L=200 and once at S=764; the
   lstm_seq pair at the convergence recipe's first layer (T=816, B=32,
   H=256) and the flagship's (T=204, B=16, H=320), the forward in
   alternating rounds with cuDNN's, and a BiLSTM layer forward + backward
   by either kernel pair at five input widths. Each LSTM forward row
   carries its sweep's plan.
3. Drives the serving path: the flagship-width model from a fixed seed
   decodes 16 synthetic utterances in the 816-frame bucket (beam 16,
   ctc_weight 0.3, lm_weight 0) through ``bin/test_asr.Solver`` on the
   card, and checks that every decode kernel was launched in that run; the
   profiler counts the device launches of one decoded batch. The
   same batch is then decoded with the kernels and with the plain versions
   on the card: the top-beam scores must agree and the top hypotheses be
   identical. All of this runs twice: under the default LSTM route
   (``encoder.rnn_impl`` auto: one matmul + lstm_seq) and with the
   fused-projection kernel pinned (``rnn_impl`` pallas); the two routes'
   top-beam scores must agree too.
4. Drives the training path: the flagship at full width from seed-0
   weights trains TRAIN_STEPS steps (batch 16 in the 816-frame bucket of
   the synthetic train split) through ``bin/train_asr.Solver.exec`` and
   validates once on dev, under the default LSTM route and again with the
   fused-projection pair pinned; every loss must be finite, no step
   skipped, every training kernel of the route launched in that run (the
   fused scan's two among them), and the two routes' losses agree. Two
   more steps run on the default route at tf_rate 0.5, so that coins fail
   and sampled tokens are fed back inside the scan. Then one train step
   with the kernels and one with the plain versions, from the same weights,
   batch and random stream, must agree in loss, gradient norm and the
   updated parameters, under either route; the profiler counts the device
   launches of a kernel step. Every launch count is read from counters set
   to 0 just before the run it belongs to.
5. Drives the convergence recipe (configs/synthetic_convergence.yaml, full
   width, BiLSTM layers through lstm_seq, tf_rate 0.8) for CONV_STEPS steps
   and one validation through ``bin/train_asr.Solver.exec``: the lstm_seq
   pair and the fused scan's pair must have launched, losses finite.
6. Prints a ``kernels`` JSON line (each row names the path its ``launches``
   were counted on), then the device JSON line last; the details go to ``--json`` (default e2e_asr_tpu_torch/_build/chip_smoke.json).

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
ALT_ROUNDS = 21  # rounds of a kernel against its library call in turns
CONV_STEPS = 3
NOISE_SEED = 20261016  # the scan checks' sampled feedback


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """ms a call (CUDA events over ``iters`` calls queued behind a spin of
    the card, so that a wrapper's host time does not pace a short kernel; a
    plain version of many launches stays host-paced)."""
    from e2e_asr_tpu_torch.bin.profile_decode import device_ms

    return device_ms(fn, iters, warmup)


def alternating_ms(fns: dict, rounds: int = ALT_ROUNDS, iters: int = 3) -> dict:
    """Median ms a call of each function over ``rounds`` rounds that time
    them in turns (``profile_decode.alternating_ms``)."""
    from e2e_asr_tpu_torch.bin.profile_decode import alternating_ms as in_turns

    return in_turns(fns, rounds, iters)


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
    from e2e_asr_tpu_torch.bin.profile_decode import (att_phase_split, flagship_att_inputs, flagship_prefix_inputs,
                                                      prefix_phase_split, print_decode_phases)
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
                **_bidir_fwd_parts(*args, train=False),
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
        per_width={str(e["d"]): {k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound", "projection_ms",
                                                    "sweep_ms")}
                   for e in entries},
        plan=_fwd_plan(b, h, dev),
    )

    # ---- 3. att_step_beam_loc: q [B, W, Dk], S encoder frames
    print("[kernel] att_step_beam_loc", flush=True)
    args = flagship_att_inputs(dev)
    q, prev, k, v, alens, taps = args[:6]
    dk, e_dim, kk, p = q.shape[2], v.shape[2], taps.shape[0], taps.shape[1]
    got = asc.att_step_beam_loc(*args)
    want = asc.att_step_beam_loc_plain(*args)
    err = max(compare("att_step align", got[0], want[0], rtol=1e-4, atol=1e-6),
              compare("att_step ctx", got[1], want[1], rtol=1e-4, atol=1e-5))
    att_extra = _repeat_and_sync("att_step_beam_loc", lambda: asc.att_step_beam_loc(*args), got)
    # the 960 h recipe's encoder length: k and v streamed in tiles
    args764 = flagship_att_inputs(dev, s=764)
    g764, w764 = asc.att_step_beam_loc(*args764), asc.att_step_beam_loc_plain(*args764)
    err = max(err, compare("att_step align S=764", g764[0], w764[0], rtol=1e-4, atol=1e-6),
              compare("att_step ctx S=764", g764[1], w764[1], rtol=1e-4, atol=1e-5))
    split = att_phase_split(args)
    print_decode_phases({"att_step_beam_loc": split})
    nvalid = float(alens.sum())
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
        ms_s764=time_ms(lambda: asc.att_step_beam_loc(*args764), 10),
        phases_us=split["phases_us"], plan=split["plan"], **att_extra,
    )
    print(f"  att_step_beam_loc: {out['att_step_beam_loc']['ms'] * 1e3:.1f} us (S=764: "
          f"{out['att_step_beam_loc']['ms_s764'] * 1e3:.1f} us), bound {out['att_step_beam_loc']['bound'][0] * 1e3:.2f} "
          f"us", flush=True)

    # ---- 4. prefix_recursion: the fused CTC prefix function
    print("[kernel] prefix_recursion (prefix_scores_fused)", flush=True)
    pargs = flagship_prefix_inputs(dev)
    ctc_lp, plens, r_g1, last1, cand1, _ = pargs
    got = cpc.prefix_scores_fused(*pargs)
    want = cpc.prefix_scores_fused_plain(*pargs)
    # cells unreachable in the plain version (NEG sums) must stay below the
    # NEG/2 guard of the log-sum-exp that consumes them
    err = max(compare(f"prefix_scores_fused {nm}", g, wt, rtol=1e-5, atol=2e-3, unreachable=ctc_prefix.NEG / 2)
              for nm, g, wt in zip(("psi", "r_h", "psi_eos"), got, want))
    prefix_extra = _repeat_and_sync("prefix_scores_fused", lambda: cpc.prefix_scores_fused(*pargs), got)
    psplit = prefix_phase_split(pargs)
    print_decode_phases({"prefix_recursion": psplit})
    t_p = ctc_lp.shape[1]
    n_p = cand1.numel()
    # the function's least traffic: ctc_lp and the parents' r_g in, the
    # candidate and last-token ids, r_h, psi and psi_eos out; ~30 operations
    # per valid (t, column) cell
    nb = (4 * (ctc_lp.numel() + r_g1.numel() + 2 * t_p * n_p + n_p + b + b * w)
          + 8 * (cand1.numel() + last1.numel()))
    nf = 30 * float(torch.clamp(plens, max=t_p).sum()) * w * cand1.shape[2]
    out["prefix_recursion"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_prefix.cu",
        replaces="e2e_asr_tpu/decode/ctc_prefix_pallas.py:155", max_abs_err=err,
        ms=time_ms(lambda: cpc.prefix_scores_fused(*pargs), 20),
        plain_ms=time_ms(lambda: cpc.prefix_scores_fused_plain(*pargs), 3, 1),
        library_ms=None, bound=bound_ms(nb, nf),
        shapes=f"ctc_lp [{b},{t_p},{ctc_lp.shape[2]}], W {w}, K {cand1.shape[2]}: psi, r_h [{b},{w},{cand1.shape[2]},{t_p},2], psi_eos",
        phases_us=psplit["phases_us"], **prefix_extra,
    )
    return out


def _repeat_and_sync(name, call, first) -> dict:
    """Three more launches bitwise equal to the first (no atomics), then one
    under PyTorch's sync debug mode set to raise: no device-to-host
    synchronisation, so a CUDA graph can capture the call."""
    for _ in range(3):
        again = call()
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"{name}: a repeat on the same inputs differs")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  {name}: repeats bitwise; no host sync", flush=True)
    return {"repeats_bitwise": True, "host_sync": False}


# The CTC prefix side of one beam step as a tree's beam loop runs it, timed in
# a process of its own over the package of the tree at its working directory:
# prefix_scores_fused + the r_h gather where the tree has the fused entry,
# else prefix_scores + eos_score + the gather (the composition it replaces).
# Prints one JSON line: device ms a call (queued behind a spin), host ms a
# call, device launches a call (profiler).
PREFIX_PATH = """
import json, time, torch
from torch.profiler import ProfilerActivity, profile
from e2e_asr_tpu_torch.decode import ctc_prefix
from e2e_asr_tpu_torch.device import resolve_device
dev = resolve_device("cuda")
g = torch.Generator(device=dev)
g.manual_seed(5)
b, w, t, v, k = 16, 16, 204, 26, 24
logits = 3.0 * torch.randn((b, t, v), generator=g, device=dev)
logits[:, :, 0] += 2.0
lp = torch.log_softmax(logits, -1)
lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
lens[0] = t
r_g = ctc_prefix.init_empty_prefix(lp, lens, w)
cand = torch.randint(1, v, (b, w, k), generator=g, device=dev)
last = torch.randint(1, v, (b, w), generator=g, device=dev)
live = torch.randint(0, w * k, (b, w), generator=g, device=dev)
rows = torch.arange(b, device=dev)[:, None]
parent = live // k
fused = getattr(ctc_prefix, "prefix_scores_fused", None)
if fused is not None:
    len32 = lens.to(torch.int32)
    def path():
        psi, r_h, eos = fused(lp, len32, r_g, last, cand, False)
        return r_h[rows, parent, live % k], psi, eos
else:
    def path():
        psi, r_h = ctc_prefix.prefix_scores(lp, lens, r_g, last, cand, prefix_is_empty=False)
        eos = ctc_prefix.eos_score(r_g, lens)
        return r_h[rows, parent, live % k], psi, eos
for _ in range(3):
    path()
torch.cuda.synchronize()
n = 20
t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
torch.cuda._sleep(2_000_000 * n)
t0.record()
for _ in range(n):
    path()
t1.record()
torch.cuda.synchronize()
h0 = time.perf_counter()
for _ in range(n):
    path()
torch.cuda.synchronize()
host_ms = (time.perf_counter() - h0) * 1e3 / n
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    path()
    torch.cuda.synchronize()
launches = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps({"fused": fused is not None, "ms": t0.elapsed_time(t1) / n, "host_ms": host_ms,
                  "launches": launches}))
"""


def parent_prefix_path(parent: str) -> dict:
    """The CTC prefix side of a beam step (PREFIX_PATH) in the parent's
    checkout at ``parent`` and in this one, in turns (parent, change, change,
    parent); medians of each tree's two runs."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if which == "parent" else here
        proc = subprocess.run([sys.executable, "-c", PREFIX_PATH], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root}, timeout=600)
        if proc.returncode != 0:
            fail(f"the {which}'s prefix path did not run: {proc.stderr[-2000:]}")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    res = {}
    for which, rs in runs.items():
        res[which] = {key: sorted(r[key] for r in rs)[len(rs) // 2] if key != "fused" else rs[0][key]
                      for key in rs[0]}
        res[which]["runs"] = rs
    print(f"  CTC prefix side of a beam step, parent (prefix_scores + eos_score + gather) vs change "
          f"(prefix_scores_fused + gather): device {res['parent']['ms']:.4f} vs {res['change']['ms']:.4f} ms, "
          f"host {res['parent']['host_ms']:.3f} vs {res['change']['host_ms']:.3f} ms, launches "
          f"{res['parent']['launches']} vs {res['change']['launches']}", flush=True)
    return res


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


def _bidir_bwd_parts(x, mask, wx, wh, ys, c, acts, dy, iters: int = 10) -> dict:
    """lstm_bidir_bwd's two parts apart (separate launches, CUDA events):
    the reverse sweep and the products (dx, dWx with db, dWh)."""
    from e2e_asr_tpu_torch.ops import rnn_cuda

    t, b, d = x.shape
    h = wh.shape[1]
    dg = torch.empty((t, 2 * b, 4 * h), device=x.device)
    outs = (torch.empty_like(x), torch.empty_like(wx), torch.empty_like(wh),
            torch.empty((2, 4 * h), device=x.device))
    return dict(
        sweep_ms=time_ms(lambda: rnn_cuda._sweep(mask, wh, c, acts, dy, dg, t, b, 2, h, 0), iters),
        products_ms=time_ms(lambda: rnn_cuda._bidir_products(x, wx, ys, dg, *outs), iters),
        sweep_grid=dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks"),
                            rnn_cuda.sweep_grid(t, b, 2, h, x.device))))


def _fwd_plan(b, h, dev, dirs=2) -> dict:
    """The forward sweep's plan (csrc e2e_lstm_fwd_plan) by name."""
    from e2e_asr_tpu_torch.ops import rnn_cuda

    return dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks"),
                    rnn_cuda.fwd_plan(b, dirs, h, dev)))


def _bidir_fwd_parts(x, mask, wx, wh, bias, train=True, iters: int = 10) -> dict:
    """The fused-projection forward's two launches apart (CUDA events): the
    projection into the kernel-time xw scratch and the sweep over it."""
    from e2e_asr_tpu_torch.ops import rnn_cuda

    t, b, _ = x.shape
    h = wh.shape[1]
    xw = torch.empty((t, 2 * b, 4 * h), device=x.device)
    ys = torch.empty((t, 2 * b, h), device=x.device)
    cs, acts = (torch.empty_like(ys), torch.empty_like(xw)) if train else (ys, ys)
    return dict(
        projection_ms=time_ms(lambda: rnn_cuda._projection(x, wx, bias, xw), iters),
        sweep_ms=time_ms(lambda: rnn_cuda._fwd_sweep(xw, mask, wh, ys, cs, acts, t, b, 2, h, 0, train), iters))


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
            f_parts = _bidir_fwd_parts(*args)
            if not all(torch.equal(p, q) for p, q in zip(got, rnn_cuda.lstm_bidir_fwd_train(*args))):
                fail(f"lstm_bidir_fwd_train D={d}: two runs on the same inputs differ")
        print(f"  lstm_bidir_fwd_train D={d}: {f_ms:.3f} ms = projection {f_parts['projection_ms']:.3f} ms + "
              f"sweep {f_parts['sweep_ms']:.3f} ms (plan {_fwd_plan(b, h, dev)}); repeats bitwise", flush=True)
        fwd.append(dict(d=d, max_abs_err=err, ms=f_ms, plain_ms=f_plain,
                        library_ms=time_ms(lambda: lstm(xg), 10), bound=bound_ms(io, nf), **f_parts))

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
            parts = _bidir_bwd_parts(x, mask, wx, wh, ys, c, acts, dy)
            again = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                fail(f"lstm_bidir_bwd D={d}: two runs on the same inputs differ")
        print(f"  lstm_bidir_bwd D={d}: {b_ms:.3f} ms = sweep {parts['sweep_ms']:.3f} ms (grid "
              f"{parts['sweep_grid']}) + products {parts['products_ms']:.3f} ms; repeats bitwise", flush=True)
        bwd.append(dict(d=d, max_abs_err=err, ms=b_ms, plain_ms=b_plain,
                        library_ms=time_ms(lambda: torch.autograd.grad(out_lib, lib_in, dy_lib,
                                                                       retain_graph=True), 10),
                        bound=bound_ms(io, nf), **parts))

        def kernel_fwd():
            with torch.no_grad():
                rnn_cuda.lstm_bidir_fwd_train(*args)

        def kernel_bwd():
            with torch.no_grad():
                rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)

        alt = alternating_ms({"kernel_fwd": kernel_fwd, "cudnn_fwd": lambda: lstm(xg),
                              "kernel_bwd": kernel_bwd,
                              "cudnn_bwd": lambda: torch.autograd.grad(out_lib, lib_in, dy_lib,
                                                                       retain_graph=True)})
        fwd[-1]["alternating"] = {"ms": alt["kernel_fwd"], "library_ms": alt["cudnn_fwd"]}
        bwd[-1]["alternating"] = {"ms": alt["kernel_bwd"], "library_ms": alt["cudnn_bwd"]}
        print(f"  alternating rounds ({ALT_ROUNDS}, median) D={d}: lstm_bidir_fwd_train {alt['kernel_fwd']:.3f} "
              f"ms vs cuDNN {alt['cudnn_fwd']:.3f} ms; lstm_bidir_bwd {alt['kernel_bwd']:.3f} ms vs cuDNN "
              f"{alt['cudnn_bwd']:.3f} ms", flush=True)
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
            per_width={str(e["d"]): {k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound", "alternating",
                                                        "projection_ms", "sweep_ms", "products_ms", "sweep_grid")
                                     if k in e}
                       for e in entries},
            alternating={k: (entries[0]["alternating"][k] + 3 * entries[1]["alternating"][k]) / 4
                         for k in ("ms", "library_ms")},
        )
    out["lstm_bidir_fwd_train"]["plan"] = _fwd_plan(b, h, dev)

    # ---- CTC lattice: log_probs [B, S, V], labels [B, L] up to the token bucket
    print("[kernel] ctc_loss (lattice: nll and its gradient)", flush=True)
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
    want = ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen)
    ok = want[0] <= ctc_cuda.BIG
    if not torch.equal(got[0] <= ctc_cuda.BIG, ok) or bool(ok[0]) or not bool(ok[1:].all()):
        fail("ctc_loss: rows with no alignment differ between kernel and plain version")
    err = compare("ctc_loss nll", got[0][ok], want[0][ok], rtol=1e-5, atol=1e-3)
    err = max(err, compare("ctc_loss G = d nll / d log_probs", got[1], want[1], rtol=1e-4, atol=1e-4))
    for _ in range(2):
        again = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail("ctc_loss: two runs on the same inputs differ")

    def loss_grad():
        lp_g = lp.clone().requires_grad_()
        nll = ctc_cuda.CTCLossFn.apply(lp_g, inlen, labels, lablen)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(nll), nll, 0.0).sum(), lp_g)
        return g

    g_k = loss_grad()
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        g_p = loss_grad()
    err = max(err, compare("ctc_loss CTCLossFn d nll / d log_probs", g_k, g_p, rtol=1e-4, atol=1e-4))
    if float(g_k[0].abs().max()) != 0.0:
        fail("ctc_loss: a row with no alignment has a gradient")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the CUDA route must not synchronise with the host
    try:
        loss_grad()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    targets = torch.cat([labels[i, :lablen[i]] for i in range(b)])
    lp_t = lp.transpose(0, 1).detach().requires_grad_()

    def library():
        nll = torch.nn.functional.ctc_loss(lp_t, targets, inlen, lablen, reduction="sum",
                                           zero_infinity=True)
        torch.autograd.grad(nll, lp_t)

    # launches of one forward + backward: the wrapper's count, and the
    # device kernels the profiler sees (kernel route and library)
    from torch.profiler import ProfilerActivity, profile

    before = ctc_cuda.ctc_lattice.launches
    loss_grad()
    per_call = ctc_cuda.ctc_lattice.launches - before
    if per_call != 1:
        fail(f"ctc_loss: {per_call} kernel launches in one CTCLossFn forward + backward, expected 1")
    device_launches = {}
    for nm, fn in (("kernel", loss_grad), ("library", library)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device_launches[nm] = sum(e.count for e in prof.key_averages()
                                  if e.device_type == torch.autograd.DeviceType.CUDA)
    alt = alternating_ms({"kernel": loss_grad, "library": library})
    print(f"  ctc_loss: {per_call} kernel launch per CTCLossFn forward + backward; device launches "
          f"{device_launches['kernel']} (F.ctc_loss {device_launches['library']}); no host sync", flush=True)
    print(f"  alternating rounds ({ALT_ROUNDS}, median): ctc_loss forward + backward {alt['kernel']:.3f} ms vs "
          f"F.ctc_loss {alt['library']:.3f} ms (ratio {alt['kernel'] / alt['library']:.3f})", flush=True)
    # the function's least work, the same for the kernel and the library:
    # log_probs, labels and lengths read once, nll and G [B, T, V] written
    # once; ~30 operations per valid (t, s) cell for alpha and beta
    io = (4 * lp.numel() + labels.element_size() * labels.numel()
          + inlen.element_size() * b + lablen.element_size() * b + 4 * (b + lp.numel()))
    nf = 30 * float((inlen.clamp(max=s_len) * (2 * lablen + 1)).sum())
    out["ctc_loss"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_loss.cu",
        replaces="e2e_asr_tpu/ops/ctc_pallas.py:170", max_abs_err=err,
        ms=time_ms(lambda: ctc_cuda.ctc_lattice(lp, labels, inlen, lablen), 20),
        plain_ms=time_ms(lambda: ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen), 3, 1),
        library_ms=time_ms(library, 10), bound=bound_ms(io, nf),
        loss_fwd_bwd_ms=time_ms(loss_grad, 10), launches_per_fwd_bwd=per_call,
        device_launches_per_fwd_bwd=device_launches,
        alternating={"ms": alt["kernel"], "library_ms": alt["library"]},
        shapes=f"log_probs [{b},{s_len},{vocab}], labels [{b},{l_max}] (S {2 * l_max + 1}), int64; "
               "ms: the kernel (nll + G); library_ms: F.ctc_loss forward + backward; "
               "loss_fwd_bwd_ms: CTCLossFn forward + backward",
    )
    return out


def _conv_taps(lens, p):
    """Taps of a centred P-tap filter that fall on frames inside [0, len),
    summed over the valid frames of every utterance."""
    r = (p - 1) // 2
    total = 0
    for n in lens.tolist():
        fr = torch.arange(n)
        total += int((fr.clamp(max=r) + (n - 1 - fr).clamp(max=r) + 1).sum())
    return float(total)


def _compare_scan_fwd(name, got, want, noise, tie_tol=1e-3):
    """The scan's outputs and residuals, kernel against plain version. With
    fed-back predictions a near-tie may resolve differently (the logits
    agree to ~1e-6, not bit for bit): where an utterance's fed tokens first
    differ, the plain version's scores of the two tokens must lie within
    ``tie_tol``; that utterance's later steps then follow another path and
    are left out of the comparison. Returns the largest error."""
    (lg, al, hd, (cs, tk, ac, qs, cx)), (lg_p, al_p, hd_p, (cs_p, tk_p, ac_p, qs_p, cx_p)) = got, want
    l, b = tk.shape
    keep = torch.ones((l, b), dtype=torch.bool, device=tk.device)
    diff = tk != tk_p
    for row in torch.nonzero(diff.any(0))[:, 0].tolist():
        t = int(torch.nonzero(diff[:, row])[0, 0])
        sc = lg_p[t - 1, row] + (noise[t - 1, row] if noise is not None else 0.0)
        gap = float((sc[tk_p[t, row]] - sc[tk[t, row]]).abs())
        print(f"  {name}: utterance {row} feeds {int(tk[t, row])} vs {int(tk_p[t, row])} at step {t}, "
              f"score gap {gap:.2e}", flush=True)
        if gap > tie_tol:
            fail(f"{name}: fed tokens differ without a near-tie")
        keep[t:, row] = False
    if int((~keep).sum()) > l * b // 10:
        fail(f"{name}: more than a tenth of the steps left the plain version's path")
    err = 0.0
    for nm, g, w in (("logits", lg, lg_p), ("align", al, al_p), ("hidden", hd, hd_p), ("c", cs, cs_p),
                     ("acts", ac, ac_p), ("q", qs, qs_p), ("ctx", cx, cx_p)):
        err = max(err, compare(f"{name} {nm}", g[keep], w[keep], rtol=1e-4, atol=1e-4))
    return err


def _scan_parity(gen, dev, args, vocab, temp, what):
    """decoder_scan_fwd against its plain version in the three feedback modes
    (teacher-forced, argmax, sampled with the kernel's noise), then
    decoder_scan_bwd against its plain version and the autograd function
    against autograd through the plain forward (scaled rtol 1e-4), all at the
    shapes of ``args``. Returns (forward error, backward error, the
    backward's arguments, the cotangents)."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    l, b = args[-1].shape
    seed = NOISE_SEED
    noise = dc.gumbel_noise(seed, l, b, vocab, dev)
    err = 0.0
    with torch.no_grad():
        for mode in ("teacher", "argmax", "sample"):
            print(f"[kernel] decoder_scan_fwd {mode} ({what})", flush=True)
            use = torch.ones(l, dtype=torch.bool) if mode == "teacher" else torch.zeros(l, dtype=torch.bool)
            sample = mode == "sample"
            got = dc.decoder_scan_fwd(*args, use, temp, sample, seed)
            want = dc.decoder_scan_fwd_plain(*args, use, temp, sample, noise if sample else None)
            err = max(err, _compare_scan_fwd(f"decoder_scan_fwd {mode} ({what})", got, want,
                                             noise if sample else None))
            if mode != "teacher" and not (int(got[3][1].max()) < vocab and int(got[3][1].min()) >= 0):
                fail(f"decoder_scan_fwd ({what}): a fed-back token is not a vocabulary id")
        print(f"[kernel] decoder_scan_bwd ({what})", flush=True)
        use = torch.ones(l, dtype=torch.bool)
        logits, align, hidden, (cseq, _, acts, qs, ctxs) = dc.decoder_scan_fwd_plain(*args, use, temp)
        k, v, lens, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args
        cots = [torch.randn(o.shape, generator=gen, device=dev) / math.sqrt(o.shape[-1])
                for o in (logits, align, hidden)]
        bargs = (k, v, lens, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
                 ctxs, *cots, temp)
        got_b = dc.decoder_scan_bwd(*bargs)
        want_b = dc.decoder_scan_bwd_plain(*bargs)
        err_b = max(_scaled(f"decoder_scan_bwd {nm} ({what})", g, w, 1e-4)
                    for nm, g, w in zip(("dgates", "dq", "dfpre", "dk", "dWlp", "dlocv"), got_b, want_b))
    # the autograd function (sweep + outside contractions) against autograd
    # through the plain forward loop, every float input
    idx = [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    names = "k v . taps wq bq wlp locv locb embed wx wh bl wout bout".split()

    def grads(fn):
        leaves = [a.clone().requires_grad_() if i in idx else a for i, a in enumerate(args)]
        outs = fn(*leaves, use, temp)[:3]
        return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)),
                                   [leaves[i] for i in idx])

    g_plain = grads(dc.decoder_scan_fwd_plain)
    g_kern = grads(dc.decoder_scan)
    err_b = max([err_b] + [_scaled(f"decoder_scan autograd d{names[i]} ({what})", g, w, 1e-4)
                           for i, g, w in zip(idx, g_kern, g_plain)])
    return err, err_b, bargs, cots


def convergence_scan_checks(dev, cfg, vocab):
    """The scan pair at the convergence recipe's shapes (B=32, the longest
    bucket's S=204 with ragged lengths, L=72, Dk 128, E 512, 8 x 65 taps,
    H = Emb = 256), where B exceeds the clusters that can be resident, so
    each cluster walks two utterances: _scan_parity there."""
    from e2e_asr_tpu_torch.bin.profile_decode import scan_inputs
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    m, ac = cfg.model, cfg.model.attention
    b, s, l = cfg.data.corpus.batch_size, cfg.data.corpus.buckets[-1] // 4, cfg.data.corpus.token_buckets[-1]
    dk, e_dim, kk, p = ac.dim, 2 * m.encoder.dim[-1], ac.loc_kernel_num, 2 * ac.loc_kernel_size + 1
    h = emb = m.decoder.dim
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    lens[0] = s
    args = scan_inputs(gen, dev, b, s, dk, e_dim, kk, p, h, emb, vocab, l, lens)
    grid = {w: dc.scan_grid(w, b, s, dk, e_dim, kk, p, h, vocab) for w in ("fwd", "bwd")}
    shapes = f"B {b}, S {s}, Dk {dk}, E {e_dim}, taps {kk}x{p}, H {h}, V {vocab}, L {l}"
    print(f"fused scan at the convergence recipe's shapes ({shapes}): grid forward {grid['fwd']}; "
          f"backward {grid['bwd']}", flush=True)
    err, err_b, _, _ = _scan_parity(gen, dev, args, vocab, float(ac.temperature), "convergence shapes")
    print(f"convergence shapes: decoder_scan_fwd max abs err {err:.3e} (three feedback modes), "
          f"decoder_scan_bwd and the autograd function {err_b:.3e} (scaled rtol 1e-4)", flush=True)
    return dict(shapes=shapes, grid=grid, fwd_max_abs_err=err, bwd_max_abs_err=err_b)


def scan_kernel_checks(dev, cfg, vocab):
    """decoder_scan_fwd / decoder_scan_bwd against their plain versions at
    the flagship training shapes (B=16, S=204, L=200, ragged lengths), in the
    three feedback modes, and once at the longest flagship bucket (S=764)
    with a short L."""
    from e2e_asr_tpu_torch.bin.profile_decode import print_scan_phases, scan_inputs, scan_phase_split
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    m = cfg.model
    ac = m.attention
    b, s, l = cfg.data.corpus.batch_size, 816 // 4, cfg.data.corpus.token_buckets[-1]
    dk, e_dim, kk, p = ac.dim, 2 * m.encoder.dim[-1], ac.loc_kernel_num, 2 * ac.loc_kernel_size + 1
    h = emb = m.decoder.dim
    temp = float(ac.temperature)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    lens[0] = s
    args = scan_inputs(gen, dev, b, s, dk, e_dim, kk, p, h, emb, vocab, l, lens)
    grid = {w: dc.scan_grid(w, b, s, dk, e_dim, kk, p, h, vocab) for w in ("fwd", "bwd")}
    resident = {cl: dc.resident_clusters("fwd", cl) for cl in dc.CLUSTER_SIZES}
    print(f"fused scan grid: resident clusters by cluster size (cudaOccupancyMaxActiveClusters at "
          f"{dc.SMEM_MAX} B a block) {resident}; grid used: forward {grid['fwd']}; backward "
          f"{grid['bwd']}", flush=True)
    err, err_b, bargs, cots = _scan_parity(gen, dev, args, vocab, temp, "flagship shapes")
    seed = NOISE_SEED
    out = {}
    with torch.no_grad():
        use = torch.ones(l, dtype=torch.bool)
        nvalid = float(lens.sum())
        ntaps = _conv_taps(lens, p)
        # bytes: k and v over the valid frames, the weights, the teacher ids in;
        # logits, align, hidden and the residuals (c, tokens, acts, q, ctx) out
        w_elems = sum(a.numel() for a in args[3:15])
        io = 4 * (nvalid * (dk + e_dim) + w_elems + l * b
                  + l * b * (vocab + s + 2 * h + 1 + 4 * h + dk + e_dim))
        # operations per step and utterance: q, the conv over the valid
        # frames (only the taps that fall on valid frames), the energies, the
        # context, the gate product, the logits
        nf = l * 2 * (b * (h * dk + (emb + e_dim + h) * 4 * h + h * vocab)
                      + ntaps * kk + nvalid * (dk * (kk + 2) + e_dim))
        out["decoder_scan_fwd"] = dict(
            route="cuda", source="e2e_asr_tpu_torch/csrc/decoder_scan.cu",
            replaces="e2e_asr_tpu/ops/decoder_pallas.py:226", max_abs_err=err,
            ms=time_ms(lambda: dc.decoder_scan_fwd(*args, use, temp), 5),
            ms_sampled=time_ms(lambda: dc.decoder_scan_fwd(*args, ~use, temp, True, seed), 5),
            plain_ms=time_ms(lambda: dc.decoder_scan_fwd_plain(*args, use, temp), 2, 1),
            library_ms=None, bound=bound_ms(io, nf),
            shapes=f"k [{b},{s},{dk}], v [{b},{s},{e_dim}], taps [{kk},{p}], H {h}, V {vocab}, L {l} "
                   "(ms: teacher-forced; ms_sampled: every step feeds a sampled token back; no "
                   "single PyTorch call computes a location-attention speller scan)",
        )

        k, v, _, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args
        # bytes: k, v (valid frames), the weights, the stored sequences and the
        # three cotangents in; dgates, dq, dfpre, dk and the partials out
        io = 4 * (nvalid * (dk + e_dim) + sum(a.numel() for a in (taps, wq, wlp, locv, locb, wx, wh, wout))
                  + l * b * (s + 2 * h + 4 * h + dk + e_dim) + l * b * (vocab + s + h)
                  + l * b * (4 * h + dk + s * kk) + b * s * dk + b * 8 * (kk + 1) * dk)
        # operations: dlogits Wout^T, dctx and dh_lstm, dq Wq^T per utterance;
        # per valid frame dalign = v . dctx, one rebuild of the tanh energies
        # (f Wlp), dfpre = de Wlp^T, dWlp += f^T de and ~12 elementwise
        # operations per attention unit; the conv that rebuilds f and the
        # transposed conv of dfpre, over the taps that fall on valid frames
        nf = l * 2 * (b * (h * vocab + (e_dim + h) * 4 * h + h * dk)
                      + nvalid * (e_dim + dk * (3 * kk + 6)) + 2 * ntaps * kk)
        out["decoder_scan_bwd"] = dict(
            route="cuda", source="e2e_asr_tpu_torch/csrc/decoder_scan_bwd.cu",
            replaces="e2e_asr_tpu/ops/decoder_pallas.py:482", max_abs_err=err_b,
            ms=time_ms(lambda: dc.decoder_scan_bwd(*bargs), 5),
            plain_ms=time_ms(lambda: dc.decoder_scan_bwd_plain(*bargs), 2, 1),
            library_ms=None, bound=bound_ms(io, nf),
            shapes=f"as decoder_scan_fwd; cotangents of logits, align, hidden (ms: the sweep "
                   "kernel alone, without the contractions outside it)",
        )

        # one step of each kernel split into its phases (the timing build)
        split = scan_phase_split(args, use, temp, cots)
        print_scan_phases(split)
        for w in ("fwd", "bwd"):
            out[f"decoder_scan_{w}"]["phases_us"] = split[w]
            out[f"decoder_scan_{w}"]["grid"] = {**grid[w], "resident_clusters_by_size": resident}

        # the longest flagship bucket: S = 764 (3056 / 4), short L
        print("[kernel] decoder_scan_fwd / decoder_scan_bwd at S=764", flush=True)
        s2, l2 = 3056 // 4, 8
        lens2 = torch.randint(s2 // 2, s2 + 1, (b,), generator=gen, device=dev)
        lens2[0] = s2
        args2 = scan_inputs(gen, dev, b, s2, dk, e_dim, kk, p, h, emb, vocab, l2, lens2)
        use2 = torch.ones(l2, dtype=torch.bool)
        got = dc.decoder_scan_fwd(*args2, use2, temp)
        want = dc.decoder_scan_fwd_plain(*args2, use2, temp)
        _compare_scan_fwd("decoder_scan_fwd S=764", got, want, None)
        logits, align, hidden, (cseq, _, acts, qs, ctxs) = want
        k, v, _, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args2
        cots2 = [torch.randn(o.shape, generator=gen, device=dev) / math.sqrt(o.shape[-1])
                 for o in (logits, align, hidden)]
        bargs2 = (k, v, lens2, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
                  ctxs, *cots2, temp)
        for nm, g, w in zip(("dgates", "dq", "dfpre", "dk", "dWlp", "dlocv"),
                            dc.decoder_scan_bwd(*bargs2), dc.decoder_scan_bwd_plain(*bargs2)):
            _scaled(f"decoder_scan_bwd S=764 {nm}", g, w, 1e-4)
        out["decoder_scan_fwd"]["ms_s764_l8"] = time_ms(lambda: dc.decoder_scan_fwd(*args2, use2, temp), 5)
        out["decoder_scan_bwd"]["ms_s764_l8"] = time_ms(lambda: dc.decoder_scan_bwd(*bargs2), 5)
    return out


def lstm_seq_checks(dev):
    """lstm_seq_fwd / lstm_seq_bwd against their plain versions at the
    convergence recipe's first layer (T=816, B=32, D=80, H=256) and at the
    flagship's (T=204, B=16, H=320), beside cuDNN's nn.LSTM; then a BiLSTM
    layer forward + backward through either kernel pair (projection included
    on both sides) at the input widths the recipes have: the numbers the
    ``auto`` rule of ops/rnn.py rests on."""
    from e2e_asr_tpu_torch.ops import rnn as rnn_ops
    from e2e_asr_tpu_torch.ops import rnn_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    fwd, bwd = [], []
    for t, b, d, h in ((816, 32, 80, 256), (204, 16, 1280, 320)):
        print(f"[kernel] lstm_seq_fwd / lstm_seq_bwd T={t} B={b} H={h}", flush=True)
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
        lens[0] = t
        x, mask, wx, wh, bias = _lstm_inputs(gen, dev, t, b, d, h, lens)
        with torch.no_grad():
            xw, m2 = rnn_cuda._kernel_time_inputs(x, mask, wx, bias)
            xw, m2 = xw.contiguous(), m2.float()
            got = rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True)
            want = rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh)
            err = max(compare(f"lstm_seq_fwd T={t} {nm}", g, w, rtol=1e-4, atol=1e-4)
                      for nm, g, w in zip(("ys", "c", "acts"), got, want))
            err = max(err, compare(f"lstm_seq_fwd T={t} ys (inference)", rnn_cuda.lstm_seq_fwd(xw, m2, wh),
                                   want[0], rtol=1e-4, atol=1e-4))
            ys, c, acts = want
            dy = torch.randn(ys.shape, generator=gen, device=dev)
            got_b = rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy)
            want_b = rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy)
            err_b = max(_scaled(f"lstm_seq_bwd T={t} {nm}", g, w, 1e-4)
                        for nm, g, w in zip(("dxw", "dWh"), got_b, want_b))
        lstm = _cudnn_lstm(dev, wx, wh, bias)
        xg = x.clone().requires_grad_()
        r = 2 * b
        vr = 2 * float(lens.sum())
        # forward bytes: xw, mask, wh in; ys, c, acts out. backward: mask, wh,
        # ys, c, acts, dy in; dxw, dWh out
        io_f = 4 * (t * r * 4 * h + t * r + 2 * h * 4 * h + t * r * h * 6)
        io_b = 4 * (t * r + 2 * h * 4 * h + t * r * h * 7 + t * r * 4 * h + 2 * h * 4 * h)
        with torch.no_grad():
            # the sweep alone, its outputs allocated outside
            f_out = [torch.empty_like(v) for v in want]
            fwd.append(dict(
                t=t, b=b, h=h, max_abs_err=err, bound=bound_ms(io_f, vr * (2 * h * 4 * h + 12 * h)),
                ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True), 5),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh), 2, 1),
                sweep_ms=time_ms(lambda: rnn_cuda._fwd_sweep(xw, m2, wh, *f_out, t, b, 2, h, 1, True), 5),
                plan=_fwd_plan(b, h, dev)))
            dxw, dwh = torch.empty_like(acts), torch.empty_like(wh)
            bwd.append(dict(
                t=t, b=b, h=h, max_abs_err=err_b, bound=bound_ms(io_b, vr * (16 * h * h + 20 * h)),
                ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy), 5),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy), 2, 1),
                sweep_ms=time_ms(lambda: rnn_cuda._sweep(m2, wh, c, acts, dy, dxw, t, b, 2, h, 1), 5),
                products_ms=time_ms(lambda: rnn_cuda._seq_products(ys, dxw, dwh), 5),
                sweep_grid=dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks"),
                                    rnn_cuda.sweep_grid(t, b, 2, h, dev)))))
            print(f"  lstm_seq_bwd T={t} B={b} H={h}: {bwd[-1]['ms']:.3f} ms = sweep {bwd[-1]['sweep_ms']:.3f} "
                  f"ms (grid {bwd[-1]['sweep_grid']}) + dWh {bwd[-1]['products_ms']:.3f} ms", flush=True)
        fwd[-1]["library_ms"] = time_ms(lambda: lstm(xg), 5)
        # cuDNN's call includes x @ Wx; the port's projection outside the
        # kernel (one matmul, the flip of the backward direction) beside it,
        # alone and in rounds in turns with the kernel and cuDNN's forward
        with torch.no_grad():
            fwd[-1]["projection_ms"] = time_ms(lambda: rnn_cuda._kernel_time_inputs(x, mask, wx, bias), 5)

            def kernel_fwd():
                rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True)

            alt = alternating_ms({"kernel_fwd": kernel_fwd,
                                  "projection": lambda: rnn_cuda._kernel_time_inputs(x, mask, wx, bias),
                                  "cudnn_fwd": lambda: lstm(xg)})
        fwd[-1]["alternating"] = {"ms": alt["kernel_fwd"], "projection_ms": alt["projection"],
                                  "library_ms": alt["cudnn_fwd"]}
        print(f"  lstm_seq_fwd T={t} B={b} H={h}: {fwd[-1]['ms']:.3f} ms (sweep alone {fwd[-1]['sweep_ms']:.3f} ms, "
              f"plan {fwd[-1]['plan']}); alternating rounds ({ALT_ROUNDS}, median): kernel {alt['kernel_fwd']:.3f} "
              f"ms + projection {alt['projection']:.3f} ms vs cuDNN {alt['cudnn_fwd']:.3f} ms", flush=True)
        out_lib, _ = lstm(xg)
        dy_lib = torch.randn(out_lib.shape, generator=gen, device=dev)
        lib_in = [xg] + list(lstm.parameters())
        bwd[-1]["library_ms"] = time_ms(
            lambda: torch.autograd.grad(out_lib, lib_in, dy_lib, retain_graph=True), 5)
        del lstm, out_lib, xg

    # a whole layer, forward + backward, by either kernel pair
    routes = []
    for t, b, d, h in ((816, 32, 40, 256), (816, 32, 80, 256), (408, 32, 512, 256),
                       (204, 16, 640, 320), (204, 16, 1280, 320)):
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
        lens[0] = t
        x, _, wx, wh, bias = _lstm_inputs(gen, dev, t, b, d, h, lens)
        xb = x.transpose(0, 1).contiguous().requires_grad_()
        w = [{"wx": wx[i].clone().requires_grad_(), "wh": wh[i].clone().requires_grad_(),
              "b": bias[i].clone().requires_grad_()} for i in range(2)]
        dy = torch.randn((b, t, 2 * h), generator=gen, device=dev)
        leaves = [xb] + [v for wi in w for v in wi.values()]

        def layer(impl):
            y = rnn_ops.bidir(xb, lens, w[0], w[1], impl=impl)
            return torch.autograd.grad((y * dy).sum(), leaves)

        for g, wt in zip(layer("pallas_xw"), layer("pallas")):
            _scaled(f"bidir pallas_xw vs pallas D={d} grads", g, wt, 1e-4)
        # the library's whole layer (cuDNN nn.LSTM forward + backward,
        # projection included, no length mask): like for like with a route
        lstm = _cudnn_lstm(dev, wx, wh, bias)
        xg = x.clone().requires_grad_()
        dy_t = dy.transpose(0, 1).contiguous()
        lib_in = [xg] + list(lstm.parameters())

        def cudnn_layer():
            return torch.autograd.grad(lstm(xg)[0], lib_in, dy_t)

        # in turns: xw, fused, fused, xw
        t_xw = time_ms(lambda: layer("pallas_xw"), 3, 1)
        t_fused = time_ms(lambda: layer("pallas"), 3, 1)
        t_fused = (t_fused + time_ms(lambda: layer("pallas"), 3, 1)) / 2
        t_xw = (t_xw + time_ms(lambda: layer("pallas_xw"), 3, 1)) / 2
        t_lib = time_ms(cudnn_layer, 3, 1)
        del lstm, xg
        routes.append(dict(t=t, b=b, d=d, h=h, pallas_xw_ms=t_xw, pallas_ms=t_fused, cudnn_ms=t_lib))
        print(f"  BiLSTM layer fwd+bwd T={t} B={b} D={d} H={h}: lstm_seq route {t_xw:.2f} ms, "
              f"fused-projection route {t_fused:.2f} ms, cuDNN nn.LSTM {t_lib:.2f} ms", flush=True)

    out = {}
    for name, entries, line, src in (("lstm_seq_fwd", fwd, 172, "lstm_bidir.cu"),
                                     ("lstm_seq_bwd", bwd, 213, "lstm_bidir_bwd.cu")):
        e0 = entries[0]  # the convergence recipe's first layer: the shape its path runs
        out[name] = dict(
            route="cuda", source=f"e2e_asr_tpu_torch/csrc/{src}",
            replaces=f"e2e_asr_tpu/ops/rnn_pallas.py:{line}", max_abs_err=max(e["max_abs_err"] for e in entries),
            ms=e0["ms"], plain_ms=e0["plain_ms"], library_ms=e0["library_ms"], bound=e0["bound"],
            shapes=f"xw [{e0['t']},{2 * e0['b']},{4 * e0['h']}], wh [2,{e0['h']},{4 * e0['h']}] (the "
                   "convergence recipe's first layer; library_ms: cuDNN nn.LSTM on x [T,B,80], its "
                   "projection included, which ms leaves out: layer_routes compares whole layers)",
            per_shape={f"T{e['t']}_B{e['b']}_H{e['h']}": {k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound",
                                                                            "projection_ms", "sweep_ms",
                                                                            "products_ms", "sweep_grid", "plan",
                                                                            "alternating")
                                                         if k in e}
                       for e in entries},
        )
        for k in ("plan", "alternating"):
            if k in e0:
                out[name][k] = e0[k]
    out["lstm_seq_fwd"]["layer_routes"] = routes
    return out


def _check_steps(log, what):
    """Prints each step's record; every loss finite, no step skipped."""
    for rec in log:
        print(f"  {what} step {rec['step']}: loss {rec['loss']:.4f} att {rec['att_loss']:.4f} "
              f"ctc {rec['ctc_loss']:.4f} gnorm {rec['grad_norm']:.3f} tf {rec['tf_rate']:.2f} | "
              f"{rec['audio_s']:.2f} audio-s in {rec['wall_s']:.3f}s = "
              f"{rec['audio_s'] / rec['wall_s']:.2f} audio-s/s", flush=True)
        if not all(math.isfinite(rec[k]) for k in ("loss", "att_loss", "ctc_loss", "grad_norm")):
            fail(f"{what} step {rec['step']}: a loss or the gradient norm is not finite")
        if rec["step_skipped"] != 0.0:
            fail(f"{what} step {rec['step']} was skipped")


def _run_counted(solver, wrappers, what):
    """solver.exec() with the wrappers' launch counts set to 0 just before
    and read just after; every one must have launched. Returns the counts
    and the wall seconds."""
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.time()
    solver.exec()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"{what} path launches: {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
    return launches, wall


def convergence_phase(dev, smi):
    """The convergence recipe (configs/synthetic_convergence.yaml) at its full
    width: first the scan pair against its plain versions at the recipe's
    shapes (``convergence_scan_checks``), then CONV_STEPS steps and one
    validation through bin/train_asr.Solver.exec, its BiLSTM layers through
    the lstm_seq kernel pair and its speller through the fused scan, coins
    failing (tf 0.8)."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import convergence_train_solver
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd

    solver = convergence_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_convergence"), SEED,
                                      CONV_STEPS)
    m = solver.config.model
    if (solver.config.data.corpus.batch_size, m.encoder.dim, m.attention.dim, m.decoder.dim) != (
            32, [256, 256, 256], 128, 256):
        fail("the convergence recipe is not at its full width")
    scan_check = convergence_scan_checks(dev, solver.config, solver.vocab_size)
    wrappers = {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd,
                "decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd}
    launches, wall = _run_counted(solver, wrappers, "convergence")
    log = list(solver.step_log)
    if len(log) != CONV_STEPS:
        fail(f"{len(log)} convergence steps ran, expected {CONV_STEPS}")
    _check_steps(log, "convergence")
    if not any(r["tf_rate"] < 1.0 for r in log):
        fail("the convergence steps ran with tf_rate 1")
    dev_sum = solver.dev_summary
    print(f"  convergence dev: {dev_sum}", flush=True)
    if not all(math.isfinite(v) for v in dev_sum.values()):
        fail("convergence validation gave a non-finite number")
    rate = log[-1]["audio_s"] / log[-1]["wall_s"]
    print(f"convergence e2e: last step {rate:.2f} audio-s/s on {smi} (B=32, 3x256 BiLSTM on 80-dim "
          f"fbank, seed-{SEED} weights); {CONV_STEPS} steps + validation {wall:.1f}s", flush=True)
    return dict(launches=launches, steps=log, dev=dev_sum, wall_s=wall, scan_check=scan_check)


def train_phase(smi):
    """The training path through bin/train_asr.Solver on the card under
    either LSTM route (the default 'auto' first, then 'pallas', the
    fused-projection pair, pinned so that it stays driven), two more steps
    with failing teacher-forcing coins on the default route, then one train
    step with the kernels against one with the plain versions."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import smoke_train_solver
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc_cuda import ctc_lattice
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import (lstm_bidir_bwd, lstm_bidir_fwd_train, lstm_seq_bwd,
                                                lstm_seq_fwd)
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves

    common = {"log_mel": log_mel, "ctc_loss": ctc_lattice, "decoder_scan_fwd": decoder_scan_fwd,
              "decoder_scan_bwd": decoder_scan_bwd}
    lstm_pair = {"auto": {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd},
                 "pallas": {"lstm_bidir_fwd_train": lstm_bidir_fwd_train, "lstm_bidir_bwd": lstm_bidir_bwd}}
    runs = {}
    for impl in ("auto", "pallas"):
        what = f"train (rnn_impl {impl})"
        solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, f"smoke_train_{impl}"), SEED,
                                    TRAIN_STEPS, rnn_impl=impl)
        batch = next(solver.tr_set.epoch(0))
        if batch.wav.shape != (16, (816 - 1) * 160 + 400):
            fail(f"train batch has shape {batch.wav.shape}, expected 16 utterances in the 816 bucket")
        launches, wall = _run_counted(solver, {**common, **lstm_pair[impl]}, what)
        log = list(solver.step_log)
        if len(log) != TRAIN_STEPS:
            fail(f"{len(log)} training steps ran, expected {TRAIN_STEPS}")
        _check_steps(log, what)
        dev_sum = solver.dev_summary
        print(f"  dev: {dev_sum}", flush=True)
        if not all(math.isfinite(v) for v in dev_sum.values()):
            fail("validation gave a non-finite number")
        steady = sorted(r["audio_s"] / r["wall_s"] for r in log[1:])
        rate = steady[len(steady) // 2]
        print(f"train e2e (rnn_impl {impl}): median {rate:.2f} audio-s/s per step over steps "
              f"2-{TRAIN_STEPS} (step 1 {log[0]['audio_s'] / log[0]['wall_s']:.2f}) on {smi} (flagship, "
              f"B=16, 816 bucket, seed-{SEED} weights); {TRAIN_STEPS} steps + validation {wall:.1f}s",
              flush=True)
        runs[impl] = dict(solver=solver, batch=batch, launches=launches, steps=log, dev=dev_sum,
                          audio_s_per_s=rate, wall_s=wall)
    # the two routes compute the same function from the same seed
    loss_gap = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                   for x, y in zip(runs["auto"]["steps"], runs["pallas"]["steps"]))
    print(f"train losses of the two LSTM routes over {TRAIN_STEPS} steps: max rel diff {loss_gap:.2e} "
          "(tolerance 1e-3)", flush=True)
    if loss_gap > 1e-3:
        fail("the two LSTM routes train to different losses")

    # ---- two more steps on the default route with failing coins (sampled
    # feedback inside the scan)
    solver, batch = runs["auto"]["solver"], runs["auto"]["batch"]
    cfg = solver.config
    cfg.hparas.tf_start = cfg.hparas.tf_end = 0.5
    solver.max_step += 2
    sampled_launches, _ = _run_counted(
        solver, {"decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd,
                 **lstm_pair["auto"]}, "train (tf 0.5, rnn_impl auto)")
    sampled = list(solver.step_log)[TRAIN_STEPS:]
    if len(sampled) != 2 or sampled_launches["decoder_scan_fwd"] != 2:
        fail(f"the two steps with failing coins did not run through the fused scan: {sampled_launches}")
    _check_steps(sampled, "train (tf 0.5, rnn_impl auto)")
    if not all(r["tf_rate"] < 1.0 for r in sampled):
        fail("the steps meant to have failing coins ran with tf_rate 1")
    cfg.hparas.tf_start = cfg.hparas.tf_end = 1.0

    # ---- one step with the kernels, one with the plain versions, under each
    # LSTM route (the fused scan is on both sides' path)
    from torch.profiler import ProfilerActivity, profile

    dbatch = solver._put(batch)
    parity = {}
    for impl in ("pallas", "auto"):
        cfg.model.encoder.rnn_impl = impl
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
                         [p.detach().clone() for p in param_leaves(state.params)], dt)
            if mode == "kernel":
                # the device launches of one more such step, counted by the profiler
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    trainer.train_step(state, dbatch, solver.step_generator(1))
                    torch.cuda.synchronize()
                step_launches = sum(e.count for e in prof.key_averages()
                                    if e.device_type == torch.autograd.DeviceType.CUDA)
        (lk, gk, pk, tk), (lp_, gp, pp, tp) = res["kernel"], res["plain"]
        loss_rel = abs(lk - lp_) / abs(lp_)
        gn_rel = abs(gk - gp) / abs(gp)
        p_err = max(float((a - c).abs().max()) for a, c in zip(pk, pp))
        print(f"train step kernel vs plain (rnn_impl {impl}): loss {lk:.6f} vs {lp_:.6f} (rel "
              f"{loss_rel:.2e}, tolerance 1e-4); grad_norm {gk:.6f} vs {gp:.6f} (rel {gn_rel:.2e}, "
              f"tolerance 1e-3); updated params max abs diff {p_err:.3e} (tolerance 1e-5; an Adadelta "
              f"first step moves a parameter by at most 3.2e-4); step {tk:.2f}s vs {tp:.2f}s; "
              f"{step_launches} device launches in a kernel-route step", flush=True)
        if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and p_err <= 1e-5):
            fail("the kernel and plain train steps disagree")
        parity[impl] = dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err,
                            kernel_step_s=tk, plain_step_s=tp, step_device_launches=step_launches)
    cfg.model.encoder.rnn_impl = "auto"
    routes = {impl: {k: v for k, v in r.items() if k not in ("solver", "batch")} for impl, r in runs.items()}
    return dict(routes=routes, sampled_steps=sampled, sampled_launches=sampled_launches, parity=parity)


def decode_phase(solver, batch, impl, lstm_fwd, smi):
    """The dev split decoded through ``Solver.exec`` with the BiLSTM layers
    on route ``impl``, the decode kernels' launch counts set to 0 just
    before and read just after; then the same batch with the kernels and
    with the plain versions on the card: top-beam scores within rel 1e-3 and
    identical top hypotheses."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import prefix_scores_fused
    from e2e_asr_tpu_torch.ops.att_step_cuda import att_step_beam_loc
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel

    solver.config.model.encoder.rnn_impl = impl
    solver.decode_batch(batch.wav, batch.wav_len)  # warm-up (cuBLAS/cuDNN handles)
    torch.cuda.synchronize()
    wrappers = {"log_mel": log_mel, lstm_fwd[0]: lstm_fwd[1],
                "att_step_beam_loc": att_step_beam_loc, "prefix_recursion": prefix_scores_fused}
    for fn in wrappers.values():
        fn.launches = 0
    solver.exec()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"decode path launches (rnn_impl {impl}): {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the decode path (rnn_impl {impl})")
    st = dict(solver.stats["dev"])
    rate = st["audio_sec"] / st["wall_s"]
    print(f"e2e (rnn_impl {impl}): {st['utts']} utts, {st['audio_sec']:.2f} audio-s in {st['wall_s']:.3f}s "
          f"wall = {rate:.2f} audio-s/s on {smi} (decode B=16 W=16, seed-{SEED} weights, cer {st['cer']:.3f})",
          flush=True)

    # device launches of one decoded batch and of one beam step (profiler)
    steps = solver.max_step_for(batch.wav.shape[1])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.decode_batch(batch.wav, batch.wav_len)
        torch.cuda.synchronize()
    batch_launches = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"decode launches (rnn_impl {impl}): {batch_launches} a batch of {steps} beam steps, "
          f"{batch_launches / steps:.1f} a step", flush=True)

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
    print(f"top-beam score max rel diff kernel vs plain (rnn_impl {impl}): {score_err:.3e} (tolerance "
          f"1e-3); identical top hypotheses {same}/16", flush=True)
    if score_err > 1e-3:
        fail("kernel decode and plain decode disagree on top-beam scores")
    # inputs and weights come from a seed and every kernel is deterministic,
    # so a differing top hypothesis is a fault, not a tie broken otherwise
    if same < 16:
        fail("kernel decode and plain decode differ in top hypotheses")
    return dict(launches=launches, e2e=st, audio_s_per_s=rate, top_score_rel_diff=score_err,
                identical_top=same, top_tokens=res_k.tokens[:, 0].cpu(), top_scores=sk,
                device_launches_a_batch=batch_launches, beam_steps=steps)


def main(json_path: str = "", parent: str = "") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from e2e_asr_tpu_torch import cuda_build
        from e2e_asr_tpu_torch.bin.profile_decode import (DECODE_PHASE_VARIANTS, FLAGSHIP, PHASE_VARIANTS,
                                                          smoke_solver)
        from e2e_asr_tpu_torch.device import resolve_device
        from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_bidir_fwd, lstm_seq_fwd
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
    logs = cuda_build.build_all(PHASE_VARIANTS + DECODE_PHASE_VARIANTS)  # the timing builds too
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
    kern.update(scan_kernel_checks(dev, cfg, solver.vocab_size))
    kern.update(lstm_seq_checks(dev))
    if parent:
        kern["prefix_recursion"]["parent_path"] = parent_prefix_path(parent)

    # ---- the serving path through the CLI's Solver, on the card, under
    # either LSTM route: the default first, then the fused-projection kernel
    batch = next(solver.eval_sets["dev"].epoch())
    if batch.wav.shape != (16, (816 - 1) * 160 + 400):
        fail(f"smoke batch has shape {batch.wav.shape}, expected 16 utterances in the 816 bucket")
    decode = {impl: decode_phase(solver, batch, impl, lstm_fwd, smi)
              for impl, lstm_fwd in (("auto", ("lstm_seq_fwd", lstm_seq_fwd)),
                                     ("pallas", ("lstm_bidir_fwd", lstm_bidir_fwd)))}
    cfg.model.encoder.rnn_impl = "auto"
    sa, sb = decode["auto"].pop("top_scores"), decode["pallas"].pop("top_scores")
    route_err = float(((sa - sb).abs() / sb.abs()).max())
    same = int((decode["auto"].pop("top_tokens") == decode["pallas"].pop("top_tokens")).all(-1).sum())
    print(f"top-beam score max rel diff between the two LSTM routes: {route_err:.3e} (tolerance 1e-3); "
          f"identical top hypotheses {same}/16", flush=True)
    if route_err > 1e-3:
        fail("the two LSTM routes decode to different top-beam scores")

    # ---- the training path
    train = train_phase(smi)
    conv = convergence_phase(dev, smi)

    # launches: every counted run that launched the kernel, by path, each
    # with its counts set to 0 just before; ``launches`` is the count of the
    # path named in ``launches_path``: a default-route run where the kernel
    # is on one (lstm_seq: the convergence recipe, whose first layer the
    # row's times are for), the pinned rnn_impl=pallas run for the
    # fused-projection LSTM kernels
    tr = train["routes"]
    paths = [
        ("flagship decode through bin/test_asr.Solver.exec, rnn_impl auto (default)", decode["auto"]["launches"]),
        (f"convergence recipe, {CONV_STEPS} steps + validation, rnn_impl auto (default)", conv["launches"]),
        (f"flagship train, {TRAIN_STEPS} steps + validation through bin/train_asr.Solver.exec, rnn_impl auto "
         "(default)", tr["auto"]["launches"]),
        ("flagship decode, rnn_impl pallas (pinned)", decode["pallas"]["launches"]),
        (f"flagship train, {TRAIN_STEPS} steps + validation, rnn_impl pallas (pinned)", tr["pallas"]["launches"]),
        ("flagship train, 2 steps at tf 0.5, rnn_impl auto (default)", train["sampled_launches"]),
    ]
    path_of = {"log_mel": 0, "att_step_beam_loc": 0, "prefix_recursion": 0, "lstm_seq_fwd": 1,
               "lstm_seq_bwd": 1, "ctc_loss": 2, "decoder_scan_fwd": 2, "decoder_scan_bwd": 2,
               "lstm_bidir_fwd": 3, "lstm_bidir_fwd_train": 4, "lstm_bidir_bwd": 4}
    rows = []
    for name, kv in kern.items():
        by_path = {what: cnt[name] for what, cnt in paths if name in cnt}
        first = paths[path_of[name]][0]
        rows.append({
            "name": name, "route": kv["route"], "source": kv["source"], "replaces": kv["replaces"],
            "launches": by_path[first], "max_abs_err": kv["max_abs_err"], "ms": kv["ms"],
            "plain_ms": kv["plain_ms"], "bound_ms": kv["bound"][0], "bound_by": kv["bound"][1],
            "library_ms": kv["library_ms"], "shapes": kv["shapes"], "launches_path": first,
            "launches_by_path": by_path,
            **{k: kv[k] for k in ("per_width", "per_shape", "layer_routes", "loss_fwd_bwd_ms",
                                  "launches_per_fwd_bwd", "device_launches_per_fwd_bwd",
                                  "ms_sampled", "ms_s764_l8", "phases_us", "grid", "alternating", "plan",
                                  "ms_s764", "repeats_bitwise", "host_sync",
                                  "parent_path")
                                  if k in kv},
        })
    out = json_path or os.path.join(cuda_build.BUILD_DIR, "chip_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": smi, "kernels": rows, "decode": decode, "decode_routes_score_rel_diff": route_err,
                   "train": train, "convergence": conv}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="chip smoke run of the PyTorch/CUDA port")
    ap.add_argument("--parent", default="", help="a checkout of the parent commit: time the CTC prefix side "
                    "of a beam step there and here, in turns")
    ap.add_argument("--json", default="", help="where to write the detailed JSON "
                    "(default: e2e_asr_tpu_torch/_build/chip_smoke.json)")
    args = ap.parse_args()
    main(args.json, args.parent)
