"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--parent DIR] [--json PATH]

1. Prints the card's name and power limit, builds every CUDA kernel from
   e2e_asr_tpu_torch/csrc/ (one nvcc per source, in parallel) and the
   native host library (csrc/native.cpp + flac.cpp, g++: edit distance,
   wav and FLAC input) and prints the build times.
2. Holds every kernel against its plain PyTorch version, each with its
   stated tolerance, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call: the log-mel kernel
   on a randn wave and on the decode batch's own waves (also against a
   float64 reference, beside a composed cuFFT yardstick; repeated bitwise,
   no host sync) and the decode kernels at the flagship decode shapes
   (configs/libri/asr_example.yaml model, decode B=16, W=16; the attention
   step also at S=764; both repeated bitwise and run once under the sync
   debug mode set to raise, each split by phase by its timing build); with
   ``--parent DIR``, a checkout of the parent commit, the CTC prefix side
   of a beam step is run there and here in turns; the
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
   by either kernel pair at five input widths; the pair with one direction
   at the LM's layer (T=256, B=32, H=512) beside a unidirectional cuDNN
   nn.LSTM. Each LSTM forward row carries its sweep's plan.
3. Drives the serving path: the flagship-width model from a fixed seed
   decodes 16 synthetic utterances in the 816-frame bucket (beam 16,
   ctc_weight 0.3, lm_weight 0) through ``bin/test_asr.Solver`` on the
   card, its beam steps replaying the CUDA graphs the solver captured for
   the bucket (decode/beam_graph.py; the capture time is printed), and
   checks that every decode kernel was launched in that run, the two
   decode kernels once a beam step. The same batch is then decoded through
   the graphs and through the eager loop (``graphs=False``): tokens,
   lengths and scores must be bitwise equal and the launch counts the
   same; the profiler counts the device launches and the launches the host
   issued of each. The batch is decoded with the kernels and with the plain
   versions on the card (eager loop): the top-beam scores must agree and
   the top hypotheses be identical. All of this runs twice: under the default LSTM route
   (``encoder.rnn_impl`` auto: one matmul + lstm_seq) and with the
   fused-projection kernel pinned (``rnn_impl`` pallas); the two routes'
   top-beam scores must agree too. Then the same batch with a seed-0 RNN-LM
   of configs/libri/lm_example.yaml's width fused in at
   decode_example.yaml's lm_weight 0.3 (ctc_weight 0.3), under both
   routes with the same checks, and one batch decoded without and with the
   LM in turns (wall, device busy time, launches).
4. Drives the training path: the flagship at full width from seed-0
   weights trains TRAIN_STEPS steps (batch 16 in the 816-frame bucket of
   the synthetic train split) through ``bin/train_asr.Solver.exec`` and
   validates once on dev, under the default LSTM route and again with the
   fused-projection pair pinned, its steps replaying the CUDA graph the
   solver captured for the bucket (training/step_graph.py; one capture a
   run, its time and the peak memory allocated printed) and its validation
   the graph of the dev bucket (training/eval_graph.py); every loss must
   be finite, no step skipped, every training kernel of the route launched
   in that run (the fused scan's two among them, counted on the replays),
   and the two routes' losses agree. Then ``graph_phase``: GRAPH_STEPS
   steps through the graphs against the eager step at flagship width,
   under both LSTM routes and at float32 and bf16 (loss, grad norm, every
   parameter and optimizer tensor bitwise, launch counts equal, coins
   failing from the second step on), the host-issued launches of one
   replayed step (fewer than 20) and one eager step under the sync debug
   mode set to raise. Then ``eval_graph_phase``: the dev epoch through the
   validation's graphs (a capture run, a replay) against the eager
   validation at flagship width, under both routes and dtypes (summary,
   tokens and CTC ids bitwise, launch counts equal, each run's wall), the
   capture's memory in the train graphs' pool against a pool of its own,
   the host-issued launches of a replayed dev batch (at most
   EVAL_HOST_LIMIT) and one eager validation under the sync debug mode. Two
   more steps run on the default route at tf_rate 0.5, so that coins fail
   and sampled tokens are fed back inside the scan. Then one train step
   with the kernels and one with the plain versions, from the same weights,
   batch and random stream, must agree in loss, gradient norm and the
   updated parameters, under either route; the profiler counts the device
   launches of a kernel step. Every launch count is read from counters set
   to 0 just before the run it belongs to.
   The LM's training path: configs/libri/lm_example.yaml at full width (512
   / 2 x 512 LSTM, tied, batch 32, Adam, clip 5) on synthetic transcripts,
   LM_STEPS steps and one validation through ``bin/train_lm.Solver.exec``,
   the step and the evaluation replaying CUDA graphs (training/lm_graph.py;
   the lstm_seq pair must have launched, losses finite, no step skipped,
   best_ppl written; captures and peak memory printed); the replayed LM
   step against the eager one bitwise over LM_GRAPH_STEPS steps with
   dropout and a non-finite step, and the host-issued launches of a
   replayed step (``lm_graph_check``); one LM step with the kernels against
   one with the plain versions (the train step's tolerances); one step
   timed at B=32 on random ids at L=256 and L=512, eager and graph.
5. Drives the convergence recipe (configs/synthetic_convergence.yaml, full
   width, BiLSTM layers through lstm_seq, tf_rate 0.8) for CONV_STEPS steps
   and one validation through ``bin/train_asr.Solver.exec``, after holding
   the log-mel kernel against its plain version and the float64 reference
   on the recipe's first batch (B=32, M=80): log_mel, the lstm_seq pair and
   the fused scan's pair must have launched, losses finite. With
   ``--parent DIR`` the parent's log-mel kernel runs on the randn, decode
   and convergence waves in turns with this one. Then the shipped recipes
   through the CLI, as shipped apart from their paths and run length:
   ``main --lm`` on configs/synthetic_lm_conv.yaml for RECIPE_LM_STEPS
   steps, then ``main --test`` on configs/synthetic_decode_conv.yaml with
   the convergence checkpoint and that LM's best_ppl fused in; both must end
   normally and the decode write output_dev.csv and output_test.csv.
   Every training path here takes its batches through the prefetcher
   (``data/prefetch.py``): the flagship and convergence runs gather them
   from the device-resident corpus (``device_cache`` auto), and each step's
   ``rd`` (the wait for its batch) is printed; the decodes print
   ``input_s``, the time they waited on the prefetcher.
6. The loader phase (``loader_phase``): the convergence recipe at full
   width on LOADER_UTTS training utterances, LOADER_STEPS steps through
   ``bin/train_asr.Solver.exec`` three ways in turns, (a) batches filled on
   the prefetch thread with no wave cache, streamed, (b) two loader threads
   with the wave cache, streamed, (c) the device-resident corpus; then the
   same utterances written as LibriSpeech-layout wav and FLAC trees, (d)
   the wav files through the int16 wave cache and (e) through one native
   ``pack_batch`` a batch, in turns d, e, e, d, (f) the FLAC files: each
   way's ``rd`` share, median audio-s/s, flat_corpus seconds and MB, host
   RSS; the first 8 device batches and step 1's loss must be equal across
   the ways, each way in the input mode and route it asked for; ways (b)
   and (c) then walk one whole epoch and print the loader's ``fill_factor``
   and ``bucket_counts``, which must agree.
7. The bfloat16 compute type, every shipped training recipe's
   ``hparas.dtype`` (the training phases above pin float32 and keep their
   float32 tolerances): each bf16 kernel variant (the lstm_seq pair, the
   fused-projection pair, the scan pair) against its bf16 plain version at
   the flagship and the convergence recipe's shapes
   (``bf16_kernel_checks``: bf16 outputs within one ulp of the tensor's
   scale on at most BF16_SHARE of the elements), timed beside its float32
   instantiation on the same values; then ``bf16_phase``: the flagship
   TRAIN_STEPS steps + validation through ``Solver.exec`` in bf16, every
   kernel of the path launched in its bf16 variant and no float32 variant
   but the validation's greedy decode's; one bf16 train step with kernels
   against plain versions under either LSTM route; the bf16-trained
   checkpoint decoded in float32 (kernels against plain versions, 16/16
   identical top hypotheses); the convergence recipe CONV_STEPS steps +
   validation in bf16. With ``--parent DIR`` the float32 instantiations of
   those kernels run there and here on the same seeded inputs and must be
   bitwise equal (``parent_f32``; the scan forward in its three feedback
   modes, the sampled one at one seed, which the parent passes as launch
   arguments and this tree in device memory; one float32 train step a
   route is compared too, beside the parent's own rerun).
8. Data parallelism (``ddp_phase``, parallel/dist.py), in processes of
   their own so that this one creates no group: (a) in a world-1 NCCL group
   ``Solver.exec`` trains DDP_STEPS flagship steps through the step graphs
   (the loss's denominators and the flat buffer of gradients and loss
   metrics all-reduced inside them) and validates through the eval graphs,
   in float32 and bf16, and the dev batch is decoded: each bitwise the same
   run without a group (summary, step log, parameters, csvs), with capture
   seconds and peak memory; (b) two gloo ranks sharing the card take one
   eager flagship step (encoder dropout, SpecAugment) against the one-rank
   step on the global batch here, within the kernel-versus-plain
   tolerances, the ranks' parameters bitwise equal; (c) a two-rank sharded
   decode over gloo writes the one-rank decode's top hypotheses; and the
   scan's Gumbel noise at a row offset is the global batch's rows'.
9. configs/libri/asr_960h.yaml (``recipe_960h_phase``), the recipe behind
   the reference's headline numbers, at its full widths (4 x 512 BiLSTM,
   512-wide speller, E = 1024), seed-0 weights, bf16, on synthetic wav
   files: one replayed train step under each encoder route on its
   416-frame bucket (B = 32) and its 3056-frame bucket (B = 16, S = 764,
   L = 520), each bitwise the eager step and within BF16_STEP_TOL of the
   plain step, every kernel of the route launched, wall and busy; the
   validation's replay bitwise the eager validation over two dev batches;
   the recipe's decode block with a seed-0 LM fused in (``decode_phase``).
   Every kernel at the recipe's shapes is held against its plain version
   and timed with its bound (``recipe_960h_kernel_checks``, and the "960h"
   shape of ``bf16_kernel_checks``): each kernel row carries it as
   ``recipe_960h``, with its launches in the phase's runs.
10. The encoder and speller variants (``variants_phase``) at the
   flagship's full widths, bf16, set by ``main``'s overrides (``VARIANTS``):
   V1 (CNN prenet, bidirectional GRU layers, GRU speller: the recurrences
   and the Python-loop speller plain, captured in the graphs) and V2 (VGG,
   one-direction LSTM layers through the lstm_seq pair, the fused scan with
   the embedding regularizer's loss): VARIANT_STEPS steps + validation
   through ``Solver.exec`` replaying their graphs (the att_align PNG
   written), one replayed step profiled (wall, busy, launches), the replay
   against the eager step and validation bitwise, the kernel step within
   BF16_STEP_TOL of the plain step; V1's GRU LM at lm_example.yaml's
   widths trained through its graphs and fused into a decode batch, V2 at
   ``emb_reg.fuse`` 0.3 taking the captured loop and decoding with it
   (``decode_phase``: graphs bitwise eager, kernels against plain versions,
   16/16 top hypotheses). Each kernel row gains ``launches_variants``.
11. The train step's stages (``stages_phase``, ``utils/stages.py``): for
   the flagship (B 16, 816-frame bucket) at float32 and bf16 and for
   configs/libri/asr_960h.yaml's 3056-frame bucket (B 16) at bf16, each
   stage program (features; encoder, CTC and speller value and gradient;
   the optimizer's update) captured from seed-0 weights and its replays
   timed against its ceiling (sol at most STAGE_SOL_MAX, each program
   launching its own kernels, STAGE_KERNELS), the stages' sum beside a replayed train step's
   busy; one replayed flagship bf16 step traced (``utils/profiling.trace``)
   and the trace must name the scan and lstm_seq kernels (TRACE_KERNELS).
12. Prints a ``kernels`` JSON line (each row names the path its ``launches``
   were counted on; the bf16 variants in rows of their own, ``_bf16``), then
   the device JSON line last; the details go to ``--json`` (default
   e2e_asr_tpu_torch/_build/chip_smoke.json).

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
import types
from contextlib import nullcontext
from unittest import mock

import numpy as np
import torch

# the card's peaks, bound_ms and each kernel's least work (bytes,
# operations): every float32 kernel's bound at the f32 rate, the bf16
# variants' at the bf16 tensor cores'; without the port the import fails
from e2e_asr_tpu_torch.utils import profiling

SEED = 0
TRAIN_STEPS = 5
ALT_ROUNDS = 21  # rounds of a kernel against its library call in turns
CONV_STEPS = 3
LM_STEPS = 10  # LM training steps at lm_example.yaml's width
RECIPE_LM_STEPS = 100  # synthetic_lm_conv.yaml's steps (it logs every 50)
NOISE_SEED = 20261016  # the scan checks' sampled feedback
LOADER_STEPS = 100  # the loader phase's steps a way (convergence recipe)
LOADER_UTTS = 1024  # its train split
# (way, loader threads, data.corpus fields, the input mode it must take): (a)
# is the input path before the loader was ported, bar the prefetch thread
LOADER_MODES = (("a", 0, {"device_cache": "off", "cache_bytes": 0}, "stream"),
                ("b", 2, {"device_cache": "off"}, "stream"),
                ("c", 2, {"device_cache": "on"}, "device_corpus"))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """``profiling.device_ms`` with two warm-up calls unless told otherwise,
    the warm-up every timing of this script has taken."""
    return profiling.device_ms(fn, iters, warmup)


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


def kernel_checks(dev, cfg, vocab, batch_wav):
    """Each kernel against its plain version at the flagship decode shapes
    (``batch_wav``: the decode batch's int16 waves)."""
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

    # ---- 1. log_mel: wav [B, N], a randn wave and the decode batch's own
    # (the synthetic corpus's int16 waves, scaled as compute_features does);
    # the convergence recipe's batch (B=32, M=80) is held in its phase
    print("[kernel] log_mel", flush=True)
    waves = {"randn": 0.1 * torch.randn((b, n), generator=gen, device=dev),
             "decode_batch": torch.from_numpy(batch_wav).to(dev).float() * (1.0 / 32768.0)}
    t = fec.n_log_mel_frames(n, win, shift)
    composed = composed_log_mel(a, win, shift, n_fft, dev)
    errs, cufft_errs, f64_errs = {}, {}, {}
    for name, x in waves.items():
        errs[name], cufft_errs[name], f64_errs[name] = log_mel_wave_check(name, x, a, dev)
    wav = waves["randn"]
    got = fec.log_mel(wav, a, win, shift, n_fft)
    mel_extra = _repeat_and_sync("log_mel", lambda: (fec.log_mel(wav, a, win, shift, n_fft),), (got,))
    mel = a.feat_dim
    nb, nf = profiling.log_mel_work(a, b, n, win, n_fft)
    out["log_mel"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/log_mel.cu",
        replaces="e2e_asr_tpu/ops/frontend_pallas.py:151", max_abs_err=max(errs.values()),
        max_abs_err_by_wave=errs,
        ms=time_ms(lambda: fec.log_mel(wav, a, win, shift, n_fft), 20),
        plain_ms=time_ms(lambda: fec.log_mel_plain(wav, a, win, shift, n_fft), 20),
        library_ms=None, cufft_ms=time_ms(lambda: composed(wav), 20), cufft_max_abs_err_by_wave=cufft_errs,
        f64_max_abs_err_by_wave=f64_errs,
        bound=profiling.bound_ms(nb, nf), shapes=f"wav [{b},{n}] -> [{b},{t},{mel}]", **mel_extra,
    )
    r = out["log_mel"]
    print(f"  log_mel: {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, cuFFT yardstick "
          f"{r['cufft_ms'] * 1e3:.2f} us, bound {r['bound'][0] * 1e3:.2f} us ({r['bound'][1]})", flush=True)
    r["parent_waves"] = {name: (x, a) for name, x in waves.items()}

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
        nb, nf = profiling.lstm_bidir_fwd_work(s_len, b, d, h, float(lens.sum()))
        with torch.no_grad():
            entries.append(dict(
                d=d, max_abs_err=err,
                ms=time_ms(lambda: rnn_cuda.lstm_bidir_fwd(*args), 10),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_bidir_fwd_plain(*args), 3, 1),
                library_ms=time_ms(lambda: lstm(x), 10), bound=profiling.bound_ms(nb, nf),
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
    nb, nf = profiling.att_step_work(args)
    out["att_step_beam_loc"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/att_step.cu",
        replaces="e2e_asr_tpu/ops/att_step_pallas.py:159", max_abs_err=err,
        ms=time_ms(lambda: asc.att_step_beam_loc(*args), 20),
        plain_ms=time_ms(lambda: asc.att_step_beam_loc_plain(*args), 20),
        library_ms=None, bound=profiling.bound_ms(nb, nf),
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
    nb, nf = profiling.prefix_work(pargs)
    out["prefix_recursion"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_prefix.cu",
        replaces="e2e_asr_tpu/decode/ctc_prefix_pallas.py:155", max_abs_err=err,
        ms=time_ms(lambda: cpc.prefix_scores_fused(*pargs), 20),
        plain_ms=time_ms(lambda: cpc.prefix_scores_fused_plain(*pargs), 3, 1),
        library_ms=None, bound=profiling.bound_ms(nb, nf),
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


def _in_turns(parent: str, script: str, argv=()) -> dict:
    """``script`` run in a process of its own over the package of the
    parent's checkout at ``parent`` and of this one, in turns (parent,
    change, change, parent): each tree's two runs (the JSON line each
    printed last) and, for each number, the median (the upper of the two)."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if which == "parent" else here
        proc = subprocess.run([sys.executable, "-c", script, *argv], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root}, timeout=600)
        if proc.returncode != 0:
            fail(f"the {which}'s run did not finish: {proc.stderr[-2000:]}")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    res = {}
    for which, rs in runs.items():
        res[which] = {key: sorted(r[key] for r in rs)[len(rs) // 2] if isinstance(rs[0][key], (int, float))
                      and not isinstance(rs[0][key], bool) else rs[0][key] for key in rs[0]}
        res[which]["runs"] = rs
    return res


def parent_prefix_path(parent: str) -> dict:
    """The CTC prefix side of a beam step (PREFIX_PATH) in the parent's
    checkout at ``parent`` and in this one, in turns."""
    res = _in_turns(parent, PREFIX_PATH)
    print(f"  CTC prefix side of a beam step, parent (prefix_scores + eos_score + gather) vs change "
          f"(prefix_scores_fused + gather): device {res['parent']['ms']:.4f} vs {res['change']['ms']:.4f} ms, "
          f"host {res['parent']['host_ms']:.3f} vs {res['change']['host_ms']:.3f} ms, launches "
          f"{res['parent']['launches']} vs {res['change']['launches']}", flush=True)
    return res


# A tree's log_mel on saved waves (argv[1]: a torch.save of {name: (wave,
# audio config)}), in a process of its own over the package of the tree at
# its working directory. Prints one JSON line: for each wave the kernel's
# max abs error against the plain version and its device ms a call.
LOG_MEL_PATH = """
import json, sys, torch
from e2e_asr_tpu_torch.bin.profile_decode import device_ms
from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.ops import frontend_cuda as fec
dev = resolve_device("cuda")
res = {}
for name, (wav, audio) in torch.load(sys.argv[1]).items():
    wav, cfg = wav.to(dev), AudioConfig(**audio)
    win, shift = int(cfg.sample_rate * cfg.frame_length / 1000), int(cfg.sample_rate * cfg.frame_shift / 1000)
    n_fft = 1 << (win - 1).bit_length()
    diff = fec.log_mel(wav, cfg, win, shift, n_fft).double() - fec.log_mel_plain(wav, cfg, win, shift, n_fft).double()
    res[f"{name}_max_abs_err"] = float(diff.abs().max())
    res[f"{name}_ms"] = device_ms(lambda: fec.log_mel(wav, cfg, win, shift, n_fft), 20, 2)
print(json.dumps(res))
"""


def parent_log_mel(parent: str, waves: dict) -> dict:
    """The parent's log_mel kernel and this one on the same waves ({name:
    (wave, audio config)}), in turns: device ms and max abs error against
    the plain version, per wave."""
    import dataclasses

    from e2e_asr_tpu_torch import cuda_build

    path = os.path.join(cuda_build.BUILD_DIR, "log_mel_waves.pt")
    torch.save({k: (x.cpu(), dataclasses.asdict(a)) for k, (x, a) in waves.items()}, path)
    res = _in_turns(parent, LOG_MEL_PATH, (path,))
    for name in waves:
        print(f"  log_mel ({name}), parent vs change: device {res['parent'][f'{name}_ms']:.4f} vs "
              f"{res['change'][f'{name}_ms']:.4f} ms, max abs err {res['parent'][f'{name}_max_abs_err']:.3e} vs "
              f"{res['change'][f'{name}_max_abs_err']:.3e}", flush=True)
    return res


# A tree's float32 training kernels (each kernel pair with a bf16 variant)
# on seeded inputs at the flagship's shapes, and one float32 flagship train
# step a LSTM route, in a process of its own over the package of the tree at
# its working directory; argv[1]: where to torch.save {name: [outputs]}.
F32_PATH = """
import inspect, os, sys, torch
from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.bin import profile_decode as pdm
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.ops import decoder_cuda as dc, rnn_cuda
from e2e_asr_tpu_torch.training.step import param_leaves
dev = resolve_device("cuda")
g = torch.Generator(device=dev)
g.manual_seed(7)
t, b, d, h = 204, 16, 1280, 320
lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
lens[0] = t
mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
m2 = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1)
rn = lambda *shape, sc=1.0: torch.randn(shape, generator=g, device=dev) * sc
xw, wh, x = rn(t, 2 * b, 4 * h, sc=0.5), rn(2, h, 4 * h, sc=h ** -0.5), torch.tanh(rn(t, b, d))
wx, bias, dy = rn(2, d, 4 * h, sc=h ** -0.5), rn(2, 4 * h, sc=0.1), rn(t, 2 * b, h, sc=h ** -0.5)
res = {}
with torch.no_grad():
    ys, c, acts = rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True)
    res["lstm_seq_fwd"] = [ys, c, acts]
    res["lstm_seq_bwd"] = list(rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy))
    f = rnn_cuda.lstm_bidir_fwd_train(x, mask, wx, wh, bias)
    res["lstm_bidir_fwd_train"] = list(f)
    res["lstm_bidir_bwd"] = list(rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, *f, dy))
    args, temp = pdm.flagship_scan_inputs(dev)
    l = args[-1].shape[0]
    for mode in ("teacher", "argmax", "sampled"):
        use = torch.ones(l, dtype=torch.bool) if mode == "teacher" else torch.zeros(l, dtype=torch.bool)
        # sampled: the seed as an int, which the parent passes as launch arguments
        lg, al, hd, rs = dc.decoder_scan_fwd(*args, use, temp, mode == "sampled", 20261016)
        res["decoder_scan_fwd_" + mode] = [lg, al, hd, *rs]
    lg, al, hd, cs, tk, ac, qs, cx = res["decoder_scan_fwd_teacher"]
    cots = [rn(*o.shape, sc=o.shape[-1] ** -0.5) for o in (lg, al, hd)]
    k, v, ln, taps, wq, _, wlp, locv, locb, _, wxs, whs, _, wout, _, _ = args
    res["decoder_scan_bwd"] = list(dc.decoder_scan_bwd(k, v, ln, taps, wq, wlp, locv, locb, wxs, whs, wout, al, hd, cs,
                                                       ac, qs, cx, *cots, temp))
kw = {"dtype": "float32"} if "dtype" in inspect.signature(pdm.smoke_train_solver).parameters else {}
for impl in ("auto", "pallas"):
    solver = pdm.smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "f32_" + impl), 0, 1, rnn_impl=impl, **kw)
    batch = solver._put(next(solver.tr_set.epoch(0)))
    m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0))
    res["train_step_" + impl] = [p.detach() for p in param_leaves(solver.state.params)] + [m["loss"], m["grad_norm"]]
torch.save({n: [a.cpu() for a in v] for n, v in res.items()}, sys.argv[1])
print("{}")
"""


def parent_f32(parent: str) -> dict:
    """The float32 instantiations of the kernels that gained a bf16 variant,
    run in the parent's checkout at ``parent`` and in this one on the same
    seeded inputs: every output must be bitwise equal; and one float32
    flagship train step a route, whose max abs difference is printed beside
    the parent's own from a second run (cuDNN's and index_add_'s atomics
    make a whole step differ run to run)."""
    from e2e_asr_tpu_torch import cuda_build

    here = os.path.dirname(os.path.abspath(__file__))
    outs = {}
    for which, root in (("parent", os.path.abspath(parent)), ("change", here), ("parent_again", os.path.abspath(parent))):
        path = os.path.join(cuda_build.BUILD_DIR, f"f32_{which}.pt")
        proc = subprocess.run([sys.executable, "-c", F32_PATH, path], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root}, timeout=600)
        if proc.returncode != 0:
            fail(f"the {which}'s float32 run did not finish: {proc.stderr[-2000:]}")
        outs[which] = torch.load(path)
    res = {}
    for name, want in outs["parent"].items():
        got, again = outs["change"][name], outs["parent_again"][name]
        diff = lambda xs: max(float((a.double() - c.double()).abs().max()) for a, c in zip(xs, want))
        res[name] = dict(bitwise=all(torch.equal(a, c) for a, c in zip(got, want)), max_abs=diff(got),
                         parent_rerun_max_abs=diff(again))
        print(f"  float32 {name}, change vs parent: bitwise {res[name]['bitwise']} (max abs diff "
              f"{res[name]['max_abs']:.3e}; the parent against its own rerun {res[name]['parent_rerun_max_abs']:.3e})",
              flush=True)
        if not name.startswith("train_step") and not res[name]["bitwise"]:
            fail(f"the float32 {name} is not bitwise the parent's")
    return res


def composed_log_mel(audio, win, shift, n_fft, dev, dtype=torch.float32):
    """The log-mel function composed of PyTorch calls in ``dtype``, used
    nowhere in the port: in float32 a yardstick timed beside the kernel, in
    float64 the reference both the kernel and its plain version are held
    to. The frames, their mean, pre-emphasis and window, ``torch.fft.rfft``
    (cuFFT), the power, the dense mel product and the log."""
    import torch.nn.functional as F

    from e2e_asr_tpu_torch.ops import frontend as fe
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec

    window = fe.const(fe.feature_window(audio.window, win), dev).to(dtype)
    fb = fe.const(fe.mel_filterbank(audio.feat_dim, n_fft, audio.sample_rate, audio.low_freq, audio.high_freq),
                  dev).to(dtype)
    p = max(float(audio.preemphasis), 0.0)

    def composed(wav):
        t = fec.n_log_mel_frames(wav.shape[1], win, shift)
        need = (t - 1) * shift + win
        x = F.pad(wav, (0, need - wav.shape[1])) if need > wav.shape[1] else wav[:, :need]
        d = x.to(dtype).unfold(-1, win, shift)
        d = d - d.mean(-1, keepdim=True)
        y = torch.cat([(1 - p) * d[..., :1], d[..., 1:] - p * d[..., :-1]], -1) * window
        spec = torch.fft.rfft(y, n=n_fft)
        return torch.log(torch.clamp((spec.real * spec.real + spec.imag * spec.imag) @ fb, min=fe.LOG_FLOOR))

    return composed


def log_mel_wave_check(name, x, audio, dev):
    """log_mel on wave ``x`` [B, N] f32 under ``audio``: the kernel and the
    composed cuFFT yardstick against the plain version (rtol 1e-3, atol
    2e-3), and the kernel and the plain version against the float64
    reference. Returns (kernel's max abs error, the yardstick's, {kernel,
    plain: max abs error against float64})."""
    from e2e_asr_tpu_torch.ops import frontend as fe
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec

    win = int(audio.sample_rate * audio.frame_length / 1000)
    shift = int(audio.sample_rate * audio.frame_shift / 1000)
    n_fft = fe.next_pow2(win)
    m = f"M={audio.feat_dim}, B={x.shape[0]}"
    got, want = fec.log_mel(x, audio, win, shift, n_fft), fec.log_mel_plain(x, audio, win, shift, n_fft)
    err = compare(f"log_mel ({name}, {m})", got, want, rtol=1e-3, atol=2e-3)
    cufft_err = compare(f"log_mel cuFFT yardstick ({name}, {m})",
                        composed_log_mel(audio, win, shift, n_fft, dev)(x), want, rtol=1e-3, atol=2e-3)
    ref = composed_log_mel(audio, win, shift, n_fft, dev, torch.float64)(x)
    f64 = {"kernel": float((got.double() - ref).abs().max()), "plain": float((want.double() - ref).abs().max())}
    print(f"  log_mel ({name}, {m}) against the float64 reference: kernel {f64['kernel']:.3e}, "
          f"plain version {f64['plain']:.3e}", flush=True)
    return err, cufft_err, f64


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
        sweep_ms=time_ms(lambda: rnn_cuda._sweep(mask, wh, c, acts, dy, dg, dg, t, b, 2, h, 0), iters),
        products_ms=time_ms(lambda: rnn_cuda._bidir_products(x, wx, ys, dg, dg, *outs), iters),
        sweep_grid=dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks", "piece"),
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
    valid = float(lens.sum())  # valid rows of one direction
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
        io, nf = profiling.lstm_bidir_fwd_work(s_len, b, d, h, valid, train=True)
        with torch.no_grad():
            f_ms = time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train(*args), 10)
            f_plain = time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train_plain(*args), 3, 1)
            f_parts = _bidir_fwd_parts(*args)
            if not all(torch.equal(p, q) for p, q in zip(got, rnn_cuda.lstm_bidir_fwd_train(*args))):
                fail(f"lstm_bidir_fwd_train D={d}: two runs on the same inputs differ")
        print(f"  lstm_bidir_fwd_train D={d}: {f_ms:.3f} ms = projection {f_parts['projection_ms']:.3f} ms + "
              f"sweep {f_parts['sweep_ms']:.3f} ms (plan {_fwd_plan(b, h, dev)}); repeats bitwise", flush=True)
        fwd.append(dict(d=d, max_abs_err=err, ms=f_ms, plain_ms=f_plain,
                        library_ms=time_ms(lambda: lstm(xg), 10), bound=profiling.bound_ms(io, nf), **f_parts))

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
        io, nf = profiling.lstm_bidir_bwd_work(s_len, b, d, h, valid)
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
                        bound=profiling.bound_ms(io, nf), **parts))

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
        device_launches[nm] = profiling.device_launches(prof)
    alt = alternating_ms({"kernel": loss_grad, "library": library})
    print(f"  ctc_loss: {per_call} kernel launch per CTCLossFn forward + backward; device launches "
          f"{device_launches['kernel']} (F.ctc_loss {device_launches['library']}); no host sync", flush=True)
    print(f"  alternating rounds ({ALT_ROUNDS}, median): ctc_loss forward + backward {alt['kernel']:.3f} ms vs "
          f"F.ctc_loss {alt['library']:.3f} ms (ratio {alt['kernel'] / alt['library']:.3f})", flush=True)
    io, nf = profiling.ctc_work(lp, labels, inlen, lablen)
    out["ctc_loss"] = dict(
        route="cuda", source="e2e_asr_tpu_torch/csrc/ctc_loss.cu",
        replaces="e2e_asr_tpu/ops/ctc_pallas.py:170", max_abs_err=err,
        ms=time_ms(lambda: ctc_cuda.ctc_lattice(lp, labels, inlen, lablen), 20),
        plain_ms=time_ms(lambda: ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen), 3, 1),
        library_ms=time_ms(library, 10), bound=profiling.bound_ms(io, nf),
        loss_fwd_bwd_ms=time_ms(loss_grad, 10), launches_per_fwd_bwd=per_call,
        device_launches_per_fwd_bwd=device_launches,
        alternating={"ms": alt["kernel"], "library_ms": alt["library"]},
        shapes=f"log_probs [{b},{s_len},{vocab}], labels [{b},{l_max}] (S {2 * l_max + 1}), int64; "
               "ms: the kernel (nll + G); library_ms: F.ctc_loss forward + backward; "
               "loss_fwd_bwd_ms: CTCLossFn forward + backward",
    )
    return out


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


BF16_ULPS = 1.0  # bf16 outputs both versions round alike: at most one bf16 ulp of the tensor's scale apart ...
BF16_SHARE = 0.15  # ... on at most this share of its elements


def _ulps(got, want):
    """(the largest |got - want| in bf16 ulps at want's scale, i.e. of its
    largest magnitude, the share of elements that differ)."""
    g, w = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(max(float(w.abs().max()), 2.0 ** -126))) - 7)
    return float((g - w).abs().max()) / ulp, float((g != w).float().mean())


def _bf16_state(name, got, want):
    """A bf16 output that the kernel and its plain version round alike: at
    most BF16_ULPS ulp of the tensor's scale apart on at most BF16_SHARE of
    its elements. Float32 sums in another order and FMA contraction flip a
    rounding now and then, and in a recurrence each flip carries to later
    steps: 1-10% of the state at one ulp on this card's shapes; leaving one
    rounding point out moves more than BF16_SHARE of it
    (tests/test_torch_bf16.py::test_a_left_out_rounding_point_is_told_apart_from_noise).
    Returns the max abs error."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        fail(f"{name}: {got.dtype} / {want.dtype}, expected bfloat16 from both versions")
    mx, share = _ulps(got, want)
    err = float((got.float() - want.float()).abs().max())
    print(f"  {name}: max abs err {err:.3e} = {mx:.2f} bf16 ulp at the tensor's scale, {100 * share:.3f}% of "
          f"elements differ (tolerance {BF16_ULPS} ulp on {100 * BF16_SHARE}%)", flush=True)
    if not (mx <= BF16_ULPS and share <= BF16_SHARE) or not bool(torch.isfinite(got.float()).all()):
        fail(f"{name} disagrees with its plain version")
    return err


# (T, B, D, H) of the bf16 LSTM layer checks: the flagship's, the
# convergence recipe's, asr_960h.yaml's longest bucket, and the ESPnet
# recipe's (5 x 1024 BLSTM after VGG2L's 2,560: B 20 and B 10 past 800
# input frames, here both at its longest utterances' 764 frames; the
# backward sweep stages a step's dgates in pieces there). The ESPnet layers
# take the lstm_seq pair alone (ops/rnn.py ``auto``).
BF16_LSTM_SHAPES = (("flagship", (204, 16, 1280, 320)), ("convergence", (816, 32, 80, 256)),
                    ("960h", (764, 16, 1280, 512)), ("espnet_b10", (764, 10, 2560, 1024)),
                    ("espnet_b20", (764, 20, 2560, 1024)))


def bf16_kernel_checks(dev, cfg, vocab):
    """Each bf16 kernel variant against its bf16 plain version (the plain
    version on the card with use_plain patched), at the flagship training
    shapes (LSTM layer T=204, B=16, H=320, D=1280; the scan at B=16, S=204,
    L=200) and the convergence recipe's (T=816, B=32, H=256, D=80; the scan
    at B=32, S=204, L=72), the LSTM layer also at BF16_LSTM_SHAPES' others:
    every bf16 output within BF16_ULPS on BF16_SHARE
    (``_bf16_state``), the forwards' float32 residuals (acts, q, ctx) at
    scaled rtol 1e-3 (their bf16 inputs differ where a rounding flipped),
    the scan backward's float32 outputs, from the same inputs on both
    sides, at scaled rtol 1e-4 as in float32. Times the bf16 kernel, its float32 instantiation on
    the same values and the bf16 plain version."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import RECIPE_960H, flagship_scan_inputs, scan_inputs, scan_shape
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc
    from e2e_asr_tpu_torch.ops import rnn_cuda

    bf = torch.bfloat16
    plain = lambda: mock.patch.object(cuda_build, "use_plain", lambda x: True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    rows = {n: dict(per_shape={}) for n in ("lstm_seq_fwd", "lstm_seq_bwd", "lstm_bidir_fwd_train",
                                            "lstm_bidir_bwd", "decoder_scan_fwd", "decoder_scan_bwd")}

    def record(name, shape, err, ms, ms_f32, plain_ms, bound, library_ms=None):
        rows[name]["per_shape"][shape] = dict(max_abs_err=err, ms=ms, ms_f32=ms_f32, plain_ms=plain_ms,
                                              bound=bound, library_ms=library_ms)
        print(f"  {name} bf16 [{shape}]: {ms:.3f} ms (float32 instantiation {ms_f32:.3f} ms), plain "
              f"{plain_ms:.3f} ms, library {library_ms if library_ms is None else round(library_ms, 3)} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)

    with torch.no_grad():
        for shape, (t, b, d, h) in BF16_LSTM_SHAPES:
            lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
            lens[0] = t
            x, mask, wx, wh, bias = _lstm_inputs(gen, dev, t, b, d, h, lens)
            xs, wxs, whs, bs = (a.to(bf) for a in (x, wx, wh, bias))
            r = 2 * b
            m2 = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1)
            valid = float(lens.sum())
            print(f"[kernel] bf16 lstm_seq pair [{shape}]: T={t}, B={b}, H={h}", flush=True)
            xw = (torch.randn((t, r, 4 * h), generator=gen, device=dev) * 0.5).to(bf)
            dy = (torch.randn((t, r, h), generator=gen, device=dev) / math.sqrt(h)).to(bf)
            got = rnn_cuda.lstm_seq_fwd(xw, m2, whs, train=True)
            with plain():
                want = rnn_cuda.lstm_seq_fwd(xw, m2, whs, train=True)
            if got[2].dtype != torch.float32:
                fail("lstm_seq_fwd bf16: acts are not float32")
            err = max(_bf16_state(f"lstm_seq_fwd bf16 {n} [{shape}]", g, w) for n, g, w in zip(("ys", "c"), got, want))
            err = max(err, _scaled(f"lstm_seq_fwd bf16 acts [{shape}]", got[2], want[2], 1e-3))
            lib = _cudnn_lstm(dev, wx, wh, bias).to(bf)
            record("lstm_seq_fwd", shape, err, time_ms(lambda: rnn_cuda.lstm_seq_fwd(xw, m2, whs, train=True), 5),
                   time_ms(lambda: rnn_cuda.lstm_seq_fwd(xw.float(), m2, whs.float(), train=True), 5),
                   time_ms(lambda: rnn_cuda.lstm_seq_fwd_plain(xw, m2, whs), 1, 0),
                   profiling.bound_ms(*profiling.lstm_seq_fwd_work(t, b, h, valid, 2, bf), bf), time_ms(lambda: lib(xs), 5))
            ys, c, acts = got
            gb = rnn_cuda.lstm_seq_bwd(m2, whs, ys, c, acts, dy)
            with plain():
                wb = rnn_cuda.lstm_seq_bwd(m2, whs, ys, c, acts, dy)
            err = max(_bf16_state(f"lstm_seq_bwd bf16 {n} [{shape}]", g, w)
                      for n, g, w in zip(("dxw", "dwh"), gb, wb))
            f32 = [a.float() for a in (whs, ys, c, dy)]
            xl = xs.clone().requires_grad_()
            with torch.enable_grad():
                out_l = lib(xl)[0]
            record("lstm_seq_bwd", shape, err, time_ms(lambda: rnn_cuda.lstm_seq_bwd(m2, whs, ys, c, acts, dy), 5),
                   time_ms(lambda: rnn_cuda.lstm_seq_bwd(m2, f32[0], f32[1], f32[2], acts, f32[3]), 5),
                   time_ms(lambda: rnn_cuda.lstm_seq_bwd_plain(m2, whs, ys, c, acts, dy), 1, 0),
                   profiling.bound_ms(*profiling.lstm_seq_bwd_work(t, b, h, valid, 2, bf), bf),
                   time_ms(lambda: torch.autograd.grad(out_l, [xl] + list(lib.parameters()), dy[:, :b].repeat(
                       1, 1, 2), retain_graph=True), 3))
            if shape.startswith("espnet"):
                continue

            print(f"[kernel] bf16 lstm_bidir pair [{shape}]: T={t}, B={b}, D={d}, H={h}", flush=True)
            got = rnn_cuda.lstm_bidir_fwd_train(xs, mask, wxs, whs, bs)
            with plain():
                want = rnn_cuda.lstm_bidir_fwd_train(xs, mask, wxs, whs, bs)
            err = max(_bf16_state(f"lstm_bidir_fwd_train bf16 {n} [{shape}]", g, w)
                      for n, g, w in zip(("ys", "c", "acts"), got, want))
            record("lstm_bidir_fwd_train", shape, err,
                   time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train(xs, mask, wxs, whs, bs), 5),
                   time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train(*(a.float() for a in (xs, mask, wxs, whs, bs))), 5),
                   time_ms(lambda: rnn_cuda.lstm_bidir_fwd_train_plain(xs, mask, wxs, whs, bs), 1, 0),
                   profiling.bound_ms(*profiling.lstm_bidir_fwd_work(t, b, d, h, valid, True, bf), bf),
                   time_ms(lambda: lib(xs), 5))
            ys, c, acts = got
            dyb = (torch.randn((t, r, h), generator=gen, device=dev) / math.sqrt(h)).to(bf)
            gb = rnn_cuda.lstm_bidir_bwd(xs, mask, wxs, whs, ys, c, acts, dyb)
            with plain():
                wb = rnn_cuda.lstm_bidir_bwd(xs, mask, wxs, whs, ys, c, acts, dyb)
            err = max(_bf16_state(f"lstm_bidir_bwd bf16 {n} [{shape}]", g, w)
                      for n, g, w in zip(("dx", "dwx", "dwh", "db"), gb, wb))
            record("lstm_bidir_bwd", shape, err,
                   time_ms(lambda: rnn_cuda.lstm_bidir_bwd(xs, mask, wxs, whs, ys, c, acts, dyb), 5),
                   time_ms(lambda: rnn_cuda.lstm_bidir_bwd(*(a.float() for a in (xs, mask, wxs, whs, ys, c, acts, dyb))), 5),
                   time_ms(lambda: rnn_cuda.lstm_bidir_bwd_plain(xs, mask, wxs, whs, ys, c, acts, dyb), 1, 0),
                   profiling.bound_ms(*profiling.lstm_bidir_bwd_work(t, b, d, h, valid, bf), bf),
                   time_ms(lambda: torch.autograd.grad(out_l, [xl] + list(lib.parameters()), dyb[:, :b].repeat(
                       1, 1, 2), retain_graph=True), 3))

        # the scan pair at the flagship's and the convergence recipe's shapes
        conv_gen = torch.Generator(device=dev)
        conv_gen.manual_seed(SEED + 13)
        f_args, temp = flagship_scan_inputs(dev)
        ccfg = _convergence_config()
        m, ac = ccfg.model, ccfg.model.attention
        cb, cs, cl = ccfg.data.corpus.batch_size, ccfg.data.corpus.buckets[-1] // 4, ccfg.data.corpus.token_buckets[-1]
        clens = torch.randint(cs // 2, cs + 1, (cb,), generator=conv_gen, device=dev)
        clens[0] = cs
        c_args = scan_inputs(conv_gen, dev, cb, cs, ac.dim, 2 * m.encoder.dim[-1], ac.loc_kernel_num,
                             2 * ac.loc_kernel_size + 1, m.decoder.dim, m.decoder.dim, vocab, cl, clens)
        # configs/libri/asr_960h.yaml's longest bucket: B = 16, S = 764, L = 520,
        # Dk 300, E = 1024, 10 x 201 taps, H = 512 (the kernels' MAX_H)
        hcfg = Config.load(RECIPE_960H)
        hm, ha, hc = hcfg.model, hcfg.model.attention, hcfg.data.corpus
        hb, hs, hl = hc.batch_size // 2, hc.buckets[-1] // 4, hc.token_buckets[-1]
        hlens = torch.randint(hs // 2, hs + 1, (hb,), generator=conv_gen, device=dev)
        hlens[0] = hs
        h_args = scan_inputs(conv_gen, dev, hb, hs, ha.dim, 2 * hm.encoder.dim[-1], ha.loc_kernel_num,
                             2 * ha.loc_kernel_size + 1, hm.decoder.dim, hm.decoder.dim, vocab, hl, hlens)
        for shape, args, tp in (("flagship", f_args, temp), ("convergence", c_args, float(ac.temperature)),
                                ("960h", h_args, float(ha.temperature))):
            sargs = tuple(a.to(bf) if a.is_floating_point() else a for a in args)
            b, s, dk, e_dim, kk, p, h, v = scan_shape(sargs)
            l = sargs[-1].shape[0]
            print(f"[kernel] bf16 decoder_scan pair [{shape}]: B={b}, S={s}, L={l}, H={h}, V={v}", flush=True)
            err = 0.0
            # the 960 h recipe's L = 520 teacher-forced only (its tf_start is 1.0);
            # its float32 residuals carry the bf16 state's flipped roundings
            # over 520 steps (``_carried``)
            for mode in ("teacher",) if shape == "960h" else ("teacher", "argmax"):
                use = torch.ones(l, dtype=torch.bool) if mode == "teacher" else torch.zeros(l, dtype=torch.bool)
                got = dc.decoder_scan_fwd(*sargs, use, tp)
                with plain():
                    want = dc.decoder_scan_fwd(*sargs, use, tp)
                err = max(err, _compare_scan_fwd_bf16(f"decoder_scan_fwd bf16 {mode} [{shape}]", got, want,
                                                      carried=shape == "960h"))
            use = torch.ones(l, dtype=torch.bool)
            fwd_out = dc.decoder_scan_fwd(*sargs, use, tp)
            dims = (b, s, dk, e_dim, kk, p, h, sargs[9].shape[1], v, l, sargs[2].tolist())
            f32_args = tuple(a.float() if a.is_floating_point() else a for a in sargs)
            record("decoder_scan_fwd", shape, err, time_ms(lambda: dc.decoder_scan_fwd(*sargs, use, tp), 3),
                   time_ms(lambda: dc.decoder_scan_fwd(*f32_args, use, tp), 3),
                   time_ms(lambda: dc.decoder_scan_fwd_plain(*sargs, use, tp), 1, 0),
                   profiling.bound_ms(*profiling.decoder_scan_fwd_work(*dims, bf), bf))
            logits, align, hidden, (cseq, _, acts, qs, ctxs) = fwd_out
            cots = [(torch.randn(o.shape, generator=gen, device=dev) / math.sqrt(o.shape[-1])).to(bf)
                    for o in (logits, align, hidden)]
            k, vv, lens, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = sargs
            # the context of the stored alignment, as DecoderScanFn passes it at bf16
            ctx_r = torch.einsum("lbs,bse->lbe", align.float(), vv.float())
            bargs = (k, vv, lens, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
                     ctx_r, *cots, tp)
            gb = dc.decoder_scan_bwd(*bargs)
            with plain():
                wb = dc.decoder_scan_bwd(*bargs)
            err_b = max(_scaled(f"decoder_scan_bwd bf16 {n} [{shape}]", g, w, 1e-4)
                        for n, g, w in zip(("dgates", "dq", "dfpre", "dk", "dWlp", "dlocv"), gb, wb))
            fb = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in bargs)
            record("decoder_scan_bwd", shape, err_b, time_ms(lambda: dc.decoder_scan_bwd(*bargs), 3),
                   time_ms(lambda: dc.decoder_scan_bwd(*fb), 3),
                   time_ms(lambda: dc.decoder_scan_bwd_plain(*bargs), 1, 0),
                   profiling.bound_ms(*profiling.decoder_scan_bwd_work(*dims, bf), bf))
    for name, row in rows.items():
        f = row["per_shape"]["flagship"]
        row.update(route="cuda", max_abs_err=max(v["max_abs_err"] for v in row["per_shape"].values()),
                   ms=f["ms"], plain_ms=f["plain_ms"], bound=f["bound"], library_ms=f["library_ms"],
                   ms_f32=f["ms_f32"],
                   shapes="flagship (rows' numbers), the other LSTM shapes and the scan's (per_shape)")
    return rows


def _carried(name, got, want):
    """A float32 output computed from a long bf16 recurrence's state (the
    960 h recipe's scan residuals over L = 520 steps): within scaled rtol
    1e-3 but on at most BF16_SHARE of its elements, and within BF16_ULPS
    bf16 ulp of the tensor's scale on all of them. A rounding of the bf16
    state that the two versions take apart carries into every later step's
    float32 products by about an ulp of the state: over the flagship's 200
    steps no element goes past 1e-3, over 520 at E = 1024 a few do. Returns
    the max abs error."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -126))) - 7)
    diff = (g - w).abs()
    err, over = float(diff.max()), float((diff > 1e-3 * (scale + w.abs())).float().mean())
    print(f"  {name}: max abs err {err:.3e} = {err / ulp:.2f} bf16 ulp at the tensor's scale, {100 * over:.4f}% of "
          f"elements past scaled rtol 1e-3 (tolerance {BF16_ULPS} ulp; {100 * BF16_SHARE}%)", flush=True)
    if not (err <= BF16_ULPS * ulp and over <= BF16_SHARE):
        fail(f"{name} disagrees with its plain version")
    return err


def _compare_scan_fwd_bf16(name, got, want, carried=False):
    """``_compare_scan_fwd`` at bf16: where an utterance's fed tokens first
    differ, the plain version's two scores must lie within two bf16 ulps of
    the logits' scale (the argmax is taken of the float32 logits, whose bf16
    state may differ by an ulp), that utterance's later steps are left out;
    then every bf16 output within ``_bf16_state``'s tolerance and the
    float32 residuals at scaled rtol 1e-3 (``carried``: ``_carried``'s
    criterion). Returns the largest error."""
    (lg, al, hd, (cs, tk, ac, qs, cx)), (lg_p, al_p, hd_p, (cs_p, tk_p, ac_p, qs_p, cx_p)) = got, want
    l, b = tk.shape
    keep = torch.ones((l, b), dtype=torch.bool, device=tk.device)
    diff = tk != tk_p
    tie_tol = 2 * 2.0 ** (math.floor(math.log2(float(lg_p.float().abs().max()))) - 7)
    for row in torch.nonzero(diff.any(0))[:, 0].tolist():
        t = int(torch.nonzero(diff[:, row])[0, 0])
        sc = lg_p[t - 1, row].float()
        gap = float((sc[tk_p[t, row]] - sc[tk[t, row]]).abs())
        print(f"  {name}: utterance {row} feeds {int(tk[t, row])} vs {int(tk_p[t, row])} at step {t}, "
              f"score gap {gap:.2e} (tie within {tie_tol:.2e})", flush=True)
        if gap > tie_tol:
            fail(f"{name}: fed tokens differ without a near-tie")
        keep[t:, row] = False
    if int((~keep).sum()) > l * b // 4:
        fail(f"{name}: more than a quarter of the steps left the plain version's path")
    err = max(_bf16_state(f"{name} {nm}", g[keep], w[keep])
              for nm, g, w in (("logits", lg, lg_p), ("align", al, al_p), ("hidden", hd, hd_p), ("c", cs, cs_p)))
    check = _carried if carried else lambda n, g, w: _scaled(n, g, w, 1e-3)
    return max([err] + [check(f"{name} {nm}", g[keep], w[keep])
                        for nm, g, w in (("acts", ac, ac_p), ("q", qs, qs_p), ("ctx", cx, cx_p))])


def _convergence_config():
    """configs/synthetic_convergence.yaml as the port reads it."""
    from e2e_asr_tpu_torch.config import Config

    return Config.load("configs/synthetic_convergence.yaml")


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
    resident_bwd = {cl: dc.resident_clusters("bwd", cl) for cl in dc.BWD_CLUSTER_SIZES}
    gb, sms = grid["bwd"], torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"fused scan grid: resident clusters by cluster size (cudaOccupancyMaxActiveClusters at "
          f"{dc.SMEM_MAX} B a block) forward {resident}, backward {resident_bwd}; grid used: forward "
          f"{grid['fwd']}; backward {gb}", flush=True)
    print(f"fused scan backward plan: {gb['clusters']} clusters of {gb['cluster_size']}, {gb['slots']} "
          f"slot(s), at most {gb['frames']} frames a block, {gb['frame_blocks']} of the card's {sms} SMs "
          f"holding frames; resident: " + ", ".join(r for r in dc.BWD_RESIDENTS if gb[r]), flush=True)
    err, err_b, bargs, cots = _scan_parity(gen, dev, args, vocab, temp, "flagship shapes")
    seed = NOISE_SEED
    out = {}
    with torch.no_grad():
        use = torch.ones(l, dtype=torch.bool)
        dims = (b, s, dk, e_dim, kk, p, h, emb, vocab, l, lens.tolist())
        out["decoder_scan_fwd"] = dict(
            route="cuda", source="e2e_asr_tpu_torch/csrc/decoder_scan.cu",
            replaces="e2e_asr_tpu/ops/decoder_pallas.py:226", max_abs_err=err,
            ms=time_ms(lambda: dc.decoder_scan_fwd(*args, use, temp), 5),
            ms_sampled=time_ms(lambda: dc.decoder_scan_fwd(*args, ~use, temp, True, seed), 5),
            plain_ms=time_ms(lambda: dc.decoder_scan_fwd_plain(*args, use, temp), 2, 1),
            library_ms=None, bound=profiling.bound_ms(*profiling.decoder_scan_fwd_work(*dims)),
            shapes=f"k [{b},{s},{dk}], v [{b},{s},{e_dim}], taps [{kk},{p}], H {h}, V {vocab}, L {l} "
                   "(ms: teacher-forced; ms_sampled: every step feeds a sampled token back; no "
                   "single PyTorch call computes a location-attention speller scan)",
        )

        out["decoder_scan_bwd"] = dict(
            route="cuda", source="e2e_asr_tpu_torch/csrc/decoder_scan_bwd.cu",
            replaces="e2e_asr_tpu/ops/decoder_pallas.py:482", max_abs_err=err_b,
            ms=time_ms(lambda: dc.decoder_scan_bwd(*bargs), 5),
            plain_ms=time_ms(lambda: dc.decoder_scan_bwd_plain(*bargs), 2, 1),
            library_ms=None, bound=profiling.bound_ms(*profiling.decoder_scan_bwd_work(*dims)),
            shapes=f"as decoder_scan_fwd; cotangents of logits, align, hidden (ms: the sweep "
                   "kernel alone, without the contractions outside it)",
        )

        # one step of each kernel split into its phases (the timing build)
        split = scan_phase_split(args, use, temp, cots)
        print_scan_phases(split)
        for w in ("fwd", "bwd"):
            out[f"decoder_scan_{w}"]["phases_us"] = split[w]
            out[f"decoder_scan_{w}"]["grid"] = {**grid[w], "resident_clusters_by_size":
                                                resident if w == "fwd" else resident_bwd}

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
        valid = float(lens.sum())
        with torch.no_grad():
            # the sweep alone, its outputs allocated outside
            f_out = [torch.empty_like(v) for v in want]
            fwd.append(dict(
                t=t, b=b, h=h, max_abs_err=err, bound=profiling.bound_ms(*profiling.lstm_seq_fwd_work(t, b, h, valid)),
                ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True), 5),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh), 2, 1),
                sweep_ms=time_ms(lambda: rnn_cuda._fwd_sweep(xw, m2, wh, *f_out, t, b, 2, h, 1, True), 5),
                plan=_fwd_plan(b, h, dev)))
            dxw, dwh = torch.empty_like(acts), torch.empty_like(wh)
            bwd.append(dict(
                t=t, b=b, h=h, max_abs_err=err_b, bound=profiling.bound_ms(*profiling.lstm_seq_bwd_work(t, b, h, valid)),
                ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy), 5),
                plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy), 2, 1),
                sweep_ms=time_ms(lambda: rnn_cuda._sweep(m2, wh, c, acts, dy, dxw, dxw, t, b, 2, h, 1), 5),
                products_ms=time_ms(lambda: rnn_cuda._seq_products(ys, dxw, dwh), 5),
                sweep_grid=dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks", "piece"),
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
    for name, e in zip(("lstm_seq_fwd", "lstm_seq_bwd"), lm_lstm_checks(dev)):
        out[name]["per_shape"][f"LM_T{e['t']}_B{e['b']}_H{e['h']}_dirs1"] = {
            k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound", "projection_ms", "plan", "max_abs_err")
            if k in e}
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e["max_abs_err"])
    return out


def lm_lstm_checks(dev):
    """The LM's layer on the lstm_seq pair with one direction, at
    configs/libri/lm_example.yaml's width (B=32, D=H=512) over the LibriSpeech
    LM bucket of T=256 tokens, ragged lengths: forward and backward against
    their plain versions, timed beside a unidirectional cuDNN nn.LSTM (its
    projection included; the port's projection outside the kernel timed
    apart). Returns (fwd, bwd) entries for lstm_seq_checks' per_shape."""
    from e2e_asr_tpu_torch.ops import rnn_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    t, b, d, h = 256, 32, 512, 512
    print(f"[kernel] lstm_seq_fwd / lstm_seq_bwd, one direction (the LM), T={t} B={b} H={h}", flush=True)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    x, _, wx, wh, bias = _lstm_inputs(gen, dev, t, b, d, h, lens)
    wx, wh, bias = wx[:1], wh[:1], bias[:1]
    m2 = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    with torch.no_grad():
        xw = (x @ wx[0] + bias[0]).contiguous()
        got = rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True)
        want = rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh)
        err = max(compare(f"lstm_seq_fwd LM T={t} {nm}", g, w, rtol=1e-4, atol=1e-4)
                  for nm, g, w in zip(("ys", "c", "acts"), got, want))
        ys, c, acts = want
        dy = torch.randn(ys.shape, generator=gen, device=dev)
        got_b = rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy)
        want_b = rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy)
        err_b = max(_scaled(f"lstm_seq_bwd LM T={t} {nm}", g, w, 1e-4)
                    for nm, g, w in zip(("dxw", "dWh"), got_b, want_b))
        valid = float(lens.sum())
        fwd = dict(t=t, b=b, h=h, dirs=1, max_abs_err=err,
                   bound=profiling.bound_ms(*profiling.lstm_seq_fwd_work(t, b, h, valid, dirs=1)),
                   ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True), 5),
                   plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh), 2, 1),
                   projection_ms=time_ms(lambda: x @ wx[0] + bias[0], 5), plan=_fwd_plan(b, h, dev, dirs=1))
        bwd = dict(t=t, b=b, h=h, dirs=1, max_abs_err=err_b,
                   bound=profiling.bound_ms(*profiling.lstm_seq_bwd_work(t, b, h, valid, dirs=1)),
                   ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy), 5),
                   plain_ms=time_ms(lambda: rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy), 2, 1))
    lstm = torch.nn.LSTM(d, h).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx[0].t())
        lstm.weight_hh_l0.copy_(wh[0].t())
        lstm.bias_ih_l0.copy_(bias[0])
        lstm.bias_hh_l0.zero_()
    xg = x.clone().requires_grad_()
    fwd["library_ms"] = time_ms(lambda: lstm(xg), 5)
    out_lib, _ = lstm(xg)
    lib_in = [xg] + list(lstm.parameters())
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(out_lib, lib_in, dy, retain_graph=True), 5)
    for name, e in (("lstm_seq_fwd", fwd), ("lstm_seq_bwd", bwd)):
        print(f"  {name} LM T={t} B={b} H={h} dirs 1: {e['ms']:.3f} ms (bound {e['bound'][0]:.3f}, "
              f"{e['bound'][1]}), plain {e['plain_ms']:.2f} ms, cuDNN unidirectional nn.LSTM "
              f"{e['library_ms']:.3f} ms (projection included)", flush=True)
    print(f"  LM projection outside the kernel (x Wx + b): {fwd['projection_ms']:.3f} ms", flush=True)
    return fwd, bwd


def _check_steps(log, what):
    """Prints each step's record; every loss finite, no step skipped."""
    for rec in log:
        print(f"  {what} step {rec['step']}: loss {rec['loss']:.4f} att {rec['att_loss']:.4f} "
              f"ctc {rec['ctc_loss']:.4f} gnorm {rec['grad_norm']:.3f} tf {rec['tf_rate']:.2f} | "
              f"{rec['audio_s']:.2f} audio-s in {rec['wall_s']:.3f}s = "
              f"{rec['audio_s'] / rec['wall_s']:.2f} audio-s/s, rd {rec['rd_s'] * 1e3:.2f} ms", flush=True)
        if not all(math.isfinite(rec[k]) for k in ("loss", "att_loss", "ctc_loss", "grad_norm")):
            fail(f"{what} step {rec['step']}: a loss or the gradient norm is not finite")
        if rec["step_skipped"] != 0.0:
            fail(f"{what} step {rec['step']} was skipped")


def _reset_peak() -> float:
    """Collects what is free and resets the peak statistic; returns the MB
    still allocated (the process's other solvers and caches)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 20


def _peak_line(before_mb: float, peak_mb: float) -> str:
    return (f"peak memory allocated {peak_mb:.1f} MB (torch.cuda.max_memory_allocated, graphs included), "
            f"{peak_mb - before_mb:.1f} MB above the {before_mb:.1f} MB allocated before the run")


def _run_counted(solver, wrappers, what, attr="launches"):
    """solver.exec() with the wrappers' launch counts (``attr``: launches of
    the float32 variants, ``launches_bf16`` of the bf16 ones) set to 0 just
    before and read just after; every one must have launched. Returns the
    counts and the wall seconds."""
    for fn in wrappers.values():
        setattr(fn, attr, 0)
    t0 = time.time()
    solver.exec()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: getattr(fn, attr) for name, fn in wrappers.items()}
    print(f"{what} path launches: {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
    return launches, wall


def convergence_phase(dev, smi):
    """The convergence recipe (configs/synthetic_convergence.yaml) at its full
    width: first the scan pair against its plain versions at the recipe's
    shapes (``convergence_scan_checks``) and log_mel on the recipe's first
    batch (B=32, M=80; ``log_mel_wave_check``), then CONV_STEPS steps and
    one validation through bin/train_asr.Solver.exec, its features through
    log_mel, its BiLSTM layers through the lstm_seq kernel pair and its
    speller through the fused scan, coins failing (tf 0.8)."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import convergence_train_solver
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd

    # float32 pinned: these checks keep their float32 tolerances (bf16_phase
    # runs the recipe at its own bfloat16)
    solver = convergence_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_convergence"), SEED,
                                      CONV_STEPS, dtype="float32")
    m = solver.config.model
    if (solver.config.data.corpus.batch_size, m.encoder.dim, m.attention.dim, m.decoder.dim) != (
            32, [256, 256, 256], 128, 256):
        fail("the convergence recipe is not at its full width")
    scan_check = convergence_scan_checks(dev, solver.config, solver.vocab_size)
    # log_mel on the recipe's first batch (its int16 waves, gathered from the
    # device-resident corpus by resolve_wav, scaled as compute_features does): B=32, M=80
    from e2e_asr_tpu_torch.training.step import resolve_wav

    audio = solver.config.data.audio
    wav = resolve_wav(solver._put(next(solver.tr_set.epoch(0))))[0].float() * (1.0 / 32768.0)
    if wav.shape[0] != 32 or audio.feat_dim != 80 or not audio.use_pallas:
        fail(f"the convergence batch is {tuple(wav.shape)} at M={audio.feat_dim}, expected B=32, M=80, the kernel")
    with torch.inference_mode():
        mel_check = log_mel_wave_check("convergence_batch", wav, audio, dev)
    wrappers = {"log_mel": log_mel, "lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd,
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
    return dict(launches=launches, steps=log, dev=dev_sum, wall_s=wall, scan_check=scan_check,
                log_mel_check=mel_check, log_mel_wave=(wav, audio), ckpt=os.path.join(solver.ckpdir, "latest"))


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
        # float32 pinned: these checks keep their float32 tolerances (bf16_phase
        # trains the recipe at its own bfloat16)
        solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, f"smoke_train_{impl}"), SEED,
                                    TRAIN_STEPS, rnn_impl=impl, dtype="float32")
        batch = next(solver.tr_set.epoch(0))  # offsets into the device-resident corpus (auto)
        shape = (len(batch.wav_len), batch.n_samples)
        if shape != (16, (816 - 1) * 160 + 400) or solver.input_mode != "device_corpus":
            fail(f"train batch has shape {shape} ({solver.input_mode}), expected 16 utterances in the 816 "
                 "bucket from the device-resident corpus")
        if solver.train_graphs is None:
            fail(f"the flagship train step ({what}) does not run through the CUDA graphs")
        before_mb = _reset_peak()
        launches, wall = _run_counted(solver, {**common, **lstm_pair[impl]}, what)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        captures = [(k, round(t, 3)) for k, t in solver.train_graphs.captures]
        eval_captures = [(k, round(t, 3)) for k, t in solver.eval_graphs.captures] if solver.eval_graphs else []
        print(f"  {what}: {len(captures)} capture(s), {', '.join(f'{t:.2f}s' for _, t in captures)}; validation "
              f"{len(eval_captures)} capture(s), {', '.join(f'{t:.2f}s' for _, t in eval_captures)}; "
              f"{_peak_line(before_mb, peak_mb)}", flush=True)
        if len(captures) != 1:
            fail(f"the flagship train phase ({what}) captured {len(captures)} graphs, expected one (one bucket)")
        if len(eval_captures) != 1:
            fail(f"the flagship validation ({what}) captured {len(eval_captures)} graphs, expected one "
                 "(one dev bucket)")
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
        rd_ms = [round(r["rd_s"] * 1e3, 3) for r in log]
        print(f"train e2e (rnn_impl {impl}): median {rate:.2f} audio-s/s per step over steps "
              f"2-{TRAIN_STEPS} (step 1 {log[0]['audio_s'] / log[0]['wall_s']:.2f}) on {smi} (flagship, "
              f"B=16, 816 bucket, seed-{SEED} weights, device-resident corpus); rd per step {rd_ms} ms; "
              f"{TRAIN_STEPS} steps + validation {wall:.1f}s", flush=True)
        runs[impl] = dict(solver=solver, batch=batch, launches=launches, steps=log, dev=dev_sum,
                          audio_s_per_s=rate, wall_s=wall, rd_ms=rd_ms, captures=captures, peak_mb=peak_mb,
                          allocated_before_mb=before_mb, eval_captures=eval_captures)
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
                step_launches = profiling.device_launches(prof)
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


GRAPH_STEPS = 3  # steps of the replay-against-eager check (the first captures)
EVAL_HOST_LIMIT = 10  # host-issued launches of a replayed dev batch or LM step


def _graph_counts():
    from e2e_asr_tpu_torch.training.step_graph import COUNTED, COUNTERS

    return {f"{fn.__name__}{'' if a == 'launches' else '_bf16'}": getattr(fn, a, 0) for fn in COUNTED for a in COUNTERS}


def graph_phase(smi):
    """The train step's CUDA graphs (training/step_graph.py) against the
    eager step at the flagship's full width, under both LSTM routes and
    both compute types: GRAPH_STEPS steps of the smoke train batches from
    seed-0 weights through ``TrainGraphs`` (the first runs eagerly and
    captures, the rest replay) and through the eager step, from the same
    weights, batches (offsets into the device-resident corpus) and seeds,
    the teacher-forcing rate 1.0, 0.75, 0.5 (coins fail from the second
    step on): loss, grad norm, step_skipped, every parameter and optimizer
    tensor bitwise equal after each step, and the same launch counts. Then,
    float32 on the default route: the profiler's host-issued and device
    launches of one replayed step, and one eager step under the sync debug
    mode set to raise."""
    from itertools import islice

    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import host_launches, smoke_train_solver
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_graph"), SEED, GRAPH_STEPS)
    cfg = solver.config
    cfg.hparas.tf_start, cfg.hparas.tf_end, cfg.hparas.tf_step = 1.0, 0.5, 2
    batches = [solver._put(b) for b in islice(solver.tr_set.epoch(0), GRAPH_STEPS)]
    if len(batches) != GRAPH_STEPS or batches[0].get("wav") is not None:
        fail("the graph phase needs GRAPH_STEPS offsets batches of the smoke train split")

    def tensors(state):
        return [p.detach() for p in param_leaves(state.params)] + [
            t for k in sorted(state.opt_state) for t in param_leaves(state.opt_state[k])]

    def fresh():
        params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
        trainer = Trainer(cfg)
        return trainer, trainer.init_state(params)

    out = {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("auto", "pallas"):
            cfg.hparas.dtype, cfg.model.encoder.rnn_impl = dtype, impl
            what = f"{dtype}, rnn_impl {impl}"
            (tg, sg), (te, se) = fresh(), fresh()
            graphs = TrainGraphs(log=lambda m, what=what: print(f"  graph phase ({what}): {m}", flush=True))
            steps = []
            for i, b in enumerate(batches):
                c0 = _graph_counts()
                mg = tg.train_step(sg, b, solver.step_generator(i), graphs=graphs)
                got = [float(mg[k]) for k in ("loss", "grad_norm", "step_skipped", "tf_rate")]
                got_t = [mg[k].clone() for k in ("loss", "grad_norm", "step_skipped")]
                c1 = _graph_counts()
                me = te.train_step(se, b, solver.step_generator(i))
                c2 = _graph_counts()
                same = all(torch.equal(a, me[k]) for a, k in zip(got_t, ("loss", "grad_norm", "step_skipped")))
                state_same = all(torch.equal(a, c) for a, c in zip(tensors(sg), tensors(se)))
                dg = {k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]}
                de = {k: c2[k] - c1[k] for k in c0 if c2[k] - c1[k]}
                steps.append(dict(loss=got[0], grad_norm=got[1], tf_rate=got[3], bitwise=same and state_same,
                                  launches_graph=dg, launches_eager=de))
                print(f"  graph vs eager ({what}) step {i + 1}{' (capture)' if i == 0 else ' (replay)'}: loss "
                      f"{got[0]:.6f}, grad_norm {got[1]:.6f}, tf {got[3]:.2f}; loss, grad norm and skip bitwise "
                      f"{same}, every parameter and optimizer tensor bitwise {state_same}; launches {dg}", flush=True)
                if not (same and state_same):
                    fail(f"the replayed train step ({what}) is not bitwise the eager step at step {i + 1}")
                if dg != de or not dg:
                    fail(f"the graph and eager steps ({what}) counted other launches: {dg} vs {de}")
                if got[2] != 0.0 or not math.isfinite(got[0]):
                    fail(f"the graph phase's step {i + 1} ({what}) was skipped or not finite")
            out[f"{dtype}_{impl}"] = dict(steps=steps, captures=graphs.captures)
            if (dtype, impl) == ("float32", "auto"):
                b = batches[-1]
                tg.train_step(sg, b, solver.step_generator(9), graphs=graphs)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    tg.train_step(sg, b, solver.step_generator(10), graphs=graphs)
                    torch.cuda.synchronize()
                host = host_launches(prof)
                dev_launches = profiling.device_launches(prof)
                print(f"  one replayed flagship step ({what}): {host} launches issued by the host, {dev_launches} "
                      "device launches (profiler)", flush=True)
                if host >= 20:
                    fail(f"a replayed train step issued {host} launches from the host (limit 20)")
                out["replay_host_launches"], out["replay_device_launches"] = host, dev_launches
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    m = te.train_step(se, b, solver.step_generator(11))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                print(f"  one eager flagship step ({what}) under the sync debug mode 'error': no host "
                      f"synchronisation (loss {float(m['loss']):.6f})", flush=True)
                out["eager_step_sync_debug_error"] = "no host synchronisation"
            del graphs, tg, sg, te, se
    cfg.hparas.dtype, cfg.model.encoder.rnn_impl = "float32", "auto"
    return out


EVAL_COUNTED = ("log_mel", "ctc_lattice", "decoder_scan_fwd", "lstm_seq_fwd", "lstm_bidir_fwd")


def _eval_counts():
    """The validation path's launch counters (both variants) by name."""
    return {k: v for k, v in _graph_counts().items() if k.replace("_bf16", "") in EVAL_COUNTED}


def eval_graph_phase(smi):
    """Validation through CUDA graphs (training/eval_graph.py) against the
    eager validation at the flagship's full width, under both LSTM routes
    and both compute types: the smoke train solver's dev epoch (16
    utterances in the 816 bucket, one batch, 240 greedy steps) through
    ``Solver.dev_epoch`` three times, the graphs' first run (a capture),
    their replay and the eager run, each with the launch counters set to 0
    just before: the summary, every token and CTC id bitwise equal, the
    replay's counts the eager run's, and each run's wall. Before them one
    train step through the solver's train graphs, so that the validation's
    graphs share a pool that holds a train step; at float32 on the default
    route the peak memory of the capture in that shared pool against one in
    a pool of its own, the profiler's host-issued and device launches of a
    replayed dev batch (at most EVAL_HOST_LIMIT issued by the host), and one
    eager validation under the sync debug mode set to raise."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import host_launches, smoke_train_solver
    from e2e_asr_tpu_torch.bin.train_asr import DEV_STEP_RATIO
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs

    solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_eval_graph"), SEED, 1)
    cfg = solver.config
    if solver.eval_graphs is None or solver.eval_graphs.share is not solver.train_graphs:
        fail("the flagship's validation does not run through CUDA graphs sharing the train graphs' pool")
    solver.trainer.train_step(solver.state, solver._put(next(solver.tr_set.epoch(0))), solver.step_generator(0),
                              graphs=solver.train_graphs)
    torch.cuda.synchronize()
    out = {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("auto", "pallas"):
            cfg.hparas.dtype, cfg.model.encoder.rnn_impl = dtype, impl
            what = f"{dtype}, rnn_impl {impl}"
            runs, kept = {}, {}
            for mode in ("capture", "replay", "eager"):
                before_mb = _reset_peak()
                c0 = _eval_counts()
                kept[mode] = []
                t0 = time.perf_counter()
                summary, _ = solver.dev_epoch(graphs=mode != "eager", keep=kept[mode])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c1 = _eval_counts()
                runs[mode] = dict(summary=summary, wall_s=wall,
                                  launches={k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]},
                                  peak_mb_above=torch.cuda.max_memory_allocated() / 2 ** 20 - before_mb)
            same = runs["capture"]["summary"] == runs["replay"]["summary"] == runs["eager"]["summary"]
            arrays = all(np.array_equal(a[k], b[k]) for m in ("capture", "replay") for a, b in
                         zip(kept[m], kept["eager"]) for k in b) and len(kept["replay"]) == len(kept["eager"]) > 0
            captures = [(k, round(t, 3)) for k, t in solver.eval_graphs.captures]
            print(f"  validation graphs vs eager ({what}): summary bitwise {same}, tokens and CTC ids bitwise "
                  f"{arrays}; wall capture run {runs['capture']['wall_s']:.3f} s, replay {runs['replay']['wall_s']:.3f} "
                  f"s, eager {runs['eager']['wall_s']:.3f} s; launches replay {runs['replay']['launches']}, eager "
                  f"{runs['eager']['launches']}; captures so far {[t for _, t in captures]} s; "
                  f"{runs['replay']['summary']}", flush=True)
            if not (same and arrays):
                fail(f"graph validation ({what}) is not bitwise the eager validation")
            if runs["replay"]["launches"] != runs["eager"]["launches"] or not runs["replay"]["launches"]:
                fail(f"graph and eager validation ({what}) counted other launches")
            if not all(math.isfinite(v) for v in runs["replay"]["summary"].values()):
                fail(f"graph validation ({what}) gave a non-finite number")
            out[f"{dtype}_{impl}"] = dict(runs=runs, captures=captures)
    cfg.hparas.dtype, cfg.model.encoder.rnn_impl = "float32", "auto"

    # ---- float32, default route: the pool's choice, launches, the sync check
    batch = solver._put(next(solver.dv_set.epoch()))
    max_step = int(batch["text"].shape[1] * DEV_STEP_RATIO)
    shared = solver.eval_graphs
    peaks = {}
    for name, graphs in (("shared with the train graphs", EvalGraphs(share=solver.train_graphs)),
                         ("its own", EvalGraphs())):
        before_mb = _reset_peak()
        torch.cuda.empty_cache()  # as the capture does when it starts: the growth below is the pool's own
        res0 = torch.cuda.memory_reserved() / 2 ** 20
        solver.trainer.validate_batch(solver.state.params, batch, max_step, graphs=graphs)
        torch.cuda.synchronize()
        peaks[name] = dict(peak_mb_above=torch.cuda.max_memory_allocated() / 2 ** 20 - before_mb,
                           reserved_mb_added=torch.cuda.memory_reserved() / 2 ** 20 - res0,
                           capture_s=graphs.captures[-1][1])
        peak = peaks[name]
        print(f"  a flagship dev batch's validation captured into a pool {name}: "
              f"{_peak_line(before_mb, before_mb + peak['peak_mb_above'])}; reserved memory grew "
              f"{peak['reserved_mb_added']:.1f} MB; capture {peak['capture_s']:.2f} s", flush=True)
        del graphs
    out["pool"] = peaks
    solver.trainer.validate_batch(solver.state.params, batch, max_step, graphs=shared)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.trainer.validate_batch(solver.state.params, batch, max_step, graphs=shared)
        torch.cuda.synchronize()
    host = host_launches(prof)
    device = profiling.device_launches(prof)
    print(f"  one replayed flagship dev batch (float32, auto, {max_step} greedy steps): {host} launches issued by the "
          f"host, {device} device launches (profiler)", flush=True)
    if host > EVAL_HOST_LIMIT:
        fail(f"a replayed dev batch issued {host} launches from the host (limit {EVAL_HOST_LIMIT})")
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver.trainer.eval_device(solver.state.params, batch, max_step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  one eager flagship dev batch under the sync debug mode 'error': no host synchronisation", flush=True)
    out.update(replay_host_launches=host, replay_device_launches=device,
               eager_sync_debug_error="no host synchronisation")
    return out


def _bf16_counted(run, kernels, what, decode_f32=()):
    """run() with every kernel's launch counts (both variants) set to 0 just
    before and read just after: the bf16 variants of ``kernels["bf16"]`` and
    the float32 kernels of ``kernels["f32"]`` (log_mel and the CTC loss stay
    float32, as in the JAX package) must have launched, and no float32
    variant of a kernel that has a bf16 one (a bf16 recipe never runs them
    quietly) but those in ``decode_f32``: the validation's greedy decode
    runs float32, as the JAX package's does. Returns ({name: launches}, the
    wall seconds)."""
    fns = {**kernels["bf16"], **kernels["f32"]}
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**{f"{n}_bf16": fn.launches_bf16 for n, fn in kernels["bf16"].items()},
                **{n: fn.launches for n, fn in kernels["f32"].items()}}
    quiet = {n: fn.launches for n, fn in kernels["bf16"].items() if fn.launches and n not in decode_f32}
    print(f"{what} path launches: {launches}", flush=True)
    if quiet:
        fail(f"the {what} path ran float32 variants of kernels that have a bf16 one: {quiet}")
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
    return launches, wall


BF16_STEP_TOL = dict(loss_rel=1e-4, grad_norm_rel=1e-3, param_abs=1e-4)


def bf16_phase(dev, smi, batch):
    """The bfloat16 compute type (every shipped training recipe's
    hparas.dtype) on the card: the flagship trains TRAIN_STEPS steps + one
    validation through bin/train_asr.Solver.exec in bf16 (default route),
    every kernel of the path in its bf16 variant (``_bf16_counted``); one
    bf16 train step with the kernels against one with the plain versions
    under either LSTM route (BF16_STEP_TOL: the float32 check's loss and
    gradient-norm tolerances, the parameters' ten times its 1e-5: a rounding
    flipped in one version's bf16 state carries through the recurrences,
    and an Adadelta first step moves a parameter by at most 3.2e-4, with
    its sign where the gradient is near zero); the checkpoint it wrote decoded in float32 through
    bin/test_asr.Solver (``decode_phase``: kernels against plain versions,
    16/16 identical top hypotheses); the convergence recipe CONV_STEPS steps
    + validation in bf16."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import convergence_train_solver, smoke_solver, smoke_train_solver
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc_cuda import ctc_lattice
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import (lstm_bidir_bwd, lstm_bidir_fwd_train, lstm_seq_bwd,
                                                lstm_seq_fwd)
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves

    scan = {"decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd}
    pairs = {"auto": {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd},
             "pallas": {"lstm_bidir_fwd_train": lstm_bidir_fwd_train, "lstm_bidir_bwd": lstm_bidir_bwd}}
    f32 = {"log_mel": log_mel, "ctc_loss": ctc_lattice}
    out = {}

    # ---- the flagship through Solver.exec in bf16 (the recipe's own dtype)
    solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_train_bf16"), SEED, TRAIN_STEPS)
    if solver.compute_dtype != "bfloat16":
        fail(f"the flagship recipe trains in {solver.compute_dtype}, expected its hparas.dtype bfloat16")
    if solver.train_graphs is None:
        fail("the bf16 flagship train step does not run through the CUDA graphs")
    before_mb = _reset_peak()
    launches, wall = _bf16_counted(solver.exec, {"bf16": {**scan, **pairs["auto"]}, "f32": f32},
                                   "bf16 train (rnn_impl auto)", decode_f32=("lstm_seq_fwd",))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    captures = [(k, round(t, 3)) for k, t in solver.train_graphs.captures]
    print(f"  bf16 train: {len(captures)} capture(s), {', '.join(f'{t:.2f}s' for _, t in captures)}; "
          f"{_peak_line(before_mb, peak_mb)}", flush=True)
    log = list(solver.step_log)
    if len(log) != TRAIN_STEPS:
        fail(f"{len(log)} bf16 training steps ran, expected {TRAIN_STEPS}")
    _check_steps(log, "bf16 train (rnn_impl auto)")
    dev_sum = solver.dev_summary
    print(f"  bf16 dev: {dev_sum}", flush=True)
    if not all(math.isfinite(v) for v in dev_sum.values()):
        fail("bf16 validation gave a non-finite number")
    steady = sorted(r["audio_s"] / r["wall_s"] for r in log[1:])
    rate = steady[len(steady) // 2]
    print(f"bf16 train e2e (rnn_impl auto): median {rate:.2f} audio-s/s per step over steps 2-{TRAIN_STEPS} "
          f"on {smi} (flagship, B=16, 816 bucket, seed-{SEED} weights); {TRAIN_STEPS} steps + validation "
          f"{wall:.1f}s", flush=True)
    meta = open(os.path.join(solver.ckpdir, "latest.meta")).read()
    if "compute_dtype bfloat16" not in meta:
        fail(f"the bf16 checkpoint's .meta does not record its compute dtype: {meta!r}")
    out["train"] = dict(launches=launches, steps=log, dev=dev_sum, audio_s_per_s=rate, wall_s=wall,
                        captures=captures, peak_mb=peak_mb, allocated_before_mb=before_mb)

    # ---- one bf16 step with the kernels, one with the plain versions, per route
    cfg = solver.config
    dbatch = solver._put(next(solver.tr_set.epoch(0)))
    parity = {}
    for impl in ("pallas", "auto"):
        cfg.model.encoder.rnn_impl = impl
        res = {}
        for mode in ("kernel", "plain"):
            params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
            trainer = Trainer(cfg)
            state = trainer.init_state(params)
            ctx = mock.patch.object(cuda_build, "use_plain", lambda x: True) if mode == "plain" else nullcontext()
            holder = {}

            def step():
                holder["m"] = trainer.train_step(state, dbatch, solver.step_generator(0))

            with ctx:
                if mode == "kernel":
                    cnt, dt = _bf16_counted(step, {"bf16": {**scan, **pairs[impl]}, "f32": f32},
                                            f"bf16 train step (rnn_impl {impl})")
                else:
                    t1 = time.time()
                    step()
                    torch.cuda.synchronize()
                    dt = time.time() - t1
            m = holder["m"]
            res[mode] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().clone() for p in param_leaves(state.params)], dt)
            if not all(p.dtype == torch.float32 for p in res[mode][2]):
                fail("a parameter is not float32 after a bf16 step")
        (lk, gk, pk, tk), (lp_, gp, pp, tp) = res["kernel"], res["plain"]
        loss_rel, gn_rel = abs(lk - lp_) / abs(lp_), abs(gk - gp) / abs(gp)
        diffs = torch.cat([(a - c).abs().flatten() for a, c in zip(pk, pp)])
        p_err = float(diffs.max())
        moved = float((diffs > 1e-5).float().mean())
        tol = BF16_STEP_TOL
        print(f"bf16 train step kernel vs plain (rnn_impl {impl}): loss {lk:.6f} vs {lp_:.6f} (rel {loss_rel:.2e}, "
              f"tolerance {tol['loss_rel']}); grad_norm {gk:.6f} vs {gp:.6f} (rel {gn_rel:.2e}, tolerance "
              f"{tol['grad_norm_rel']}); updated params max abs diff {p_err:.3e} (tolerance {tol['param_abs']}), "
              f"{100 * moved:.3f}% of them more than 1e-5 apart; step {tk:.2f}s vs {tp:.2f}s", flush=True)
        if not (loss_rel <= tol["loss_rel"] and gn_rel <= tol["grad_norm_rel"] and p_err <= tol["param_abs"]):
            fail("the kernel and plain bf16 train steps disagree")
        parity[impl] = dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err,
                            param_share_over_1e5=moved, kernel_step_s=tk, plain_step_s=tp, launches=cnt)
    cfg.model.encoder.rnn_impl = "auto"
    out["parity"] = parity

    # ---- the bf16-trained checkpoint decoded in float32 (the decode's own type)
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_fwd as seq_fwd

    dsolver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_bf16_decode"), SEED,
                           ckpt=os.path.join(solver.ckpdir, "latest"))
    d = decode_phase(dsolver, batch, "auto", ("lstm_seq_fwd", seq_fwd), smi, tag=", bf16-trained checkpoint")
    d.pop("top_tokens")
    d.pop("top_scores")
    out["decode_f32_of_bf16_ckpt"] = d

    # ---- the convergence recipe in bf16
    csolver = convergence_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_convergence_bf16"), SEED,
                                       CONV_STEPS)
    if csolver.compute_dtype != "bfloat16":
        fail(f"the convergence recipe trains in {csolver.compute_dtype}, expected bfloat16")
    launches, wall = _bf16_counted(csolver.exec, {"bf16": {**scan, **pairs["auto"]}, "f32": {"log_mel": log_mel}},
                                   "bf16 convergence", decode_f32=("lstm_seq_fwd",))
    log = list(csolver.step_log)
    _check_steps(log, "bf16 convergence")
    dev_sum = csolver.dev_summary
    print(f"  bf16 convergence dev: {dev_sum}", flush=True)
    if len(log) != CONV_STEPS or not all(math.isfinite(v) for v in dev_sum.values()):
        fail("the bf16 convergence run did not give CONV_STEPS finite steps and a finite validation")
    rate = log[-1]["audio_s"] / log[-1]["wall_s"]
    print(f"bf16 convergence e2e: last step {rate:.2f} audio-s/s on {smi}; {CONV_STEPS} steps + validation "
          f"{wall:.1f}s", flush=True)
    out["convergence"] = dict(launches=launches, steps=log, dev=dev_sum, audio_s_per_s=rate, wall_s=wall)
    return out


DDP_STEPS = 3  # flagship steps of the data-parallel phase's world-1 runs
DDP_TIMEOUT = 600  # seconds a spawned group of the data-parallel phase may take
DDP_TOL = {"float32": (1e-4, 1e-3, 1e-5), "bfloat16": (1e-4, 1e-3, 1e-4)}  # loss rel, grad norm rel, params abs


def _ddp_flagship(path, steps, dev_utts=16, dropout=0.0):
    """The flagship smoke config (flagship_train_config) written to ``path``:
    ``steps`` steps and a validation at the last, ``dev_utts`` dev
    utterances (16 a batch), encoder dropout ``dropout``."""
    from e2e_asr_tpu_torch.bin.profile_decode import flagship_train_config

    cfg = flagship_train_config(steps, "auto", "")
    cfg.hparas.seed = SEED
    cfg.data.corpus.dev_split = [f"dev:{dev_utts}"]
    cfg.model.encoder.dropout = [dropout] * len(cfg.model.encoder.dim)
    cfg.save(path)
    return str(path), cfg


def ddp_phase(smi):
    """Data parallelism (parallel/dist.py) on the one card, in processes of
    their own (parallel/mp_worker.py), so that this process creates no
    group:

    (a) a world-1 NCCL group: ``Solver.exec`` trains DDP_STEPS flagship steps
        through the step graphs (the two collectives captured in them) and
        validates through the eval graphs (DDP_STEPS and once more), in
        float32 and bf16, and ``bin/test_asr.Solver`` decodes the dev batch,
        each first without a group and then in the group: summary, step log,
        parameters and csvs bitwise equal; capture seconds and peak memory;
    (b) two gloo ranks sharing the card: one eager flagship step (encoder
        dropout 0.1, SpecAugment on; float32 and bf16) against the one-rank
        eager step on the global batch here (loss rel 1e-4, grad norm rel
        1e-3, params abs 1e-5 float32 / 1e-4 bf16), the ranks' parameters
        bitwise equal to each other;
    (c) a two-rank sharded decode over gloo (two dev batches, one a rank):
        the csvs of the one-rank decode here.

    Also the scan's Gumbel noise at a row offset: ``gumbel_noise(..., row0)``
    bitwise the full batch's rows. Returns the numbers and each run's kernel
    launches."""
    from e2e_asr_tpu_torch import convert, cuda_build
    from e2e_asr_tpu_torch.data.dataset import load_dataset
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc
    from e2e_asr_tpu_torch.parallel import mp_worker
    from e2e_asr_tpu_torch.training.step import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(cuda_build.BUILD_DIR, "smoke_ddp")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    out = {}

    # ---- the Gumbel noise's row offset (the scan's sampled feedback)
    full = dc.gumbel_noise(NOISE_SEED, 200, 16, 31, dev)
    half = dc.gumbel_noise(NOISE_SEED, 200, 8, 31, dev, row0=8)
    same_noise = torch.equal(full[:, 8:], half)
    print(f"ddp: scan Gumbel noise of rows 8-15 at row0 8 bitwise the full batch's rows: {same_noise}", flush=True)
    if not same_noise:
        fail("the scan's Gumbel noise at a row offset is not the global batch's")

    # ---- (a) a world-1 NCCL group against no group
    cfg_path, cfg = _ddp_flagship(os.path.join(out_dir, "flagship.yaml"), DDP_STEPS)
    tr, _, feat_dim, vocab, _, _ = load_dataset(cfg.data, num_workers=0)
    params, _ = asr_mod.asr_init(SEED, feat_dim, vocab, cfg.model, dev)
    ckpt = os.path.join(out_dir, f"flagship_seed{SEED}.pt")
    convert.save_checkpoint(ckpt, params, vocab, feat_dim)
    spec = {"config": cfg_path, "ckpt": ckpt, "dir": os.path.join(out_dir, "world1"), "device": "cuda",
            "modes": ["train", "decode"], "dtypes": ["float32", "bfloat16"], "out": os.path.join(out_dir, "w1.pt")}
    t0 = time.time()
    mp_worker.run("world1", spec, 1, os.path.join(out_dir, "world1_log"), DDP_TIMEOUT, cwd=root)
    w1 = torch.load(spec["out"], weights_only=False)
    for run, r in w1.items():
        extra = ""
        if run.startswith("train"):
            g, w = r["with"], r["without"]
            extra = (f"; summary {g['summary']}; step graphs {g['train_graphs']}, captures {g['captures_s']} s with "
                     f"the group ({w['captures_s']} s without); peak memory {g['peak_mb_above']:.1f} MB above the "
                     f"run's start with the group ({w['peak_mb_above']:.1f} without); wall {g['wall_s']:.2f} s "
                     f"({w['wall_s']:.2f} without)")
        print(f"ddp (a) world-1 NCCL group vs no group, {run}: bitwise {r['same']}; launches "
              f"{r['with']['launches']}{extra}", flush=True)
        if not all(r["same"].values()):
            fail(f"the world-1 NCCL group's {run} is not bitwise the run without a group: {r['same']}")
        if run.startswith("train") and not r["with"]["train_graphs"]:
            fail(f"the world-1 NCCL {run} did not run through the step graphs")
    out["world1_nccl"] = {run: {"same": r["same"], "launches": r["with"]["launches"],
                                **{k: r["with"].get(k) for k in ("captures_s", "peak_mb_above", "wall_s", "summary")},
                                "without": {k: r["without"].get(k) for k in ("captures_s", "peak_mb_above", "wall_s")}}
                          for run, r in w1.items()}
    out["world1_nccl_s"] = time.time() - t0

    # ---- (b) two gloo ranks on the card, one eager step, against one rank here
    step_path, step_cfg = _ddp_flagship(os.path.join(out_dir, "flagship_dropout.yaml"), 1, dropout=0.1)
    b = next(tr.epoch(0))
    batch = {"wav": b.wav, "wav_len": b.wav_len, "text": b.text, "text_len": b.text_len}
    if b.wav.shape[0] != 16:
        fail(f"the data-parallel step needs a batch of 16 rows, got {b.wav.shape}")
    np.savez(os.path.join(out_dir, "batch.npz"), **batch)
    spec = {"config": step_path, "params": ckpt, "batch": os.path.join(out_dir, "batch.npz"), "seed": 7,
            "device": "cuda", "backend": "gloo", "dtypes": ["float32", "bfloat16"], "out": os.path.join(out_dir, "step")}
    t0 = time.time()
    mp_worker.run("step", spec, 2, os.path.join(out_dir, "step_log"), DDP_TIMEOUT, local_rank_zero=True, cwd=root)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    out["two_gloo_ranks_step"] = {"s": time.time() - t0}
    dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    for dtype in ("float32", "bfloat16"):
        step_cfg.hparas.dtype = dtype
        trainer = Trainer(step_cfg)
        state = trainer.init_state(convert.load_checkpoint(ckpt, dev)["params"])
        one = mp_worker.step_result(trainer, state, dbatch, 7, dev)
        got = ranks[0][dtype]
        loss_rel = abs(float(got["loss"]) - float(one["loss"])) / abs(float(one["loss"]))
        gn_rel = abs(float(got["grad_norm"]) - float(one["grad_norm"])) / abs(float(one["grad_norm"]))
        p_err = max(float((a - c).abs().max()) for a, c in zip(got["params"], one["params"]))
        equal = all(torch.equal(a, c) for a, c in zip(ranks[0][dtype]["params"], ranks[1][dtype]["params"]))
        tl, tg, tp = DDP_TOL[dtype]
        print(f"ddp (b) two gloo ranks on one card vs one rank on the global batch, eager flagship step ({dtype}, "
              f"encoder dropout 0.1, SpecAugment): loss {float(got['loss']):.6f} vs {float(one['loss']):.6f} (rel "
              f"{loss_rel:.2e}, tolerance {tl:g}); grad_norm rel {gn_rel:.2e} (tolerance {tg:g}); params max abs "
              f"diff {p_err:.3e} (tolerance {tp:g}); the ranks' params bitwise equal {equal}; rank 0 launches "
              f"{got['launches']}", flush=True)
        if not (loss_rel <= tl and gn_rel <= tg and p_err <= tp and equal) or float(got["step_skipped"]):
            fail(f"two gloo ranks' step ({dtype}) is not the one-rank step on the global batch")
        out["two_gloo_ranks_step"][dtype] = dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err,
                                                 ranks_bitwise=equal, launches=got["launches"])

    # ---- (c) a two-rank sharded decode over gloo against one rank here
    dec_path, _ = _ddp_flagship(os.path.join(out_dir, "flagship_decode.yaml"), 1, dev_utts=32)
    spec = {"config": dec_path, "ckpt": ckpt, "dir": os.path.join(out_dir, "decode"), "device": "cuda",
            "backend": "gloo", "out": os.path.join(out_dir, "decode")}
    t0 = time.time()
    mp_worker.run("decode", spec, 2, os.path.join(out_dir, "decode_log"), DDP_TIMEOUT, local_rank_zero=True, cwd=root)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    wall = time.time() - t0
    one = mp_worker.decode_run({**spec, "dir": os.path.join(out_dir, "decode_one")}, "single")
    n_rows = len(one["csvs"]["output_dev.csv"].splitlines()) - 1
    same_top = ranks[0]["csvs"]["output_dev.csv"] == one["csvs"]["output_dev.csv"]
    same_beam = ranks[0]["csvs"]["beam_dev.csv"] == one["csvs"]["beam_dev.csv"]
    print(f"ddp (c) two-rank sharded decode over gloo on one card ({n_rows} utterances, 2 batches): top "
          f"hypotheses csv bitwise the one-rank decode's {same_top}, beam csv {same_beam}; cer {ranks[0]['er']} / "
          f"{ranks[1]['er']} vs {one['er']}; rank 1 wrote {ranks[1]['files']}; launches rank 0 "
          f"{ranks[0]['launches']}, rank 1 {ranks[1]['launches']}; {wall:.1f} s", flush=True)
    if not (same_top and ranks[0]["er"] == ranks[1]["er"] == one["er"]) or ranks[1]["files"] or n_rows <= 16:
        fail("the two-rank sharded decode does not give the one-rank decode's hypotheses")
    out["two_rank_decode"] = dict(top_bitwise=same_top, beam_bitwise=same_beam, er=ranks[0]["er"],
                                  launches=[r["launches"] for r in ranks], s=wall)
    return out


def lm_train_phase(dev, smi):
    """The LM's training path at configs/libri/lm_example.yaml's full width
    (512 / 2 x 512 LSTM, tied, batch 32, Adam, clip 5) on synthetic
    transcripts: LM_STEPS steps and one validation through
    bin/train_lm.Solver.exec (the lstm_seq pair must have launched, losses
    finite, no step skipped, best_ppl written); one train step with the
    kernels against one with the plain versions from the same weights, batch
    and dropout stream; one step timed at B=32 on random ids at L=256 and
    L=512, the LibriSpeech LM buckets."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.bin.profile_decode import lm_train_solver
    from e2e_asr_tpu_torch.models import lm as lm_mod
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd
    from e2e_asr_tpu_torch.optim import Optimizer
    from e2e_asr_tpu_torch.training.lm_graph import LMGraphs
    from e2e_asr_tpu_torch.training.step import TrainState, param_leaves

    solver = lm_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_lm"), SEED, LM_STEPS)
    cfg = solver.config
    lm, h = cfg.lm, cfg.hparas
    if (lm.emb_dim, lm.dim, lm.n_layers, lm.emb_tying, lm.batch_size, h.optimizer.lower(), h.grad_clip) != (
            512, 512, 2, True, 32, "adam", 5.0):
        fail("the LM recipe is not at its full width")
    if solver.graphs is None or solver.eval_graphs is None:
        fail("the LM step or its evaluation does not run through CUDA graphs on the card")
    before_mb = _reset_peak()
    launches, wall = _run_counted(solver, {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd},
                                  "LM train")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    captures = {what: [(k, round(t, 3)) for k, t in g.captures]
                for what, g in (("step", solver.graphs), ("evaluation", solver.eval_graphs))}
    print(f"  LM train: step captures {[t for _, t in captures['step']]} s, evaluation captures "
          f"{[t for _, t in captures['evaluation']]} s; {_peak_line(before_mb, peak_mb)}", flush=True)
    if not captures["step"] or not captures["evaluation"]:
        fail("the LM run captured no step or no evaluation graph")
    log = list(solver.step_log)
    if len(log) != LM_STEPS:
        fail(f"{len(log)} LM steps ran, expected {LM_STEPS}")
    for rec in log:
        print(f"  LM step {rec['step']}: loss {rec['loss']:.4f} gnorm {rec['grad_norm']:.3f} "
              f"{rec['n_tokens']:.0f} tokens in {rec['wall_s'] * 1e3:.1f} ms", flush=True)
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            fail(f"LM step {rec['step']}: the loss or the gradient norm is not finite")
        if rec["step_skipped"] != 0.0:
            fail(f"LM step {rec['step']} was skipped")
    best = os.path.join(solver.ckpdir, "best_ppl")
    if not (math.isfinite(solver.dev_ppl) and os.path.isfile(best)):
        fail(f"LM validation: dev ppl {solver.dev_ppl}, best_ppl written {os.path.isfile(best)}")
    print(f"LM e2e: {LM_STEPS} steps + validation {wall:.1f}s on {smi}; dev ppl {solver.dev_ppl:.3f}", flush=True)

    # ---- one step with the kernels, one with the plain versions
    batch = solver._put(next(solver.tr_set.epoch(0)))

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(SEED)
        params = lm_mod.lm_init(gen, solver.vocab_size, lm, dev)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = Optimizer(h)
        return TrainState(params, opt.init(leaves), 0), opt

    graph_check = lm_graph_check(solver, fresh, smi)

    res = {}
    for mode in ("kernel", "plain"):
        state, opt = fresh()
        ctx = mock.patch.object(cuda_build, "use_plain", lambda x: True) if mode == "plain" else nullcontext()
        with ctx:
            m = train_lm.train_step(state, opt, lm, batch, solver.step_generator(0))
        res[mode] = (float(m["loss"]), float(m["grad_norm"]), [p.detach().clone() for p in param_leaves(state.params)])
    (lk, gk, pk), (lp_, gp, pp) = res["kernel"], res["plain"]
    loss_rel, gn_rel = abs(lk - lp_) / abs(lp_), abs(gk - gp) / abs(gp)
    p_err = max(float((a - c).abs().max()) for a, c in zip(pk, pp))
    print(f"LM train step kernel vs plain (B={batch['text'].shape[0]}, L={batch['text'].shape[1]}): loss "
          f"{lk:.6f} vs {lp_:.6f} (rel {loss_rel:.2e}, tolerance 1e-4); grad_norm {gk:.6f} vs {gp:.6f} (rel "
          f"{gn_rel:.2e}, tolerance 1e-3); updated params max abs diff {p_err:.3e} (tolerance 1e-5; Adam's "
          f"first step moves a parameter by at most lr {h.lr:g})", flush=True)
    if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and p_err <= 1e-5):
        fail("the kernel and plain LM train steps disagree")

    # ---- one step at the LibriSpeech LM buckets, random ids, B=32
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    step_ms = {}
    for length in (256, 512):
        text = torch.randint(1, solver.vocab_size, (32, length), generator=gen, device=dev, dtype=torch.int32)
        b_l = {"text": text, "text_len": torch.full((32,), length, dtype=torch.int32, device=dev)}
        for mode in ("eager", "graph"):
            state, opt = fresh()
            graphs = LMGraphs() if mode == "graph" else None
            times = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_lm.train_step(state, opt, lm, b_l, solver.step_generator(i), graphs=graphs)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms[f"{length}_{mode}"] = sorted(times[1:])[len(times[1:]) // 2]
            print(f"LM train step B=32 L={length} (random ids, lm_example width, {mode}): median "
                  f"{step_ms[f'{length}_{mode}']:.2f} ms of steps 2-6 (step 1 {times[0]:.2f} ms"
                  f"{', the capture' if graphs else ''}), host clock around a synchronised step, on {smi}", flush=True)
    return dict(launches=launches, steps=log, dev_ppl=solver.dev_ppl, wall_s=wall, captures=captures,
                peak_mb=peak_mb, allocated_before_mb=before_mb, graph_check=graph_check,
                parity=dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err),
                step_ms_by_length=step_ms)


LM_GRAPH_STEPS = 4  # steps of the LM's replay-against-eager check (the first captures, the third non-finite)


def lm_graph_check(solver, fresh, smi):
    """The LM step's CUDA graphs (training/lm_graph.py) against the eager
    step at lm_example.yaml's width: LM_GRAPH_STEPS steps of the solver's
    training batches of one bucket shape from the same weights and seeds
    (dropout on; the first captures, the rest replay), the third
    made non-finite by a NaN bias in both models (restored after it): the
    metrics and every parameter and optimizer tensor bitwise after each
    step (NaNs compared by their bits), the skipped step leaving both models
    as they were, the same launch counts; then the profiler's host-issued
    launches of one replayed step and its ring copy (at most
    EVAL_HOST_LIMIT)."""
    from itertools import islice

    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.bin.profile_decode import host_launches
    from e2e_asr_tpu_torch.training.lm_graph import LMGraphs
    from e2e_asr_tpu_torch.training.step import param_leaves

    lm = solver.config.lm
    if lm.dropout <= 0:
        fail("the LM graph check needs the recipe's dropout on")
    bits = lambda t: t.detach().reshape(-1).contiguous().view(torch.uint8)  # noqa: E731

    def tensors(state):
        return [p.detach() for p in param_leaves(state.params)] + [
            t for k in sorted(state.opt_state) for t in param_leaves(state.opt_state[k])]

    def same(xs, ys):
        return all(a.dtype == b.dtype and torch.equal(bits(a), bits(b)) for a, b in zip(xs, ys))

    (sg, og), (se, oe) = fresh(), fresh()
    graphs = LMGraphs()
    first = next(solver.tr_set.epoch(0))["text"].shape  # batches of one bucket shape: replays after the capture
    batches = [solver._put(b) for b in islice((b for b in solver.tr_set.forever() if b["text"].shape == first),
                                              LM_GRAPH_STEPS)]
    steps = []
    for i, b in enumerate(batches):
        if i == 2:
            saved = sg.params["cells"][0]["b"].detach().clone()
            for st in (sg, se):
                st.params["cells"][0]["b"].data.fill_(float("nan"))
            before = [t.clone() for t in tensors(sg)]
        c0 = _graph_counts()
        mg = train_lm.train_step(sg, og, lm, b, solver.step_generator(i), graphs=graphs)
        got = mg["scalars"].clone()
        c1 = _graph_counts()
        me = train_lm.train_step(se, oe, lm, b, solver.step_generator(i))
        c2 = _graph_counts()
        ok = same([got], [me["scalars"]]) and same(tensors(sg), tensors(se))
        skipped = float(got[3])
        kept = i != 2 or same(tensors(sg), before)
        dg = {k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]}
        de = {k: c2[k] - c1[k] for k in c0 if c2[k] - c1[k]}
        steps.append(dict(scalars=got.tolist(), bitwise=ok, launches_graph=dg, launches_eager=de))
        print(f"  LM graph vs eager step {i + 1}{' (capture)' if i == 0 else ' (replay)'}, shape "
              f"{list(b['text'].shape)}: {dict(zip(train_lm.SCALARS, got.tolist()))}; bitwise {ok}; launches {dg}",
              flush=True)
        if i == 2:
            for st in (sg, se):
                st.params["cells"][0]["b"].data.copy_(saved)
        if not ok or not kept:
            fail(f"the replayed LM step is not bitwise the eager step at step {i + 1}")
        if skipped != float(i == 2):
            fail(f"LM graph check step {i + 1}: step_skipped {skipped}")
        if dg != de or not dg:
            fail(f"the LM graph and eager steps counted other launches: {dg} vs {de}")
    b = batches[-1]
    ring = torch.empty((2, len(train_lm.SCALARS)), device=b["text"].device)
    ring[0].copy_(train_lm.train_step(sg, og, lm, b, solver.step_generator(9), graphs=graphs)["scalars"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ring[1].copy_(train_lm.train_step(sg, og, lm, b, solver.step_generator(10), graphs=graphs)["scalars"])
        torch.cuda.synchronize()
    host = host_launches(prof)
    device = profiling.device_launches(prof)
    print(f"  one replayed LM step (lm_example width, B={b['text'].shape[0]}, L={b['text'].shape[1]}): {host} "
          f"launches issued by the host, {device} device launches (profiler) on {smi}", flush=True)
    if host > EVAL_HOST_LIMIT:
        fail(f"a replayed LM step issued {host} launches from the host (limit {EVAL_HOST_LIMIT})")
    return dict(steps=steps, captures=graphs.captures, replay_host_launches=host, replay_device_launches=device)


def decode_in_turns(solvers: dict, batch) -> dict:
    """Wall, device busy time and launches of one decoded batch for each
    solver, in turns (a, b, b, a): ``profile_decode.profile_run``."""
    from e2e_asr_tpu_torch.bin.profile_decode import profile_run

    names = list(solvers)
    audio_s = float(batch.wav_len.sum()) / solvers[names[0]].config.data.audio.sample_rate
    wav, wav_len = solvers[names[0]].put(batch.wav, batch.wav_len)
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        r = profile_run(lambda: solvers[name].decode_batch(wav, wav_len), audio_s)
        runs[name].append({k: r[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                                             "host_launches", "audio_s_per_s")})
        print(f"  {name}: wall {r['wall_ms']:.1f} ms, device busy {r['device_busy_ms']:.1f} ms, idle "
              f"{r['device_idle_share']:.3f}, {r['kernel_launches']} launches ({r['host_launches']} issued by the "
              f"host), {r['audio_s_per_s']:.1f} audio-s/s", flush=True)
    return runs


def recipe_phase(conv_ckpt: str, smi):
    """The shipped recipes as shipped apart from their paths and run length:
    ``main --lm`` on configs/synthetic_lm_conv.yaml (max_step and valid_step
    cut to RECIPE_LM_STEPS), then ``main --test`` on
    configs/synthetic_decode_conv.yaml with the convergence phase's
    checkpoint and that LM's best_ppl fused in (its lm_weight 0.3 and
    ctc_weight 0.3): both exit normally, the decode writes output_dev.csv
    and output_test.csv, and the kernels of each path launched."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import prefix_scores_fused
    from e2e_asr_tpu_torch.main import main as cli_main
    from e2e_asr_tpu_torch.ops.att_step_cuda import att_step_beam_loc
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd

    root = os.path.join(cuda_build.BUILD_DIR, "smoke_recipes")
    lm_argv = ["--lm", "--config", "configs/synthetic_lm_conv.yaml", "-o", f"hparas.max_step={RECIPE_LM_STEPS}",
               "-o", f"hparas.valid_step={RECIPE_LM_STEPS}", "--name", "lm_conv",
               "--logdir", os.path.join(root, "log"), "--ckpdir", os.path.join(root, "ckpt")]
    lm_launches, lm_wall = _run_counted(
        types.SimpleNamespace(exec=lambda: cli_main(lm_argv)),
        {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd}, "synthetic_lm_conv.yaml")
    best = os.path.join(root, "ckpt", "lm_conv", "best_ppl")
    if not os.path.isfile(best):
        fail("main --lm on synthetic_lm_conv.yaml wrote no best_ppl")
    outdir = os.path.join(root, "result")
    dec_argv = ["--test", "--config", "configs/synthetic_decode_conv.yaml", "--load", conv_ckpt,
                "-o", f"decode.lm_path={best}", "--name", "decode_conv", "--outdir", outdir]
    ers = {}
    dec_launches, dec_wall = _run_counted(
        types.SimpleNamespace(exec=lambda: ers.update(cli_main(dec_argv))),
        {"log_mel": log_mel, "lstm_seq_fwd": lstm_seq_fwd, "att_step_beam_loc": att_step_beam_loc,
         "prefix_recursion": prefix_scores_fused}, "synthetic_decode_conv.yaml (LM fused)")
    for split in ("dev", "test"):
        path = os.path.join(outdir, "decode_conv", f"output_{split}.csv")
        with open(path) as f:
            rows = f.read().splitlines()
        if len(rows) < 2:
            fail(f"{path} holds no decoded utterance")
    if set(ers) != {"dev", "test"} or not all(math.isfinite(v) for v in ers.values()):
        fail(f"synthetic_decode_conv.yaml error rates {ers}")
    print(f"recipes on {smi}: synthetic_lm_conv.yaml {RECIPE_LM_STEPS} steps + validation {lm_wall:.1f}s; "
          f"synthetic_decode_conv.yaml with that LM fused, dev and test decoded in {dec_wall:.1f}s, cer {ers} "
          f"(the recogniser is the convergence phase's {CONV_STEPS}-step checkpoint)", flush=True)
    return dict(lm_launches=lm_launches, lm_wall_s=lm_wall, decode_launches=dec_launches, decode_wall_s=dec_wall,
                error_rates=ers)


def _rss_mb() -> tuple:
    """(current, peak) resident set of this process, MB."""
    import resource

    cur = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = float(line.split()[1]) / 1024
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _crc_table(poly: int, bits: int) -> np.ndarray:
    top, mask = 1 << (bits - 1), (1 << bits) - 1
    table = np.zeros(256, np.int64)
    for i in range(256):
        c = i << (bits - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table[i] = c
    return table


_CRC8, _CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def _crc16_rows(rows: np.ndarray) -> np.ndarray:
    """FLAC's CRC-16 (poly 0x8005, init 0) of each row of a uint8 matrix, the
    rows at once: a row's leading zero bytes leave a CRC at 0, so shorter
    frames are passed right-aligned behind zeros."""
    crc = np.zeros(rows.shape[0], np.int64)
    for col in rows.T:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[((crc >> 8) ^ col) & 0xFF]
    return crc


def flac_verbatim(waves, sample_rate: int = 16000, block: int = 4096) -> list:
    """Mono 16-bit FLAC streams of the int16 ``waves``, VERBATIM subframes in
    frames of ``block`` samples: the bytes ``tests/flac_tools.write_flac``
    writes with ``kind="verbatim"`` (STREAMINFO with the block size and the
    sample count, frame headers with a one-byte frame number and a 16-bit
    block size, CRC-8 and CRC-16), computed with numpy so that a corpus of a
    thousand utterances takes seconds."""
    heads, frames = [], []  # per frame: header bytes; payload (subframe)
    for x in waves:
        n = len(x)
        if n > 127 * block:
            raise ValueError("a one-byte frame number holds 128 frames")
        head = bytearray(b"fLaC\x80\x00\x00\x22")
        info = (sample_rate << 44) | (0 << 41) | (15 << 36) | n  # rate 20 b, channels-1 3 b, bps-1 5 b, total 36 b
        head += block.to_bytes(2, "big") * 2 + bytes(6) + info.to_bytes(8, "big") + bytes(16)
        heads.append([bytes(head)])
        for i, start in enumerate(range(0, n, block)):
            bs = min(block, n - start)
            fh = bytearray([0xFF, 0xF8, 0x70, 0x00, i]) + (bs - 1).to_bytes(2, "big")
            c = 0
            for byte in fh:
                c = _CRC8[c ^ byte]
            fh.append(int(c))
            frames.append((len(heads) - 1, bytes(fh) + b"\x02" + np.asarray(x[start:start + bs], ">i2").tobytes()))
    width = max(len(f) for _, f in frames)
    mat = np.zeros((len(frames), width), np.uint8)
    for r, (_, f) in enumerate(frames):
        mat[r, width - len(f):] = np.frombuffer(f, np.uint8)
    crcs = _crc16_rows(mat)
    for (w, f), c in zip(frames, crcs):
        heads[w].append(f + int(c).to_bytes(2, "big"))
    return [b"".join(parts) for parts in heads]


def write_file_corpus(root: str, utts: dict) -> dict:
    """The utterances ``utts`` ({split: [Utterance]}) as two
    LibriSpeech-layout trees under ``root``, ``wav`` (16-bit PCM) and
    ``flac`` (``flac_verbatim``), of the same int16 samples (the loader's
    int16 pass of each wave), in the manifest's order; returns {kind:
    tree}."""
    import wave

    from e2e_asr_tpu_torch.data.dataset import quantize_i16

    trees = {k: os.path.join(root, k) for k in ("wav", "flac")}
    for split, us in utts.items():
        pcm = [quantize_i16(u.load()) for u in us]
        lines = "\n".join(f"1-{split}-{i:05d} {u.text}" for i, u in enumerate(us)) + "\n"
        dirs = {k: os.path.join(t, split, "1", split) for k, t in trees.items()}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"1-{split}.trans.txt"), "w") as f:
                f.write(lines)
        for i, (x, data) in enumerate(zip(pcm, flac_verbatim(pcm))):
            with wave.open(os.path.join(dirs["wav"], f"1-{split}-{i:05d}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(16000)
                f.writeframes(x.astype("<i2").tobytes())
            with open(os.path.join(dirs["flac"], f"1-{split}-{i:05d}.flac"), "wb") as f:
                f.write(data)
    return trees


def _loader_way(way, njobs, corpus, mode, smi, wrappers, cache_route=False):
    """One way of ``loader_phase``: the convergence recipe through
    ``Solver.exec`` with ``njobs`` loader threads and ``corpus`` (fields of
    data.corpus); ``cache_route`` takes every row's wav path away, so that a
    wav corpus fills its batches from the int16 wave cache instead of one
    native ``pack_batch`` a batch. Returns (result, the first 8 device
    batches)."""
    from e2e_asr_tpu_torch import cuda_build, native
    from e2e_asr_tpu_torch.bin.profile_decode import convergence_train_solver
    from e2e_asr_tpu_torch.training.step import resolve_wav

    shown = {k: v for k, v in corpus.items() if k not in ("path", "name", "train_split", "dev_split")}
    what = (f"loader ({way}: njobs {njobs}, " + ", ".join(f"{k} {v}" for k, v in shown.items())
            + (f", {corpus['name']} {os.path.basename(corpus['path'])} files" if "path" in corpus else "")
            + (", int16 cache route" if cache_route else "") + ")")
    rss0, _ = _rss_mb()
    t0 = time.time()
    # float32 pinned, as the loader phase measured it before bf16 (the
    # input path is the same at either dtype)
    solver = convergence_train_solver(os.path.join(cuda_build.BUILD_DIR, f"smoke_loader_{way}"), SEED,
                                      LOADER_STEPS, tf=None, train_utts=LOADER_UTTS, log_step=10,
                                      njobs=njobs, corpus=corpus, dtype="float32")
    setup_s = time.time() - t0
    if (solver.input_mode, solver.tr_set.num_workers, solver.tr_set.emit_offsets) != (
            mode, njobs, mode == "device_corpus"):
        fail(f"{what} ran input mode {solver.input_mode} with {solver.tr_set.num_workers} loader threads")
    if cache_route:
        for it in (*solver.tr_set._items, *solver.dv_set._items):
            it[0].wav_path = None
    paths = {bool(it[0].wav_path) for it in solver.tr_set._items}
    m = solver.config.model
    if (solver.config.data.corpus.batch_size, m.encoder.dim, solver.config.data.audio.feat_dim) != (
            32, [256, 256, 256], 80):
        fail(f"{what}: the convergence recipe is not at its full width")
    batches, forms = [], set()
    real_step = solver.trainer.train_step
    real_pack, packs = native.pack_batch, []

    def spy(state, batch, gen, *a, **k):
        if len(batches) < 8:  # the device batch the step sees, copied out
            forms.add("wav" if batch.get("wav") is not None else "offsets")
            wav, wav_len = resolve_wav(batch)
            batches.append([t.cpu() for t in (wav, wav_len, batch["text"], batch["text_len"])])
        return real_step(state, batch, gen, *a, **k)

    def pack(paths_, n, *a):
        packs.append(len(paths_))
        return real_pack(paths_, n, *a)

    solver.trainer.train_step = spy
    with mock.patch.object(native, "pack_batch", pack):
        launches, wall = _run_counted(solver, wrappers, what)
    log = list(solver.step_log)
    if len(log) != LOADER_STEPS:
        fail(f"{what}: {len(log)} steps ran, expected {LOADER_STEPS}")
    if not all(math.isfinite(r["loss"]) and r["step_skipped"] == 0.0 for r in log):
        fail(f"{what}: a loss is not finite or a step was skipped")
    if forms != {"offsets" if mode == "device_corpus" else "wav"}:
        fail(f"{what}: the step saw {forms} batches")
    native_route = paths == {True} and mode == "stream"
    if bool(packs) != native_route:
        fail(f"{what}: {len(packs)} native pack_batch calls, a wav-path corpus streamed {native_route}")
    n_epoch = len(solver.tr_set)

    def share(steps):
        return sum(r["rd_s"] for r in steps) / max(sum(r["wall_s"] for r in steps), 1e-9)

    steady = log[10:]
    # the steps' audio over their wall: one step's wall is its issue, but
    # for the last of a log window, whose record waits for the device
    rate = sum(r["audio_s"] for r in steady) / max(sum(r["wall_s"] for r in steady), 1e-9)
    rss, peak = _rss_mb()
    res = dict(njobs=njobs, corpus=corpus, input_mode=solver.input_mode, setup_s=setup_s, wall_s=wall,
               launches=launches, step1_loss=log[0]["loss"], audio_s_per_s=rate, pack_batch_calls=len(packs),
               batches_an_epoch=n_epoch, rd_share=share(steady), rd_share_first_epoch=share(log[10:n_epoch]),
               rd_share_later_epochs=share(log[n_epoch:]), rd_share_of_run=sum(r["rd_s"] for r in log) / wall,
               rd_ms=[round(r["rd_s"] * 1e3, 3) for r in log], wall_ms=[round(r["wall_s"] * 1e3, 3) for r in log],
               host_rss_mb=rss, host_rss_growth_mb=rss - rss0, host_peak_rss_mb=peak, dev=solver.dev_summary)
    extra = f"; {len(packs)} native pack_batch calls" if packs else ""
    if mode == "device_corpus":
        res.update(flat_corpus_s=solver.flat_corpus_s, corpus_mb=solver._corpus_buf.numel() * 2 / (1 << 20))
        extra = f"; flat_corpus {res['flat_corpus_s']:.2f}s, {res['corpus_mb']:.1f} MB int16 on the card"
    if way in ("b", "c"):
        # one whole epoch of the train split (the cache's waves, or offsets)
        for _ in solver.tr_set.epoch(0):
            pass
        res.update(fill_factor=solver.tr_set.fill_factor, bucket_counts=solver.tr_set.bucket_counts())
        extra += f"; epoch 0 fill_factor {res['fill_factor']:.4f}, bucket_counts {res['bucket_counts']}"
    print(f"{what} on {smi}: {res['audio_s_per_s']:.2f} audio-s/s over steps 11-{LOADER_STEPS} (their audio "
          f"over their wall, nine log windows); "
          f"rd {res['rd_share']:.1%} of their wall ({res['rd_share_first_epoch']:.1%} over steps 11-{n_epoch}, "
          f"the rest of the first epoch; {res['rd_share_later_epochs']:.1%} over steps {n_epoch + 1}-"
          f"{LOADER_STEPS}; {res['rd_share_of_run']:.1%} of the whole {wall:.1f}s run, validation included); "
          f"step 1 loss {log[0]['loss']:.6f}; set-up {setup_s:.1f}s{extra}; host RSS {rss:.0f} MB "
          f"({rss - rss0:+.0f} MB over this way; peak {peak:.0f})", flush=True)
    del solver, spy, real_step
    torch.cuda.empty_cache()
    return res, batches


def loader_phase(smi):
    """The input path at the convergence recipe's full width (B=32, 3 x 256
    BiLSTM, 80-dim fbank, the recipe's own teacher-forcing schedule), its
    train split cut to LOADER_UTTS utterances and dev to 32: LOADER_STEPS
    steps through bin/train_asr.Solver.exec, logging every 10, validating
    once at the end, three ways in turns from the same seed (LOADER_MODES):
    (a) batches filled on the prefetch thread with no wave cache and
    streamed, as before the loader was ported but for that thread; (b) two
    loader threads and the int16 wave cache, streamed; (c) the
    device-resident corpus. Then the same utterances from files
    (``write_file_corpus``: a LibriSpeech-layout tree of wav files and one
    of FLAC files, the same int16 samples), streamed with two loader
    threads: the wav tree through the int16 wave cache (d) and through one
    native ``pack_batch`` a batch (e), in turns d, e, e, d; the FLAC tree
    (f, decoded by the native FLAC reader into the wave cache). Each way
    prints the share of its wall that ``rd`` (the wait in next(prefetch))
    took over steps 11-LOADER_STEPS, over the rest of the first epoch and
    over the later epochs, the audio-s/s of steps 11-LOADER_STEPS (their
    audio over their wall: the metrics are read once a log window, so only
    a window's wall waits for the device), (c)'s flat_corpus seconds and
    MB, and the host RSS. Fails if the first 8 device batches of any way
    (after resolve_wav) differ bitwise from (a)'s, if step 1's loss differs
    between the ways, if a way ran another input mode than it asked for, or
    if (e) made no native pack_batch call or (d) or (f) made one. No speed
    threshold."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.data import corpus as corpus_mod
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd

    wrappers = {"log_mel": log_mel, "lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd,
                "decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd}
    out, seen = {}, {}
    for way, njobs, corpus, mode in LOADER_MODES:
        out[way], seen[way] = _loader_way(way, njobs, corpus, mode, smi, wrappers)

    # ---- the same utterances from wav and FLAC files
    t0 = time.time()
    ccfg = _convergence_config().data.corpus
    utts = {"train": corpus_mod.load_corpus(ccfg.name, "", [f"train:{LOADER_UTTS}"]),
            "dev": corpus_mod.load_corpus(ccfg.name, "", ["dev:32"])}
    trees = write_file_corpus(os.path.join(cuda_build.BUILD_DIR, "loader_files"), utts)
    sizes = {k: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(t) for f in fs) / 2 ** 20
             for k, t in trees.items()}
    print(f"loader: {LOADER_UTTS} + 32 utterances written as wav ({sizes['wav']:.1f} MB) and FLAC "
          f"({sizes['flac']:.1f} MB) files in {time.time() - t0:.1f}s", flush=True)
    files = lambda kind: {"name": "librispeech", "path": trees[kind], "train_split": ["train"],  # noqa: E731
                          "dev_split": ["dev"], "device_cache": "off"}
    for way, kind, cache in (("d", "wav", True), ("e", "wav", False), ("e2", "wav", False), ("d2", "wav", True),
                             ("f", "flac", False)):
        out[way], seen[way] = _loader_way(way, 2, files(kind), "stream", smi, wrappers, cache_route=cache)
        out[way]["files_mb"] = sizes[kind]
    ref = seen["a"]
    for way in seen:
        if len(seen[way]) != 8 or not all(all(torch.equal(x, y) for x, y in zip(p, q))
                                          for p, q in zip(seen[way], ref)):
            fail(f"loader way ({way}): its first 8 device batches differ from way (a)'s")
        if out[way]["step1_loss"] != out["a"]["step1_loss"]:
            fail(f"loader way ({way}): step 1 loss {out[way]['step1_loss']!r} against (a)'s "
                 f"{out['a']['step1_loss']!r}")
    if (out["b"]["fill_factor"], out["b"]["bucket_counts"]) != (out["c"]["fill_factor"], out["c"]["bucket_counts"]):
        fail("loader: an epoch's fill_factor or bucket_counts differ between the streamed and device-corpus ways")
    print(f"loader: the first 8 device batches of ways {sorted(w for w in seen if w != 'a')} equal (a)'s bitwise "
          "(the wav and FLAC files' among them); step 1 losses equal", flush=True)
    return out


def decode_phase(solver, batch, impl, lstm_fwd, smi, tag=""):
    """The dev split decoded through ``Solver.exec`` with the BiLSTM layers
    on route ``impl`` (``lstm_fwd``: the (name, wrapper) of the LSTM
    forward it launches; None for a GRU encoder), the decode kernels'
    launch counts set to 0 just
    before and read just after (the beam steps replay the solver's CUDA
    graphs, captured by the warm-up); then the same batch through the graphs
    and through the eager loop (tokens, lengths and scores bitwise equal,
    the same launch counts) and with the kernels and with the plain
    versions on the card (eager loop): top-beam scores within rel 1e-3 and
    identical top hypotheses. ``tag`` names the run in what is printed (the
    solver's lm_weight, where an LM is fused in)."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import host_launches
    from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import prefix_scores_fused
    from e2e_asr_tpu_torch.ops.att_step_cuda import att_step_beam_loc
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel

    solver.config.model.encoder.rnn_impl = impl
    wav, wav_len = solver.put(batch.wav, batch.wav_len)
    steps = solver.max_step_for(batch.wav.shape[1])
    n_captures = len(solver.beam_graphs.captures)
    solver.decode_batch(wav, wav_len)  # warm-up: captures the beam step (once for the solver's weights)
    solver.decode_batch(wav, wav_len, graphs=False)  # and the eager loop's
    torch.cuda.synchronize()
    capture_s = [sec for _, sec in solver.beam_graphs.captures[n_captures:]]
    print(f"beam step graphs (rnn_impl {impl}{tag}): {len(solver.beam_graphs.graphs)} captured for the solver, "
          f"this warm-up's capture {capture_s} s", flush=True)
    wrappers = {"log_mel": log_mel, **({lstm_fwd[0]: lstm_fwd[1]} if lstm_fwd else {}),
                "att_step_beam_loc": att_step_beam_loc, "prefix_recursion": prefix_scores_fused}
    for fn in wrappers.values():
        fn.launches = 0
    solver.exec()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"decode path launches (rnn_impl {impl}{tag}): {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on the decode path (rnn_impl {impl}{tag})")
    for name in ("att_step_beam_loc", "prefix_recursion"):
        if launches[name] != steps:
            fail(f"{name}: {launches[name]} launches in a decoded batch of {steps} beam steps")
    st = dict(solver.stats["dev"])
    rate = st["audio_sec"] / st["wall_s"]
    print(f"e2e (rnn_impl {impl}{tag}): {st['utts']} utts, {st['audio_sec']:.2f} audio-s in {st['wall_s']:.3f}s "
          f"wall = {rate:.2f} audio-s/s on {smi} (decode B=16 W=16, seed-{SEED} weights, cer {st['cer']:.3f}); "
          f"input_s {st['input_s'] * 1e3:.2f} ms (the wait on the prefetcher), decode_s {st['decode_s']:.3f}s",
          flush=True)

    # ---- the graphs against the eager loop: results, counts, launches (profiler)
    res, counts, device_l, host_l = {}, {}, {}, {}
    for mode in ("graph", "eager"):
        for fn in wrappers.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res[mode] = solver.decode_batch(wav, wav_len, graphs=mode == "graph")
            torch.cuda.synchronize()
        counts[mode] = {name: fn.launches for name, fn in wrappers.items()}
        device_l[mode] = profiling.device_launches(prof)
        host_l[mode] = host_launches(prof)
        print(f"decode launches (rnn_impl {impl}{tag}, {mode}): {device_l[mode]} device launches a batch of "
              f"{steps} beam steps ({device_l[mode] / steps:.1f} a step), {host_l[mode]} issued by the host "
              f"({host_l[mode] / steps:.2f} a step)", flush=True)
    diff = {k: float((getattr(res["graph"], k).double() - getattr(res["eager"], k).double()).abs().max())
            for k in ("tokens", "lengths", "scores")}
    bitwise = all(torch.equal(x, y) for x, y in zip(res["graph"], res["eager"]))
    print(f"graph replay vs eager loop (rnn_impl {impl}{tag}): bitwise equal {bitwise} (max abs diff {diff}); "
          f"kernel counts {counts['graph']} vs {counts['eager']}", flush=True)
    if not bitwise:
        fail("the graph replay and the eager loop decode differently")
    if counts["graph"] != counts["eager"]:
        fail("the graph replay and the eager loop count different launches")

    # ---- the same batch with kernels and with plain versions, on the card
    res_k = res["eager"]
    t_p = time.time()
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        res_p = solver.decode_batch(wav, wav_len, graphs=False)
    torch.cuda.synchronize()
    print(f"plain-version decode of the batch: {time.time() - t_p:.2f}s", flush=True)
    sk, sp = res_k.scores[:, 0].double().cpu(), res_p.scores[:, 0].double().cpu()
    if res_k.tokens.shape != (16, 16, steps):
        fail(f"unexpected token shape {tuple(res_k.tokens.shape)}")
    if not (torch.isfinite(sk).all() and torch.isfinite(sp).all()):
        fail("non-finite top-beam scores")
    score_err = float(((sk - sp).abs() / sp.abs()).max())
    same = int((res_k.tokens[:, 0] == res_p.tokens[:, 0]).all(-1).sum())
    print(f"top-beam score max rel diff kernel vs plain (rnn_impl {impl}{tag}): {score_err:.3e} (tolerance "
          f"1e-3); identical top hypotheses {same}/16", flush=True)
    if score_err > 1e-3:
        fail("kernel decode and plain decode disagree on top-beam scores")
    # inputs and weights come from a seed and every kernel is deterministic,
    # so a differing top hypothesis is a fault, not a tie broken otherwise
    if same < 16:
        fail("kernel decode and plain decode differ in top hypotheses")
    return dict(launches=launches, e2e=st, audio_s_per_s=rate, top_score_rel_diff=score_err,
                identical_top=same, top_tokens=res_k.tokens[:, 0].cpu(), top_scores=sk,
                device_launches_a_batch=device_l["graph"], device_launches_a_batch_eager=device_l["eager"],
                host_launches_a_batch=host_l["graph"], host_launches_a_batch_eager=host_l["eager"],
                graph_vs_eager_bitwise=bitwise, capture_s=capture_s, beam_steps=steps)


RECIPE_960H_REPS = 5  # timed replays of a 960 h train step and dev epochs


def recipe_960h_kernel_checks(dev, cfg, vocab):
    """The float32 kernels of configs/libri/asr_960h.yaml's path at its own
    shapes (its bf16 kernels: ``bf16_kernel_checks``' "960h" shape), each
    against its plain version with the tolerances of the flagship's checks,
    timed, with its bound: log_mel on the 3056-frame bucket's [16, 489200]
    waves; the CTC lattice at S = 764 with up to 519 labels; the beam
    attention step (E = 1024) and the fused CTC prefix function at the
    decode batch's S = T = 104, the attention step also at S = 764.
    Returns {name: row}."""
    from e2e_asr_tpu_torch.bin.profile_decode import flagship_att_inputs, flagship_prefix_inputs
    from e2e_asr_tpu_torch.decode import ctc_prefix
    from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc
    from e2e_asr_tpu_torch.ops import att_step_cuda as asc
    from e2e_asr_tpu_torch.ops import ctc_cuda
    from e2e_asr_tpu_torch.ops import frontend as fe
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 960)
    a, c = cfg.data.audio, cfg.data.corpus
    win, shift = int(a.sample_rate * a.frame_length / 1000), int(a.sample_rate * a.frame_shift / 1000)
    n_fft = fe.next_pow2(win)
    frames, l_max = c.buckets[-1], c.token_buckets[-1] - 1
    b_long = max(1, c.batch_size // 2)  # the half-batch rule's rows at the longest bucket
    out = {}

    def row(name, shapes, err, ms, plain_ms, work, library_ms=None, **extra):
        out[name] = dict(shapes=shapes, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=profiling.bound_ms(*work),
                         library_ms=library_ms, **extra)
        r = out[name]
        print(f"  {name} [960h: {shapes}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})", flush=True)

    print("[kernel] asr_960h.yaml shapes: log_mel, ctc_loss, att_step_beam_loc, prefix_recursion", flush=True)
    n = (frames - 1) * shift + win
    wav = 0.1 * torch.randn((b_long, n), generator=gen, device=dev)
    err, _, _ = log_mel_wave_check("randn, the 3056-frame bucket", wav, a, dev)
    row("log_mel", f"wav [{b_long},{n}] -> [{b_long},{frames},{a.feat_dim}]", err,
        time_ms(lambda: fec.log_mel(wav, a, win, shift, n_fft), 10),
        time_ms(lambda: fec.log_mel_plain(wav, a, win, shift, n_fft), 3, 1), profiling.log_mel_work(a, b_long, n, win, n_fft))

    s_len = frames // 4
    logits = 3.0 * torch.randn((b_long, s_len, vocab), generator=gen, device=dev)
    logits[:, :, 0] += 2.0
    lp = torch.log_softmax(logits, -1)
    lablen = torch.randint(l_max // 2, l_max + 1, (b_long,), generator=gen, device=dev)
    lablen[0] = l_max
    labels = torch.randint(1, vocab, (b_long, l_max), generator=gen, device=dev)
    labels = torch.where(torch.arange(l_max, device=dev)[None] < lablen[:, None], labels, 0)
    inlen = torch.randint(l_max + l_max // 8, s_len + 1, (b_long,), generator=gen, device=dev)
    inlen[0] = s_len
    got, want = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen), ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen)
    ok = want[0] <= ctc_cuda.BIG  # rows with an alignment
    if not torch.equal(got[0] <= ctc_cuda.BIG, ok) or not bool(ok[0]):
        fail("ctc_loss [960h]: the kernel and its plain version find alignments for other rows")
    err = max(compare("ctc_loss nll [960h]", got[0][ok], want[0][ok], rtol=1e-5, atol=1e-3),
              compare("ctc_loss G [960h]", got[1], want[1], rtol=1e-4, atol=1e-4))
    targets = torch.cat([labels[i, :lablen[i]] for i in range(b_long)])
    lp_t = lp.transpose(0, 1).detach().requires_grad_()

    def library():
        nll = torch.nn.functional.ctc_loss(lp_t, targets, inlen, lablen, reduction="sum", zero_infinity=True)
        torch.autograd.grad(nll, lp_t)

    row("ctc_loss", f"log_probs [{b_long},{s_len},{vocab}], labels [{b_long},{l_max}]", err,
        time_ms(lambda: ctc_cuda.ctc_lattice(lp, labels, inlen, lablen), 10),
        time_ms(lambda: ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen), 3, 1),
        profiling.ctc_work(lp, labels, inlen, lablen), library_ms=time_ms(library, 5))

    s_dec = c.buckets[1] // 4  # the decode batch's bucket (416 frames)
    args = flagship_att_inputs(dev, s=s_dec, cfg=cfg)
    args764 = flagship_att_inputs(dev, s=s_len, cfg=cfg)
    err = 0.0
    for tag, x in (("", args), (" S=764", args764)):
        g, w_ = asc.att_step_beam_loc(*x), asc.att_step_beam_loc_plain(*x)
        err = max(err, compare(f"att_step align [960h{tag}]", g[0], w_[0], rtol=1e-4, atol=1e-6),
                  compare(f"att_step ctx [960h{tag}]", g[1], w_[1], rtol=1e-4, atol=1e-5))
    q, v = args[0], args[3]
    row("att_step_beam_loc", f"q [{q.shape[0]},{q.shape[1]},{q.shape[2]}], S {s_dec}, E {v.shape[2]}", err,
        time_ms(lambda: asc.att_step_beam_loc(*args), 20), time_ms(lambda: asc.att_step_beam_loc_plain(*args), 20),
        profiling.att_step_work(args), ms_s764=time_ms(lambda: asc.att_step_beam_loc(*args764), 10),
        plan=asc.plan(q.shape[0], q.shape[1], s_dec, q.shape[2], v.shape[2], args[5].shape[0], args[5].shape[1]),
        plan_s764=asc.plan(q.shape[0], q.shape[1], s_len, q.shape[2], v.shape[2], args[5].shape[0],
                           args[5].shape[1]))

    pargs = flagship_prefix_inputs(dev, t=s_dec, cfg=cfg, vocab=vocab)
    got, want = cpc.prefix_scores_fused(*pargs), cpc.prefix_scores_fused_plain(*pargs)
    err = max(compare(f"prefix_scores_fused {nm} [960h]", g, wt, rtol=1e-5, atol=2e-3, unreachable=ctc_prefix.NEG / 2)
              for nm, g, wt in zip(("psi", "r_h", "psi_eos"), got, want))
    row("prefix_recursion", f"ctc_lp [{pargs[0].shape[0]},{s_dec},{vocab}], W {pargs[4].shape[1]}, "
        f"K {pargs[4].shape[2]}", err, time_ms(lambda: cpc.prefix_scores_fused(*pargs), 20),
        time_ms(lambda: cpc.prefix_scores_fused_plain(*pargs), 3, 1), profiling.prefix_work(pargs))
    return out


def recipe_960h_phase(smi):
    """configs/libri/asr_960h.yaml on the card at its full widths (4 x 512
    BiLSTM, 512-wide speller: the scan kernels' MAX_H, E = 1024), seed-0
    weights, at bf16, the recipe's type, on a LibriSpeech-layout tree of
    synthetic wav files (``profile_decode.recipe_960h_corpus``: its
    416-frame bucket at B = 32 and its 3056-frame one at the half-batch
    rule's B = 16, read from ``batch_shapes()``, with 519-character
    transcripts: the scan's S = 764 and L = 520):

    - under each encoder route (``rnn_impl`` auto: lstm_seq; pallas:
      lstm_bidir), for each of the two buckets, one train step through a
      ``TrainGraphs`` (the first call runs it eagerly and captures; the
      state is put back and the step replayed), the replay bitwise the eager
      step, held against the plain step on the card (``use_plain`` patched)
      with BF16_STEP_TOL; the launches of the replay counted (the route's
      LSTM pair and the scan pair in their bf16 variants, log_mel and
      ctc_loss: none may be 0); the replayed step's wall and busy
      (``profile_run``);
    - validation over the two dev batches: the graphs' capture run, their
      replay and the eager run (summary, tokens and CTC ids bitwise, the same
      launches), each run's wall;
    - the recipe's decode block (B 16, beam 16, ctc_weight 0.3, lm_weight
      0.3 with a seed-0 LM of lm_example.yaml's width at this vocabulary)
      on one batch of 16 through ``bin/test_asr.Solver`` (``decode_phase``:
      graphs against the eager loop, kernels against plain versions, top
      hypotheses identical, the attention step and the CTC prefix kernel
      once a beam step).
    """
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import (profile_run, recipe_960h_config, recipe_960h_corpus,
                                                      recipe_960h_train_solver, smoke_solver)
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc_cuda import ctc_lattice
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import (lstm_bidir_bwd, lstm_bidir_fwd_train, lstm_seq_bwd,
                                                lstm_seq_fwd)
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    t0 = time.time()
    root = recipe_960h_corpus(os.path.join(cuda_build.BUILD_DIR, "recipe_960h_corpus"), SEED)
    print(f"asr_960h.yaml phase: corpus written in {time.time() - t0:.1f}s", flush=True)
    solver = recipe_960h_train_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_960h"), root, SEED)
    cfg = solver.config
    if solver.compute_dtype != "bfloat16" or solver.train_graphs is None or solver.eval_graphs is None:
        fail("asr_960h.yaml does not train in bf16 through the CUDA graphs")
    shapes = solver.tr_set.batch_shapes()
    c = cfg.data.corpus
    by_bucket = {n: (rows, toks) for rows, n, toks in shapes}
    want_rows = {416: c.batch_size, 3056: max(1, c.batch_size // 2)}
    bucket_n = {fr: (fr - 1) * 160 + 400 for fr in want_rows}
    if any(by_bucket.get(bucket_n[fr], (0,))[0] != rows for fr, rows in want_rows.items()):
        fail(f"asr_960h.yaml batch shapes {shapes}: expected B = {want_rows} in the 416 and 3056 buckets")
    frames_of = {v: k for k, v in bucket_n.items()}
    batches = {}
    for b in solver.tr_set.epoch(0):
        batches.setdefault(frames_of.get(b.n_samples), b)
    print(f"  batch shapes {shapes}; steps on the 416 bucket (B={want_rows[416]}) and the 3056 bucket "
          f"(B={want_rows[3056]}, text up to {int(batches[3056].text_len.max())} tokens)", flush=True)
    sr = cfg.data.audio.sample_rate
    scan = {"decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd}
    pairs = {"auto": {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd},
             "pallas": {"lstm_bidir_fwd_train": lstm_bidir_fwd_train, "lstm_bidir_bwd": lstm_bidir_bwd}}
    f32 = {"log_mel": log_mel, "ctc_loss": ctc_lattice}

    def tensors(state):
        return [p.detach() for p in param_leaves(state.params)] + [
            t for k in sorted(state.opt_state) for t in param_leaves(state.opt_state[k])]

    def fresh():
        params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
        trainer = Trainer(cfg)
        return trainer, trainer.init_state(params)

    out = {"batch_shapes": shapes, "steps": {}}
    tol = BF16_STEP_TOL
    for impl in ("auto", "pallas"):
        cfg.model.encoder.rnn_impl = impl
        for fr in (416, 3056):
            what = f"asr_960h.yaml bf16 step, {fr}-frame bucket, rnn_impl {impl}"
            dbatch = solver._put(batches[fr])
            audio_s = float(batches[fr].wav_len.sum()) / sr
            trainer, state = fresh()
            snap = [t.clone() for t in tensors(state)]
            graphs = TrainGraphs(log=lambda m, what=what: print(f"  {what}: {m}", flush=True))
            before_mb = _reset_peak()
            m = trainer.train_step(state, dbatch, solver.step_generator(0), graphs=graphs)  # eager + capture
            eager = [float(m[k]) for k in ("loss", "grad_norm")], [t.clone() for t in tensors(state)]
            for t, s0 in zip(tensors(state), snap):
                t.copy_(s0)
            state.step = 0
            holder = {}

            def replay():
                holder["m"] = trainer.train_step(state, dbatch, solver.step_generator(0), graphs=graphs)

            launches, _ = _bf16_counted(replay, {"bf16": {**scan, **pairs[impl]}, "f32": f32}, what)
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            mk = [float(holder["m"][k]) for k in ("loss", "grad_norm", "step_skipped")]
            pk = [t.clone() for t in tensors(state)]
            same = mk[:2] == eager[0] and all(torch.equal(x, y) for x, y in zip(pk, eager[1]))
            if not same:
                fail(f"{what}: the replayed step is not bitwise the eager step")
            if mk[2] != 0.0 or not math.isfinite(mk[0]):
                fail(f"{what}: the step was skipped or its loss is not finite")
            trainer_p, state_p = fresh()
            t1 = time.time()
            with mock.patch.object(cuda_build, "use_plain", lambda x: True):
                mp = trainer_p.train_step(state_p, dbatch, solver.step_generator(0))
                mp = [float(mp[k]) for k in ("loss", "grad_norm")]
            torch.cuda.synchronize()
            plain_s = time.time() - t1
            loss_rel, gn_rel = abs(mk[0] - mp[0]) / abs(mp[0]), abs(mk[1] - mp[1]) / abs(mp[1])
            p_err = max(float((x - y).abs().max()) for x, y in zip(pk[:len(param_leaves(state.params))],
                                                                    tensors(state_p)))
            print(f"  {what}: replay bitwise the eager step; kernel vs plain loss {mk[0]:.6f} vs {mp[0]:.6f} "
                  f"(rel {loss_rel:.2e}, tolerance {tol['loss_rel']}), grad_norm {mk[1]:.6f} vs {mp[1]:.6f} "
                  f"(rel {gn_rel:.2e}, tolerance {tol['grad_norm_rel']}), updated params max abs diff "
                  f"{p_err:.3e} (tolerance {tol['param_abs']}); plain step {plain_s:.2f} s; "
                  f"{_peak_line(before_mb, peak_mb)}", flush=True)
            if not (loss_rel <= tol["loss_rel"] and gn_rel <= tol["grad_norm_rel"] and p_err <= tol["param_abs"]):
                fail(f"{what}: the kernel and plain steps disagree")
            del trainer_p, state_p
            prof = profile_run(replay, audio_s, reps=RECIPE_960H_REPS)
            print(f"  {what}: wall {prof['wall_ms']:.2f} ms (median of {RECIPE_960H_REPS} replays; "
                  f"{', '.join(f'{w:.2f}' for w in prof['walls_ms'])}), busy {prof['device_busy_ms']:.2f} ms, "
                  f"idle {prof['device_idle_share']:.3f}, {prof['audio_s_per_s']:.1f} audio-s/s on {smi}, "
                  f"{prof['kernel_launches']} device launches, {prof['host_launches']} issued by the host; "
                  f"capture {graphs.captures[-1][1]:.2f} s", flush=True)
            for k in prof["kernels"][:8]:
                print(f"    {k['device_ms']:.3f} ms  {k['count']}x  {k['name'][:110]}", flush=True)
            out["steps"][f"{impl}_{fr}"] = dict(
                launches=launches, loss=mk[0], grad_norm=mk[1], loss_rel=loss_rel, grad_norm_rel=gn_rel,
                param_max_abs=p_err, plain_step_s=plain_s, capture_s=graphs.captures[-1][1], peak_mb=peak_mb,
                rows=len(batches[fr].uids),
                **{k: prof[k] for k in ("wall_ms", "walls_ms", "device_busy_ms", "device_idle_share",
                                        "audio_s", "audio_s_per_s", "kernel_launches", "host_launches")},
                kernels=prof["kernels"][:12])
            del graphs, trainer, state, snap, eager, pk
    cfg.model.encoder.rnn_impl = "auto"

    # ---- validation: two dev batches of 32, the graphs against eager
    runs, kept = {}, {}
    for mode in ("capture", "replay", "eager"):
        c0 = _eval_counts()
        kept[mode] = []
        t1 = time.perf_counter()
        summary, _ = solver.dev_epoch(graphs=mode != "eager", keep=kept[mode])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        c1 = _eval_counts()
        runs[mode] = dict(summary=summary, wall_s=wall, launches={k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]})
    same = runs["replay"]["summary"] == runs["eager"]["summary"] == runs["capture"]["summary"]
    arrays = len(kept["replay"]) == len(kept["eager"]) == 2 and all(
        np.array_equal(x[k], y[k]) for x, y in zip(kept["replay"], kept["eager"]) for k in y)
    n_dev = len(kept["eager"])
    print(f"  asr_960h.yaml validation ({n_dev} dev batches of {c.batch_size}, bf16): summary bitwise {same}, tokens "
          f"and CTC ids bitwise {arrays}; wall capture run {runs['capture']['wall_s']:.3f} s, replay "
          f"{runs['replay']['wall_s']:.3f} s ({runs['replay']['wall_s'] / max(n_dev, 1) * 1e3:.1f} ms a dev batch), "
          f"eager {runs['eager']['wall_s']:.3f} s on {smi}; launches replay {runs['replay']['launches']}; "
          f"{runs['replay']['summary']}", flush=True)
    if not (same and arrays):
        fail("asr_960h.yaml: graph validation is not bitwise the eager validation")
    if runs["replay"]["launches"] != runs["eager"]["launches"] or not runs["replay"]["launches"]:
        fail("asr_960h.yaml: graph and eager validation counted other launches")
    if not all(math.isfinite(v) for v in runs["replay"]["summary"].values()):
        fail("asr_960h.yaml: validation gave a non-finite number")
    walls = []
    for _ in range(RECIPE_960H_REPS):
        t1 = time.perf_counter()
        solver.dev_epoch(graphs=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) / n_dev * 1e3)
    print(f"  asr_960h.yaml dev batch (B={c.batch_size}, 416 bucket) through the graphs: "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms a batch ({RECIPE_960H_REPS} epochs) on {smi}", flush=True)
    out["validation"] = dict(runs=runs, dev_batch_wall_ms=walls, captures=solver.eval_graphs.captures)
    del solver
    _reset_peak()
    torch.cuda.empty_cache()

    # ---- the recipe's decode block with a seed-0 LM fused in
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_fwd as seq_fwd

    dcfg = recipe_960h_config(root, "dev-decode")
    dsolver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_960h_decode"), SEED, cfg=dcfg,
                           lm_weight=dcfg.decode.lm_weight)
    d = dsolver.config.decode
    if (d.beam_size, d.batch_size, d.ctc_weight, d.lm_weight) != (16, 16, 0.3, 0.3) or dsolver.lm_params is None:
        fail(f"asr_960h.yaml's decode block is not beam 16, batch 16, ctc 0.3, lm 0.3 with an LM: {d}")
    batch = next(dsolver.eval_sets["dev"].epoch())
    dec = decode_phase(dsolver, batch, "auto", ("lstm_seq_fwd", seq_fwd), smi, tag=", asr_960h.yaml, lm_weight 0.3")
    dec.pop("top_tokens")
    dec.pop("top_scores")
    out["decode"] = dec
    del dsolver
    _reset_peak()
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    print(f"asr_960h.yaml phase: {out['wall_s']:.1f} s", flush=True)
    return out


VARIANT_STEPS = 3  # train steps of a variant through Solver.exec (the first captures), then one validation
VARIANT_LM_STEPS = 4  # the GRU LM's steps through train_lm.Solver.exec
# the variants of the flagship (configs/libri/asr_example.yaml, its widths
# and bf16 kept) as main's -o overrides
VARIANTS = {
    "V1": ("model.encoder.prenet=cnn", "model.encoder.module=GRU", "model.decoder.module=GRU"),
    "V2": ("model.encoder.bidirection=false", "model.emb_reg.enable=true", "model.emb_reg.weight=0.5",
           "model.emb_reg.fuse=0"),
}


def _variant_config(name: str, max_step: int, extra=()):
    from e2e_asr_tpu_torch.bin.profile_decode import flagship_train_config
    from e2e_asr_tpu_torch.main import apply_overrides

    cfg = flagship_train_config(max_step)
    apply_overrides(cfg, list(VARIANTS[name]) + list(extra))
    return cfg


def _variant_train_solver(outdir: str, cfg, name: str):
    from e2e_asr_tpu_torch.bin.train_asr import Solver

    cfg.hparas.seed = SEED
    paras = types.SimpleNamespace(config="asr_example.yaml", name=name, logdir=os.path.join(outdir, "log"),
                                  ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=SEED, cpu=False,
                                  verbose=True, auto_resume=False)
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


def _state_tensors(state):
    from e2e_asr_tpu_torch.training.step import param_leaves

    return [p.detach() for p in param_leaves(state.params)] + [
        t for k in sorted(state.opt_state) for t in param_leaves(state.opt_state[k])]


def _variant_replay_vs_eager(solver, what):
    """GRAPH_STEPS train steps of the solver's batches from seed-0 weights
    through ``TrainGraphs`` (the first captures) and through the eager step,
    teacher forcing 1.0, 0.75, 0.5 (failing coins from the second step on):
    metrics and every parameter and optimizer tensor bitwise after each step,
    the same launch counts. Then the validation of the first dev batch,
    alignment kept, through ``EvalGraphs`` twice (capture, replay) against
    the eager ``eval_device``: every output bitwise."""
    from itertools import islice

    from e2e_asr_tpu_torch.bin.train_asr import DEV_STEP_RATIO
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
    from e2e_asr_tpu_torch.training.step import Trainer
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    cfg = solver.config
    tf = (cfg.hparas.tf_start, cfg.hparas.tf_end, cfg.hparas.tf_step)
    cfg.hparas.tf_start, cfg.hparas.tf_end, cfg.hparas.tf_step = 1.0, 0.5, 2
    batches = [solver._put(b) for b in islice(solver.tr_set.epoch(0), GRAPH_STEPS)]

    def fresh():
        params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
        trainer = Trainer(cfg)
        return trainer, trainer.init_state(params)

    (tg, sg), (te, se) = fresh(), fresh()
    graphs = TrainGraphs(log=lambda m: print(f"  {what}: {m}", flush=True))
    steps = []
    for i, b in enumerate(batches):
        c0 = _graph_counts()
        mg = tg.train_step(sg, b, solver.step_generator(i), graphs=graphs)
        got = {k: mg[k].clone() for k in ("loss", "grad_norm", "step_skipped", "tf_rate")}
        c1 = _graph_counts()
        me = te.train_step(se, b, solver.step_generator(i))
        c2 = _graph_counts()
        same = all(torch.equal(got[k], me[k]) for k in ("loss", "grad_norm", "step_skipped"))
        state_same = all(torch.equal(a, c) for a, c in zip(_state_tensors(sg), _state_tensors(se)))
        dg = {k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]}
        de = {k: c2[k] - c1[k] for k in c0 if c2[k] - c1[k]}
        steps.append(dict(loss=float(got["loss"]), grad_norm=float(got["grad_norm"]), tf_rate=float(got["tf_rate"]),
                          bitwise=same and state_same, launches_graph=dg, launches_eager=de))
        print(f"  {what} graph vs eager step {i + 1}{' (capture)' if i == 0 else ' (replay)'}: loss "
              f"{float(got['loss']):.6f}, grad_norm {float(got['grad_norm']):.6f}, tf {float(got['tf_rate']):.2f}; "
              f"metrics bitwise {same}, every parameter and optimizer tensor bitwise {state_same}; launches {dg}",
              flush=True)
        if not (same and state_same):
            fail(f"{what}: the replayed train step is not bitwise the eager step at step {i + 1}")
        if dg != de:
            fail(f"{what}: the graph and eager steps counted other launches: {dg} vs {de}")
        if float(got["step_skipped"]) != 0.0 or not math.isfinite(float(got["loss"])):
            fail(f"{what}: graph check step {i + 1} was skipped or not finite")
    cfg.hparas.tf_start, cfg.hparas.tf_end, cfg.hparas.tf_step = tf

    dev_batch = next(solver.dv_set.epoch())
    db = solver._put(dev_batch)
    max_step = int(dev_batch.text.shape[1] * DEV_STEP_RATIO)
    evals = EvalGraphs(log=lambda m: print(f"  {what}: {m}", flush=True))
    outs = []
    for _ in range(2):
        outs.append({k: v.clone() for k, v in tg.validate_batch(sg.params, db, max_step, graphs=evals,
                                                                keep_align=True).items()})
    eager = tg.eval_device(sg.params, db, max_step, keep_align=True)
    ev_same = all(torch.equal(o[k], eager[k]) for o in outs for k in eager)
    if "align" not in eager or set(outs[0]) != set(eager):
        fail(f"{what}: the validation kept no alignment")
    print(f"  {what} validation (alignment kept) capture + replay vs eager: every output bitwise {ev_same} "
          f"({', '.join(f'{k} {list(v.shape)}' for k, v in eager.items())})", flush=True)
    if not ev_same:
        fail(f"{what}: the replayed validation is not bitwise the eager one")
    return dict(steps=steps, captures=graphs.captures, validation_bitwise=ev_same,
                validation_captures=evals.captures)


def _variant_parity(solver, kernels, what):
    """One eager bf16 train step with the kernels against one with the
    plain versions (``cuda_build.use_plain`` patched), from seed-0 weights
    on the same batch and seed: BF16_STEP_TOL."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves

    cfg = solver.config
    dbatch = solver._put(next(solver.tr_set.epoch(0)))
    res = {}
    for mode in ("kernel", "plain"):
        params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, cfg.model, solver.device)
        trainer = Trainer(cfg)
        state = trainer.init_state(params)
        holder = {}

        def step():
            holder["m"] = trainer.train_step(state, dbatch, solver.step_generator(0))

        if mode == "kernel":
            cnt, dt = _bf16_counted(step, kernels, f"{what} train step (kernels)")
        else:
            with mock.patch.object(cuda_build, "use_plain", lambda x: True):
                t1 = time.time()
                step()
                torch.cuda.synchronize()
                dt = time.time() - t1
        m = holder["m"]
        res[mode] = (float(m["loss"]), float(m["grad_norm"]), [p.detach().clone() for p in param_leaves(state.params)],
                     dt)
    (lk, gk, pk, tk), (lp_, gp, pp, tp) = res["kernel"], res["plain"]
    loss_rel, gn_rel = abs(lk - lp_) / abs(lp_), abs(gk - gp) / abs(gp)
    p_err = max(float((a - c).abs().max()) for a, c in zip(pk, pp))
    tol = BF16_STEP_TOL
    print(f"{what} bf16 train step kernel vs plain: loss {lk:.6f} vs {lp_:.6f} (rel {loss_rel:.2e}, tolerance "
          f"{tol['loss_rel']}); grad_norm {gk:.6f} vs {gp:.6f} (rel {gn_rel:.2e}, tolerance {tol['grad_norm_rel']}); "
          f"updated params max abs diff {p_err:.3e} (tolerance {tol['param_abs']}); step {tk:.2f}s vs {tp:.2f}s",
          flush=True)
    if not (loss_rel <= tol["loss_rel"] and gn_rel <= tol["grad_norm_rel"] and p_err <= tol["param_abs"]):
        fail(f"{what}: the kernel and plain bf16 train steps disagree")
    return dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=p_err, kernel_step_s=tk, plain_step_s=tp,
                launches=cnt)


def _variant_step_profile(solver, what, smi):
    """Wall, device busy and launches of one replayed train step of the
    solver's graphs (``profile_run``: median of 3 host-clock walls)."""
    from e2e_asr_tpu_torch.bin.profile_decode import profile_run

    batch = next(solver.tr_set.epoch(0))
    dbatch = solver._put(batch)
    k = [100]

    def run():
        k[0] += 1
        solver.trainer.train_step(solver.state, dbatch, solver.step_generator(k[0]), graphs=solver.train_graphs)

    prof = profile_run(run, float(batch.wav_len.sum()) / solver.config.data.audio.sample_rate, reps=3)
    prof["kernels"] = prof["kernels"][:12]
    print(f"{what} train step (replayed graph, B=16, 816 bucket, bf16): wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms (idle share {prof['device_idle_share']:.3f}), {prof['host_launches']} "
          f"launches issued by the host, {prof['kernel_launches']} device launches, on {smi}", flush=True)
    for row in prof["kernels"][:6]:
        print(f"    {row['device_ms']:.3f} ms  x{row['count']}  {row['name'][:100]}", flush=True)
    return prof


def _variant_encoder_profile(solver, what, smi):
    """The encoder's share of a variant's step: its forward and backward
    alone (the step's features, at the compute type; the gradients of every
    encoder parameter from the sum of its output) captured as a CUDA graph
    and profiled replaying (``profile_run``), against the whole step's
    busy (``_variant_step_profile``)."""
    from e2e_asr_tpu_torch.bin.profile_decode import profile_run
    from e2e_asr_tpu_torch.device import graph_capture
    from e2e_asr_tpu_torch.models.encoder import encoder_apply
    from e2e_asr_tpu_torch.ops.frontend import compute_features
    from e2e_asr_tpu_torch.training.step import compute_dtype, param_leaves, resolve_wav

    cfg = solver.config
    batch = next(solver.tr_set.epoch(0))
    wav, wav_len = resolve_wav(solver._put(batch))
    feat, feat_len = compute_features(wav, wav_len, cfg.data.audio)
    feat = feat.to(compute_dtype(cfg))
    enc_p = solver.state.params["encoder"]
    leaves = param_leaves(enc_p)

    def fwd_bwd():
        with torch.enable_grad():
            enc, _ = encoder_apply(enc_p, cfg.model.encoder, feat, feat_len)
            return torch.autograd.grad(enc.float().sum(), leaves)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd_bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph, None, side):
        out = fwd_bwd()
    torch.cuda.synchronize()
    prof = profile_run(graph.replay, float(batch.wav_len.sum()) / cfg.data.audio.sample_rate, reps=3)
    prof["kernels"] = prof["kernels"][:8]
    del graph, out
    print(f"{what} encoder forward + backward alone (replayed graph, bf16): wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['device_busy_ms']:.2f} ms, {prof['kernel_launches']} device launches, on {smi}", flush=True)
    return prof


def variants_phase(dev, smi, batch):
    """The encoder and speller variants at the flagship's full widths
    (40-dim features, 4 layers of 320, attention 300 / 10 x 201 taps, a
    320-wide speller, B 16 in the 816 bucket, bf16), set by ``VARIANTS``'
    overrides. V1 (CNN prenet, bidirectional GRU layers, GRU speller):
    VARIANT_STEPS steps + validation through Solver.exec (the step and the
    validation replaying their CUDA graphs; log_mel and the CTC loss
    launched; the GRU and the loop speller plain), the att_align PNG
    written; the replay against the eager step and validation, bitwise;
    the kernel step against the plain step (BF16_STEP_TOL); one replayed
    step profiled, and the encoder's forward + backward alone (its share of
    the step's busy); a GRU LM at lm_example.yaml's widths trained
    VARIANT_LM_STEPS steps + validation through its graphs (replay against
    eager bitwise); one decode batch with that LM fused (beam 16, ctc 0.3,
    LM 0.3) through ``decode_phase``. V2 (VGG prenet, one-direction LSTM
    layers, LSTM speller, the embedding regularizer at weight 0.5, fuse 0):
    the same training checks, the encoder through the lstm_seq pair with
    one direction and the speller through the scan pair with the plugin's
    hidden-state cotangent (all bf16 variants launched); one step at fuse
    0.3, which takes the loop (no scan launch); one decode batch at fuse
    0.3."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.align_image import read_png
    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.bin.profile_decode import LM_RECIPE, smoke_solver
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc_cuda import ctc_lattice
    from e2e_asr_tpu_torch.ops.decoder_cuda import decoder_scan_bwd, decoder_scan_fwd
    from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel
    from e2e_asr_tpu_torch.ops.rnn_cuda import lstm_seq_bwd, lstm_seq_fwd
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    f32 = {"log_mel": log_mel, "ctc_loss": ctc_lattice}
    bf16 = {"V1": {}, "V2": {"lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd,
                             "decoder_scan_fwd": decoder_scan_fwd, "decoder_scan_bwd": decoder_scan_bwd}}
    out = {}
    for name in ("V1", "V2"):
        what = f"variant {name} ({', '.join(o.split('.', 1)[1] for o in VARIANTS[name])})"
        t_phase = time.time()
        root = os.path.join(cuda_build.BUILD_DIR, f"smoke_variant_{name}")
        solver = _variant_train_solver(root, _variant_config(name, VARIANT_STEPS), f"variant_{name}")
        cfg = solver.config
        if (cfg.model.encoder.dim, cfg.model.decoder.dim, solver.compute_dtype) != ([320] * 4, 320, "bfloat16"):
            fail(f"{what} is not at the flagship's widths and bf16")
        if solver.train_graphs is None or solver.eval_graphs is None:
            fail(f"{what}: the train step or the validation does not run through CUDA graphs")
        route = asr_mod.speller_route(solver.state.params, cfg.model, True, solver.device)
        if route != {"V1": "loop", "V2": "fused"}[name]:
            fail(f"{what}: the speller takes the {route} route")
        launches, wall = _bf16_counted(solver.exec, {"bf16": bf16[name], "f32": f32}, f"{what} train",
                                       decode_f32=("lstm_seq_fwd",))
        log = list(solver.step_log)
        if len(log) != VARIANT_STEPS:
            fail(f"{what}: {len(log)} steps ran, expected {VARIANT_STEPS}")
        _check_steps(log, what)
        if name == "V2" and not all(math.isfinite(r["emb_reg_loss"]) and r["emb_reg_loss"] > 0 for r in log):
            fail(f"{what}: the embedding regularizer's loss is missing or not positive")
        pngs = sorted(f for f in os.listdir(solver.logdir) if f.startswith("att_align_") and f.endswith(".png"))
        if len(pngs) != 1:
            fail(f"{what}: validation wrote {pngs}, expected one att_align PNG")
        img = read_png(os.path.join(solver.logdir, pngs[0]))
        print(f"  {what}: dev {solver.dev_summary}; {pngs[0]} {list(img.shape)}; {VARIANT_STEPS} steps + "
              f"validation {wall:.1f}s; captures {[round(t, 2) for _, t in solver.train_graphs.captures]} s (train), "
              f"{[round(t, 2) for _, t in solver.eval_graphs.captures]} s (validation)", flush=True)
        if not all(math.isfinite(v) for v in solver.dev_summary.values()):
            fail(f"{what}: validation gave a non-finite number")
        res = dict(launches=launches, steps=log, dev=solver.dev_summary, wall_s=wall, align_png=list(img.shape),
                   captures=solver.train_graphs.captures, eval_captures=solver.eval_graphs.captures)
        res["step_profile"] = _variant_step_profile(solver, what, smi)
        res["encoder_profile"] = _variant_encoder_profile(solver, what, smi)
        share = res["encoder_profile"]["device_busy_ms"] / res["step_profile"]["device_busy_ms"]
        res["encoder_busy_share"] = share
        print(f"{what}: the encoder's forward + backward is {100 * share:.1f}% of the step's busy", flush=True)
        res["graph_check"] = _variant_replay_vs_eager(solver, what)
        res["parity"] = _variant_parity(solver, {"bf16": bf16[name], "f32": f32}, what)
        ckpt = os.path.join(solver.ckpdir, "latest")

        dcfg = _variant_config(name, VARIANT_STEPS)
        if name == "V1":
            # ---- a GRU LM at lm_example.yaml's widths, on the recogniser's tokenizer
            from e2e_asr_tpu_torch.bin.train_lm import Solver as LMSolver

            lm_cfg = Config.load(LM_RECIPE)
            lm_cfg.lm.module = "GRU"
            c = lm_cfg.data.corpus
            c.name, c.path, c.train_split, c.dev_split = "synthetic", "", ["train:640"], ["dev:64"]
            lm_cfg.data.text.vocab_file = os.path.join(solver.ckpdir, "tokenizer.vocab")
            h = lm_cfg.hparas
            h.max_step, h.valid_step, h.log_step, h.seed = VARIANT_LM_STEPS, VARIANT_LM_STEPS, 1, SEED
            paras = types.SimpleNamespace(config=LM_RECIPE, name="gru_lm", logdir=os.path.join(root, "lm_log"),
                                          ckpdir=os.path.join(root, "lm_ckpt"), load=None, seed=SEED, cpu=False,
                                          verbose=True)
            lm_solver = LMSolver(lm_cfg, paras, "train")
            lm_solver.load_data()
            lm_solver.set_model()
            if lm_solver.graphs is None or (lm_cfg.lm.emb_dim, lm_cfg.lm.dim, lm_cfg.lm.n_layers) != (512, 512, 2):
                fail("the GRU LM is not at lm_example.yaml's widths or does not run through its graphs")
            t0 = time.time()
            lm_solver.exec()
            torch.cuda.synchronize()
            lm_wall = time.time() - t0
            lm_log = list(lm_solver.step_log)
            if len(lm_log) != VARIANT_LM_STEPS or not all(math.isfinite(r["loss"]) and r["step_skipped"] == 0.0
                                                         for r in lm_log):
                fail(f"the GRU LM's steps: {lm_log}")
            print(f"  GRU LM (lm_example width): {VARIANT_LM_STEPS} steps + validation {lm_wall:.1f}s, step walls "
                  f"{[round(r['wall_s'] * 1e3, 1) for r in lm_log]} ms, dev ppl {lm_solver.dev_ppl:.3f} on {smi}",
                  flush=True)
            # the LM step's replay against the eager step, two steps of one batch
            from e2e_asr_tpu_torch.models import lm as lm_mod
            from e2e_asr_tpu_torch.optim import Optimizer
            from e2e_asr_tpu_torch.training.lm_graph import LMGraphs
            from e2e_asr_tpu_torch.training.step import TrainState, param_leaves

            def fresh_lm():
                gen = torch.Generator()
                gen.manual_seed(SEED)
                params = lm_mod.lm_init(gen, lm_solver.vocab_size, lm_cfg.lm, dev)
                leaves = param_leaves(params)
                for p in leaves:
                    p.requires_grad_(True)
                opt = Optimizer(lm_cfg.hparas)
                return TrainState(params, opt.init(leaves), 0), opt

            (sg, og), (se, oe) = fresh_lm(), fresh_lm()
            lb = lm_solver._put(next(lm_solver.tr_set.epoch(0)))
            lm_graphs = LMGraphs()
            lm_same = True
            for i in range(2):
                mg = train_lm.train_step(sg, og, lm_cfg.lm, lb, lm_solver.step_generator(i), graphs=lm_graphs)
                got = mg["scalars"].clone()
                me = train_lm.train_step(se, oe, lm_cfg.lm, lb, lm_solver.step_generator(i))
                lm_same &= torch.equal(got, me["scalars"]) and all(
                    torch.equal(a, c) for a, c in zip(_state_tensors(sg), _state_tensors(se)))
            print(f"  GRU LM step capture + replay vs eager: scalars and every tensor bitwise {lm_same}", flush=True)
            if not lm_same:
                fail("the GRU LM's replayed step is not bitwise the eager step")
            res["lm"] = dict(steps=lm_log, wall_s=lm_wall, dev_ppl=lm_solver.dev_ppl, graph_bitwise=lm_same)
            dcfg.lm = lm_cfg.lm
            dcfg.decode.lm_weight, dcfg.decode.lm_config = 0.3, ""
            dcfg.decode.lm_path = os.path.join(lm_solver.ckpdir, "best_ppl")
            lstm_fwd = None
        else:
            # ---- fused decoding in training: the loop, captured
            fcfg = _variant_config(name, VARIANT_STEPS, ("model.emb_reg.fuse=0.3",))
            params, _ = asr_mod.asr_init(SEED, solver.feat_dim, solver.vocab_size, fcfg.model, solver.device)
            from e2e_asr_tpu_torch.training.step import Trainer

            trainer = Trainer(fcfg)
            state = trainer.init_state(params)
            if asr_mod.speller_route(state.params, fcfg.model, True, solver.device) != "loop":
                fail(f"{what}: emb_reg.fuse 0.3 does not take the loop")
            for fn in (decoder_scan_fwd, decoder_scan_bwd):
                fn.launches = fn.launches_bf16 = 0
            fb = solver._put(next(solver.tr_set.epoch(0)))
            graphs = TrainGraphs()
            fm = [float(trainer.train_step(state, fb, solver.step_generator(i), graphs=graphs)["loss"])
                  for i in range(2)]
            scan = sum(fn.launches + fn.launches_bf16 for fn in (decoder_scan_fwd, decoder_scan_bwd))
            print(f"  {what} at emb_reg.fuse 0.3: route loop, 2 steps (capture, replay) losses {fm}, scan launches "
                  f"{scan}", flush=True)
            if scan or not all(math.isfinite(v) for v in fm):
                fail(f"{what} at fuse 0.3: the scan launched or a loss is not finite")
            res["fuse_step"] = dict(losses=fm, scan_launches=scan)
            dcfg.model.emb_reg.fuse = 0.3
            lstm_fwd = ("lstm_seq_fwd", lstm_seq_fwd)
        # ---- one decode batch (beam 16, ctc 0.3; V1 with the GRU LM, V2 at fuse 0.3)
        dsolver = smoke_solver(os.path.join(root, "decode"), SEED, ckpt=ckpt, cfg=dcfg)
        tag = f", {what}" + (", GRU LM fused at 0.3" if name == "V1" else ", emb_reg.fuse 0.3")
        d = decode_phase(dsolver, batch, "auto", lstm_fwd, smi, tag=tag)
        d.pop("top_tokens")
        d.pop("top_scores")
        res["decode"] = d
        res["phase_s"] = time.time() - t_phase
        print(f"{what}: phase {res['phase_s']:.1f}s on {smi}", flush=True)
        out[name] = res
        del solver, dsolver
    return out


STAGE_SOL_MAX = 1.05  # a stage's ceiling over its measured time: above this the count is wrong
# (name, recipe, bucket frames, batch (0: the recipe's, halved above half_batch_len), compute type, traced)
STAGE_TABLES = (("flagship, float32", "configs/libri/asr_example.yaml", 816, 16, "float32", False),
                ("flagship, bfloat16", "configs/libri/asr_example.yaml", 816, 16, "bfloat16", True),
                ("asr_960h.yaml, bfloat16", "configs/libri/asr_960h.yaml", 3056, 0, "bfloat16", False))
# kernel names a traced flagship step must show: the scan pair's and the lstm_seq pair's sweeps
TRACE_KERNELS = ("decoder_scan_fwd_kernel", "decoder_scan_bwd_kernel", "lstm_fwd_sweep_kernel",
                 "lstm_bwd_sweep_kernel")
# the kernels each stage program of STAGE_TABLES' recipes launches (the encoder's
# BiLSTM layers under rnn_impl auto: the lstm_seq pair), by wrapper name
STAGE_KERNELS = {"frontend_fwd": ("log_mel",), "encoder_fb": ("lstm_seq_fwd", "lstm_seq_bwd"),
                 "ctc_fb": ("ctc_lattice",), "decoder_fb": ("decoder_scan_fwd", "decoder_scan_bwd")}


def stages_phase(smi):
    """The train step's stages (``utils/stages.py`` through
    ``bin/profile_decode.stage_table``) for each of STAGE_TABLES: every
    stage program (features, encoder, CTC, speller, optimizer) captured as a
    CUDA graph from seed-0 weights and its replays timed, against its
    ceiling, and the stages' sum against one replayed train step's busy;
    the flagship's bf16 step traced once (``utils/profiling.trace``). Fails
    if a stage's ms is not finite and positive, if its sol exceeds
    STAGE_SOL_MAX, if a stage program does not launch each of its kernels
    (STAGE_KERNELS: log_mel, the lstm_seq pair, ctc_loss, the scan pair, in
    the table's variant) in a replay, or if the launch counters, set to 0
    just before the stage programs run and read just after, show one of
    them not launched; or if the trace is empty or names none of
    TRACE_KERNELS."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin.profile_decode import stage_table
    from e2e_asr_tpu_torch.config import Config

    tdir = os.path.join(cuda_build.BUILD_DIR, "stages_trace")
    out = {}
    for name, path, frames, batch, dtype, traced in STAGE_TABLES:
        print(f"[stages] {name} ({path}, {frames}-frame bucket) on {smi}", flush=True)
        res = stage_table(Config.load(path), frames, dtype, batch, trace_dir=tdir if traced else "")
        for stage, kernels in STAGE_KERNELS.items():
            # log_mel and ctc_loss run float32 at either compute type
            want = [k if k in ("log_mel", "ctc_lattice") or dtype == "float32" else f"{k}_bf16" for k in kernels]
            got = res["stage_launches"].get(stage, {})
            print(f"  {stage} launches a replay: {got}", flush=True)
            if not all(got.get(k, 0) > 0 for k in want):
                fail(f"stages {name}: the {stage} program does not launch {want}: {got}")
            if not all(res["launches"].get(k, 0) > 0 for k in want):
                fail(f"stages {name}: the counters after the stage programs show {want} not launched: "
                     f"{res['launches']}")
        for k, ms in res["stage_ms"].items():
            sol = res["ceilings"][k]["ceiling_ms"] / ms if ms > 0 else math.inf
            if not (math.isfinite(ms) and ms > 0):
                fail(f"stages {name}: {k} took {ms} ms")
            if sol > STAGE_SOL_MAX:
                fail(f"stages {name}: {k}'s ceiling {res['ceilings'][k]['ceiling_ms']:.5f} ms is above its "
                     f"measured {ms:.5f} ms (sol {sol:.3f}): a wrong count")
        print(f"  launches in the stage programs' timed replays: {res['launches']}", flush=True)
        out[name] = res
    trace_path = out["flagship, bfloat16"]["trace"]
    text = open(trace_path).read() if os.path.isfile(trace_path) else ""
    missing = [k for k in TRACE_KERNELS if k not in text]
    print(f"[stages] trace of a replayed flagship bf16 step: {trace_path}, {len(text)} bytes; "
          f"kernels named: {[k for k in TRACE_KERNELS if k in text]}", flush=True)
    if not text or missing:
        fail(f"the traced flagship step is empty or does not name {missing}")
    out["trace_bytes"] = len(text)
    return out


def main(json_path: str = "", parent: str = "") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from e2e_asr_tpu_torch import cuda_build, native
        from e2e_asr_tpu_torch.bin.profile_decode import (DECODE_PHASE_VARIANTS, FLAGSHIP, PHASE_VARIANTS,
                                                          RECIPE_960H, smoke_solver)
        from e2e_asr_tpu_torch.config import Config
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
    t0 = time.time()
    print(f"native host library (g++): {os.path.basename(native.build())} in {time.time() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack frame" in line:
                print(f"  ptxas {name}: {line.strip()}")

    solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "smoke"), SEED)
    cfg = solver.config
    batch = next(solver.eval_sets["dev"].epoch())
    if batch.wav.shape != (16, (816 - 1) * 160 + 400):
        fail(f"smoke batch has shape {batch.wav.shape}, expected 16 utterances in the 816 bucket")
    with torch.inference_mode():
        kern = kernel_checks(dev, cfg, solver.vocab_size, batch.wav)
    kern.update(train_kernel_checks(dev, cfg, solver.vocab_size))
    kern.update(scan_kernel_checks(dev, cfg, solver.vocab_size))
    kern.update(lstm_seq_checks(dev))
    kern_bf16 = bf16_kernel_checks(dev, cfg, solver.vocab_size)
    kern_960h = recipe_960h_kernel_checks(dev, Config.load(RECIPE_960H), solver.vocab_size)
    if parent:
        kern["prefix_recursion"]["parent_path"] = parent_prefix_path(parent)
    mel_waves = kern["log_mel"].pop("parent_waves")

    # ---- the serving path through the CLI's Solver, on the card, under
    # either LSTM route: the default first, then the fused-projection kernel
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

    # ---- the fused decode: a seed-0 LM of lm_example.yaml's width fused in at
    # decode_example.yaml's lm_weight 0.3, under either LSTM route; then one
    # batch decoded without and with the LM in turns
    lm_solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "smoke_lm_decode"), SEED, lm_weight=0.3)
    if lm_solver.lm_params is None or (lm_solver.config.decode.lm_weight, lm_solver.config.decode.ctc_weight) != (
            0.3, 0.3):
        fail("the fused decode has no LM, or not decode_example.yaml's weights")
    decode_lm = {impl: decode_phase(lm_solver, batch, impl, lstm_fwd, smi, tag=", lm_weight 0.3")
                 for impl, lstm_fwd in (("auto", ("lstm_seq_fwd", lstm_seq_fwd)),
                                        ("pallas", ("lstm_bidir_fwd", lstm_bidir_fwd)))}
    lm_solver.config.model.encoder.rnn_impl = "auto"
    for d in decode_lm.values():
        d.pop("top_scores")
        d.pop("top_tokens")
    print(f"decode of one batch without and with the LM, in turns, on {smi} (rnn_impl auto):", flush=True)
    decode_lm["in_turns"] = decode_in_turns({"lm_weight 0": solver, "lm_weight 0.3": lm_solver}, batch)

    # ---- the training paths
    train = train_phase(smi)
    graph = graph_phase(smi)
    evals = eval_graph_phase(smi)
    lm_train = lm_train_phase(dev, smi)
    conv = convergence_phase(dev, smi)
    recipes = recipe_phase(conv.pop("ckpt"), smi)
    loader = loader_phase(smi)
    bf16 = bf16_phase(dev, smi, batch)
    r960 = recipe_960h_phase(smi)
    variants = variants_phase(dev, smi, batch)
    ddp = ddp_phase(smi)
    stage_tables = stages_phase(smi)
    r = kern["log_mel"]
    mel_waves["convergence_batch"] = conv.pop("log_mel_wave")
    for key, v in zip(("max_abs_err_by_wave", "cufft_max_abs_err_by_wave", "f64_max_abs_err_by_wave"),
                      conv["log_mel_check"]):
        r[key]["convergence_batch"] = v
    r["max_abs_err"] = max(r["max_abs_err_by_wave"].values())
    if parent:
        r["parent_path"] = parent_log_mel(parent, mel_waves)
        bf16["f32_against_parent"] = parent_f32(parent)

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
        ("flagship decode with the LM fused in (lm_weight 0.3), rnn_impl auto (default)",
         decode_lm["auto"]["launches"]),
        ("flagship decode with the LM fused in (lm_weight 0.3), rnn_impl pallas (pinned)",
         decode_lm["pallas"]["launches"]),
        (f"LM train (lm_example.yaml width), {LM_STEPS} steps + validation through bin/train_lm.Solver.exec "
         "(step and evaluation graph replays)", lm_train["launches"]),
        *((f"flagship validation, one dev epoch (one batch, 240 greedy steps) replaying its CUDA graph, float32, "
           f"rnn_impl {impl}", {("ctc_loss" if k == "ctc_lattice" else k): v
                                for k, v in evals[f"float32_{impl}"]["runs"]["replay"]["launches"].items()})
          for impl in ("auto", "pallas")),
        (f"main --lm on configs/synthetic_lm_conv.yaml, {RECIPE_LM_STEPS} steps + validation",
         recipes["lm_launches"]),
        ("main --test on configs/synthetic_decode_conv.yaml with that LM fused in", recipes["decode_launches"]),
        *((f"loader way ({way}): convergence recipe, {LOADER_STEPS} steps + validation, njobs {r['njobs']}, "
           f"{r['input_mode']}", r["launches"]) for way, r in loader.items()),
        *((f"data parallel (a), world-1 NCCL group: {run} (flagship, {DDP_STEPS} steps + 2 validations through the "
           "graphs, or the dev batch's decode)", r["launches"]) for run, r in ddp["world1_nccl"].items()),
        ("data parallel (b), two gloo ranks on one card: rank 0's eager flagship step, float32",
         ddp["two_gloo_ranks_step"]["float32"]["launches"]),
        ("data parallel (c), two-rank sharded decode over gloo: rank 0's dev batch", ddp["two_rank_decode"]["launches"][0]),
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
                                  "parent_path", "max_abs_err_by_wave", "cufft_ms", "cufft_max_abs_err_by_wave",
                                  "f64_max_abs_err_by_wave")
                                  if k in kv},
        })
    # the bf16 variants: launches of the bf16 flagship training through
    # Solver.exec (default route), and of the bf16 kernel step of the parity
    # check with rnn_impl pallas pinned for the fused-projection pair
    bf16_paths = {
        "lstm_seq_fwd": ("bf16 flagship train through bin/train_asr.Solver.exec, rnn_impl auto (default)",
                         bf16["train"]["launches"]),
        "lstm_bidir_fwd_train": ("bf16 flagship train step (parity check), rnn_impl pallas (pinned)",
                                 bf16["parity"]["pallas"]["launches"]),
    }
    for name, kv in kern_bf16.items():
        what, counts = bf16_paths["lstm_bidir_fwd_train" if name.startswith("lstm_bidir") else "lstm_seq_fwd"]
        rows.append({
            "name": f"{name}_bf16", "route": "cuda", "source": kern[name]["source"],
            "replaces": kern[name]["replaces"], "launches": counts[f"{name}_bf16"],
            "max_abs_err": kv["max_abs_err"], "ms": kv["ms"], "plain_ms": kv["plain_ms"],
            "bound_ms": kv["bound"][0], "bound_by": kv["bound"][1], "library_ms": kv["library_ms"],
            "ms_f32_same_values": kv["ms_f32"], "shapes": kv["shapes"], "per_shape": kv["per_shape"],
            "launches_path": what,
            "launches_data_parallel": {
                "world-1 NCCL group, flagship bf16 train": ddp["world1_nccl"]["train_bfloat16"]["launches"].get(
                    f"{name}_bf16", 0),
                "two gloo ranks on one card, rank 0's bf16 step": ddp["two_gloo_ranks_step"]["bfloat16"]["launches"].get(
                    f"{name}_bf16", 0)},
        })
    # configs/libri/asr_960h.yaml: each kernel at the recipe's shapes, with
    # its launches in the recipe's runs (a replayed train step a bucket and
    # route, each counted alone; the decode batch)
    runs_960h = {f"train step replay, rnn_impl {k.split('_')[0]}, {k.split('_')[1]}-frame bucket": v["launches"]
                 for k, v in r960["steps"].items()}
    runs_960h["decode batch (lm_weight 0.3), rnn_impl auto"] = r960["decode"]["launches"]
    for row in rows:
        name = row["name"]
        at = kern_960h.get(name) or row.get("per_shape", {}).get("960h")
        counted = {run: cnt[name] for run, cnt in runs_960h.items() if cnt.get(name)}
        if at is not None or counted:
            row["recipe_960h"] = {**({k: v for k, v in at.items() if k != "bound"} if at else {}),
                                  **({"bound_ms": at["bound"][0], "bound_by": at["bound"][1]} if at else {}),
                                  "launches": counted}
    # the variants (variants_phase): each kernel's launches in their runs
    variant_runs = []
    for name, v in variants.items():
        variant_runs += [(f"variant {name}: {VARIANT_STEPS} bf16 steps + validation through Solver.exec", v["launches"]),
                         (f"variant {name}: one eager bf16 kernel step (parity check)", v["parity"]["launches"]),
                         (f"variant {name}: decode batch through Solver.exec", v["decode"]["launches"])]
    for row in rows:
        row["launches_variants"] = {run: cnt[row["name"]] for run, cnt in variant_runs if cnt.get(row["name"])}
    print("variants path launches: " + json.dumps({row["name"]: row["launches_variants"] for row in rows
                                                   if row["launches_variants"]}), flush=True)
    out = json_path or os.path.join(cuda_build.BUILD_DIR, "chip_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": smi, "kernels": rows, "decode": decode, "decode_routes_score_rel_diff": route_err,
                   "decode_lm": decode_lm, "train": train, "train_graphs": graph, "eval_graphs": evals,
                   "lm_train": lm_train,
                   "convergence": conv,
                   "recipes": recipes, "loader": loader, "bf16": bf16, "recipe_960h": r960, "variants": variants,
                   "data_parallel": ddp, "stages": stage_tables}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="chip smoke run of the PyTorch/CUDA port")
    ap.add_argument("--parent", default="", help="a checkout of the parent commit: time log_mel (and hold it "
                    "against its plain version on the same waves) and the CTC prefix side of a beam step there "
                    "and here, in turns; hold the float32 kernels that have a bf16 variant bitwise to the "
                    "parent's")
    ap.add_argument("--json", default="", help="where to write the detailed JSON "
                    "(default: e2e_asr_tpu_torch/_build/chip_smoke.json)")
    args = ap.parse_args()
    main(args.json, args.parent)
