"""Where the time of one flagship decode batch, or one training step, goes
on the card.

    python -m e2e_asr_tpu_torch.bin.profile_decode [--train [--scan-phases]] [--rnn-impl IMPL] [--out PATH]

Decode (default): decodes the chip smoke batch (16 synthetic utterances in
the 816-frame bucket, flagship width, seed-0 weights, beam 16, ctc_weight
0.3, lm 0). ``--train``: one training step of the flagship
(configs/libri/asr_example.yaml: Adadelta, grad_clip 5, SpecAugment on,
ctc_weight 0.5, tf 1.0, float32) on a batch of 16 synthetic utterances in
the 816-frame bucket, through ``bin/train_asr.Solver``'s trainer.

Either runs once to warm up, once timed by the host clock around a
synchronised run, and once under ``torch.profiler``. Prints the wall time,
the device's busy time (the sum of kernel times: one stream, so kernels do
not overlap), its idle share of the unprofiled and of the profiled wall,
and the kernels by device time. Writes the same as JSON to ``--out``
(default ``e2e_asr_tpu_torch/_build/profile_decode.json`` or
``profile_train.json``).

``--train --scan-phases`` instead splits one step of each fused speller
scan kernel into its phases: the kernels' timing build (``-DSCAN_PHASES``,
built beside the normal libraries) runs at the flagship training shapes
(B=16, S=204, Dk=300, E=640, K=10, P=201, H=Emb=320, V=26, L=200, ragged
lengths: the inputs of ``chip_smoke.py``'s scan checks) and the mean us per
phase per step of each kernel is printed (``profile_scan_phases.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time
import types

import torch

from e2e_asr_tpu_torch.ops.decoder_cuda import PHASE_BUILD

FLAGSHIP = "configs/libri/asr_example.yaml"


def flagship_smoke_config(rnn_impl: str = "auto"):
    """Flagship model + audio (configs/libri/asr_example.yaml), decoded as
    configs/libri/decode_example.yaml (beam 16, batch 16, ctc_weight 0.3,
    ctc_beam_ratio 1.5, max_len_ratio 0.6) with lm_weight 0, on 16
    synthetic utterances that all fall in the 816-frame bucket
    (half_batch_len above it keeps them one batch). ``rnn_impl`` routes the
    BiLSTM layers (``encoder.rnn_impl``)."""
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(FLAGSHIP)
    c = cfg.data.corpus
    c.name, c.path = "synthetic", ""
    c.train_split, c.dev_split, c.test_split = ["train:96"], ["dev:16"], []
    c.buckets, c.token_buckets, c.half_batch_len = [816], [200], 1000
    d = cfg.decode
    d.beam_size, d.batch_size, d.ctc_weight, d.lm_weight = 16, 16, 0.3, 0.0
    d.ctc_beam_ratio, d.max_len_ratio, d.min_len_ratio = 1.5, 0.6, 0.0
    cfg.model.encoder.rnn_impl = rnn_impl
    return cfg


def smoke_solver(outdir: str, seed: int = 0, rnn_impl: str = "auto"):
    """A test-mode Solver on the card over the smoke config, with a
    checkpoint of seeded flagship-width weights written to ``outdir``."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.bin.test_asr import Solver
    from e2e_asr_tpu_torch.data.dataset import load_eval_datasets
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.models import asr as asr_mod

    cfg = flagship_smoke_config(rnn_impl)
    dev = resolve_device("cuda")
    _, feat_dim, vocab, _, _ = load_eval_datasets(cfg.data, cfg.decode.batch_size)
    params, _ = asr_mod.asr_init(seed, feat_dim, vocab, cfg.model, dev)
    os.makedirs(outdir, exist_ok=True)
    ckpt = os.path.join(outdir, f"flagship_seed{seed}.pt")
    convert.save_checkpoint(ckpt, params, vocab, feat_dim)
    paras = types.SimpleNamespace(
        config=FLAGSHIP, name="smoke", outdir=outdir, load=ckpt, seed=seed, cpu=False, verbose=True,
    )
    solver = Solver(cfg, paras, "test")
    solver.load_data()
    solver.set_model()
    return solver


def flagship_train_config(max_step: int, rnn_impl: str = "auto"):
    """The smoke config (flagship model, audio and hparas; synthetic corpus,
    one 816-frame bucket of batch 16) trained for ``max_step`` steps and
    validated once at the last, logging every step."""
    cfg = flagship_smoke_config(rnn_impl)
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step = max_step, max_step, 1
    return cfg


def smoke_train_solver(outdir: str, seed: int = 0, max_step: int = 5, rnn_impl: str = "auto"):
    """A train-mode Solver on the card over ``flagship_train_config``, with
    fresh seed-``seed`` weights (no resume) and its logs and checkpoints
    under ``outdir``."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver

    cfg = flagship_train_config(max_step, rnn_impl)
    cfg.hparas.seed = seed
    paras = types.SimpleNamespace(
        config=FLAGSHIP, name="smoke_train", logdir=os.path.join(outdir, "log"),
        ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=seed, cpu=False, verbose=True,
        auto_resume=False,
    )
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


CONVERGENCE = "configs/synthetic_convergence.yaml"


def convergence_train_solver(outdir: str, seed: int = 0, max_step: int = 3, rnn_impl: str = "auto",
                             tf: float = 0.8):
    """A train-mode Solver on the card over the convergence recipe
    (configs/synthetic_convergence.yaml at its full width: batch 32, three
    256-wide BiLSTM layers on 80-dim fbank with no prenet, attention 128 / 8
    filters / 65 taps, 256-wide speller, Adam, encoder dropout 0.1), its
    splits cut to 96 training and 32 dev utterances, ``max_step`` steps and
    one validation, the teacher-forcing rate held at ``tf`` so that coins
    fail from the first step, and the BiLSTM layers routed by ``rnn_impl``."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(CONVERGENCE)
    c = cfg.data.corpus
    c.train_split, c.dev_split, c.test_split = ["train:96"], ["dev:32"], []
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step, h.seed = max_step, max_step, 1, seed
    h.tf_start = h.tf_end = tf
    cfg.model.encoder.rnn_impl = rnn_impl
    paras = types.SimpleNamespace(
        config=CONVERGENCE, name="smoke_convergence", logdir=os.path.join(outdir, "log"),
        ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=seed, cpu=False, verbose=True,
        auto_resume=False,
    )
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _run_fn(train: bool, rnn_impl: str):
    """(function that runs one unit of work, audio seconds in it)."""
    from e2e_asr_tpu_torch import cuda_build

    if train:
        solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "profile_train"), rnn_impl=rnn_impl)
        batch = solver._put(next(solver.tr_set.epoch(0)))
        audio_s = float(batch["wav_len"].sum()) / solver.config.data.audio.sample_rate

        def run():
            m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0))
            float(m["loss"])  # the step's own fence (the NaN/inf check already waits)

        return run, audio_s
    solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "profile"), rnn_impl=rnn_impl)
    batch = next(solver.eval_sets["dev"].epoch())
    audio_s = float(batch.wav_len.sum()) / solver.config.data.audio.sample_rate
    return (lambda: solver.decode_batch(batch.wav, batch.wav_len)), audio_s


# ----------------------------------------------- the fused scan's phase split
PHASE_VARIANTS = (("decoder_scan", PHASE_BUILD), ("decoder_scan_bwd", PHASE_BUILD))  # timing builds
PH_STEPS, PH_SLOTS = 512, 16  # csrc: steps recorded, marks per step
# the phases between consecutive marks of one step, in order (csrc PHASE(t, i))
FWD_PHASES = ("q pull and token", "conv", "energies", "softmax", "context partial",
              "cluster barrier 1", "combine", "grid barrier 1", "gate product", "cell update",
              "grid barrier 2", "logits, argmax and q slice", "cluster barrier 2")
BWD_PHASES = ("gate stage", "grid barrier 1", "row stage", "grid barrier 2",
              "loads and the softmax term", "conv", "energies",
              "reductions over frames", "dfpre", "cluster barrier", "pulls and transposed conv",
              "grid barrier 3")


def scan_inputs(gen, dev, b, s, dk, e_dim, kk, p, h, emb, v, l, lens):
    """Seeded inputs of the fused speller scan at the given shapes: (k, v,
    enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
    teacher [L, B] int32), weights at their init scales."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    uni = lambda bound, *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound
    return (torch.tanh(rnd(b, s, dk)), torch.tanh(rnd(b, s, e_dim)), lens,
            uni(1 / math.sqrt(p), kk, p), uni(1 / math.sqrt(h), h, dk), uni(0.1, dk),
            uni(1 / math.sqrt(kk), kk, dk), uni(1 / math.sqrt(dk), dk), uni(0.1, dk),
            rnd(v, emb) / math.sqrt(emb), uni(1 / math.sqrt(h), emb + e_dim, 4 * h),
            uni(1 / math.sqrt(h), h, 4 * h), uni(1 / math.sqrt(h), 4 * h),
            uni(1 / math.sqrt(h), h, v), uni(0.1, v),
            torch.randint(0, v, (l, b), generator=gen, device=dev, dtype=torch.int32))


def flagship_scan_inputs(dev, seed: int = 2):
    """The fused scan's inputs at the flagship training shapes, as
    ``chip_smoke.py`` draws them (seeded generator on ``dev``): B=16,
    S=204 with ragged lengths in [S/2, S], L=200 teacher ids."""
    from e2e_asr_tpu_torch.data.dataset import load_eval_datasets

    cfg = flagship_smoke_config()
    _, _, vocab, _, _ = load_eval_datasets(cfg.data, cfg.decode.batch_size)
    m, ac = cfg.model, cfg.model.attention
    b, s, l = cfg.data.corpus.batch_size, 816 // 4, cfg.data.corpus.token_buckets[-1]
    dk, e_dim, kk, p = ac.dim, 2 * m.encoder.dim[-1], ac.loc_kernel_num, 2 * ac.loc_kernel_size + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    lens[0] = s
    args = scan_inputs(gen, dev, b, s, dk, e_dim, kk, p, m.decoder.dim, m.decoder.dim, vocab, l, lens)
    return args, float(ac.temperature)


def scan_shape(args):
    """(B, S, Dk, E, K, P, H, V) of the fused scan's inputs ``args``."""
    k, v, _, taps, wq, *_rest = args
    return (k.shape[0], k.shape[1], k.shape[2], v.shape[2], taps.shape[0], taps.shape[1], wq.shape[0],
            args[13].shape[1])


def _phase_means(name: str, l: int, names) -> tuple:
    """Mean us per phase over the L steps of the last launch of the timing
    build of ``name`` (marks of the global timer, in ns), and the timer's
    step: the smallest nonzero difference of two marks."""
    from e2e_asr_tpu_torch import cuda_build

    out = torch.zeros(PH_STEPS * PH_SLOTS, dtype=torch.int64, device="cuda")
    cuda_build.launch(name, "e2e_decoder_scan_phase_times", out, out.numel(), defines=PHASE_BUILD)
    marks = out.view(PH_STEPS, PH_SLOTS)[:min(l, PH_STEPS)].double()
    diff = marks[:, 1:len(names) + 1] - marks[:, :len(names)]
    dur = diff.mean(0) / 1e3
    return {nm: float(x) for nm, x in zip(names, dur)}, float(diff[diff > 0].min())


def scan_phase_split(args, use_teacher, temp: float, cots=None, cluster_size=None):
    """The per-phase split of one step of each scan kernel (timing build:
    block 0 marks the global timer at every phase boundary of every step),
    on the card. ``args`` as ``scan_inputs``; ``cots`` the cotangents of
    (logits, align, hidden) for the backward (random if None). Returns
    {"fwd": {phase: mean us per step}, "bwd": {...}, "fwd_ms", "bwd_ms": the
    timing build's whole-launch times, "fwd_ms_normal", "bwd_ms_normal": the
    normal build's, "timer_step_ns"}; ``cluster_size`` overrides the grid's
    pick. Launch counters are not touched."""
    from e2e_asr_tpu_torch.ops.decoder_cuda import _bwd_launch, _fwd_launch

    k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout, teacher = args
    l = teacher.shape[0]
    res = {}
    fwd = lambda: _fwd_launch(PHASE_BUILD, *args, use_teacher, temp, False, 0, cluster_size)
    logits, align, hidden, (cseq, _, acts, qs, ctxs) = fwd()  # builds the variant, warms up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fwd()
    t1.record()
    torch.cuda.synchronize()
    res["fwd_ms"] = t0.elapsed_time(t1)
    res["fwd"], step_f = _phase_means("decoder_scan", l, FWD_PHASES)
    if cots is None:
        g = torch.Generator(device=k.device)
        g.manual_seed(0)
        cots = [torch.randn(o.shape, generator=g, device=k.device) / math.sqrt(o.shape[-1])
                for o in (logits, align, hidden)]
    bwd = lambda: _bwd_launch(PHASE_BUILD, k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout,
                              align, hidden, cseq, acts, qs, ctxs, *cots, temp, cluster_size)
    bwd()
    torch.cuda.synchronize()
    t0.record()
    bwd()
    t1.record()
    torch.cuda.synchronize()
    res["bwd_ms"] = t0.elapsed_time(t1)
    res["bwd"], step_b = _phase_means("decoder_scan_bwd", l, BWD_PHASES)
    res["timer_step_ns"] = min(step_f, step_b)
    res["steps"] = l
    for w, fn in (("fwd", lambda: _fwd_launch((), *args, use_teacher, temp, False, 0, cluster_size)),
                  ("bwd", lambda: _bwd_launch((), k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout,
                                              align, hidden, cseq, acts, qs, ctxs, *cots, temp,
                                              cluster_size))):
        fn()
        torch.cuda.synchronize()
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        torch.cuda.synchronize()
        res[f"{w}_ms_normal"] = t0.elapsed_time(t1) / 3
    return res


def print_scan_phases(split: dict) -> None:
    """One line a kernel: the mean us per phase, their sum, and the sum over
    the L steps beside the timing build's launch time (the rest is the
    launch's set-up before the first step and its tail after the last)."""
    for which, w in (("decoder_scan_fwd", "fwd"), ("decoder_scan_bwd", "bwd")):
        ph = split[w]
        parts = ", ".join(f"{k} {v:.2f}" for k, v in ph.items())
        total = sum(ph.values())
        print(f"{which} phases, mean us per step (timing build, {split[w + '_ms']:.2f} ms a launch; "
              f"normal build {split[w + '_ms_normal']:.2f} ms): {parts}; sum {total:.2f} us x "
              f"{split['steps']} steps = {total * split['steps'] / 1e3:.2f} ms of the "
              f"{split[w + '_ms']:.2f} (global timer step {split['timer_step_ns']:.0f} ns)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile one training step")
    ap.add_argument("--rnn-impl", default="auto", choices=("auto", "pallas", "pallas_xw"),
                    help="kernel pair of the BiLSTM layers (encoder.rnn_impl)")
    ap.add_argument("--scan-phases", action="store_true",
                    help="with --train: split a step of each fused scan kernel into its phases")
    ap.add_argument("--cluster-sizes", default="",
                    help="with --scan-phases: comma-separated cluster sizes to split the kernels at "
                         "(default: the size the grid picks)")
    ap.add_argument("--out", default="", help="JSON result (default: _build/profile_*.json)")
    args = ap.parse_args(argv)
    if args.scan_phases and not args.train:
        ap.error("--scan-phases needs --train")
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from e2e_asr_tpu_torch import cuda_build

    what = "scan_phases" if args.scan_phases else "train" if args.train else "decode"
    out = args.out or os.path.join(cuda_build.BUILD_DIR, f"profile_{what}.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.scan_phases:
        from e2e_asr_tpu_torch.device import resolve_device
        from e2e_asr_tpu_torch.ops import decoder_cuda as dc

        cuda_build.build_all(PHASE_VARIANTS)  # every library, the timing build too, in parallel
        dev = resolve_device("cuda")
        scan_args, temp = flagship_scan_inputs(dev)
        use = torch.ones(scan_args[-1].shape[0], dtype=torch.bool)
        splits = {}
        for cl in [int(c) for c in args.cluster_sizes.split(",") if c] or [None]:
            split = scan_phase_split(scan_args, use, temp, cluster_size=cl)
            grids = {w: dc.scan_grid(w, *scan_shape(scan_args), cluster_size=cl) for w in ("fwd", "bwd")}
            print(f"{card}: fused scan phase split, flagship training shapes; grid {grids}")
            print_scan_phases(split)
            splits[str(grids["fwd"]["cluster_size"])] = {**split, "grid": grids}
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "by_cluster_size": splits}, f, indent=1)
        return
    run, audio_s = _run_fn(args.train, args.rnn_impl)
    run()  # warm-up
    torch.cuda.synchronize()

    # wall time without the profiler, host clock around a synchronised run
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    rows = []
    for evt in prof.key_averages():
        us = _device_time_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "count": evt.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    launches = sum(r["count"] for r in rows)
    result = {
        "card": card, "what": what, "rnn_impl": args.rnn_impl, "wall_ms": wall_ms, "audio_s": audio_s,
        "audio_s_per_s": audio_s / (wall_ms / 1e3),
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_wall_ms, "kernel_launches": launches,
        "kernels": rows,
    }
    unit = "one train step (B=16)" if args.train else "decode (B=16, W=16)"
    print(f"{card}: {unit} of {audio_s:.2f} audio-s wall {wall_ms:.1f} ms = "
          f"{result['audio_s_per_s']:.1f} audio-s/s")
    print(f"profiled: wall {prof_wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{result['device_idle_share']:.3f} of the unprofiled wall "
          f"({result['device_idle_share_profiled']:.3f} profiled), {launches} kernel launches")
    for r in rows[:25]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name'][:100]}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
