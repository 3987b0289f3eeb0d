"""Where the time of one flagship decode batch, or one training step, goes
on the card.

    python -m e2e_asr_tpu_torch.bin.profile_decode [--train] [--out PATH]

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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import types

import torch

FLAGSHIP = "configs/libri/asr_example.yaml"


def flagship_smoke_config():
    """Flagship model + audio (configs/libri/asr_example.yaml), decoded as
    configs/libri/decode_example.yaml (beam 16, batch 16, ctc_weight 0.3,
    ctc_beam_ratio 1.5, max_len_ratio 0.6) with lm_weight 0, on 16
    synthetic utterances that all fall in the 816-frame bucket
    (half_batch_len above it keeps them one batch)."""
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(FLAGSHIP)
    c = cfg.data.corpus
    c.name, c.path = "synthetic", ""
    c.train_split, c.dev_split, c.test_split = ["train:96"], ["dev:16"], []
    c.buckets, c.token_buckets, c.half_batch_len = [816], [200], 1000
    d = cfg.decode
    d.beam_size, d.batch_size, d.ctc_weight, d.lm_weight = 16, 16, 0.3, 0.0
    d.ctc_beam_ratio, d.max_len_ratio, d.min_len_ratio = 1.5, 0.6, 0.0
    return cfg


def smoke_solver(outdir: str, seed: int = 0):
    """A test-mode Solver on the card over the smoke config, with a
    checkpoint of seeded flagship-width weights written to ``outdir``."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.bin.test_asr import Solver
    from e2e_asr_tpu_torch.data.dataset import load_eval_datasets
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.models import asr as asr_mod

    cfg = flagship_smoke_config()
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


def flagship_train_config(max_step: int):
    """The smoke config (flagship model, audio and hparas; synthetic corpus,
    one 816-frame bucket of batch 16) trained for ``max_step`` steps and
    validated once at the last, logging every step."""
    cfg = flagship_smoke_config()
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step = max_step, max_step, 1
    return cfg


def smoke_train_solver(outdir: str, seed: int = 0, max_step: int = 5):
    """A train-mode Solver on the card over ``flagship_train_config``, with
    fresh seed-``seed`` weights (no resume) and its logs and checkpoints
    under ``outdir``."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver

    cfg = flagship_train_config(max_step)
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


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _run_fn(train: bool):
    """(function that runs one unit of work, audio seconds in it)."""
    from e2e_asr_tpu_torch import cuda_build

    if train:
        solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "profile_train"))
        batch = solver._put(next(solver.tr_set.epoch(0)))
        audio_s = float(batch["wav_len"].sum()) / solver.config.data.audio.sample_rate

        def run():
            m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0))
            float(m["loss"])  # the step's own fence (the NaN/inf check already waits)

        return run, audio_s
    solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "profile"))
    batch = next(solver.eval_sets["dev"].epoch())
    audio_s = float(batch.wav_len.sum()) / solver.config.data.audio.sample_rate
    return (lambda: solver.decode_batch(batch.wav, batch.wav_len)), audio_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile one training step")
    ap.add_argument("--out", default="", help="JSON result (default: _build/profile_*.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from e2e_asr_tpu_torch import cuda_build

    what = "train" if args.train else "decode"
    out = args.out or os.path.join(cuda_build.BUILD_DIR, f"profile_{what}.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    run, audio_s = _run_fn(args.train)
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
        "card": card, "what": what, "wall_ms": wall_ms, "audio_s": audio_s,
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
