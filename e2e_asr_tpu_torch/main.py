"""CLI entry point, with the JAX package's flag surface.

    python -m e2e_asr_tpu_torch.main --config cfg.yaml              # train ASR
        [--name exp] [--logdir log/] [--ckpdir ckpt/] [--load ckpt] [--njobs N]
        [--no-auto-resume] [--amp | --pure-f32] [-o KEY=VAL ...] [--cpu] [--multihost]
    python -m e2e_asr_tpu_torch.main --config cfg.yaml --test --load ckpt
        [--name exp] [--outdir result/] [--njobs N] [-o KEY=VAL ...] [--cpu] [--multihost]
    python -m e2e_asr_tpu_torch.main --config lm.yaml --lm        # train the RNN-LM
        [--name exp] [--logdir log/] [--ckpdir ckpt/] [--load ckpt] [-o KEY=VAL ...] [--cpu] [--multihost]

Training and decoding run on the card unless ``--cpu`` is given (without
CUDA and without ``--cpu`` they raise). ``--lm`` trains the LM that a decode
config fuses in (``decode.lm_weight``, ``decode.lm_path``); ``--lm --test``
raises, as in the JAX package (the LM's dev perplexity is part of its
training logs). ``--njobs`` is the number of threads that fill the train,
dev and eval batches ahead of the step (0: on the calling thread).
``--amp`` / ``--pure-f32`` set ``hparas.dtype`` to bfloat16 / float32 after
the ``-o`` overrides; ``--pure-f32`` wins when both are given.

Data parallelism over processes (``--multihost``; the JAX package's flag,
which there calls ``jax.distributed.initialize()``): launch one process a
card with torchrun,

    python -m torch.distributed.run --nproc-per-node N -m e2e_asr_tpu_torch.main \
        --config cfg.yaml --multihost [...]

(``--nnodes``, ``--node-rank`` and ``--master-addr`` for several hosts).
Each process joins the group (``parallel/dist.py`` ``init``: NCCL on the
card, gloo with ``--cpu``) and takes its row block of every global batch;
the batch size of the config is the global one. Training and LM training
sum the loss's normalisers and the gradients over the ranks inside the
step, validation and the decode shard their batches, and rank 0 alone
writes logs, checkpoints and result csvs. The group is shut down at exit.
Without ``--multihost`` no group exists and nothing of this runs.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="End-to-end ASR on PyTorch/CUDA")
    p.add_argument("--config", type=str, required=True, help="experiment yaml")
    p.add_argument("--name", default=None, type=str, help="experiment name")
    p.add_argument("--logdir", default="log/", type=str)
    p.add_argument("--ckpdir", default="ckpt/", type=str)
    p.add_argument("--outdir", default="result/", type=str)
    p.add_argument("--load", default=None, type=str,
                   help="checkpoint (convert.save_checkpoint) to resume from / decode")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--njobs", default=2, type=int, help="loader threads filling batches ahead")
    p.add_argument("--test", action="store_true", help="evaluation (beam decode)")
    p.add_argument("--lm", action="store_true", help="RNN-LM task")
    p.add_argument("--no-msg", action="store_true")
    p.add_argument(
        "--no-auto-resume", dest="auto_resume", action="store_false",
        help="do not auto-resume from ckpdir/<name>/latest",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun process group (data parallelism; NCCL on the card, gloo with --cpu)")
    p.add_argument("--amp", action="store_true", help="force the bfloat16 compute dtype")
    p.add_argument("--pure-f32", action="store_true", help="force the float32 compute dtype (wins over --amp)")
    p.add_argument(
        "-o", "--override", action="append", default=[], metavar="KEY=VAL",
        help="dotted config override, e.g. -o decode.beam_size=4 (VAL parsed as YAML)",
    )
    return p


def apply_overrides(config, overrides):
    """Apply dotted KEY=VAL overrides onto the typed config in place."""
    import yaml

    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"--override expects KEY=VAL, got {ov!r}")
        obj = config
        parts = key.split(".")
        for p_ in parts[:-1]:
            obj = getattr(obj, p_)
        if not hasattr(obj, parts[-1]):
            raise AttributeError(f"unknown config key {key!r}")
        setattr(obj, parts[-1], yaml.safe_load(val))
    return config


def main(argv=None):
    paras = build_parser().parse_args(argv)
    paras.verbose = not paras.no_msg
    np.random.seed(paras.seed)
    if paras.lm:
        if paras.test:
            raise ValueError("--lm --test: LM evaluation is part of --lm training (dev perplexity)")
        from e2e_asr_tpu_torch.bin.train_lm import Solver

        mode = "train"
    elif paras.test:
        from e2e_asr_tpu_torch.bin.test_asr import Solver

        mode = "test"
    else:
        from e2e_asr_tpu_torch.bin.train_asr import Solver

        mode = "train"
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.parallel import dist

    config = Config.load(paras.config)
    apply_overrides(config, paras.override)
    config.hparas.seed = paras.seed
    if paras.amp:
        config.hparas.dtype = "bfloat16"
    if paras.pure_f32:
        config.hparas.dtype = "float32"
    if paras.multihost:
        dist.init(resolve_device("cpu" if paras.cpu else "cuda"))
    try:
        solver = Solver(config, paras, mode)
        solver.load_data()
        solver.set_model()
        return solver.exec()
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
