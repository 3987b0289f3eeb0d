"""Where the time of one flagship decode batch, one training step, a dev
epoch or an LM step goes on the card.

    python -m e2e_asr_tpu_torch.bin.profile_decode [--train [--scan-phases]] [--rnn-impl IMPL]
        [--lm-weight W] [--eager] [--parent DIR] [--out PATH]
    python -m e2e_asr_tpu_torch.bin.profile_decode --validate [--dtype D] | --lm [--parent DIR]
    python -m e2e_asr_tpu_torch.bin.profile_decode --ddp [--dtype D] [--parent DIR]
    python -m e2e_asr_tpu_torch.bin.profile_decode --stages [--dtype D] [--config YAML] [--bucket F] [--batch B]

Decode (default): decodes the chip smoke batch (16 synthetic utterances in
the 816-frame bucket, flagship width, seed-0 weights, beam 16, ctc_weight
0.3, lm_weight 0; with ``--lm-weight W`` > 0 a seed-0 RNN-LM of
configs/libri/lm_example.yaml's width, 512-wide embedding, two 512-wide
LSTM layers, tied output, is fused in at weight W, as
configs/libri/decode_example.yaml fuses its LM at 0.3). ``--train``: one training step of the flagship
(configs/libri/asr_example.yaml: Adadelta, grad_clip 5, SpecAugment on,
ctc_weight 0.5, tf 1.0, float32) on a batch of 16 synthetic utterances in
the 816-frame bucket, through ``bin/train_asr.Solver``'s trainer.

The decode replays the beam step's CUDA graphs (decode/beam_graph.py; the
warm-up run captures them); ``--eager`` decodes through the eager loop of
``beam_step`` instead (``beam_search(..., graphs=False)``). The train step
likewise replays the solver's CUDA graph of the step
(training/step_graph.py); ``--train --eager`` runs the eager step.

Either runs once to warm up, once timed by the host clock around a
synchronised run, and once under ``torch.profiler``. Prints the wall time,
the device's busy time (the sum of kernel times: one stream, so kernels do
not overlap), its idle share of the unprofiled and of the profiled wall,
the launches the host issued (runtime calls that launch a kernel or a
graph) and the kernels the device ran, and the kernels by device time.
Writes the same as JSON to ``--out`` (default
``e2e_asr_tpu_torch/_build/profile_decode[_eager].json``,
``profile_decode_lm[_eager].json`` or ``profile_train.json``).

``--parent DIR`` (DIR: a checkout of the parent commit, e.g. a ``git
archive`` under ``runs/``) profiles the decode in processes of their own in
turns, parent, change, change, parent: in each, the batch without an LM and
with one fused in at 0.3; the change's process through the graphs and
through the eager loop in turns (graph, eager, eager, graph), the parent's
its own loop twice; each run's wall the median of DECODE_REPS timed
decodes. Prints wall, busy, idle share and host-issued launches a beam step
of each (``profile_decode_turns.json``). ``--train --parent DIR`` does the
same for the flagship train step (``--dtype``, default the recipe's bf16):
the change's process through the graph and the eager step in turns, the
parent's its own step twice, each run's wall the median of TRAIN_REPS
timed steps (``profile_train_turns.json``).

``--validate`` profiles the flagship's dev epoch (VALIDATE_DEV_UTTS
utterances: 4 batches of 16 in the 816 bucket, at the recipe's bf16 or
``--dtype``) through ``bin/train_asr.Solver.validate`` (checkpoint writes
taken out), after one train step through the train graphs: this tree's
validation through its CUDA graphs and eagerly (``graphs=False``) in turns,
and with ``--parent DIR`` the parent's validation, processes parent,
change, change, parent; each run's wall the median of VALIDATE_REPS dev
epochs. Prints wall, busy, idle, host-issued and device launches a dev
batch, capture seconds and peak memory (``profile_validate_turns.json``).
``--lm`` does the same for the LM step (configs/libri/lm_example.yaml's
width, B = 32, random ids, L = 256 and 512): runs of LM_WINDOW steps,
graphs and eager steps with their metrics into a ring read once a run,
against the parent's steps with every metric read after each step
(``profile_lm_turns.json``).

``--ddp`` profiles what the data-parallel layout (``parallel/dist.py``)
costs on one card: the flagship train step (``--dtype``, default the
recipe's bf16) replaying its CUDA graph in a process without a group
(``nogroup``), in a world-1 NCCL group (``group``: the loss's denominators
and the flat buffer of gradients and loss metrics all-reduced inside the
graph), and without a group but drawing every random tensor at twice the
batch's rows, as a rank of a world of two draws (``draws2``); with
``--parent DIR`` the parent's own step too; processes in turns (parent,
nogroup, group, draws2, draws2, group, nogroup, parent), each run the
median of TRAIN_REPS timed steps. Prints wall, busy, idle, host-issued and
device launches a step, the device time of the collective (NCCL) kernels,
of the random draws and of every kernel the group adds to the step
(``profile_ddp_turns.json``).

``--stages`` prints the train step's stage table at a recipe's bucket
(``--config``, default the flagship; ``--bucket`` frames, default 816;
``--batch``, default the recipe's batch size, halved above its
half_batch_len as the loader halves it; ``--dtype``, default the
recipe's): each stage of ``utils/stages.py`` (the features' forward, the
encoder's, the CTC objective's and the teacher-forced speller's value and
gradient, the optimizer's update) captured once as a CUDA graph and its
replays timed, beside its ceiling and ``sol`` (the JAX package's rounded
report and the unrounded numbers), then the sum of the stages' ms against
the busy of one replayed train step at the same bucket: stages timed alone
do not overlap, so the sum may exceed the step (``profile_stages.json``).

``--decode-phases`` instead splits one launch of each decode kernel into
its phases: the timing builds (``-DATT_PHASES``, ``-DPREFIX_PHASES``) run at
the flagship decode shapes (B=16, W=16, S=T=204, Dk=300, E=640, K=10, P=201,
24 candidates a beam, vocabulary 26, lengths in [S/2, S]) and block 0's us
per phase are printed beside each kernel's device time. Variants of both
sources, made by rewriting their text into ``_build/decode_variants/`` and
built only here, are timed in turns with the normal build: the attention
step's ablations (no tanh, one TF32 product in place of three, neither;
their values are wrong, only their times count), and the CTC prefix kernel's
log-sum-exp on the approximate intrinsics __expf/__logf in place of the
accurate expf/logf, both also held against the plain version at T = 204,
764 and 1000; and the log-mel kernel with its parts compiled out in turn
(the mel sums, every frame's transform, both; wrong values, times only) at
the flagship decode shapes
(``profile_decode_phases.json``).

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
import sys
import time
import types

import numpy as np
import torch

from e2e_asr_tpu_torch.ops.decoder_cuda import PHASE_BUILD
from e2e_asr_tpu_torch.utils.profiling import ANNOTATION_PREFIXES, device_events, device_ms

FLAGSHIP = "configs/libri/asr_example.yaml"
LM_RECIPE = "configs/libri/lm_example.yaml"  # the LM that decode_example.yaml fuses in


def flagship_smoke_config(rnn_impl: str = "auto"):
    """Flagship model + audio (configs/libri/asr_example.yaml), decoded as
    configs/libri/decode_example.yaml (beam 16, batch 16, ctc_weight 0.3,
    ctc_beam_ratio 1.5, max_len_ratio 0.6) with lm_weight 0 (``smoke_solver``
    fuses an LM in), on 16 synthetic utterances that all fall in the
    816-frame bucket (half_batch_len above it keeps them one batch).
    ``rnn_impl`` routes the BiLSTM layers (``encoder.rnn_impl``)."""
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


def smoke_lm_checkpoint(outdir: str, vocab: int, seed: int = 0) -> str:
    """An LM checkpoint (kind "lm") of seeded weights at LM_RECIPE's width,
    written to ``outdir``; returns its path."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.models import lm as lm_mod

    gen = torch.Generator()
    gen.manual_seed(seed)
    params = lm_mod.lm_init(gen, vocab, Config.load(LM_RECIPE).lm, torch.device("cpu"))
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"lm_seed{seed}.pt")
    convert.save_checkpoint(path, params, vocab, 0, kind="lm")
    return path


def smoke_solver(outdir: str, seed: int = 0, rnn_impl: str = "auto", lm_weight: float = 0.0,
                 ckpt: str = "", cfg=None):
    """A test-mode Solver on the card over the smoke config (or ``cfg``, e.g.
    ``recipe_960h_config``'s), with a checkpoint of seeded weights at its
    width written to ``outdir`` (or the checkpoint ``ckpt``, e.g. one a
    smoke training wrote); with ``lm_weight`` > 0 it fuses in a seeded LM of
    LM_RECIPE's width at its vocabulary (``smoke_lm_checkpoint``) through
    ``decode.lm_path`` / ``lm_config``."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.bin.test_asr import Solver
    from e2e_asr_tpu_torch.data.dataset import load_eval_datasets
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.models import asr as asr_mod

    cfg = cfg or flagship_smoke_config(rnn_impl)
    cfg.model.encoder.rnn_impl = rnn_impl
    dev = resolve_device("cuda")
    _, feat_dim, vocab, _, _ = load_eval_datasets(cfg.data, cfg.decode.batch_size)
    os.makedirs(outdir, exist_ok=True)
    if not ckpt:
        params, _ = asr_mod.asr_init(seed, feat_dim, vocab, cfg.model, dev)
        ckpt = os.path.join(outdir, f"flagship_seed{seed}.pt")
        convert.save_checkpoint(ckpt, params, vocab, feat_dim)
    if lm_weight > 0:
        d = cfg.decode
        d.lm_weight, d.lm_config = lm_weight, LM_RECIPE
        d.lm_path = smoke_lm_checkpoint(outdir, vocab, seed)
    paras = types.SimpleNamespace(
        config=FLAGSHIP, name="smoke", outdir=outdir, load=ckpt, seed=seed, cpu=False, verbose=True,
    )
    solver = Solver(cfg, paras, "test")
    solver.load_data()
    solver.set_model()
    return solver


def flagship_train_config(max_step: int, rnn_impl: str = "auto", dtype: str = ""):
    """The smoke config (flagship model, audio and hparas; synthetic corpus,
    one 816-frame bucket of batch 16) trained for ``max_step`` steps and
    validated once at the last, logging every step; ``dtype`` pins
    ``hparas.dtype`` (empty: the recipe's, bfloat16)."""
    cfg = flagship_smoke_config(rnn_impl)
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step = max_step, max_step, 1
    if dtype:
        h.dtype = dtype
    return cfg


def smoke_train_solver(outdir: str, seed: int = 0, max_step: int = 5, rnn_impl: str = "auto",
                       dtype: str = ""):
    """A train-mode Solver on the card over ``flagship_train_config``, with
    fresh seed-``seed`` weights (no resume) and its logs and checkpoints
    under ``outdir``."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver

    cfg = flagship_train_config(max_step, rnn_impl, dtype)
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


RECIPE_960H = "configs/libri/asr_960h.yaml"
# the 960 h recipe's corpus written as LibriSpeech-layout wav files:
# {split: (utterances, seconds from, to, characters a transcript from, to
# (0: the synthetic text's own))}; the 416-frame bucket (2.1-4.2 s) and the
# 3056-frame one (its 16 utterances of 29-30.5 s with transcripts of
# 500-519 characters: the speller's L at the token bucket's 520)
RECIPE_960H_SPLITS = {"train-clean-100": ((32, 2.2, 4.1, 0), (16, 29.0, 30.5, 500)),
                      "dev-clean": ((64, 2.2, 4.1, 0),), "dev-decode": ((16, 2.2, 4.1, 0),)}


def recipe_960h_corpus(root: str, seed: int = 0) -> str:
    """Writes RECIPE_960H_SPLITS's utterances under ``root`` as a
    LibriSpeech-layout tree of 16-bit wav files (a speaker a split, a
    chapter a group): the synthetic corpus's waves (word coding) and
    transcripts, a long one's transcript continued with the words of
    further synthetic transcripts; returns ``root``. A tree written before
    is kept."""
    import wave

    from e2e_asr_tpu_torch.data import corpus

    done = os.path.join(root, ".complete")
    if os.path.isfile(done):
        return root
    for si, (split, groups) in enumerate(RECIPE_960H_SPLITS.items()):
        for gi, (n, lo, hi, chars) in enumerate(groups):
            d = os.path.join(root, split, str(100 + si), str(gi))
            os.makedirs(d, exist_ok=True)
            utts = corpus.synthetic(n, min_sec=lo, max_sec=hi, seed=seed + 10 * si + gi)
            extra = iter(u.text for u in corpus.synthetic(64 * n if chars else 0, seed=seed + 1000 + si))
            lines = []
            for i, u in enumerate(utts):
                words = u.text.split()
                while chars and len(" ".join(words)) < chars:
                    words += next(extra).split()
                text = " ".join(words)
                while chars and len(text) > chars + 19:
                    text = text.rsplit(" ", 1)[0]
                uid = f"{100 + si}-{gi}-{i:04d}"
                with wave.open(os.path.join(d, f"{uid}.wav"), "wb") as f:
                    f.setnchannels(1)
                    f.setsampwidth(2)
                    f.setframerate(16000)
                    f.writeframes(np.clip(u.load() * 32768, -32768, 32767).astype("<i2").tobytes())
                lines.append(f"{uid} {text}")
            with open(os.path.join(d, f"{100 + si}-{gi}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    open(done, "w").close()
    return root


def recipe_960h_config(root: str, dev_split: str = "dev-clean"):
    """configs/libri/asr_960h.yaml as shipped (4 x 512 BiLSTM, 512-wide
    speller, batch 32 with the half-batch rule at 800 frames, buckets to
    3056 frames / 520 tokens, ctc_weight 0.5, Adadelta, SpecAugment, bf16;
    the decode block: beam 16, batch 16, ctc_weight 0.3, lm_weight 0.3) on
    the tree ``recipe_960h_corpus`` wrote: train-clean-100, ``dev_split``,
    no test split."""
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(RECIPE_960H)
    c = cfg.data.corpus
    c.path, c.train_split, c.dev_split, c.test_split = root, ["train-clean-100"], [dev_split], []
    return cfg


def recipe_960h_train_solver(outdir: str, root: str, seed: int = 0, rnn_impl: str = "auto"):
    """A train-mode Solver on the card over ``recipe_960h_config`` (one
    validation a run, logging every step), fresh seed-``seed`` weights, its
    logs and checkpoints under ``outdir``."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver

    cfg = recipe_960h_config(root)
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step, h.seed = 1, 1, 1, seed
    cfg.model.encoder.rnn_impl = rnn_impl
    paras = types.SimpleNamespace(
        config=RECIPE_960H, name="smoke_960h", logdir=os.path.join(outdir, "log"),
        ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=seed, cpu=False, verbose=True,
        auto_resume=False,
    )
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


CONVERGENCE = "configs/synthetic_convergence.yaml"


def convergence_train_solver(outdir: str, seed: int = 0, max_step: int = 3, rnn_impl: str = "auto",
                             tf: float = 0.8, train_utts: int = 96, log_step: int = 1,
                             njobs: int = None, corpus: dict = None, dtype: str = ""):
    """A train-mode Solver on the card over the convergence recipe
    (configs/synthetic_convergence.yaml at its full width: batch 32, three
    256-wide BiLSTM layers on 80-dim fbank with no prenet, attention 128 / 8
    filters / 65 taps, 256-wide speller, Adam, encoder dropout 0.1), its
    splits cut to ``train_utts`` training and 32 dev utterances, ``max_step``
    steps and one validation, logging every ``log_step`` steps, the
    teacher-forcing rate held at ``tf`` so that coins fail from the first
    step (None: the recipe's schedule), and the BiLSTM layers routed by
    ``rnn_impl``. ``njobs`` (loader threads; None: the recipe's
    ``num_workers``) and ``corpus`` (fields of ``data.corpus`` to set, e.g.
    ``device_cache``, ``cache_bytes``) pick the input path; ``dtype`` pins
    ``hparas.dtype`` (empty: the recipe's, bfloat16)."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(CONVERGENCE)
    c = cfg.data.corpus
    c.train_split, c.dev_split, c.test_split = [f"train:{train_utts}"], ["dev:32"], []
    for k, v in (corpus or {}).items():
        if not hasattr(c, k):
            raise AttributeError(f"data.corpus has no field {k!r}")
        setattr(c, k, v)
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step, h.seed = max_step, max_step, log_step, seed
    if dtype:
        h.dtype = dtype
    if tf is not None:
        h.tf_start = h.tf_end = tf
    cfg.model.encoder.rnn_impl = rnn_impl
    paras = types.SimpleNamespace(
        config=CONVERGENCE, name="smoke_convergence", logdir=os.path.join(outdir, "log"),
        ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=seed, cpu=False, verbose=True,
        auto_resume=False, njobs=njobs,
    )
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


def lm_train_solver(outdir: str, seed: int = 0, max_step: int = 10):
    """A train-mode LM Solver (bin/train_lm.py) on the card over LM_RECIPE at
    its full width (512-wide embedding, two 512-wide LSTM layers, tied
    output, batch 32, Adam, clip 5) on synthetic transcripts (no LibriSpeech
    text here): 640 training and 64 dev utterances, ``max_step`` steps and
    one validation at the last, logging every step."""
    from e2e_asr_tpu_torch.bin.train_lm import Solver
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(LM_RECIPE)
    c = cfg.data.corpus
    c.name, c.path, c.train_split, c.dev_split = "synthetic", "", ["train:640"], ["dev:64"]
    h = cfg.hparas
    h.max_step, h.valid_step, h.log_step, h.seed = max_step, max_step, 1, seed
    paras = types.SimpleNamespace(
        config=LM_RECIPE, name="smoke_lm", logdir=os.path.join(outdir, "log"),
        ckpdir=os.path.join(outdir, "ckpt"), load=None, seed=seed, cpu=False, verbose=True,
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


def _run_fn(train: bool, rnn_impl: str, lm_weight: float = 0.0, eager: bool = False, dtype: str = ""):
    """(function that runs one unit of work, audio seconds in it). The
    training batch is one streaming batch on the device, repeated: an
    offsets batch (the smoke corpus is device-resident under
    ``device_cache: auto``) is gathered once through ``resolve_wav``, so
    that the profiled step is the model's alone; the step replays the
    solver's CUDA graph unless ``eager``, its loss read as the fence;
    ``dtype`` pins the training's ``hparas.dtype`` (empty: the recipe's)."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.training.step import resolve_wav

    if train:
        solver = smoke_train_solver(os.path.join(cuda_build.BUILD_DIR, "profile_train"), rnn_impl=rnn_impl,
                                    dtype=dtype)
        batch = solver._put(next(solver.tr_set.epoch(0)))
        batch = {"wav": resolve_wav(batch)[0], **{k: batch[k] for k in ("wav_len", "text", "text_len")}}
        audio_s = float(batch["wav_len"].sum()) / solver.config.data.audio.sample_rate
        graphs = None if eager else solver.train_graphs

        def run():
            m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0), graphs=graphs)
            float(m["loss"])

        return run, audio_s
    solver = smoke_solver(os.path.join(cuda_build.BUILD_DIR, "profile"), rnn_impl=rnn_impl, lm_weight=lm_weight)
    batch = next(solver.eval_sets["dev"].epoch())
    audio_s = float(batch.wav_len.sum()) / solver.config.data.audio.sample_rate
    wav, wav_len = solver.put(batch.wav, batch.wav_len)
    return (lambda: solver.decode_batch(wav, wav_len, graphs=not eager)), audio_s


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


def flagship_att_inputs(dev, seed: int = 1, s: int = 816 // 4, cfg=None):
    """The beam attention step's inputs at the flagship decode shapes (B=16,
    W=16, S=204 unless given, Dk=300, E=640, 10 x 201 taps, lengths in [S/2,
    S] with the first at S, int32), or at those of ``cfg``'s model and
    decode block, weights at their init scales: the arguments of
    ``att_step_cuda.att_step_beam_loc``."""
    cfg = cfg or flagship_smoke_config()
    m, ac = cfg.model, cfg.model.attention
    b, w = cfg.decode.batch_size, cfg.decode.beam_size
    dk, e_dim, kk, p = ac.dim, 2 * m.encoder.dim[-1], ac.loc_kernel_num, 2 * ac.loc_kernel_size + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    lens[0] = s
    uni = lambda bound, *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound
    return (torch.randn((b, w, dk), generator=gen, device=dev),
            torch.softmax(2.0 * torch.randn((b, w, s), generator=gen, device=dev), -1),
            torch.tanh(torch.randn((b, s, dk), generator=gen, device=dev)),
            torch.tanh(torch.randn((b, s, e_dim), generator=gen, device=dev)), lens.to(torch.int32),
            uni(1 / math.sqrt(p), kk, p), uni(1 / math.sqrt(kk), kk, dk), uni(1 / math.sqrt(dk), dk),
            0.1 * torch.randn((dk,), generator=gen, device=dev), float(ac.temperature))


DECODE_PHASE_VARIANTS = (("att_step", ("ATT_PHASES",)), ("ctc_prefix", ("PREFIX_PHASES",)))  # timing builds


def alternating_ms(fns: dict, rounds: int = 21, iters: int = 3) -> dict:
    """Median ms a call of each function over ``rounds`` rounds that time
    them in turns (the order reversed every other round), ``iters`` calls a
    round: a comparison within one call, which host-paced single timings of
    two functions minutes apart do not give."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(reversed(fns))):
            times[name].append(device_ms(fns[name], iters, 0))
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


# variants of the decode kernels' sources, built and timed only by
# --decode-phases: {source: {variant: [(text, its replacement, occurrences)]}}
_NO_TANH = [("fmaf(l2.x, tanhf(", "fmaf(l2.x, (", 2), ("fmaf(l2.y, tanhf(", "fmaf(l2.y, (", 2)]
_ONE_TF32 = [("                mma_tf32(fw[j], al[s2], bh);  // three TF32 products: lo hi + hi lo + hi hi\n"
              "                mma_tf32(fw[j], ah[s2], bl);\n", "", 1)]
# the log-mel kernel's parts compiled out in turn (timed only): the mel sums
# and logs, every frame's transform (staging, tables and stores stay), both
_NO_MEL = [("    mel_tile<NC>(a, t, smem + l.buf, ot, nvalid, warp, lane);\n", "", 1)]
_NO_FRAMES = [("    frame<NC>(a, t, span", "    if (false) frame<NC>(a, t, span", 1)]
SOURCE_VARIANTS = {
    "att_step": {"no_tanh": _NO_TANH, "one_tf32": _ONE_TF32, "no_tanh+one_tf32": _NO_TANH + _ONE_TF32},
    "ctc_prefix": {"__expf___logf": [("m + logf(1.0f + expf(n - m))", "m + __logf(1.0f + __expf(n - m))", 1)]},
    "log_mel": {"no_mel": _NO_MEL, "no_frames": _NO_FRAMES, "no_frames+no_mel": _NO_FRAMES + _NO_MEL},
}


def build_source_variants() -> None:
    """Write each variant of ``SOURCE_VARIANTS`` (its source's text with
    the replacements made, each found as often as stated) into
    ``_build/decode_variants/``, compile them in parallel and register each
    library as ``cuda_build.library(source, (variant,))``."""
    from e2e_asr_tpu_torch import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "decode_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "tf32_mma.cuh")) as f, \
            open(os.path.join(out_dir, "tf32_mma.cuh"), "w") as g:
        g.write(f.read())
    procs = {}
    for name, variants in SOURCE_VARIANTS.items():
        with open(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu")) as f:
            base = f.read()
        for var, edits in variants.items():
            src = base
            for old, new, count in edits:
                if src.count(old) != count:
                    raise RuntimeError(f"{name}.cu: {old!r} found {src.count(old)} times, not {count}")
                src = src.replace(old, new)
            stem = os.path.join(out_dir, f"{name}-{var.replace('+', '-')}")
            with open(stem + ".cu", "w") as f:
                f.write(src)
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"]
            procs[(name, var)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), stem)
    for (name, var), (proc, stem) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{name}.cu variant {var} failed to build:\n{log}")
        cuda_build.register(name, var, stem + ".so")


def _phase_split(launch, phase_fn: str, lib: str, defines, names, iters: int) -> dict:
    """Mean us per phase over ``iters`` launches of a timing build (block 0
    sums the global timer's advance over each phase; ``phase_fn`` copies the
    sums out), beside the timing build's and the normal build's device ms."""
    from e2e_asr_tpu_torch import cuda_build

    out = torch.zeros(16, dtype=torch.int64, device="cuda")
    sums = torch.zeros(len(names), dtype=torch.float64)
    for _ in range(iters):
        launch(defines)
        cuda_build.launch(lib, phase_fn, out, out.numel(), defines=defines)
        sums += out[:len(names)].double().cpu()
    return {"phases_us": {nm: float(x) / iters / 1e3 for nm, x in zip(names, sums)},
            "timing_build_ms": device_ms(lambda: launch(defines), iters), "ms": device_ms(lambda: launch(()), iters)}


def att_phase_split(args, iters: int = 20) -> dict:
    """The beam attention step's phases (``att_step_cuda.PHASES``) at
    ``args`` and its launch plan. Launch counters are not touched."""
    from e2e_asr_tpu_torch.ops import att_step_cuda as asc

    q, prev, k, v, *_ = args
    res = _phase_split(lambda d: asc._launch(d, *args), "e2e_att_step_phase_times", "att_step",
                       asc.PHASE_BUILD, asc.PHASES, iters)
    res["plan"] = asc.plan(*prev.shape, k.shape[2], v.shape[2], args[5].shape[0], args[5].shape[1])
    return res


def att_variants_ms(args) -> dict:
    """ms a launch of the normal build and of each attention-step variant
    of ``SOURCE_VARIANTS`` (built by ``build_source_variants``), in turns."""
    from e2e_asr_tpu_torch.ops import att_step_cuda as asc

    fns = {"normal": lambda: asc._launch((), *args)}
    fns.update({v: (lambda v=v: asc._launch((v,), *args)) for v in SOURCE_VARIANTS["att_step"]})
    return alternating_ms(fns, rounds=9)


def prefix_variants(dev, ts=(816 // 4, 764, 1000)) -> dict:
    """At each T of ``ts`` (the flagship's other shapes): the normal build
    and each CTC prefix variant of ``SOURCE_VARIANTS``, ms a launch in turns
    and the max abs error of psi, r_h and psi_eos against the plain version
    over the cells the plain version reaches (> NEG / 2)."""
    from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc

    res = {}
    for t in ts:
        args = flagship_prefix_inputs(dev, t=t)
        want = cpc.prefix_scores_fused_plain(*args)
        builds = {"normal": ()} | {v: (v,) for v in SOURCE_VARIANTS["ctc_prefix"]}
        err = {}
        for name, d in builds.items():
            got = cpc._launch(d, *args)
            err[name] = {nm: float((g.double() - wv.double())[wv > cpc.NEG / 2].abs().max())
                         for nm, g, wv in zip(("psi", "r_h", "psi_eos"), got, want)}
        ms = alternating_ms({name: (lambda d=d: cpc._launch(d, *args)) for name, d in builds.items()}, rounds=9)
        res[f"T{t}"] = {name: {"ms": ms[name], "max_abs_err": err[name]} for name in builds}
    return res


def log_mel_variants_ms(dev, seed: int = 0) -> dict:
    """us a launch, in turns, of the log-mel kernel's normal build and each
    variant of ``SOURCE_VARIANTS["log_mel"]`` (built by
    ``build_source_variants``) at the flagship decode shapes (B=16,
    N=130,800, a randn wave; M=40, 25 ms / 10 ms at 16 kHz); and of the
    normal build and the one with neither frames nor mel sums at B = 1 and
    64, which part of the time does not grow with the batch."""
    from e2e_asr_tpu_torch.ops import frontend_cuda as fec

    a = flagship_smoke_config().data.audio
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    res = {}
    for b, names in ((16, list(SOURCE_VARIANTS["log_mel"])), (1, ["no_frames+no_mel"]), (64, ["no_frames+no_mel"])):
        wav = 0.1 * torch.randn((b, 815 * 160 + 400), generator=gen, device=dev)
        builds = {"normal": ()} | {v: (v,) for v in names}
        ms = alternating_ms({name: (lambda d=d: fec._launch(d, wav, a, 400, 160, 512)) for name, d in builds.items()},
                            rounds=9)
        res[f"B{b}"] = {name: v * 1e3 for name, v in ms.items()}
    return res


def flagship_prefix_inputs(dev, seed: int = 3, t: int = 816 // 4, cfg=None, vocab: int = 26):
    """The fused CTC prefix function's inputs at the flagship decode shapes
    (B=16, W=16, K=24 candidates a beam, T=204 unless given, vocabulary 26,
    lengths in [T/2, T] with the first at T), or at ``cfg``'s decode block:
    parents that emitted one token, one candidate of each beam equal to its
    last token, as ``chip_smoke.py`` draws them."""
    from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc
    from e2e_asr_tpu_torch.decode.ctc_prefix import init_empty_prefix

    cfg = cfg or flagship_smoke_config()
    b, w = cfg.decode.batch_size, cfg.decode.beam_size
    k = min(vocab, max(w, int(w * cfg.decode.ctc_beam_ratio)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    logits = 3.0 * torch.randn((b, t, vocab), generator=gen, device=dev)
    logits[:, :, 0] += 2.0
    ctc_lp = torch.log_softmax(logits, -1)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    cand0 = torch.randint(1, vocab, (b, w, k), generator=gen, device=dev)
    last0 = torch.zeros((b, w), dtype=torch.long, device=dev)
    _, r_h0, _ = cpc.prefix_scores_fused_plain(ctc_lp, lens, init_empty_prefix(ctc_lp, lens, w), last0, cand0, 1)
    last1 = cand0[:, :, 0].contiguous()
    cand1 = torch.randint(1, vocab, (b, w, k), generator=gen, device=dev)
    cand1[:, :, 1] = last1
    return ctc_lp, lens.to(torch.int32), r_h0[:, :, 0].contiguous(), last1, cand1, 0


def prefix_phase_split(args, iters: int = 20) -> dict:
    """The fused CTC prefix kernel's phases (``ctc_prefix_cuda.PHASES``) at
    ``args``. Launch counters are not touched."""
    from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc

    return _phase_split(lambda d: cpc._launch(d, *args), "e2e_prefix_phase_times", "ctc_prefix",
                        cpc.PHASE_BUILD, cpc.PHASES, iters)


def print_decode_phases(split: dict) -> None:
    for name, sp in split.items():
        parts = ", ".join(f"{k} {v:.2f}" for k, v in sp["phases_us"].items())
        print(f"{name} phases, block 0, us (timing build {sp['timing_build_ms'] * 1e3:.1f} us a launch; normal "
              f"build {sp['ms'] * 1e3:.1f} us{'; plan ' + str(sp['plan']) if 'plan' in sp else ''}): {parts}; "
              f"sum {sum(sp['phases_us'].values()):.2f} us", flush=True)
        if "variants_ms" in sp:
            var = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in sp["variants_ms"].items())
            print(f"  {name} source variants in turns, us a launch: {var}", flush=True)
        for t, by in sp.get("variants", {}).items():
            for k, r in by.items():
                errs = ", ".join(f"{nm} {e:.3e}" for nm, e in r["max_abs_err"].items())
                print(f"  {name} {t} {k}: {r['ms'] * 1e3:.2f} us (in turns), max abs err vs plain {errs}",
                      flush=True)


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


HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")  # runtime / driver API names


def host_launches(prof) -> int:
    """Launches the host issued under ``prof``: the runtime and driver calls
    that launch a kernel (cooperative ones too) or a whole graph."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith(HOST_LAUNCH_CALLS))


def profile_run(run, audio_s: float, reps: int = 1) -> dict:
    """``run`` once to warm up, ``reps`` times timed by the host clock around
    a synchronised run (``wall_ms`` their median), once under
    ``torch.profiler``: the wall, the device's busy time (the sum of kernel
    times: one stream), idle shares, the launches the host issued and the
    kernels the device ran, and the kernels by device time."""
    run()  # warm-up
    torch.cuda.synchronize()

    # wall time without the profiler, host clock around a synchronised run
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    rows = []
    for evt in device_events(prof):
        us = _device_time_us(evt)
        if us > 0:
            rows.append({"name": evt.key, "count": evt.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    return {
        "wall_ms": wall_ms, "walls_ms": walls, "audio_s": audio_s, "audio_s_per_s": audio_s / (wall_ms / 1e3),
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_wall_ms,
        "kernel_launches": sum(r["count"] for r in rows), "host_launches": host_launches(prof), "kernels": rows,
    }


DECODE_REPS = 5  # timed decodes a run in the parent comparison
# One tree's decode profiles (``--parent``), run in a process of its own
# from the root of that tree: argv[1] the modes in order ("graph", "eager";
# "loop": the tree's own decode_batch, the parent's). Prints one JSON line,
# {lm_weight: [run, ...]}.
_TURNS_SCRIPT = """
import json, os, sys
from e2e_asr_tpu_torch.bin.profile_decode import smoke_solver
res = {}
for lm_weight in (0.0, 0.3):
    solver = smoke_solver(os.path.join("e2e_asr_tpu_torch", "_build", "profile_turns"), 0, lm_weight=lm_weight)
    batch = next(solver.eval_sets["dev"].epoch())
    audio_s = float(batch.wav_len.sum()) / solver.config.data.audio.sample_rate
    steps = solver.max_step_for(batch.wav.shape[1])
    wav, wav_len = solver.put(batch.wav, batch.wav_len)
    runs = []
    for mode in sys.argv[1].split(","):
        kw = {"graphs": mode == "graph"} if mode != "loop" else {}
        r = profile_run(lambda: solver.decode_batch(wav, wav_len, **kw), audio_s, reps=int(sys.argv[2]))
        r.pop("kernels")
        runs.append({"mode": mode, "beam_steps": steps, **r})
    res[str(lm_weight)] = runs
print(json.dumps(res))
"""


def _in_turns(parent: str, body: str, argv, what: str) -> list:
    """``body`` (with this module's profiling functions, ``turns_script``)
    run in processes of their own in turns: parent, change, change, parent
    with ``parent`` (a checkout of the parent commit), else the change
    once; the parent's modes "loop,loop", the change's "graph,eager,eager,
    graph". Returns [(tree, its JSON line)]."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    change = ("change", root, "graph,eager,eager,graph")
    order = [("parent", parent, "loop,loop"), change, change, ("parent", parent, "loop,loop")] if parent else [change]
    script = turns_script(body)
    out = []
    for which, path, modes in order:
        path = os.path.abspath(path)
        proc = subprocess.run([sys.executable, "-c", script, modes, *map(str, argv)], cwd=path, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": path}, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the {which}'s {what} profile failed:\n{proc.stderr[-3000:]}")
        out.append((which, json.loads(proc.stdout.strip().splitlines()[-1])))
    return out


def decode_turns(parent: str, card: str) -> dict:
    """The flagship decode batch, unfused and fused at 0.3, in the parent's
    checkout at ``parent`` and in this one, in processes of their own in
    turns (parent, change, change, parent); this tree's through the graphs
    and the eager loop in turns."""
    out = {}
    for which, res in _in_turns(parent, _TURNS_SCRIPT, (DECODE_REPS,), "decode"):
        for lm_weight, runs in res.items():
            for r in runs:
                name = "parent" if which == "parent" else f"change {r['mode']}"
                out.setdefault(lm_weight, {}).setdefault(name, []).append(r)
                print(f"{card}: lm_weight {lm_weight} {name}: wall {r['wall_ms']:.1f} ms (timed "
                      f"{', '.join(f'{w:.1f}' for w in r['walls_ms'])}), busy {r['device_busy_ms']:.1f} ms, idle "
                      f"{r['device_idle_share']:.3f}, host launches {r['host_launches']} "
                      f"({r['host_launches'] / r['beam_steps']:.2f} a beam step), device launches "
                      f"{r['kernel_launches']}, {r['audio_s_per_s']:.1f} audio-s/s", flush=True)
    return out


TRAIN_REPS = 9  # timed steps a run in the parent comparison of the train step
# One tree's train-step profiles (``--train --parent``), run in a process of
# its own from the root of that tree: argv[1] the modes in order ("graph",
# "eager"; "loop": the tree's own step, the parent's), argv[2] the timed
# steps a run, argv[3] the dtype. Prints one JSON line, [run, ...].
_TRAIN_TURNS_SCRIPT = """
import json, os, sys
from e2e_asr_tpu_torch.bin.profile_decode import smoke_train_solver
from e2e_asr_tpu_torch.training.step import resolve_wav
solver = smoke_train_solver(os.path.join("e2e_asr_tpu_torch", "_build", "profile_train_turns"), 0, dtype=sys.argv[3])
batch = solver._put(next(solver.tr_set.epoch(0)))
batch = {"wav": resolve_wav(batch)[0], **{k: batch[k] for k in ("wav_len", "text", "text_len")}}
audio_s = float(batch["wav_len"].sum()) / solver.config.data.audio.sample_rate
runs = []
for mode in sys.argv[1].split(","):
    kw = {"graphs": solver.train_graphs if mode == "graph" else None} if mode != "loop" else {}
    def run():
        m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0), **kw)
        float(m["loss"])
    r = profile_run(run, audio_s, reps=int(sys.argv[2]))
    r.pop("kernels")
    runs.append({"mode": mode, **r})
print(json.dumps(runs))
"""


def turns_script(body: str) -> str:
    """``body`` with this module's profiling functions in its text, so that
    every tree is measured by the same code."""
    import inspect

    head = "import time\nimport torch\n"
    head += f"HOST_LAUNCH_CALLS = {HOST_LAUNCH_CALLS!r}\nANNOTATION_PREFIXES = {ANNOTATION_PREFIXES!r}\n"
    for fn in (device_events, _device_time_us, host_launches, profile_run):
        head += inspect.getsource(fn) + "\n"
    return head + body


def train_turns(parent: str, card: str, dtype: str) -> list:
    """The flagship train step in the parent's checkout at ``parent`` and in
    this one, in processes of their own in turns (parent, change, change,
    parent); this tree's through the graph and the eager step in turns."""
    out = []
    for which, runs in _in_turns(parent, _TRAIN_TURNS_SCRIPT, (TRAIN_REPS, dtype), "train-step"):
        for r in runs:
            r["tree"] = which
            name = "parent" if which == "parent" else f"change {r['mode']}"
            out.append(r)
            print(f"{card}: train step ({dtype or 'recipe dtype'}) {name}: wall {r['wall_ms']:.1f} ms (timed "
                  f"{', '.join(f'{w:.1f}' for w in r['walls_ms'])}), busy {r['device_busy_ms']:.1f} ms, idle "
                  f"{r['device_idle_share']:.3f}, host launches {r['host_launches']}, device launches "
                  f"{r['kernel_launches']}, {r['audio_s_per_s']:.1f} audio-s/s", flush=True)
    return out


VALIDATE_REPS = 3  # timed dev epochs a run in the validation profile
VALIDATE_DEV_UTTS = 64  # the flagship dev epoch: 4 batches of 16 in the 816 bucket
# One tree's validation profiles (``--validate``), run in a process of its own
# from the root of that tree: argv[1] the modes in order ("graph", "eager";
# "loop": the tree's own validate, the parent's), argv[2] the timed epochs a
# run, argv[3] the dtype, argv[4] the dev utterances. Each run is
# ``Solver.validate`` with its checkpoint writes taken out, after one train
# step through the solver's train graphs. Prints one JSON line, [run, ...].
_VALIDATE_TURNS_SCRIPT = """
import json, os, sys, types
from e2e_asr_tpu_torch.bin.profile_decode import flagship_train_config
from e2e_asr_tpu_torch.bin.train_asr import Solver
cfg = flagship_train_config(1, "auto", sys.argv[3])
cfg.hparas.seed = 0
cfg.data.corpus.dev_split = ["dev:" + sys.argv[4]]
out = os.path.join("e2e_asr_tpu_torch", "_build", "profile_validate_turns")
paras = types.SimpleNamespace(config="configs/libri/asr_example.yaml", name="validate", logdir=os.path.join(out, "log"),
                              ckpdir=os.path.join(out, "ckpt"), load=None, seed=0, cpu=False, verbose=True,
                              auto_resume=False)
solver = Solver(cfg, paras, "train")
solver.load_data()
solver.set_model()
solver.save_checkpoint = lambda *a, **k: None
sr = cfg.data.audio.sample_rate
audio_s = sum(float(b.wav_len.sum()) for b in solver.dv_set.epoch()) / sr
solver.trainer.train_step(solver.state, solver._put(next(solver.tr_set.epoch(0))), solver.step_generator(0),
                          graphs=solver.train_graphs)
torch.cuda.synchronize()
runs = []
for mode in sys.argv[1].split(","):
    kw = {"graphs": mode == "graph"} if mode != "loop" else {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    r = profile_run(lambda: solver.validate(**kw), audio_s, reps=int(sys.argv[2]))
    r.pop("kernels")
    r["peak_mb_above"] = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    r["dev_batches"] = len(solver.dv_set)
    graphs = getattr(solver, "eval_graphs", None)
    r["captures_s"] = [] if graphs is None else [t for _, t in graphs.captures]
    runs.append({"mode": mode, **r})
print(json.dumps(runs))
"""

LM_WINDOW = 10  # LM steps a profiled run: a log window, the metrics read at its end
# One tree's LM-step profiles (``--lm``), as above: argv[1] the modes ("graph",
# "eager": the change's exec loop, its metrics into a ring read once a run;
# "loop": the tree's own train_step with every metric read after each step,
# as the parent's exec reads them), argv[2] the timed runs, argv[3] the
# steps a run. Random ids, B = 32, at L = 256 and 512. Prints one JSON line,
# {length: [run, ...]}.
_LM_TURNS_SCRIPT = """
import json, os, sys
from e2e_asr_tpu_torch.bin import train_lm
from e2e_asr_tpu_torch.bin.profile_decode import lm_train_solver
LM_WINDOW = int(sys.argv[3])
solver = lm_train_solver(os.path.join("e2e_asr_tpu_torch", "_build", "profile_lm_turns"), 0, 1)
cfg = solver.config
gen = torch.Generator(device="cuda")
gen.manual_seed(11)
res = {}
for length in (256, 512):
    text = torch.randint(1, solver.vocab_size, (32, length), generator=gen, device="cuda", dtype=torch.int32)
    batch = {"text": text, "text_len": torch.full((32,), length, dtype=torch.int32, device="cuda")}
    runs = []
    for mode in sys.argv[1].split(","):
        graphs = getattr(solver, "graphs", None) if mode == "graph" else None
        ring = torch.empty((LM_WINDOW, 4), device="cuda")
        def run():
            for i in range(LM_WINDOW):
                if mode == "loop":
                    m = train_lm.train_step(solver.state, solver.opt, cfg.lm, batch, solver.step_generator(i))
                    {k: float(v) for k, v in m.items()}
                else:
                    m = train_lm.train_step(solver.state, solver.opt, cfg.lm, batch, solver.step_generator(i),
                                            graphs=graphs)
                    ring[i].copy_(m["scalars"])
            if mode != "loop":
                ring.tolist()
        r = profile_run(run, 32.0 * length * LM_WINDOW, reps=int(sys.argv[2]))
        r.pop("kernels")
        runs.append({"mode": mode, **r})
    res[str(length)] = runs
print(json.dumps(res))
"""


# One tree's data-parallel step profiles (``--ddp``), run in a process of its
# own from the root of that tree: argv[1] the mode ("loop": the tree's own
# graph step without a group, the parent's; "nogroup"; "group": a world-1
# NCCL group; "draws2": no group, the random draws at twice the rows),
# argv[2] the timed steps a run, argv[3] the dtype. Prints one JSON line,
# [run].
_DDP_TURNS_SCRIPT = """
import json, os, sys
mode = sys.argv[1]
if mode == "group":
    from e2e_asr_tpu_torch.parallel import dist, mp_worker
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(mp_worker.free_port()))
    dist.init(torch.device("cuda"))
if mode == "draws2":
    from e2e_asr_tpu_torch.parallel import dist
    dist.row_block = lambda rows: (0, 2 * rows)
from e2e_asr_tpu_torch.bin.profile_decode import smoke_train_solver
from e2e_asr_tpu_torch.training.step import resolve_wav
solver = smoke_train_solver(os.path.join("e2e_asr_tpu_torch", "_build", "profile_ddp_turns"), 0, dtype=sys.argv[3])
batch = solver._put(next(solver.tr_set.epoch(0)))
batch = {"wav": resolve_wav(batch)[0], **{k: batch[k] for k in ("wav_len", "text", "text_len")}}
audio_s = float(batch["wav_len"].sum()) / solver.config.data.audio.sample_rate
def run():
    m = solver.trainer.train_step(solver.state, batch, solver.step_generator(0), graphs=solver.train_graphs)
    float(m["loss"])
r = profile_run(run, audio_s, reps=int(sys.argv[2]))
r["graphs"] = solver.train_graphs is not None
print(json.dumps([{"mode": mode, **r}]))
if mode == "group":
    dist.shutdown()
"""


def _ddp_kind(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if "distribution" in low or "philox" in low or "normal" in low or "uniform" in low:
        return "random"
    return ""


def ddp_turns(parent: str, card: str, dtype: str) -> list:
    """The flagship graph step without a group, in a world-1 NCCL group and
    with the draws of a rank of two, (and the parent's) in processes of
    their own in turns. Prints wall, busy, idle, launches a step, the
    collective kernels' and the random draws' device time, and the kernels
    the group adds."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    change = [("change", root, m) for m in ("nogroup", "group", "draws2")]
    order = change + change[::-1]
    if parent:
        order = [("parent", parent, "loop")] + order + [("parent", parent, "loop")]
    script = turns_script(_DDP_TURNS_SCRIPT)
    out = []
    for which, path, mode in order:
        path = os.path.abspath(path)
        proc = subprocess.run([sys.executable, "-c", script, mode, str(TRAIN_REPS), dtype], cwd=path,
                              capture_output=True, text=True, env={**os.environ, "PYTHONPATH": path}, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the {which}'s {mode} step profile failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])[0]
        r["tree"] = which
        for kind in ("collective", "random"):
            rows = [k for k in r["kernels"] if _ddp_kind(k["name"]) == kind]
            r[f"{kind}_ms"] = sum(k["device_ms"] for k in rows)
            r[f"{kind}_launches"] = sum(k["count"] for k in rows)
        out.append(r)
        print(f"{card}: ddp train step ({dtype or 'recipe dtype'}) {which} {mode}: wall {r['wall_ms']:.2f} ms (timed "
              f"{', '.join(f'{w:.2f}' for w in r['walls_ms'])}), busy {r['device_busy_ms']:.3f} ms, idle "
              f"{r['device_idle_share']:.3f}, host launches {r['host_launches']}, device launches "
              f"{r['kernel_launches']}, collectives {r['collective_ms']:.4f} ms in {r['collective_launches']} "
              f"launches, random draws {r['random_ms']:.4f} ms in {r['random_launches']}, graphs {r['graphs']}",
              flush=True)
    base = {k["name"]: k for k in next(r for r in out if r["mode"] == "nogroup")["kernels"]}
    grp = next(r for r in out if r["mode"] == "group")
    added = [{"name": k["name"], "count": k["count"] - base.get(k["name"], {}).get("count", 0),
              "device_ms": k["device_ms"] - base.get(k["name"], {}).get("device_ms", 0.0)}
             for k in grp["kernels"] if k["count"] > base.get(k["name"], {}).get("count", 0)]
    print(f"{card}: kernels the world-1 group adds to a step (count, device ms):", flush=True)
    for k in added:
        print(f"  {k['device_ms']:9.4f} ms  {k['count']:5d}x  {k['name'][:110]}", flush=True)
    for r in out:
        r["kernels"] = r["kernels"][:40]
    return [{"added_by_group": added}] + out


def validate_turns(parent: str, card: str, dtype: str) -> list:
    """The flagship's dev epoch (VALIDATE_DEV_UTTS utterances) through
    ``Solver.validate``: graphs and the eager validation in this tree, the
    parent's own validation, in turns. Prints wall, busy, idle and launches
    a dev batch, capture seconds and peak memory of each run."""
    out = []
    for which, runs in _in_turns(parent, _VALIDATE_TURNS_SCRIPT, (VALIDATE_REPS, dtype, VALIDATE_DEV_UTTS),
                                 "validation"):
        for r in runs:
            r["tree"] = which
            n = r["dev_batches"]
            out.append(r)
            name = "parent" if which == "parent" else f"change {r['mode']}"
            print(f"{card}: dev epoch ({dtype or 'recipe dtype'}, {n} batches) {name}: wall {r['wall_ms']:.1f} ms "
                  f"(timed {', '.join(f'{w:.1f}' for w in r['walls_ms'])}) = {r['wall_ms'] / n:.2f} ms a batch, busy "
                  f"{r['device_busy_ms'] / n:.2f} ms a batch, idle {r['device_idle_share']:.3f}, host launches "
                  f"{r['host_launches'] / n:.1f} a batch, device launches {r['kernel_launches'] / n:.1f} a batch, "
                  f"captures {r['captures_s']} s, peak memory {r['peak_mb_above']:.1f} MB above the run's start",
                  flush=True)
    return out


def lm_turns(parent: str, card: str) -> dict:
    """The LM step (lm_example.yaml's width, B = 32, random ids, L = 256 and
    512), LM_WINDOW steps a run: graphs and eager steps with the metrics
    ring in this tree, the parent's steps with their per-step reads, in
    turns. Prints wall, busy, idle and launches a step."""
    out = {}
    for which, res in _in_turns(parent, _LM_TURNS_SCRIPT, (VALIDATE_REPS, LM_WINDOW), "LM step"):
        for length, runs in res.items():
            for r in runs:
                r["tree"] = which
                out.setdefault(length, []).append(r)
                name = "parent" if which == "parent" else f"change {r['mode']}"
                w = LM_WINDOW
                print(f"{card}: LM step L={length} {name}: wall {r['wall_ms'] / w:.3f} ms a step (runs of {w}: "
                      f"{', '.join(f'{x / w:.3f}' for x in r['walls_ms'])}), busy {r['device_busy_ms'] / w:.3f} ms, "
                      f"idle {r['device_idle_share']:.3f}, host launches {r['host_launches'] / w:.1f} a step, device "
                      f"launches {r['kernel_launches'] / w:.1f} a step", flush=True)
    return out


STAGE_VOCAB = 26  # the synthetic corpus's characters: the vocabulary of every smoke model
STAGE_ITERS = 5  # replays a round of a stage program (time_fn: the median of three rounds)


def stage_bucket(cfg, frames: int, batch: int = 0):
    """(B, L) at ``cfg``'s bucket of ``frames`` feature frames: its token
    bucket, and ``batch`` or else the config's batch size, halved above
    ``half_batch_len`` as the loader sizes it."""
    c = cfg.data.corpus
    if frames not in c.buckets:
        raise ValueError(f"{frames} is not a bucket of the config: {c.buckets}")
    b = batch or (max(1, c.batch_size // 2) if frames > c.half_batch_len else c.batch_size)
    return b, c.token_buckets[c.buckets.index(frames)]


def stage_table(cfg, frames: int, dtype: str, batch: int = 0, vocab: int = STAGE_VOCAB,
                iters: int = STAGE_ITERS, trace_dir: str = "") -> dict:
    """The train step's stages at ``cfg``'s bucket of ``frames`` frames and
    compute type ``dtype`` (``utils/stages.py``: each stage program
    captured and its replays timed, held against its ceiling), printed
    with the JAX package's rounded report beside the unrounded numbers, and
    the sum of the stages' ms against one replayed train step's busy
    (``profile_run`` of ``Trainer.train_step`` through ``TrainGraphs`` on
    the stage inputs). With ``trace_dir`` one replayed step is traced there
    (``utils/profiling.trace``, ``train_step.json``). Seed-0 weights.
    ``stage_launches``: each program's kernel launches a replay;
    ``launches``: the launch counters, set to 0 just before the stage
    programs run and read just after them (before the step runs)."""
    import copy

    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import Trainer
    from e2e_asr_tpu_torch.training.step_graph import COUNTED, COUNTERS, TrainGraphs
    from e2e_asr_tpu_torch.utils import stages
    from e2e_asr_tpu_torch.utils.profiling import trace

    dev = resolve_device("cuda")
    cfg = copy.deepcopy(cfg)
    cfg.hparas.dtype = dtype
    b, l_tok = stage_bucket(cfg, frames, batch)
    for fn in COUNTED:
        for c in COUNTERS:
            setattr(fn, c, 0)
    stage_launches: dict = {}
    measured = stages.measure_stages(cfg, b, frames, l_tok, vocab, iters, dtype, dev, launches=stage_launches)
    launches = {fn.__name__ + ("_bf16" if c == "launches_bf16" else ""): getattr(fn, c)
                for fn in COUNTED for c in COUNTERS}
    n_params = stages.param_count(cfg, vocab)
    ceil = stages.stage_ceilings(cfg, b, frames, l_tok, vocab, dtype, n_params)
    rep = stages.stage_report(cfg, b, frames, l_tok, vocab, measured, n_params, dtype)

    trainer = Trainer(cfg)
    params, _ = asr_mod.asr_init(0, cfg.data.audio.output_dim, vocab, cfg.model, dev)
    state = trainer.init_state(params)
    inputs = stages.stage_inputs(cfg, b, frames, l_tok, vocab)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    graphs, gen = TrainGraphs(), torch.Generator(device=dev)
    gen.manual_seed(0)

    def run():
        float(trainer.train_step(state, tbatch, gen, graphs=graphs)["loss"])

    audio_s = float(inputs["wav_len"].sum()) / cfg.data.audio.sample_rate
    step = profile_run(run, audio_s, reps=TRAIN_REPS)
    step.pop("kernels")
    out = {"frames": frames, "b": b, "l_tok": l_tok, "vocab": vocab, "dtype": dtype, "n_params": n_params,
           "report": rep, "stage_ms": {k: v * 1e3 for k, v in measured.items()},
           "ceilings": {k: ceil[k] for k in ceil}, "stage_sum_ms": sum(measured.values()) * 1e3, "step": step,
           "stage_launches": stage_launches, "launches": {k: n for k, n in launches.items() if n}}
    if trace_dir:
        with trace(trace_dir, "train_step"):
            run()
        out["trace"] = os.path.join(trace_dir, "train_step.json")
    print(f"stages at the {frames}-frame bucket (B {b}, L {l_tok}, vocab {vocab}, {dtype}, "
          f"{n_params} parameters):", flush=True)
    print(f"  {'stage':<14} {'ms':>10} {'ceiling ms':>11} {'sol':>7}  bound  (report: ms / ceiling / sol)")
    for k, v in rep.items():
        c = ceil[k]
        print(f"  {k:<14} {measured[k] * 1e3:>10.4f} {c['ceiling_ms']:>11.5f} {c['ceiling_ms'] / (measured[k] * 1e3):>7.4f}"
              f"  {v['bound']:<10} ({v['ms']} / {v['ceiling_ms']} / {v['sol']})")
    for k in ("vgg_fb", "recurrence_fb"):
        print(f"  {k:<14} {'':>10} {ceil[k]['ceiling_ms']:>11.5f} {'':>7}  {ceil[k]['bound']}")
    print(f"  sum of the stages {out['stage_sum_ms']:.3f} ms against the replayed train step's busy "
          f"{step['device_busy_ms']:.3f} ms (wall {step['wall_ms']:.3f} ms; stages timed alone do not "
          f"overlap)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile one training step")
    ap.add_argument("--rnn-impl", default="auto", choices=("auto", "pallas", "pallas_xw"),
                    help="kernel pair of the BiLSTM layers (encoder.rnn_impl)")
    ap.add_argument("--scan-phases", action="store_true",
                    help="with --train: split a step of each fused scan kernel into its phases")
    ap.add_argument("--decode-phases", action="store_true",
                    help="split a launch of each decode kernel into its phases")
    ap.add_argument("--cluster-sizes", default="",
                    help="with --scan-phases: comma-separated cluster sizes to split the kernels at "
                         "(default: the size the grid picks)")
    ap.add_argument("--lm-weight", type=float, default=0.0,
                    help="decode: fuse a seed-0 LM of configs/libri/lm_example.yaml's width at this weight")
    ap.add_argument("--eager", action="store_true",
                    help="decode through the eager loop of beam_step (with --train: the eager step) instead of "
                         "the captured graphs")
    ap.add_argument("--parent", default="",
                    help="a checkout of the parent commit: decode (with --train: train-step) profiles there and "
                         "here in turns")
    ap.add_argument("--dtype", default="recipe", choices=("recipe", "float32", "bfloat16"),
                    help="with --train: the compute type (hparas.dtype; recipe: the recipe's, bfloat16)")
    ap.add_argument("--validate", action="store_true",
                    help="profile the flagship's dev epoch, the validation's graphs against the eager validation "
                         "(with --parent: and the parent's), in turns")
    ap.add_argument("--lm", action="store_true",
                    help="profile the LM step at L=256 and 512, graphs against eager (with --parent: and the "
                         "parent's), in turns")
    ap.add_argument("--ddp", action="store_true",
                    help="profile the flagship graph step without a group, in a world-1 NCCL group and with the "
                         "draws of a rank of two (with --parent: and the parent's), in turns")
    ap.add_argument("--stages", action="store_true",
                    help="the train step's stages, each timed as its own captured program against its ceiling "
                         "(with --config, --bucket, --batch, --dtype)")
    ap.add_argument("--config", default=FLAGSHIP, help="with --stages: the recipe")
    ap.add_argument("--bucket", type=int, default=816, help="with --stages: the bucket's frames")
    ap.add_argument("--batch", type=int, default=0,
                    help="with --stages: the batch (default: the recipe's, halved above half_batch_len)")
    ap.add_argument("--out", default="", help="JSON result (default: _build/profile_*.json)")
    args = ap.parse_args(argv)
    if args.stages and (args.train or args.validate or args.lm or args.ddp or args.scan_phases
                        or args.decode_phases or args.lm_weight or args.eager or args.parent):
        ap.error("--stages stands alone (with --config, --bucket, --batch and --dtype)")
    if not args.stages and (args.config != FLAGSHIP or args.bucket != 816 or args.batch):
        ap.error("--config, --bucket and --batch are options of --stages")
    if args.ddp and (args.train or args.validate or args.lm or args.scan_phases or args.decode_phases
                     or args.lm_weight or args.eager):
        ap.error("--ddp stands alone (with --parent and --dtype)")
    if (args.validate or args.lm) and (args.train or args.scan_phases or args.decode_phases or args.lm_weight
                                       or args.eager or args.validate == args.lm):
        ap.error("--validate and --lm stand alone (with --parent, and --dtype for --validate)")
    if args.scan_phases and not args.train:
        ap.error("--scan-phases needs --train")
    if args.dtype != "recipe" and (not (args.train or args.validate or args.ddp or args.stages)
                                   or args.scan_phases):
        ap.error("--dtype is an option of the training and validation profiles")
    if args.lm_weight and (args.train or args.decode_phases):
        ap.error("--lm-weight is an option of the decode profile")
    if (args.eager or args.parent) and (args.scan_phases or args.decode_phases):
        ap.error("--eager and --parent are options of the decode and train-step profiles")
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    from e2e_asr_tpu_torch import cuda_build

    what = ("stages" if args.stages else "ddp_turns" if args.ddp else "validate_turns" if args.validate else "lm_turns" if args.lm
            else "scan_phases" if args.scan_phases else "decode_phases" if args.decode_phases
            else "train_turns" if args.train and args.parent else ("train" + ("_eager" if args.eager else ""))
            if args.train else "decode_turns" if args.parent
            else ("decode_lm" if args.lm_weight else "decode") + ("_eager" if args.eager else ""))
    out = args.out or os.path.join(cuda_build.BUILD_DIR, f"profile_{what}.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.stages:
        from e2e_asr_tpu_torch.config import Config

        cfg = Config.load(args.config)
        dtype = cfg.hparas.dtype if args.dtype == "recipe" else args.dtype
        print(f"{card}: {args.config}", flush=True)
        res = stage_table(cfg, args.bucket, dtype, args.batch)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "config": args.config, **res}, f, indent=1)
        return
    if args.ddp:
        res = ddp_turns(args.parent, card, "" if args.dtype == "recipe" else args.dtype)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "reps": TRAIN_REPS, "dtype": args.dtype, "runs": res}, f, indent=1)
        return
    if args.validate or args.lm:
        res = (validate_turns(args.parent, card, "" if args.dtype == "recipe" else args.dtype) if args.validate
               else lm_turns(args.parent, card))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "reps": VALIDATE_REPS, "dtype": args.dtype, "runs": res}, f, indent=1)
        return
    if args.train and args.parent:
        turns = train_turns(args.parent, card, "" if args.dtype == "recipe" else args.dtype)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "reps": TRAIN_REPS, "dtype": args.dtype, "runs": turns}, f, indent=1)
        return
    if args.parent:
        turns = decode_turns(args.parent, card)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "reps": DECODE_REPS, "by_lm_weight": turns}, f, indent=1)
        return
    if args.decode_phases:
        from e2e_asr_tpu_torch.device import resolve_device

        cuda_build.build_all(DECODE_PHASE_VARIANTS)
        build_source_variants()
        dev = resolve_device("cuda")
        att_args = flagship_att_inputs(dev)
        split = {"att_step_beam_loc": att_phase_split(att_args),
                 "prefix_recursion": prefix_phase_split(flagship_prefix_inputs(dev))}
        split["att_step_beam_loc"]["variants_ms"] = att_variants_ms(att_args)
        split["prefix_recursion"]["variants"] = prefix_variants(dev)
        print(f"{card}: decode kernels at the flagship decode shapes")
        print_decode_phases(split)
        split["log_mel"] = {"variants_us": log_mel_variants_ms(dev)}
        for b, us in split["log_mel"]["variants_us"].items():
            print(f"log_mel {b}, variants in turns, us a launch: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()),
                  flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, **split}, f, indent=1)
        return
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
    dtype = "" if args.dtype == "recipe" else args.dtype
    run, audio_s = _run_fn(args.train, args.rnn_impl, args.lm_weight, args.eager, dtype)
    result = {"card": card, "what": what, "rnn_impl": args.rnn_impl, "lm_weight": args.lm_weight,
              "dtype": args.dtype, **profile_run(run, audio_s)}
    unit = (f"one train step (B=16, dtype {args.dtype}, {'eager' if args.eager else 'graph'})" if args.train
            else f"decode (B=16, W=16, lm_weight {args.lm_weight:g}, {'eager loop' if args.eager else 'graphs'})")
    print(f"{card}: {unit} of {audio_s:.2f} audio-s wall {result['wall_ms']:.1f} ms = "
          f"{result['audio_s_per_s']:.1f} audio-s/s")
    print(f"profiled: wall {result['profiled_wall_ms']:.1f} ms, device busy {result['device_busy_ms']:.1f} ms, "
          f"idle share {result['device_idle_share']:.3f} of the unprofiled wall "
          f"({result['device_idle_share_profiled']:.3f} profiled), {result['kernel_launches']} kernel launches, "
          f"{result['host_launches']} issued by the host")
    for r in result["kernels"][:25]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name'][:100]}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
