"""ASR training solver.

Counterpart of ``e2e_asr_tpu/bin/train_asr.py``. ``exec`` runs the step loop
to ``hparas.max_step``: the next batch from a ``DevicePrefetcher`` (the
loader's threads fill bucketed batches, a prefetch thread copies them to
the device ahead of the step) -> one training step (features, SpecAugment,
encoder, joint loss, gradients, clip, update, NaN/inf skip;
``training/step.py``) -> every ``valid_step`` steps ``validate``
(teacher-forced dev losses and greedy CER/WER of both heads) with the
``best_att`` / ``best_ctc`` / ``latest`` checkpoints. Throughput is
audio-seconds per wall second. A run resumes from its ``latest``
checkpoint (or ``--load``), data trajectory included.

Input modes (``data.corpus.device_cache``): ``on``, or ``auto`` when the
training corpus's int16 waves fit ``device_cache_bytes``, uploads every
wave once (``flat_corpus``) and each step copies [B] offsets, the step
gathering its waves on the device; ``off`` (or a corpus past int32 sample
offsets) streams padded waves. The dev set streams.

The step (``training/step.py``): on the card a replay of the CUDA graph
captured for the batch's bucket shape (``training/step_graph.py``; one
capture a key, logged with its time, the counterpart of the JAX package's
compile), whichever route the speller takes (the fused scan, or the Python
loop of ``decoder.fused_scan: scan`` or of a speller outside the fused
scan's envelope: a GRU speller, fused decoding of the embedding
regularizer); on the CPU the eager step.
Neither reads the device: each step's scalar metrics (loss, att_loss,
ctc_loss, grad_norm, tf_rate, step_skipped) go into a device ring that is
read once at every ``log_step``, before validation and at the end, as the
JAX loop reads its metrics at its log boundary; ``step_log`` still gets
one record per step.

Validation (``dev_epoch``): the dev batches come through a prefetcher; on
the card each is one replay of the CUDA graph of its dev bucket shape
(``training/eval_graph.py``: losses, CTC argmax and the greedy decode,
sharing the train graphs' memory pool), eager on the CPU. The first dev
batch also keeps its greedy alignment, written as the ``att_align`` PNG
beside ``scalars.jsonl``. The losses are
read once an epoch; each batch's tokens and CTC ids reach the host through
pinned buffers while the next batch runs.

Data parallelism (``main --multihost``, ``parallel/dist.py``): each rank
loads its row block of every train and dev batch (the config's batch size
is the global one), streams its waves (the device corpus is kept to
single-process runs, as in the JAX solver: said once in the log), and runs
the step with the trainer's ``reduce``: the loss's denominators and the
flat buffer of gradients and loss metrics are summed over the ranks inside
the step (captured in its graph under NCCL; eager under gloo, said once).
Validation shards the same way: each dev batch's loss sums stay on the
card, are summed over the ranks once an epoch and divided there, and the
six error counts are summed by ``allsum_scalars``, so that every rank holds
one summary and takes the same ``best_att`` / ``best_ctc`` decisions. Two
audio counts: a ``step_log`` record's ``audio_s`` is the global batch's
audio (each step's audio summed over the ranks at the window's one read),
``rank_audio_s`` the rank's own rows'; the logged
``throughput_audio_sec_per_sec_chip`` is per card, as the JAX package's:
the logging rank's own audio over the window's wall, over its one card.
Rank 0 alone logs and writes
checkpoints; each save ends in a barrier. Local rank 0 builds the kernels
while the host's other ranks wait.

Time per logged window (``utils/tracing.py``): ``rd`` is the wait for the
next batch in ``next(prefetch)`` (the ``input.wait`` spans), ``disp`` the
host time spent issuing the steps' work (the ``train.step`` spans),
``dev`` the rest of the window (window time - rd - disp): the time the
device's queue held the host back, ending with the ring's read. Where the
steps replay graphs with stage marks, ``stage ms`` gives each stage's
device ms a step over the window (the ``train.*`` sections, copied with the
ring's read), and ``scan steps`` the share of the token buckets' steps that
the fused speller scan ran (``scan.steps_run`` over ``scan.bucket_steps``,
``ops/decoder_cuda.py``: a step stops at its batch's longest label). The
line ends with the process's resident memory (``rss``,
as the JAX trainer's). A record's ``wall_s`` is the host time from its
step's start to the next step's start (the window's last step: to the end
of the ring's read); its ``rd_s`` is its step's ``input.wait``.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Deque, Dict, Optional, Tuple

import numpy as np
import torch

from e2e_asr_tpu_torch import convert, optim
from e2e_asr_tpu_torch.align_image import align_to_image
from e2e_asr_tpu_torch.data.dataset import load_dataset
from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.metrics import cal_er
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.solver import BaseSolver, kernels_ready
from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
from e2e_asr_tpu_torch.training.step import EVAL_SCALARS, Trainer, compute_dtype, param_leaves
from e2e_asr_tpu_torch.training.step_graph import TrainGraphs
from e2e_asr_tpu_torch.utils import tracing
from e2e_asr_tpu_torch.utils.misc import human_format, rss_gb

DEV_STEP_RATIO = 1.2  # greedy decode steps per target token at validation
STEP_LOG_LEN = 1000


class Solver(BaseSolver):
    def __init__(self, config, paras, mode: str = "train"):
        super().__init__(config, paras, mode)
        self.device = resolve_device("cpu" if paras.cpu else "cuda")
        self.best_wer = {"att": 3.0, "ctc": 3.0}
        self.max_step = config.hparas.max_step
        self.valid_step = config.hparas.valid_step
        # one record per training step, the most recent STEP_LOG_LEN steps
        self.step_log: Deque[Dict[str, float]] = collections.deque(maxlen=STEP_LOG_LEN)
        self.input_mode = ""  # "stream" or "device_corpus", set by set_model
        self.dev_align: Optional[np.ndarray] = None  # the last dev epoch's att_align image
        self.flat_corpus_s = 0.0  # host seconds flat_corpus() took (device corpus: its setup.corpus span)

    # ------------------------------------------------------------------ data
    def load_data(self):
        cfg = self.config
        (self.tr_set, self.dv_set, self.feat_dim, self.vocab_size, self.tokenizer,
         msg) = load_dataset(cfg.data, ascending=cfg.hparas.curriculum > 0,
                             num_workers=getattr(self.paras, "njobs", None),
                             process_index=dist.rank(), process_count=dist.world())
        self.verbose(msg)
        if dist.world() > 1:
            self.verbose(f"Data parallel: {dist.world()} ranks ({dist.backend()}), each loading its row block "
                         "of every train and dev batch")
        # the decode solver reads the id mapping from beside the checkpoints
        if dist.is_main():
            try:
                self.tokenizer.save(os.path.join(self.ckpdir, "tokenizer.vocab"))
            except NotImplementedError:
                pass

    # ----------------------------------------------------------------- model
    def set_model(self):
        cfg = self.config
        params, self.shapes = asr_mod.asr_init(
            cfg.hparas.seed, self.feat_dim, self.vocab_size, cfg.model, self.device
        )
        # a data-parallel step sums over the ranks; in a world of one it sums nothing
        self.trainer = Trainer(cfg, reduce=dist.all_sum_ if dist.initialized() else None)
        load_path = self.paras.load or (
            self.latest_ckpt_path() if getattr(self.paras, "auto_resume", True) else None
        )
        if load_path:
            payload = convert.load_checkpoint(load_path, self.device)
            self.state = self.trainer.init_state(payload["params"])
            if "opt_state" in payload:
                self.state.opt_state = optim.restore(payload["opt_state"], self.device)
                self.state.step = int(payload["step"])
            self.step = self.state.step
            self.verbose(f"Resumed from {load_path} @ step {self.step}")
        else:
            self.state = self.trainer.init_state(params)
        n_params = sum(p.numel() for p in param_leaves(self.state.params))
        self.verbose(
            f"ASR model: enc_dim={self.shapes.enc_dim}, vocab={self.vocab_size}, "
            f"#params={human_format(n_params)}, device={self.device}"
        )
        self.compute_dtype = str(compute_dtype(cfg)).replace("torch.", "")
        self.verbose(f"Compute dtype: {self.compute_dtype}")
        if self.device.type == "cuda":
            kernels_ready(self.verbose)
        self._corpus_buf = self._device_corpus()
        self.train_graphs = self._train_graphs()
        self.eval_graphs = self._eval_graphs()

    def _train_graphs(self):
        """The solver's cache of train-step graphs, or None where the step
        runs eagerly: on the CPU, and under a group whose collectives cannot
        be captured (said here once). Either speller route is captured: the
        fused scan, or the Python loop (which reads no coin on the host)."""
        if self.device.type != "cuda":
            return None
        if self.trainer.reduce is not None and not dist.capturable():
            self.verbose(f"Train step: eager (the {dist.backend()} group's collectives cannot be captured)")
            return None
        route = asr_mod.speller_route(self.state.params, self.config.model, True, self.device)
        self.verbose(f"Train step: CUDA graphs, one a bucket shape (training/step_graph.py; speller {route})")
        return TrainGraphs(log=self.verbose)

    def _eval_graphs(self):
        """The solver's cache of validation graphs (sharing the train graphs'
        memory pool), or None on the CPU, where validation runs eagerly."""
        if self.device.type != "cuda":
            return None
        route = asr_mod.speller_route(self.state.params, self.config.model, False, self.device)
        self.verbose(f"Validation: CUDA graphs, one a dev bucket shape (training/eval_graph.py; speller {route})")
        return EvalGraphs(log=self.verbose, share=self.train_graphs)

    def _device_corpus(self):
        """The training corpus's flat int16 buffer on the device, or None to
        stream (``data.corpus.device_cache``)."""
        c = self.config.data.corpus
        # YAML reads a bare on / off as a boolean: take it as the word
        mode = {True: "on", False: "off"}.get(c.device_cache, c.device_cache)
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"data.corpus.device_cache must be auto, on or off, not {c.device_cache!r}")
        want = mode == "on" or (mode == "auto" and self.tr_set.total_wav_bytes <= c.device_cache_bytes)
        if want and dist.world() > 1:
            self.verbose(f"Device-resident corpus disabled: {dist.world()} ranks stream their rows "
                         "(the device corpus is kept to single-process runs)")
            want = False
        if want and not self.tr_set.flat_corpus_fits:
            self.verbose("Device-resident corpus disabled: the corpus exceeds int32 sample offsets; "
                         "streaming instead")
            want = False
        if not want:
            self.input_mode = "stream"
            self.verbose(f"Input: streaming padded waves ({self.tr_set.num_workers} loader threads, "
                         f"device_cache {mode})")
            return None
        before = tracing.total_s("setup.corpus")
        flat, _ = self.tr_set.flat_corpus()
        self.flat_corpus_s = tracing.total_s("setup.corpus") - before
        buf = torch.from_numpy(flat).to(self.device)
        self.input_mode = "device_corpus"
        self.verbose(f"Input: device-resident corpus, {flat.nbytes / (1 << 20):.1f} MB int16 on "
                     f"{self.device} (flat_corpus {self.flat_corpus_s:.2f}s; a step copies offsets)")
        return buf

    # ------------------------------------------------------------------ loop
    def _put(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch on the device, in either form: pinned
        ``non_blocking`` copies on the card; an offsets batch also carries
        the device-resident ``corpus`` and its ``n_samples``."""
        keys = ("wav_len", "text", "text_len") + (("wav",) if batch.wav is not None else ("wav_off",))
        out = {k: to_device(getattr(batch, k), self.device) for k in keys}
        if batch.wav is None:
            out["corpus"] = self._corpus_buf  # already on the device
            out["n_samples"] = batch.n_samples
        return out

    def step_generator(self, step: int) -> torch.Generator:
        """The random stream of one training step, from the seed and the step."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.config.hparas.seed + 1) * 1_000_003 + step)
        return gen

    def exec(self):
        cfg = self.config
        self.verbose(f"Total training steps {self.max_step}.")
        curriculum_epochs = 1 if cfg.hparas.curriculum > 0 else 0
        data_iter = self.tr_set.forever(curriculum_epochs=curriculum_epochs, skip_steps=self.step)
        prefetch = DevicePrefetcher(data_iter, self._put, depth=2, device=self.device)
        sr = cfg.data.audio.sample_rate
        keys = self.trainer.scalar_keys()
        # the steps' scalar metrics, one row a step, read at the window's end;
        # allocated here, outside any graph's pool
        ring = torch.empty((STEP_LOG_LEN, len(keys)), dtype=torch.float32, device=self.device)
        pending = []  # the host half of each step's record, until the ring is read
        t_wall = time.time()
        audio_acc = 0.0

        def window_start():
            """The totals a logged window's rd, disp and stage ms count from."""
            return tracing.total_s("input.wait"), tracing.total_s("train.step"), tracing.snapshot("all")

        rd0, disp0, snap0 = window_start()

        def flush() -> Dict[str, float]:
            """Reads the ring (the window's one wait for the device) into
            ``step_log``, each step's ``audio_s`` the global batch's (summed
            over the ranks) and ``rank_audio_s`` this rank's rows'; the
            window's throughput counts the latter. Returns the last step's
            metrics."""
            nonlocal audio_acc
            tracing.fetch()  # the stage marks' totals, copied before the ring's read waits
            rows = ring[:len(pending)].tolist()
            audio = dist.allsum_scalars([rec["audio_s"] for rec in pending]).tolist()
            t_end = time.time()
            for n, (rec, row) in enumerate(zip(pending, rows)):
                t_next = pending[n + 1]["t0"] if n + 1 < len(pending) else t_end
                self.step_log.append({**dict(zip(keys, row)), "step": rec["step"], "audio_s": audio[n],
                                      "rank_audio_s": rec["audio_s"], "wall_s": t_next - rec.pop("t0"),
                                      "rd_s": rec["rd_s"]})
                audio_acc += rec["audio_s"]
            pending.clear()
            return self.step_log[-1]

        try:
            while self.step < self.max_step:
                t0 = time.time()
                rd = tracing.total_s("input.wait")
                batch, dbatch = next(prefetch)
                rd = tracing.total_s("input.wait") - rd
                metrics = self.trainer.train_step(self.state, dbatch, self.step_generator(self.step),
                                                  graphs=self.train_graphs)
                ring[len(pending)].copy_(metrics["scalars"])
                self.step += 1
                audio = float(batch.wav_len.sum()) / sr
                pending.append({"step": self.step, "audio_s": audio, "t0": t0, "rd_s": rd})

                logged = self.step % cfg.hparas.log_step == 0
                validate = self.step % self.valid_step == 0
                if logged or validate or len(pending) == STEP_LOG_LEN or self.step >= self.max_step:
                    m = flush()
                if logged:
                    dt = time.time() - t_wall
                    t_rd = tracing.total_s("input.wait") - rd0
                    t_disp = tracing.total_s("train.step") - disp0
                    t_dev = max(dt - t_rd - t_disp, 0.0)
                    thr = audio_acc / max(dt, 1e-9)  # per card: a rank drives one (JAX: / local devices)
                    snap = tracing.snapshot("all")  # copied by flush() before its read of the ring
                    stages = tracing.section_means(snap0, snap, "train.")
                    run, bucket = (snap["counts"].get(k, 0) - snap0["counts"].get(k, 0)
                                   for k in ("scan.steps_run", "scan.bucket_steps"))
                    self.progress(
                        f"loss {m['loss']:.3f} | att {m.get('att_loss', 0):.3f} | "
                        f"ctc {m.get('ctc_loss', 0):.3f} | gnorm {m['grad_norm']:.2f} | "
                        f"tf {m['tf_rate']:.2f} | {thr:.1f} audio-s/s/chip | "
                        f"rd {t_rd:.2f}s ({t_rd / max(dt, 1e-9):.0%}) | disp {t_disp:.2f}s | "
                        f"dev {t_dev:.2f}s ({t_dev / max(dt, 1e-9):.0%}) | "
                        + (f"stage ms {' '.join(f'{k} {v:.2f}' for k, v in stages.items())} | " if stages else "")
                        + (f"scan steps {run / bucket:.0%} | " if bucket else "")
                        + f"rss {rss_gb():.1f}G"
                    )
                    self.write_log("loss", {"tr_att": m.get("att_loss", 0.0), "tr_ctc": m.get("ctc_loss", 0.0)})
                    self.write_log("grad_norm", m["grad_norm"])
                    self.write_log("tf_rate", m["tf_rate"])
                    self.write_log("throughput_audio_sec_per_sec_chip", thr)
                    t_wall, audio_acc = time.time(), 0.0
                    rd0, disp0, snap0 = tracing.total_s("input.wait"), tracing.total_s("train.step"), snap

                if validate:
                    self.validate()
                    tracing.drop()  # the validation is no gap between two steps
                    t_wall, audio_acc = time.time(), 0.0
                    rd0, disp0, snap0 = window_start()
        finally:
            prefetch.close()
        self.verbose("Training completed.")
        self.save_checkpoint("latest", "step", float(self.step), self.state)

    # ------------------------------------------------------------ validation
    def validate(self, graphs: bool = True) -> Dict[str, float]:
        """Dev losses (teacher-forced) and greedy error rates of both heads
        (``dev_epoch``); saves ``best_att`` / ``best_ctc`` on improvement and
        ``latest``. ``graphs=False`` runs the dev batches eagerly on the card."""
        summary, sample = self.dev_epoch(graphs)
        if sample is not None:
            self.write_log("dev_sample", sample)
        if self.dev_align is not None:
            self.write_image("att_align", self.dev_align)
        self.progress("DEV " + " | ".join(f"{k} {v:.3f}" for k, v in summary.items()))
        self.write_log("dev_loss", {k: v for k, v in summary.items() if "loss" in k})
        for head, key in (("att", "dev_er_att"), ("ctc", "dev_er_ctc")):
            if key in summary:
                self.write_log("er", {key: summary[key]})
                if summary[key] < self.best_wer[head]:
                    self.best_wer[head] = summary[key]
                    self.save_checkpoint(f"best_{head}", key, summary[key], self.state)
        self.save_checkpoint("latest", "step", float(self.step), self.state)
        self.dev_summary = summary
        return summary

    def dev_epoch(self, graphs: bool = True, keep: Optional[list] = None) -> Tuple[Dict[str, float], Optional[str]]:
        """One pass over the dev set: (summary, the ``dev_sample`` text of
        the first batch with a reference, or None).

        The dev batches come through a ``DevicePrefetcher``. Each runs
        ``Trainer.eval_device`` (losses, CTC argmax, greedy tokens), on the
        card a replay of ``eval_graphs`` unless ``graphs`` is False, with no
        host read: its losses stay on the device, one row a batch, read once
        after the last batch; its tokens, CTC ids and encoder lengths are
        copied to pinned host buffers behind its work, and the host scores
        batch i (``cal_er``) while batch i + 1 runs. The summary is the
        per-batch host path's: each loss the mean of the batches' float32
        values in float64, each error rate the corpus-level ratio of the
        counts. Under data parallelism each rank validates its row block of
        every dev batch: the batches' loss numerators and denominators
        (``eval_device`` ``sums``, one device row a batch) are summed over
        the ranks in one collective after the last batch and divided on the
        card (``Trainer.eval_losses``: in a world of one, the batches' own
        losses bit for bit), and the error counts are summed by
        ``allsum_scalars``; the sample is rank 0's. The first dev batch
        also keeps the greedy decode's alignment (its own graph, keyed by
        ``keep_align``; every other batch's is as before): that of its first
        utterance with a reference, [max_step, S] of the first head, becomes
        ``dev_align`` (``align_to_image``, [max_step, S, 3] uint8; None
        without an attention head or such an utterance), which ``validate``
        writes as the ``att_align`` PNG. ``keep`` (a list) receives each
        batch's host arrays."""
        params = self.state.params
        keys = self.trainer.scalar_keys(EVAL_SCALARS)
        eval_graphs = self.eval_graphs if graphs else None
        er = np.zeros(6, np.float64)  # att err/len, att alt err/len, ctc err/len
        have = set()
        rows = []  # each batch's loss sums, on the device
        sample = []
        self.dev_align = None

        def score(batch, host, event):
            if event is not None:
                event.synchronize()
            host = {k: v.numpy() for k, v in host.items()}
            text, valid = batch.text, batch.text_len > 0
            if "tokens" in host:
                toks = host["tokens"]
                er[0:2] += cal_er(self.tokenizer, toks[valid], text[valid], mode=self._er_mode())
                er[2:4] += cal_er(self.tokenizer, toks[valid], text[valid], mode=self._er_mode(alt=True))
                if not sample and valid.any():
                    i = int(np.argmax(valid))
                    sample.append(f"hyp: {self.tokenizer.decode(toks[i])}\n\nref: {self.tokenizer.decode(text[i])}")
            if "align" in host:
                self.dev_align = align_to_image(host["align"])
            if "ctc_preds" in host:
                er[4:6] += cal_er(self.tokenizer, host["ctc_preds"][valid], text[valid], mode=self._er_mode(),
                                  ctc=True, pred_len=host["enc_len"][valid])
            have.update(host)
            if keep is not None:
                keep.append(host)

        pending = None
        prefetch = DevicePrefetcher(self.dv_set.epoch(), self._put, depth=2, device=self.device)
        try:
            for batch, dbatch in prefetch:
                max_step = int(batch.text.shape[1] * DEV_STEP_RATIO)
                m = self.trainer.validate_batch(params, dbatch, max_step, graphs=eval_graphs, keep_align=not rows)
                rows.append(m["sums"].clone())
                outs = {k: m[k] for k in ("tokens", "ctc_preds", "enc_len") if k in m}
                valid = batch.text_len > 0
                if "align" in m and valid.any():
                    outs["align"] = m["align"][int(np.argmax(valid)), :, 0, :]
                event = None
                if self.device.type == "cuda":
                    outs = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
                            for k, v in outs.items()}
                    event = torch.cuda.Event()
                    event.record()
                if pending is not None:
                    score(*pending)
                pending = (batch, outs, event)
            if pending is not None:
                score(*pending)
        finally:
            prefetch.close()
        summary = {}
        if rows:  # as many dev batches on every rank
            sums = dist.all_sum_(torch.stack(rows))
            losses = self.trainer.eval_losses(sums).T.tolist()  # the one read of the losses
            summary = {k: float(np.mean(col)) for k, col in zip(keys, losses)}
        er = dist.allsum_scalars(er)
        if "tokens" in have:
            summary["dev_er_att"] = float(er[0] / max(er[1], 1))
            summary[f"dev_{self._er_mode(alt=True)}_att"] = float(er[2] / max(er[3], 1))
        if "ctc_preds" in have:
            summary["dev_er_ctc"] = float(er[4] / max(er[5], 1))
        return summary, (sample[0] if sample else None)

    def _er_mode(self, alt: bool = False) -> str:
        primary = "cer" if self.tokenizer.token_type == "character" else "wer"
        if alt:
            return "wer" if primary == "cer" else "cer"
        return primary
