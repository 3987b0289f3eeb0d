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

Time per logged window: ``rd`` is the wait for the next batch in
``next(prefetch)``, ``disp`` the host time spent issuing the step's work,
``dev`` the wait for the device at the step's finiteness check (the skip
decision needs the loss and the gradient norm on the host, so every step
is fenced there).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Deque, Dict

import numpy as np
import torch

from e2e_asr_tpu_torch import convert, cuda_build
from e2e_asr_tpu_torch.data.dataset import load_dataset
from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from e2e_asr_tpu_torch.decode.greedy import greedy_decode
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.metrics import cal_er
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.ops.frontend import compute_features
from e2e_asr_tpu_torch.solver import BaseSolver
from e2e_asr_tpu_torch.training.step import Trainer, param_leaves

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
        self.flat_corpus_s = 0.0  # host seconds flat_corpus() took (device corpus)

    # ------------------------------------------------------------------ data
    def load_data(self):
        cfg = self.config
        (self.tr_set, self.dv_set, self.feat_dim, self.vocab_size, self.tokenizer,
         msg) = load_dataset(cfg.data, ascending=cfg.hparas.curriculum > 0,
                             num_workers=getattr(self.paras, "njobs", None))
        self.verbose(msg)
        # the decode solver reads the id mapping from beside the checkpoints
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
        self.trainer = Trainer(cfg)
        load_path = self.paras.load or (
            self.latest_ckpt_path() if getattr(self.paras, "auto_resume", True) else None
        )
        if load_path:
            payload = convert.load_checkpoint(load_path, self.device)
            self.state = self.trainer.init_state(payload["params"])
            if "opt_state" in payload:
                self.state.opt_state = payload["opt_state"]
                self.state.step = int(payload["step"])
            self.step = self.state.step
            self.verbose(f"Resumed from {load_path} @ step {self.step}")
        else:
            self.state = self.trainer.init_state(params)
        n_params = sum(p.numel() for p in param_leaves(self.state.params))
        self.verbose(
            f"ASR model: enc_dim={self.shapes.enc_dim}, vocab={self.vocab_size}, "
            f"#params={n_params}, device={self.device}"
        )
        if cfg.hparas.dtype == "bfloat16":  # the JAX step's test (e2e_asr_tpu/training/step.py _dtype)
            self.verbose(f"Compute dtype: float32, not the recipe's hparas.dtype {cfg.hparas.dtype} (the port "
                         "trains in float32 until bf16 is ported: ROADMAP Queue 1 item 4)")
        if self.device.type == "cuda":
            t0 = time.time()
            cuda_build.build_all()
            self.verbose(f"CUDA kernels ready in {time.time() - t0:.1f}s")
        self._corpus_buf = self._device_corpus()

    def _device_corpus(self):
        """The training corpus's flat int16 buffer on the device, or None to
        stream (``data.corpus.device_cache``)."""
        c = self.config.data.corpus
        # YAML reads a bare on / off as a boolean: take it as the word
        mode = {True: "on", False: "off"}.get(c.device_cache, c.device_cache)
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"data.corpus.device_cache must be auto, on or off, not {c.device_cache!r}")
        want = mode == "on" or (mode == "auto" and self.tr_set.total_wav_bytes <= c.device_cache_bytes)
        if want and not self.tr_set.flat_corpus_fits:
            self.verbose("Device-resident corpus disabled: the corpus exceeds int32 sample offsets; "
                         "streaming instead")
            want = False
        if not want:
            self.input_mode = "stream"
            self.verbose(f"Input: streaming padded waves ({self.tr_set.num_workers} loader threads, "
                         f"device_cache {mode})")
            return None
        t0 = time.time()
        flat, _ = self.tr_set.flat_corpus()
        self.flat_corpus_s = time.time() - t0
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
        t_wall = time.time()
        audio_acc = t_rd = t_disp = t_dev = 0.0
        try:
            while self.step < self.max_step:
                t0 = time.time()
                batch, dbatch = next(prefetch)
                t1 = time.time()
                metrics = self.trainer.train_step(self.state, dbatch, self.step_generator(self.step))
                t2 = time.time()
                self.step += 1
                audio = float(batch.wav_len.sum()) / sr
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                wait = m.pop("device_wait_s")
                self.step_log.append({**m, "step": self.step, "audio_s": audio, "wall_s": t2 - t0,
                                      "rd_s": t1 - t0, "dev_s": wait})
                audio_acc += audio
                t_rd += t1 - t0
                t_dev += wait
                t_disp += t2 - t1 - wait

                if self.step % cfg.hparas.log_step == 0:
                    dt = time.time() - t_wall
                    thr = audio_acc / max(dt, 1e-9)
                    self.progress(
                        f"loss {m['loss']:.3f} | att {m.get('att_loss', 0):.3f} | "
                        f"ctc {m.get('ctc_loss', 0):.3f} | gnorm {m['grad_norm']:.2f} | "
                        f"tf {m['tf_rate']:.2f} | {thr:.1f} audio-s/s | "
                        f"rd {t_rd:.2f}s ({t_rd / max(dt, 1e-9):.0%}) | disp {t_disp:.2f}s | "
                        f"dev {t_dev:.2f}s ({t_dev / max(dt, 1e-9):.0%})"
                    )
                    self.write_log("loss", {"tr_att": m.get("att_loss", 0.0), "tr_ctc": m.get("ctc_loss", 0.0)})
                    self.write_log("grad_norm", m["grad_norm"])
                    self.write_log("tf_rate", m["tf_rate"])
                    self.write_log("throughput_audio_sec_per_sec", thr)
                    t_wall, audio_acc = time.time(), 0.0
                    t_rd = t_disp = t_dev = 0.0

                if self.step % self.valid_step == 0:
                    self.validate()
                    t_wall, audio_acc = time.time(), 0.0
                    t_rd = t_disp = t_dev = 0.0
        finally:
            prefetch.close()
        self.verbose("Training completed.")
        self.save_checkpoint("latest", "step", float(self.step), self.state)

    # ------------------------------------------------------------ validation
    def validate(self) -> Dict[str, float]:
        """Dev losses (teacher-forced) and greedy error rates of both heads;
        saves ``best_att`` / ``best_ctc`` on improvement and ``latest``."""
        cfg = self.config
        params = self.state.params
        losses: Dict[str, list] = {}
        er = np.zeros(6, np.float64)  # att err/len, att alt err/len, ctc err/len
        have_att = have_ctc = sample_logged = False
        for batch in self.dv_set.epoch():  # the dev set streams
            dbatch = self._put(batch)
            m = self.trainer.eval_step(params, dbatch)
            for k in ("loss", "att_loss", "ctc_loss"):
                if k in m:
                    losses.setdefault(k, []).append(float(m[k]))
            text, valid = batch.text, batch.text_len > 0
            if "att_preds" in m:
                have_att = True
                feat, feat_len = compute_features(dbatch["wav"], dbatch["wav_len"], cfg.data.audio)
                max_step = int(text.shape[1] * DEV_STEP_RATIO)
                toks, _ = greedy_decode(params, cfg.model, feat, feat_len, max_step)
                toks = toks.cpu().numpy()
                er[0:2] += cal_er(self.tokenizer, toks[valid], text[valid], mode=self._er_mode())
                er[2:4] += cal_er(self.tokenizer, toks[valid], text[valid], mode=self._er_mode(alt=True))
                if not sample_logged and valid.any():
                    i = int(np.argmax(valid))
                    self.write_log("dev_sample", f"hyp: {self.tokenizer.decode(toks[i])}\n\n"
                                                 f"ref: {self.tokenizer.decode(text[i])}")
                    sample_logged = True
            if "ctc_preds" in m:
                have_ctc = True
                ids = m["ctc_preds"].cpu().numpy()
                enc_len = m["enc_len"].cpu().numpy()
                er[4:6] += cal_er(self.tokenizer, ids[valid], text[valid], mode=self._er_mode(),
                                  ctc=True, pred_len=enc_len[valid])
        summary = {k: float(np.mean(v)) for k, v in losses.items()}
        if have_att:
            summary["dev_er_att"] = float(er[0] / max(er[1], 1))
            summary[f"dev_{self._er_mode(alt=True)}_att"] = float(er[2] / max(er[3], 1))
        if have_ctc:
            summary["dev_er_ctc"] = float(er[4] / max(er[5], 1))
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

    def _er_mode(self, alt: bool = False) -> str:
        primary = "cer" if self.tokenizer.token_type == "character" else "wer"
        if alt:
            return "wer" if primary == "cer" else "cer"
        return primary
