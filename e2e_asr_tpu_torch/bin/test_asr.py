"""ASR evaluation solver: batched beam-search decoding of dev and test.

Counterpart of ``e2e_asr_tpu/bin/test_asr.py``. Each eval batch goes
through ``compute_features`` then ``beam_search`` on the chosen device, one
bucket shape per batch. On the card the beam steps replay CUDA graphs
(decode/beam_graph.py), captured once a bucket shape and kept on the
solver for its weights, as the JAX package compiles its decode once a
bucket shape; each capture and its time is logged. With
``decode.lm_weight`` > 0 the RNN-LM checkpoint ``decode.lm_path``
(``bin/train_lm.py``; its ``lm`` section from the ``decode.lm_config``
yaml, else this config's) is fused into the beam search. Writes <outdir>/<name>/output_{split}.csv (best
hypothesis vs truth per utterance) and beam_{split}.csv (every beam), with
the JAX package's columns, and reports the split's error rate and decoded
audio-seconds per second. The loader's threads fill the batches and a
``DevicePrefetcher`` copies them to the device ahead of the decode;
``stats[split]["input_s"]`` is the time the decode waited on it.

Tracing (``utils/tracing.py``): a batch is a ``decode.batch`` span (id: the
solver's batch number) around ``decode.features`` and ``beam_search``'s
``decode.encoder``, ``decode.steps`` and ``decode.rank``. A split's summary
line gives each one's host ms a batch, the beam step's device sections
(``beam.*`` marks: ms a step, and the share of the marked time that lies
between batches) and the wait on the prefetcher (``input.wait``).

Under a process group (``main --multihost --test``, ``parallel/dist.py``)
the decode is sharded by batch: rank r decodes batches r, r + n, r + 2n, ...
of the split's order, chosen before any batch is loaded
(``BucketedLoader.epoch(shard=...)``), so that no rank reads another's
waves. Each rank's rows reach rank 0 through the group
(``dist.gather_to_main``; no shared output directory is assumed), and rank
0 writes both csvs in the one-process order, bit for bit a one-process
run's. The error counts, utterances and audio are summed over the ranks, so
that every rank returns the same ``{split: error rate}``.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict

import numpy as np
import torch

from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config
from e2e_asr_tpu_torch.data.dataset import load_eval_datasets
from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from e2e_asr_tpu_torch.decode.beam import BeamResult, beam_search
from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.models.encoder import total_downsample
from e2e_asr_tpu_torch.native import levenshtein_batch
from e2e_asr_tpu_torch.ops.frontend import compute_features
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.solver import kernels_ready
from e2e_asr_tpu_torch.utils import tracing


class Solver:
    """Solver(config, paras).load_data()/set_model()/exec(), as in the JAX package."""

    def __init__(self, config: Config, paras, mode: str = "test"):
        if mode != "test":
            raise ValueError(f"bin/test_asr.Solver decodes only (mode 'test', not {mode!r}); "
                             "training is bin/train_asr.Solver")
        self.config = config
        self.paras = paras
        self.device = resolve_device("cpu" if paras.cpu else "cuda")
        name = paras.name
        if name is None:
            name = os.path.basename(paras.config).replace(".yaml", "") + f"_sd{paras.seed}"
        self.outdir = os.path.join(paras.outdir, name)
        # a decode config may embed the training config path (src section)
        if config.src.config:
            train_cfg = Config.load(config.src.config)
            self.config.model = train_cfg.model
            self.config.data.audio = train_cfg.data.audio
            if not self.config.data.text.vocab_file:
                self.config.data.text = train_cfg.data.text
        dist.check_config(config.parallel.dp, config.parallel.mp)
        self.ckpt = paras.load or config.src.ckpt
        if not self.ckpt:
            raise ValueError("test mode needs src.ckpt or --load")
        self.stats: Dict[str, dict] = {}

    def verbose(self, msg: str) -> None:
        if self.paras.verbose and dist.is_main():
            print("[INFO]", msg, flush=True)

    def load_data(self):
        # prefer the tokenizer saved beside the checkpoint (id mapping must match)
        if not self.config.data.text.vocab_file:
            cand = os.path.join(os.path.dirname(os.path.abspath(self.ckpt)), "tokenizer.vocab")
            if os.path.isfile(cand):
                self.config.data.text.vocab_file = cand
                self.verbose(f"Pinned tokenizer from training run: {cand}")
        self.eval_sets, self.feat_dim, self.vocab_size, self.tokenizer, msg = load_eval_datasets(
            self.config.data, batch_size=self.config.decode.batch_size,
            num_workers=getattr(self.paras, "njobs", None),
        )
        self.verbose(msg)

    def set_model(self):
        payload = convert.load_checkpoint(self.ckpt, self.device)
        if (payload["vocab_size"], payload["feat_dim"]) != (self.vocab_size, self.feat_dim):
            raise ValueError(
                f"checkpoint vocab/feat_dim {payload['vocab_size']}/{payload['feat_dim']} != "
                f"data {self.vocab_size}/{self.feat_dim}"
            )
        self.params = payload["params"]
        # the beam step's CUDA graphs, by bucket shape, for these weights
        self.beam_graphs = BeamGraphs(log=self.verbose)
        self.verbose(f"Loaded ASR ckpt from {self.ckpt} on {self.device}")
        self.lm_params, self.lm_cfg = None, None
        dcfg = self.config.decode
        if dcfg.lm_weight > 0:
            if not dcfg.lm_path:
                raise ValueError("decode.lm_weight > 0 needs decode.lm_path (an LM checkpoint)")
            self.lm_cfg = Config.load(dcfg.lm_config).lm if dcfg.lm_config else self.config.lm
            lm = convert.load_checkpoint(dcfg.lm_path, self.device, kind="lm")
            if lm["vocab_size"] != self.vocab_size:
                raise ValueError(f"LM checkpoint {dcfg.lm_path} has vocabulary size {lm['vocab_size']}, "
                                 f"the recogniser's tokenizer {self.vocab_size}")
            self.lm_params = lm["params"]
            self.verbose(f"Loaded RNNLM from {dcfg.lm_path} for shallow fusion (w={dcfg.lm_weight})")
        if self.device.type == "cuda":
            kernels_ready(self.verbose)

    def max_step_for(self, n_samples: int) -> int:
        """One max_step per bucket, from the bucket's sample count."""
        cfg = self.config
        ds = total_downsample(cfg.model.encoder)
        shift = int(cfg.data.audio.sample_rate * cfg.data.audio.frame_shift / 1000)
        max_enc = n_samples // shift // ds + 1
        return max(4, int(cfg.decode.max_len_ratio * max_enc))

    def put(self, wav: np.ndarray, wav_len: np.ndarray):
        """A host batch's (wav, wav_len) on the solver's device (pinned
        ``non_blocking`` copies on the card)."""
        return to_device(wav, self.device), to_device(wav_len, self.device)

    @torch.inference_mode()
    def decode_batch(self, wav: torch.Tensor, wav_len: torch.Tensor, graphs: bool = True) -> BeamResult:
        """Beam-decodes one batch given as tensors on the solver's device;
        on the card through the solver's graphs, or with ``graphs=False``
        through the eager loop (for comparison). The ``decode.batch`` span."""
        with tracing.span("decode.batch"):
            with tracing.span("decode.features"):
                feat, feat_len = compute_features(wav, wav_len, self.config.data.audio)
            return beam_search(
                self.params, self.config.model, self.config.decode, feat, feat_len,
                self.max_step_for(wav.shape[1]), lm_params=self.lm_params, lm_cfg=self.lm_cfg,
                graphs=graphs, graph_cache=self.beam_graphs,
            )

    def exec(self):
        """Decode every eval split, write per-split csvs; returns {split: error rate}."""
        return {split: self._decode_set(split, loader) for split, loader in self.eval_sets.items()}

    def _decode_set(self, split: str, loader) -> float:
        cfg = self.config
        batches = []  # (rows_out, rows_beam) of each batch this rank decodes, in order
        audio_sec = 0.0
        n_utt = 0
        t_dev = 0.0
        tracing.drop()  # the first batch's gap is not the last split's
        before = tracing.snapshot("all")
        t0 = time.time()
        rank, world = dist.rank(), dist.world()
        prefetch = DevicePrefetcher(loader.epoch(shard=(rank, world)), lambda b: self.put(b.wav, b.wav_len),
                                    depth=2, device=self.device)
        try:
            for batch, (wav, wav_len) in prefetch:
                t_b = time.time()
                res = self.decode_batch(wav, wav_len)
                toks = res.tokens.cpu().numpy()
                lens = res.lengths.cpu().numpy()
                scores = res.scores.cpu().numpy()
                t_dev += time.time() - t_b
                rows_out, rows_beam = [], []
                for i, uid in enumerate(batch.uids):
                    if not uid:
                        continue
                    truth = self.tokenizer.decode(batch.text[i])
                    rows_out.append((uid, truth, self.tokenizer.decode(toks[i, 0, : lens[i, 0]])))
                    for wi in range(toks.shape[1]):
                        hyp = self.tokenizer.decode(toks[i, wi, : lens[i, wi]])
                        rows_beam.append((uid, truth, hyp, float(scores[i, wi])))
                    n_utt += 1
                    audio_sec += float(batch.wav_len[i]) / cfg.data.audio.sample_rate
                batches.append((rows_out, rows_beam))
        finally:
            prefetch.close()
        wall = time.time() - t0
        after = tracing.snapshot("all")  # the last batch's readback has waited for the card
        t_in = _delta(before, after, "input.wait")[1]

        mode = "cer" if self.tokenizer.token_type == "character" else "wer"
        split_ = str.split if mode == "wer" else list
        pairs = [(split_(hyp), split_(ref)) for rows_out, _ in batches for _, ref, hyp in rows_out]
        err = int(levenshtein_batch(pairs).sum())  # one native call a split
        tot = sum(max(len(r), 1) for _, r in pairs)
        if world > 1:
            err, tot, n_utt, audio_sec = dist.allsum_scalars([err, tot, n_utt, audio_sec]).tolist()
            n_utt = int(n_utt)
        # every rank's batches on rank 0: batch i of the split is rank (i % world)'s (i // world)-th
        parts = dist.gather_to_main(batches)
        if parts is not None:
            order = [parts[i % world][i // world] for i in range(sum(len(p) for p in parts))]
            os.makedirs(self.outdir, exist_ok=True)
            with open(os.path.join(self.outdir, f"output_{split}.csv"), "w", newline="") as f:
                wtr = csv.writer(f, delimiter="\t")
                wtr.writerow(["idx", "truth", "prediction"])
                for rows_out, _ in order:
                    wtr.writerows(rows_out)
            with open(os.path.join(self.outdir, f"beam_{split}.csv"), "w", newline="") as f:
                wtr = csv.writer(f, delimiter="\t")
                wtr.writerow(["idx", "truth", "prediction", "score"])
                for _, rows_beam in order:
                    wtr.writerows(rows_beam)
        er = err / max(tot, 1)
        self.stats[split] = {"utts": n_utt, "audio_sec": audio_sec, "wall_s": wall, "decode_s": t_dev,
                             "input_s": t_in, mode: er}
        self.verbose(
            f"[{split}] decoded {n_utt} utts on {self.device} | {mode} {er:.4f} | "
            f"{audio_sec / max(wall, 1e-9):.1f} audio-s/s (decode {t_dev:.2f}s, input {t_in:.2f}s "
            f"of {wall:.2f}s wall) | {_batch_parts(before, after)}"
            f"| results -> {self.outdir}"
        )
        return er


def _delta(before: dict, after: dict, span: str):
    """(count, seconds) of ``span`` between two tracing snapshots."""
    a, b = after["spans"].get(span, {}), before["spans"].get(span, {})
    return a.get("n", 0) - b.get("n", 0), a.get("total_s", 0.0) - b.get("total_s", 0.0)


def _batch_parts(before: dict, after: dict) -> str:
    """A split's decode by part between two tracing snapshots: the batches,
    each part's host ms a batch (and the graph replays a batch), and where
    the beam step replayed graphs with marks, its device ms a step by
    section and the share of the marked time that lies between batches."""
    n = max(_delta(before, after, "decode.batch")[0], 1)

    def counted(name):
        return after["counts"].get(name, 0) - before["counts"].get(name, 0)

    host = ", ".join(f"{p} {_delta(before, after, 'decode.' + p)[1] * 1e3 / n:.2f}"
                     for p in ("features", "encoder", "steps", "rank"))
    out = (f"{counted('input.batches')} batches, host ms a batch: {host} ({counted('graph.replays') / n:.0f} "
           f"replays, {_delta(before, after, 'graph.replay')[1] * 1e3 / n:.2f} ms) ")
    means = tracing.section_means(before, after, "beam.", per="beam.speller")
    if means:
        marked = {k: v["total_ms"] - before["sections"].get(k, {}).get("total_ms", 0.0)
                  for k, v in after["sections"].items() if k.startswith("beam.")}
        gap = marked.get("beam.between_batches", 0.0) / max(sum(marked.values()), 1e-9)
        out += ("| beam step, device ms a step: "
                + ", ".join(f"{k} {v:.3f}" for k, v in means.items() if k != "between_batches")
                + f"; between batches {gap:.1%} of the marked time ")
    return out
