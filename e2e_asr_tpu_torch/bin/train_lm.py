"""RNN-LM training solver: text batches -> next-token cross-entropy ->
perplexity -> the ``best_ppl`` checkpoint.

Counterpart of ``e2e_asr_tpu/bin/train_lm.py``. ``exec`` runs the step loop
to ``hparas.max_step``: a ``TextLoader`` batch of transcripts -> the LM over
``<sos> y_1 ... y_{L-1}`` (``models/lm.py`` ``apply_seq``, its layers
through the ``lstm_seq`` kernel pair on the card) -> masked cross-entropy
against ``y`` -> gradients -> clip by global norm and the update rule
(``optim.Optimizer``) -> every ``log_step`` the ``lm_loss`` and ``lm_ppl``
scalars, every ``valid_step`` the token-weighted dev perplexity with the
``best_ppl`` and ``latest`` checkpoints; ``latest`` again at the end. The
tokenizer is pinned beside the checkpoints (``tokenizer.vocab``): fusion at
decode time must share the recogniser's id mapping.

On the card the step and the dev evaluation replay CUDA graphs, one a text
bucket shape (``training/lm_graph.py``; dropout from a generator registered
with the step's graph, re-seeded with each step's seed); on the CPU they
run eagerly. Neither reads the device: each step's scalar metrics go into a
device ring read once a log window (``step_log`` keeps one record a step,
``wall_s`` from the step's start to the next one's), and the dev sums are
read once a validation.

A step whose loss or gradient norm is not finite leaves the parameters and
the optimizer state as they were (the JAX step keeps the parameters but
advances the optimizer state, so that a non-finite gradient stays in
Adam's moments). ``--load`` restores ``params``, ``opt_state`` and ``step``;
there is no auto-resume, as in the JAX package. Checkpoints are of kind
``"lm"`` (``convert.py``).

Data parallelism (``main --lm --multihost``, ``parallel/dist.py``): each
rank's ``TextLoader`` yields its row block of every global batch; the
step's token count is summed over the ranks before the division
(``lm_loss(reduce=...)``) and its gradients and loss in one flat buffer
(``training/step.py`` ``device_update``), captured in the step's graph
under NCCL (eager under gloo); the dev sums are summed over the ranks once
a validation. Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Deque, Dict, Optional

import numpy as np
import torch

from e2e_asr_tpu_torch import convert, optim
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.data import corpus as corpus_mod
from e2e_asr_tpu_torch.data.dataset import TextLoader, build_tokenizer
from e2e_asr_tpu_torch.data.prefetch import to_device
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.models import lm as lm_mod
from e2e_asr_tpu_torch.optim import Optimizer
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.solver import BaseSolver, kernels_ready
from e2e_asr_tpu_torch.training.lm_graph import LMEvalGraphs, LMGraphs
from e2e_asr_tpu_torch.training.step import Reduce, TrainState, device_update, param_leaves
from e2e_asr_tpu_torch.utils.misc import human_format

STEP_LOG_LEN = 1000


def lm_loss(params, cfg: LMConfig, text: torch.Tensor, text_len: torch.Tensor,
            generator: Optional[torch.Generator], train: bool, reduce: Optional[Reduce] = None):
    """Next-token cross-entropy of ``<sos> y_1 ... y_{L-1}`` (``<sos>`` = 0)
    against ``y``, the mean over the tokens inside each row's length (with
    ``reduce``, over the global batch's tokens: the count summed over the
    ranks). Returns (loss, {"loss", "n_tokens"})."""
    b, length = text.shape
    text = text.long()
    inputs = torch.cat([torch.zeros((b, 1), dtype=text.dtype, device=text.device), text[:, :-1]], 1)
    logp = torch.log_softmax(lm_mod.apply_seq(params, cfg, inputs, text_len, generator, train), -1)
    nll = -logp.gather(2, text[..., None])[..., 0]
    mask = (torch.arange(length, device=text.device)[None, :] < text_len[:, None]).to(nll.dtype)
    n_tokens = mask.sum()
    if reduce is not None:
        n_tokens = reduce(n_tokens.reshape(1))[0]
    loss = torch.sum(nll * mask) / torch.clamp(n_tokens, min=1)
    return loss, {"loss": loss, "n_tokens": n_tokens}


# the scalar metrics an LM step writes into the solver's ring, in this order
SCALARS = ("loss", "n_tokens", "grad_norm", "step_skipped")


def device_step(state: TrainState, opt: Optimizer, cfg: LMConfig, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator], reduce: Optional[Reduce] = None) -> Dict[str, torch.Tensor]:
    """The device work of one update of ``state`` in place
    (``training/step.py`` ``device_update``: gradients, the NaN/inf skip by
    select, clip and update): what a CUDA graph captures
    (``training/lm_graph.py``). Reads nothing back. Returns metrics (device
    tensors) with the pre-clip ``grad_norm``, ``step_skipped`` and
    ``scalars`` (``SCALARS`` stacked, float32). With ``reduce`` the step is
    the global batch's (``lm_loss``, ``device_update``)."""
    m = device_update(state, opt, lambda params: lm_loss(
        params, cfg, batch["text"], batch["text_len"], generator, True, reduce), reduce)
    m["scalars"] = torch.stack([m[k] for k in SCALARS])
    return m


def train_step(state: TrainState, opt: Optimizer, cfg: LMConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], graphs=None, reduce: Optional[Reduce] = None
               ) -> Dict[str, torch.Tensor]:
    """One update of ``state`` in place and the host's step count (every
    step counts, a skipped one too). Eagerly, or with ``graphs`` (a
    ``training/lm_graph.LMGraphs``) by a replay of the graph of the batch's
    shape (captured at its first batch) with ``generator``'s seed, whose
    outputs are the graph's static tensors: read them before the next
    replay. ``reduce`` sums over the ranks (``device_step``)."""
    if graphs is not None:
        m = graphs.step(cfg, state, batch, generator.initial_seed(),
                        lambda b, gen: device_step(state, opt, cfg, b, gen, reduce))
    else:
        m = device_step(state, opt, cfg, batch, generator, reduce)
    state.step += 1
    return m


class Solver(BaseSolver):
    ckpt_kind = "lm"

    def __init__(self, config, paras, mode: str = "train"):
        super().__init__(config, paras, mode)
        self.device = resolve_device("cpu" if paras.cpu else "cuda")
        self.best_ppl = np.inf
        self.max_step = config.hparas.max_step
        self.valid_step = config.hparas.valid_step
        self.feat_dim = 0  # an LM takes no audio
        # one record per training step, the most recent STEP_LOG_LEN steps
        self.step_log: Deque[Dict[str, float]] = collections.deque(maxlen=STEP_LOG_LEN)

    def load_data(self):
        c = self.config.data.corpus
        tr_utts = corpus_mod.load_corpus(c.name, c.path, c.train_split)
        dv_utts = corpus_mod.load_corpus(c.name, c.path, c.dev_split)
        self.tokenizer = build_tokenizer(self.config.data, tr_utts)
        self.vocab_size = self.tokenizer.vocab_size
        bs = self.config.lm.batch_size
        procs = dict(process_index=dist.rank(), process_count=dist.world())
        self.tr_set = TextLoader(tr_utts, self.tokenizer, bs, **procs)
        self.dv_set = TextLoader(dv_utts, self.tokenizer, bs, shuffle=False, **procs)
        self.verbose(f"LM data: {len(self.tr_set)}/{len(self.dv_set)} tr/dv batches, vocab {self.vocab_size}")
        if self.mode == "train" and dist.is_main():
            try:
                self.tokenizer.save(os.path.join(self.ckpdir, "tokenizer.vocab"))
            except NotImplementedError:
                pass

    def set_model(self):
        cfg = self.config
        gen = torch.Generator()
        gen.manual_seed(cfg.hparas.seed)
        params = lm_mod.lm_init(gen, self.vocab_size, cfg.lm, self.device)
        self.opt = Optimizer(cfg.hparas)
        if self.paras.load:
            payload = convert.load_checkpoint(self.paras.load, self.device, kind="lm")
            params = payload["params"]
        for p in param_leaves(params):
            p.requires_grad_(True)
        self.state = TrainState(params, self.opt.init(param_leaves(params)), 0)
        if self.paras.load:
            self.state.opt_state = optim.restore(payload["opt_state"], self.device)
            self.state.step = self.step = int(payload["step"])
            self.verbose(f"Resumed from {self.paras.load} @ step {self.step}")
        n = sum(p.numel() for p in param_leaves(params))
        self.verbose(f"RNNLM: #params={human_format(n)}, device={self.device}")
        # a data-parallel step sums over the ranks; in a world of one it sums nothing
        self.reduce = dist.all_sum_ if dist.initialized() else None
        self.graphs = self.eval_graphs = None  # the CPU runs the eager step and evaluation
        if self.device.type == "cuda":
            kernels_ready(self.verbose)
            if dist.capturable():
                self.verbose("LM step and evaluation: CUDA graphs, one a text bucket shape (training/lm_graph.py)")
                self.graphs = LMGraphs(log=self.verbose)
            else:
                self.verbose(f"LM step: eager (the {dist.backend()} group's collectives cannot be captured); "
                             "evaluation: CUDA graphs")
            self.eval_graphs = LMEvalGraphs(log=self.verbose, share=self.graphs)

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the device (on the card pinned ``non_blocking``
        copies, so that the host does not wait for the queued steps)."""
        return {k: to_device(v, self.device) for k, v in batch.items()}

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout stream of one training step, from the seed and the step."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.config.hparas.seed + 2) * 1_000_003 + step)
        return gen

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return lm_loss(self.state.params, self.config.lm, batch["text"], batch["text_len"], None, False)[1]

    def exec(self):
        cfg = self.config
        self.verbose(f"Total training steps {self.max_step}.")
        it = self.tr_set.forever()
        # the steps' scalar metrics, one row a step, read at the window's end;
        # allocated here, outside any graph's pool
        ring = torch.empty((STEP_LOG_LEN, len(SCALARS)), dtype=torch.float32, device=self.device)
        pending = []  # (step, start time) of each step, until the ring is read

        def flush() -> Dict[str, float]:
            """Reads the ring (the window's one wait for the device) into
            ``step_log``; returns the last step's metrics."""
            rows = ring[:len(pending)].tolist()
            t_end = time.time()
            for n, ((step, t0), row) in enumerate(zip(pending, rows)):
                t_next = pending[n + 1][1] if n + 1 < len(pending) else t_end
                self.step_log.append({**dict(zip(SCALARS, row)), "step": step, "wall_s": t_next - t0})
            pending.clear()
            return self.step_log[-1]

        while self.step < self.max_step:
            t0 = time.time()
            batch = self._put(next(it))
            m = train_step(self.state, self.opt, cfg.lm, batch, self.step_generator(self.step), graphs=self.graphs,
                           reduce=self.reduce)
            ring[len(pending)].copy_(m["scalars"])
            self.step += 1
            pending.append((self.step, t0))
            logged = self.step % cfg.hparas.log_step == 0
            validate = self.step % self.valid_step == 0
            if logged or validate or len(pending) == STEP_LOG_LEN or self.step >= self.max_step:
                rec = flush()
            if logged:
                self.progress(f"lm loss {rec['loss']:.3f} | ppl {np.exp(rec['loss']):.1f} | "
                              f"gnorm {rec['grad_norm']:.2f}")
                self.write_log("lm_loss", rec["loss"])
                self.write_log("lm_ppl", float(np.exp(rec["loss"])))
            if validate:
                self.validate()
        self.verbose("Training completed.")
        self.save_checkpoint("latest", "step", float(self.step), self.state)

    def validate(self, graphs: bool = True) -> float:
        """Token-weighted dev perplexity; saves ``best_ppl`` on improvement
        and ``latest``. Each dev batch's evaluation (on the card a replay of
        the graph of its shape, unless ``graphs`` is False) adds its
        token-weighted nll and its token count, in float64, to a device sum
        read once after the last batch: the host sums' arithmetic, bit for
        bit. Under data parallelism each rank evaluates its row block of
        every dev batch and the sums are summed over the ranks once."""
        acc = torch.zeros(2, dtype=torch.float64, device=self.device)
        for batch in self.dv_set.epoch(0):
            batch = self._put(batch)
            if graphs and self.eval_graphs is not None:
                m = self.eval_graphs.eval(self.config.lm, self.state.params, batch, lambda b, _: self.eval_step(b))
            else:
                m = self.eval_step(batch)
            n = m["n_tokens"].double()
            acc += torch.stack([m["loss"].double() * n, n])
        tot_nll, tot_tok = dist.all_sum_(acc).tolist()
        ppl = float(np.exp(tot_nll / max(tot_tok, 1)))
        self.progress(f"DEV ppl {ppl:.2f}")
        self.write_log("dev_ppl", ppl)
        if ppl < self.best_ppl:
            self.best_ppl = ppl
            self.save_checkpoint("best_ppl", "ppl", ppl, self.state)
        self.save_checkpoint("latest", "step", float(self.step), self.state)
        self.dev_ppl = ppl
        return ppl
