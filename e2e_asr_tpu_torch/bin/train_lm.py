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

A step whose loss or gradient norm is not finite leaves the parameters and
the optimizer state as they were (the JAX step keeps the parameters but
advances the optimizer state, so that a non-finite gradient stays in
Adam's moments). ``--load`` restores ``params``, ``opt_state`` and ``step``;
there is no auto-resume, as in the JAX package. Checkpoints are of kind
``"lm"`` (``convert.py``).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Deque, Dict, Optional

import numpy as np
import torch

from e2e_asr_tpu_torch import convert, cuda_build
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.data import corpus as corpus_mod
from e2e_asr_tpu_torch.data.dataset import TextLoader, build_tokenizer
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.models import lm as lm_mod
from e2e_asr_tpu_torch.optim import Optimizer
from e2e_asr_tpu_torch.solver import BaseSolver
from e2e_asr_tpu_torch.training.step import TrainState, param_leaves, update_step

STEP_LOG_LEN = 1000


def lm_loss(params, cfg: LMConfig, text: torch.Tensor, text_len: torch.Tensor,
            generator: Optional[torch.Generator], train: bool):
    """Next-token cross-entropy of ``<sos> y_1 ... y_{L-1}`` (``<sos>`` = 0)
    against ``y``, the mean over the tokens inside each row's length.
    Returns (loss, {"loss", "n_tokens"})."""
    b, length = text.shape
    text = text.long()
    inputs = torch.cat([torch.zeros((b, 1), dtype=text.dtype, device=text.device), text[:, :-1]], 1)
    logp = torch.log_softmax(lm_mod.apply_seq(params, cfg, inputs, text_len, generator, train), -1)
    nll = -logp.gather(2, text[..., None])[..., 0]
    mask = (torch.arange(length, device=text.device)[None, :] < text_len[:, None]).to(nll.dtype)
    n_tokens = mask.sum()
    loss = torch.sum(nll * mask) / torch.clamp(n_tokens, min=1)
    return loss, {"loss": loss, "n_tokens": n_tokens}


def train_step(state: TrainState, opt: Optimizer, cfg: LMConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """One update of ``state`` in place (``training/step.py`` ``update_step``:
    gradients, the NaN/inf skip, clip and update). Returns metrics (tensors)
    with the pre-clip ``grad_norm`` and ``step_skipped``."""
    return update_step(state, opt, lambda params: lm_loss(
        params, cfg, batch["text"], batch["text_len"], generator, True))


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
        self.tr_set = TextLoader(tr_utts, self.tokenizer, bs)
        self.dv_set = TextLoader(dv_utts, self.tokenizer, bs, shuffle=False)
        self.verbose(f"LM data: {len(self.tr_set)}/{len(self.dv_set)} tr/dv batches, vocab {self.vocab_size}")
        if self.mode == "train":
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
            self.state.opt_state = payload["opt_state"]
            self.state.step = self.step = int(payload["step"])
            self.verbose(f"Resumed from {self.paras.load} @ step {self.step}")
        n = sum(p.numel() for p in param_leaves(params))
        self.verbose(f"RNNLM: #params={n}, device={self.device}")
        if self.device.type == "cuda":
            t0 = time.time()
            cuda_build.build_all()
            self.verbose(f"CUDA kernels ready in {time.time() - t0:.1f}s")

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

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
        while self.step < self.max_step:
            t0 = time.time()
            batch = self._put(next(it))
            m = train_step(self.state, self.opt, cfg.lm, batch, self.step_generator(self.step))
            self.step += 1
            rec = {k: float(v) for k, v in m.items()}
            self.step_log.append({**rec, "step": self.step, "wall_s": time.time() - t0})
            if self.step % cfg.hparas.log_step == 0:
                self.progress(f"lm loss {rec['loss']:.3f} | ppl {np.exp(rec['loss']):.1f} | "
                              f"gnorm {rec['grad_norm']:.2f}")
                self.write_log("lm_loss", rec["loss"])
                self.write_log("lm_ppl", float(np.exp(rec["loss"])))
            if self.step % self.valid_step == 0:
                self.validate()
        self.verbose("Training completed.")
        self.save_checkpoint("latest", "step", float(self.step), self.state)

    def validate(self) -> float:
        """Token-weighted dev perplexity; saves ``best_ppl`` on improvement
        and ``latest``."""
        tot_nll, tot_tok = 0.0, 0.0
        for batch in self.dv_set.epoch(0):
            m = self.eval_step(self._put(batch))
            n = float(m["n_tokens"])
            tot_nll += float(m["loss"]) * n
            tot_tok += n
        ppl = float(np.exp(tot_nll / max(tot_tok, 1)))
        self.progress(f"DEV ppl {ppl:.2f}")
        self.write_log("dev_ppl", ppl)
        if ppl < self.best_ppl:
            self.best_ppl = ppl
            self.save_checkpoint("best_ppl", "ppl", ppl, self.state)
        self.save_checkpoint("latest", "step", float(self.step), self.state)
        self.dev_ppl = ppl
        return ppl
