"""The joint CTC/attention training step.

Counterpart of ``e2e_asr_tpu/training/step.py``: features (with dither) ->
SpecAugment -> encoder -> both heads -> joint loss -> gradients -> global
norm -> clip + update, with the NaN/inf step skip. A batch is streaming
(``wav``) or offsets into the device-resident corpus (``resolve_wav``
gathers its waves). Loss conventions:

- attention head: cross-entropy over the non-pad target tokens, mean over
  them;
- CTC head: per-utterance nll divided by the label length, labels without
  the trailing <eos>, mean over the valid utterances (text_len > 0);
- joint: ctc_weight * ctc + (1 - ctc_weight) * att;
- ``hparas.ctc_infeasible``: 'skip' lets an utterance with no CTC alignment
  make the loss +inf, and the step is then skipped; 'mask' leaves such
  utterances out of the mean (evaluation always masks them);
- a step whose loss or pre-clip gradient norm is not finite changes
  neither the parameters nor the optimizer state (both are checked before
  the optimizer touches anything).

Compute type: ``hparas.dtype`` (``compute_dtype``). The features, dither
and SpecAugment are computed in float32 and then cast to it; every layer
casts its float32 parameters to its input's type, so at ``bfloat16`` the
whole forward and backward are stored in bfloat16 (the kernels' own
rounding points are those of the JAX package's Pallas kernels); both
heads' outputs go back to float32 for the losses. Parameters, gradients,
their norm and the optimizer state stay float32. Evaluation runs the same
``compute_loss``. Random draws (dither, SpecAugment, dropout, the
teacher-forcing coins, sampled feedback) come from one ``torch.Generator``
per step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import Config
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.ops.ctc import ctc_loss
from e2e_asr_tpu_torch.ops.frontend import compute_features
from e2e_asr_tpu_torch.ops.specaugment import specaugment
from e2e_asr_tpu_torch.optim import Optimizer, OptState, global_norm, tf_rate


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order (sorted dict keys,
    list order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def compute_dtype(cfg: Config) -> torch.dtype:
    """The compute type of ASR training and validation (``hparas.dtype``,
    as ``e2e_asr_tpu/training/step.py`` ``_dtype`` reads it)."""
    return torch.bfloat16 if cfg.hparas.dtype == "bfloat16" else torch.float32


def resolve_wav(batch: Dict[str, torch.Tensor], n_samples: int = 0):
    """(wav, wav_len) of a batch in either form (``e2e_asr_tpu/training/
    step.py`` ``resolve_wav``).

    A streaming batch carries ``wav``. An offsets batch carries ``wav_off``
    [B], the device-resident flat int16 corpus under ``corpus`` and
    ``n_samples`` (the argument, where given, stands in for it); row b is
    the ``n_samples`` samples from ``wav_off[b]``, the start clamped to the
    buffer as ``lax.dynamic_slice`` clamps it, and every sample at or past
    ``wav_len[b]`` is zeroed: the zero-padded streaming batch, bitwise.
    Plain indexing of a strided view; no host synchronisation."""
    if batch.get("wav") is not None:
        return batch["wav"], batch["wav_len"]
    n = int(n_samples or batch.get("n_samples", 0))
    if n <= 0:
        raise ValueError("an offsets batch needs its n_samples")
    flat = batch["corpus"]
    if flat.shape[0] < n:
        raise ValueError(f"flat corpus of {flat.shape[0]} samples is shorter than a {n}-sample row")
    off = torch.clamp(batch["wav_off"].long(), 0, flat.shape[0] - n)
    wav = flat.unfold(0, n, 1)[off]  # [B, n]: rows of the [len - n + 1, n] view
    wav_len = batch["wav_len"]
    pos = torch.arange(n, device=wav.device)[None, :]
    return wav.masked_fill(pos >= wav_len[:, None], 0), wav_len


def compute_loss(
    params,
    cfg: Config,
    wav: torch.Tensor,
    wav_len: torch.Tensor,
    text: torch.Tensor,
    text_len: torch.Tensor,
    tf: float,
    generator: Optional[torch.Generator],
    train: bool = True,
    sample_decoding: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.model
    feat, feat_len = compute_features(
        wav, wav_len, cfg.data.audio, generator=generator if train else None
    )
    if train and m.specaugment.enable and generator is not None:
        feat = specaugment(feat, feat_len, m.specaugment, generator)
    feat = feat.to(compute_dtype(cfg))
    out = asr_mod.forward(
        params, m, feat, feat_len, decode_step=text.shape[1], tf_rate=tf, teacher=text,
        generator=generator if train else None, train=train, sample_decoding=sample_decoding,
    )
    enc_len = out["enc_len"]
    text = text.long()
    valid_utt = text_len > 0
    n_utt = torch.clamp(valid_utt.sum(), min=1)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=wav.device)

    if "att_logits" in out:
        logp = torch.log_softmax(out["att_logits"].float(), -1)
        pos = torch.arange(text.shape[1], device=text.device)[None, :]
        tok_mask = ((pos < text_len[:, None]) & valid_utt[:, None]).to(logp.dtype)
        nll = -logp.gather(2, text[..., None])[..., 0]
        att_loss = torch.sum(nll * tok_mask) / torch.clamp(tok_mask.sum(), min=1)
        metrics["att_loss"] = att_loss
        metrics["att_preds"] = torch.argmax(logp, -1)
        total = total + (1.0 - m.ctc_weight) * att_loss

    if "ctc_log_probs" in out:
        lp = out["ctc_log_probs"].float()
        label_len = torch.clamp(text_len - 1, min=0)  # strip <eos>
        pos = torch.arange(text.shape[1], device=text.device)[None, :]
        labels = torch.where(pos < label_len[:, None], text, 0)
        nll = ctc_loss(lp, enc_len, labels, label_len)
        keep = valid_utt
        if not train or cfg.hparas.ctc_infeasible == "mask":
            keep = keep & torch.isfinite(nll)
        per_utt = torch.where(keep, nll / torch.clamp(label_len, min=1), 0.0)
        ctc_l = per_utt.sum() / n_utt
        metrics["ctc_loss"] = ctc_l
        metrics["ctc_preds"] = torch.argmax(lp, -1)
        total = total + m.ctc_weight * ctc_l

    metrics["loss"] = total
    metrics["enc_len"] = enc_len
    return total, metrics


@dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int


def update_step(state: TrainState, opt: Optimizer, loss_fn) -> Dict[str, torch.Tensor]:
    """One update of ``state`` in place from ``loss_fn(params) -> (loss,
    metrics)``: gradients, their global norm, the NaN/inf skip (the step's
    one host synchronisation) and, where both are finite, clip and update.
    Returns the metrics (detached) with the pre-clip ``grad_norm``,
    ``step_skipped`` and ``device_wait_s`` (host seconds spent waiting for
    the device at the finiteness check)."""
    leaves = param_leaves(state.params)
    with torch.enable_grad():
        loss, metrics = loss_fn(state.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    g_norm = global_norm(grads)
    metrics["grad_norm"] = g_norm
    t0 = time.perf_counter()
    ok = bool(torch.isfinite(loss) & torch.isfinite(g_norm))
    metrics["device_wait_s"] = torch.tensor(time.perf_counter() - t0)
    metrics["step_skipped"] = torch.tensor(0.0 if ok else 1.0)
    if ok:
        opt.update(leaves, grads, state.opt_state, g_norm)
    state.step += 1
    return metrics


class Trainer:
    """``train_step`` / ``eval_step`` over one parameter tree (the
    counterpart of ``make_train_step`` / ``make_eval_step``)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.opt = Optimizer(cfg.hparas)

    def init_state(self, params) -> TrainState:
        for p in param_leaves(params):
            p.requires_grad_(True)
        return TrainState(params, self.opt.init(param_leaves(params)), 0)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], sample_decoding: bool = True):
        """One update in place from a batch in either form (``resolve_wav``).
        Returns metrics (tensors), with the pre-clip ``grad_norm``,
        ``tf_rate``, ``step_skipped`` and ``device_wait_s`` (host seconds
        spent waiting for the device at the finiteness check)."""
        tf = tf_rate(self.cfg.hparas, state.step)
        wav, wav_len = resolve_wav(batch)
        metrics = update_step(state, self.opt, lambda params: compute_loss(
            params, self.cfg, wav, wav_len, batch["text"], batch["text_len"], tf,
            generator, train=True, sample_decoding=sample_decoding))
        metrics["tf_rate"] = torch.tensor(tf)
        return metrics

    @torch.no_grad()
    def eval_step(self, params, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Teacher-forced losses and greedy per-head predictions."""
        wav, wav_len = resolve_wav(batch)
        _, metrics = compute_loss(
            params, self.cfg, wav, wav_len, batch["text"], batch["text_len"],
            tf=1.0, generator=None, train=False,
        )
        return metrics
