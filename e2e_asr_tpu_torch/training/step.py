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
  neither the parameters nor the optimizer state, counts included: the
  update is computed all the same and every tensor takes
  ``where(ok, new, old)`` on the device, as the JAX step selects
  (``e2e_asr_tpu/training/step.py``); ``step_skipped`` = 1 - ok stays a
  device tensor.

Device stage marks (``utils/tracing.py``): a captured train step holds a
mark before each stage (``train.features``, ``.encoder``, ``.heads``,
``.backward``, ``.reduce`` with a ``reduce``, ``.optimizer``) and one at
its end, so that each replay adds the stages' device times and the gap to
the next step (``train.between_steps``); where the speller takes the Python
loop, its steps are ``train.speller`` inside ``.heads`` (``models/asr.py``). They launch only while
``TrainGraphs`` captures; an eager step, a validation and an LM step
launch none.

Nothing in a step reads the device from the host, and no number that
changes from step to step is a Python scalar inside it: the teacher-forcing
rate is a 0-dim device tensor (``Trainer.tf_buf``, written with ``fill_``
before the step), the coins stay on the device, the scan's sampled-feedback
seed is a device tensor, and the learning rate and bias corrections come
from the optimizer's device counts. So the same code runs eagerly and as a
captured CUDA graph (``training/step_graph.py``), which the solver replays
on the card.

Compute type: ``hparas.dtype`` (``compute_dtype``). The features, dither
and SpecAugment are computed in float32 and then cast to it; every layer
casts its float32 parameters to its input's type, so at ``bfloat16`` the
whole forward and backward are stored in bfloat16 (the kernels' own
rounding points are those of the JAX package's Pallas kernels); both
heads' outputs go back to float32 for the losses (the attention head's
logits; the CTC head's log-probs, or its logits from
``models/asr.py`` ``CTC_FLOAT32_VOCAB`` classes on). Parameters, gradients,
their norm and the optimizer state stay float32. Evaluation runs the same
``compute_loss`` (``eval_device``: with the greedy decode, one program on
the card, ``training/eval_graph.py``). Random draws (dither, SpecAugment,
dropout, the teacher-forcing coins, sampled feedback) come from one
``torch.Generator`` per step (the graphs re-seed a generator of their own
with its seed).

Data parallelism (``parallel/dist.py``): the JAX step computes the loss of
the *global* batch, so its normalisers are global. With ``reduce`` (the
trainer's, ``dist.all_sum_``, set where a process group exists)
``compute_loss`` sums the two denominators (the attention head's token
count, the CTC head's utterance count) over the ranks in one 2-element
collective before its divisions, each rank's loss its own numerator over
the global count; ``device_update`` copies the gradients and the loss
metrics into one flat float32 buffer, sums it over the ranks in one
collective and takes the norm, the skip, the clip and the update from the
sums, so that every rank updates alike. A mean of per-rank losses would
not be the reference wherever the ranks' token counts differ. Padding rows
(``text_len`` = ``wav_len`` = 0) add nothing to either sum. Random draws
of a row's tensor take the global batch's shape (``dist.global_draw``); the
step generator's seed is the same on every rank. Without ``reduce`` there
is no collective, no flat buffer and no extra copy. Validation returns each
dev batch's loss numerators and denominators (``eval_device`` ``sums``),
summed over the ranks once an epoch and divided by ``eval_losses``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import Config
from e2e_asr_tpu_torch.decode.greedy import greedy_decode
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.models import plugin as plugin_mod
from e2e_asr_tpu_torch.ops.ctc import ctc_loss
from e2e_asr_tpu_torch.ops.frontend import compute_features
from e2e_asr_tpu_torch.ops.specaugment import specaugment
from e2e_asr_tpu_torch.optim import Optimizer, OptState, global_norm, tf_rate
from e2e_asr_tpu_torch.utils import tracing

Reduce = Callable[[torch.Tensor], torch.Tensor]  # a sum over the ranks, in place (dist.all_sum_)


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
    tf,
    generator: Optional[torch.Generator],
    train: bool = True,
    sample_decoding: bool = True,
    reduce: Optional[Reduce] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(joint loss, metrics) of a batch. The metrics hold each head's loss
    and its numerator and denominator (``att_num`` / ``att_den``,
    ``ctc_num`` / ``ctc_den``; with the embedding regularizer's loss,
    ``emb_reg_loss`` and ``emb_reg_num`` / ``emb_reg_den``); with ``reduce``
    the denominators are the global batch's (one collective of the counts,
    before the divisions). With ``emb_reg.fuse`` > 0 the attention head's
    log-probs are the plugin's fused mixture, renormalised."""
    m = cfg.model
    feat, feat_len = compute_features(
        wav, wav_len, cfg.data.audio, generator=generator if train else None
    )
    if train and m.specaugment.enable and generator is not None:
        feat = specaugment(feat, feat_len, m.specaugment, generator)
    feat = feat.to(compute_dtype(cfg))
    tracing.mark("train.encoder")
    enc, enc_len = asr_mod.encode(params, m, feat, feat_len, generator if train else None, train)
    tracing.mark("train.heads")
    # in training the loss reads no speller output past the batch's longest
    # label, so the fused scan stops there: a count on the device, read by
    # the kernels (outside training every output is read: eval_step's
    # att_preds cover all L)
    steps = torch.clamp(text_len.max(), max=text.shape[1]).to(torch.int32).reshape(1) if train else None
    out = asr_mod.heads(
        params, m, enc, enc_len, decode_step=text.shape[1], tf_rate=tf, teacher=text,
        generator=generator if train else None, train=train, sample_decoding=sample_decoding, steps=steps,
    )
    enc_len = out["enc_len"]
    text = text.long()
    valid_utt = text_len > 0
    pos = torch.arange(text.shape[1], device=text.device)[None, :]
    tok_mask = ((pos < text_len[:, None]) & valid_utt[:, None]).float()
    use_er = "emb_reg" in params and "att_logits" in out and m.emb_reg.weight > 0
    dens = [tok_mask.sum(), valid_utt.sum()]  # the attention head's tokens, the CTC head's utterances
    if use_er:
        er_num, er_den = plugin_mod.emb_reg_sums(params["emb_reg"], m.emb_reg, out["att_hidden"], text, text_len)
        dens.append(er_den)
    if reduce is not None:
        dens = list(reduce(torch.stack([d.float() for d in dens])))
    att_den, ctc_den = dens[:2]
    metrics: Dict[str, torch.Tensor] = {}
    att_loss = ctc_l = er = None

    if "att_logits" in out:
        if "emb_reg" in params and m.emb_reg.fuse > 0:
            logp = torch.log_softmax(plugin_mod.fused_log_probs(
                params["emb_reg"], m.emb_reg, out["att_logits"], out["att_hidden"]), -1)
        else:
            logp = torch.log_softmax(out["att_logits"].float(), -1)
        nll = -logp.gather(2, text[..., None])[..., 0]
        att_num = torch.sum(nll * tok_mask)
        att_loss = att_num / torch.clamp(att_den, min=1)
        metrics.update(att_loss=att_loss, att_num=att_num, att_den=att_den.float())
        metrics["att_preds"] = torch.argmax(logp, -1)
        if use_er:
            er = er_num / torch.clamp(dens[2], min=1)
            metrics.update(emb_reg_loss=er, emb_reg_num=er_num, emb_reg_den=dens[2])

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
        ctc_num = per_utt.sum()
        ctc_l = ctc_num / torch.clamp(ctc_den, min=1)
        metrics.update(ctc_loss=ctc_l, ctc_num=ctc_num, ctc_den=ctc_den.float())
        metrics["ctc_preds"] = torch.argmax(lp, -1)

    total = joint_loss(att_loss, ctc_l, m.ctc_weight, wav.device, er, m.emb_reg.weight)
    metrics["loss"] = total
    metrics["enc_len"] = enc_len
    return total, metrics


def joint_loss(att_loss: Optional[torch.Tensor], ctc_loss_: Optional[torch.Tensor], ctc_weight: float,
               device, emb_reg_loss: Optional[torch.Tensor] = None, emb_reg_weight: float = 0.0) -> torch.Tensor:
    """ctc_weight * ctc + (1 - ctc_weight) * att (+ emb_reg_weight *
    emb_reg, in the JAX package's order of sums) over the heads there are
    (elementwise, so that ``eval_losses`` computes each dev batch's loss with
    the arithmetic of ``compute_loss``)."""
    total = torch.zeros((), device=device)
    if att_loss is not None:
        total = total + (1.0 - ctc_weight) * att_loss
    if emb_reg_loss is not None:
        total = total + emb_reg_weight * emb_reg_loss
    if ctc_loss_ is not None:
        total = total + ctc_weight * ctc_loss_
    return total


@dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int


# the scalar metrics a training step writes into the solver's ring, in this
# order (those of the heads the model has)
SCALARS = ("loss", "att_loss", "ctc_loss", "emb_reg_loss", "grad_norm", "tf_rate", "step_skipped")
EVAL_SCALARS = ("loss", "att_loss", "ctc_loss", "emb_reg_loss")  # the losses: those of a dev batch
EVAL_SUMS = ("att_num", "att_den", "ctc_num", "ctc_den", "emb_reg_num", "emb_reg_den")  # a dev batch's row of loss sums


def flat_all_sum(grads: List[torch.Tensor], scalars: List[torch.Tensor],
                 reduce: Reduce) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``grads`` and the 0-dim ``scalars`` copied into one flat float32
    buffer (one concatenation: a batched copy kernel on the card, not a
    copy a tensor), summed over the ranks by ``reduce`` in one collective;
    returns (the summed gradients, the summed scalars), views of that
    buffer."""
    sizes = [g.numel() for g in grads]
    n = sum(sizes)
    flat = torch.empty(n + len(scalars), dtype=torch.float32, device=grads[0].device)
    torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1) for s in scalars], out=flat)
    reduce(flat)
    return [v.view(g.shape) for v, g in zip(flat[:n].split(sizes), grads)], list(flat[n:].unbind())


def device_update(state: TrainState, opt: Optimizer, loss_fn, reduce: Optional[Reduce] = None
                  ) -> Dict[str, torch.Tensor]:
    """One update of ``state``'s tensors in place from ``loss_fn(params) ->
    (loss, metrics)``: gradients, their global norm, clip and update, each
    tensor taking ``where(ok, new, old)`` with ok = loss and norm finite.
    With ``reduce`` the gradients and the losses (``EVAL_SCALARS``)
    are first summed over the ranks in one flat buffer (``flat_all_sum``),
    and everything after comes from the sums. Touches no host state and
    reads nothing back. Returns the metrics (detached) with the pre-clip
    ``grad_norm`` and ``step_skipped`` (1 - ok, float32), all on the
    device."""
    leaves = param_leaves(state.params)
    with torch.enable_grad():
        loss, metrics = loss_fn(state.params)
        tracing.mark("train.backward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if reduce is not None:
        tracing.mark("train.reduce")
        keys = [k for k in EVAL_SCALARS if k in metrics]
        grads, sums = flat_all_sum(grads, [metrics[k].float() for k in keys], reduce)
        metrics.update(zip(keys, sums))
        loss = metrics["loss"]
    tracing.mark("train.optimizer")
    g_norm = global_norm(grads)
    metrics["grad_norm"] = g_norm
    ok = torch.isfinite(loss) & torch.isfinite(g_norm)
    metrics["step_skipped"] = 1.0 - ok.float()
    opt.update(leaves, grads, state.opt_state, g_norm, ok)
    return metrics


class Trainer:
    """``train_step`` / ``eval_step`` / ``eval_device`` over one parameter
    tree (the counterpart of ``make_train_step`` / ``make_eval_step`` and
    the validation's jitted greedy decode)."""

    def __init__(self, cfg: Config, reduce: Optional[Reduce] = None):
        self.cfg = cfg
        self.opt = Optimizer(cfg.hparas)
        self.tf_buf: Optional[torch.Tensor] = None  # the step's teacher-forcing rate, on the device
        # the sum over the ranks of a data-parallel step (dist.all_sum_), None in a world of one
        self.reduce = reduce

    def init_state(self, params) -> TrainState:
        for p in param_leaves(params):
            p.requires_grad_(True)
        return TrainState(params, self.opt.init(param_leaves(params)), 0)

    def scalar_keys(self, names: Tuple[str, ...] = SCALARS) -> Tuple[str, ...]:
        """The names of ``metrics["scalars"]``, in order: those of ``names``
        (``SCALARS`` of a train step, ``EVAL_SCALARS`` of a dev batch) that
        the heads this model has give (``emb_reg_loss``: an attention head
        with the embedding regularizer's loss weighted in)."""
        m = self.cfg.model
        w = m.ctc_weight
        er = w < 1 and m.emb_reg.enable and m.emb_reg.weight > 0
        return tuple(k for k in names if not (k == "att_loss" and w >= 1) and not (k == "ctc_loss" and w <= 0)
                     and not (k == "emb_reg_loss" and not er))

    def sum_keys(self) -> Tuple[str, ...]:
        """The names of ``eval_device``'s ``sums``, in order: the numerator
        and denominator of each head this model has (``EVAL_SUMS``)."""
        have = {k.rsplit("_", 1)[0] for k in self.scalar_keys(EVAL_SCALARS) if k != "loss"}
        return tuple(k for k in EVAL_SUMS if k.rsplit("_", 1)[0] in have)

    def eval_losses(self, sums: torch.Tensor) -> torch.Tensor:
        """[n, len(sum_keys())] rows of ``sums`` (each dev batch's, summed
        over the ranks) -> [n, len(scalar_keys(EVAL_SCALARS))] losses, on
        the sums' device with ``compute_loss``'s arithmetic: in a world of
        one each row is ``eval_device``'s ``scalars`` bit for bit."""
        col = dict(zip(self.sum_keys(), sums.unbind(1)))
        heads = {h: col[f"{h}_num"] / torch.clamp(col[f"{h}_den"], min=1) for h in ("att", "ctc", "emb_reg")
                 if f"{h}_num" in col}
        m = self.cfg.model
        total = joint_loss(heads.get("att"), heads.get("ctc"), m.ctc_weight, sums.device, heads.get("emb_reg"),
                           m.emb_reg.weight)
        by_key = {"loss": total.expand(sums.shape[0]), **{f"{h}_loss": v for h, v in heads.items()}}
        return torch.stack([by_key[k] for k in self.scalar_keys(EVAL_SCALARS)], 1)

    def set_tf(self, step: int, device: torch.device) -> torch.Tensor:
        """``tf_buf`` (allocated once, outside any graph) holding the
        teacher-forcing rate of ``step``, written by one ``fill_``."""
        if self.tf_buf is None or self.tf_buf.device != torch.device(device):
            self.tf_buf = torch.zeros((), dtype=torch.float32, device=device)
        return self.tf_buf.fill_(tf_rate(self.cfg.hparas, step))

    def device_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator], sample_decoding: bool = True):
        """The step's device work from ``tf_buf`` and a batch in either form
        (``resolve_wav``): what a CUDA graph captures. Returns the metrics
        with ``tf_rate`` and ``scalars`` (the ``scalar_keys`` stacked, float32).
        Captured by ``TrainGraphs``, it holds the stage marks."""
        tracing.mark("train.features", gap="train.between_steps")
        wav, wav_len = resolve_wav(batch)
        tf = self.tf_buf
        metrics = device_update(state, self.opt, lambda params: compute_loss(
            params, self.cfg, wav, wav_len, batch["text"], batch["text_len"], tf,
            generator, train=True, sample_decoding=sample_decoding, reduce=self.reduce), self.reduce)
        metrics["tf_rate"] = tf.clone()
        metrics["scalars"] = torch.stack([metrics[k] for k in self.scalar_keys()])
        tracing.mark(None)
        return metrics

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], sample_decoding: bool = True, graphs=None):
        """One update in place from a batch in either form (``resolve_wav``).
        Returns metrics (device tensors), with the pre-clip ``grad_norm``,
        ``tf_rate``, ``step_skipped`` and ``scalars``. With ``graphs`` (a
        ``training/step_graph.TrainGraphs``) the step replays the CUDA
        graph of the batch's shape (capturing it at its first batch) with
        ``generator``'s seed, and the metrics are the graph's static
        outputs: read them before the next step. Without, it runs eagerly
        (the tests' and comparisons' route, and the solver's on the CPU or
        under a gloo group). The ``train.step`` span."""
        with tracing.span("train.step"):
            dev = batch["wav_len"].device
            self.set_tf(state.step, dev)
            if graphs is not None:
                metrics = graphs.step(self, state, batch, generator.initial_seed(), sample_decoding)
            else:
                metrics = self.device_step(state, batch, generator, sample_decoding)
        state.step += 1
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

    @torch.no_grad()
    def eval_device(self, params, batch: Dict[str, torch.Tensor], max_step: int,
                    keep_align: bool = False) -> Dict[str, torch.Tensor]:
        """The validation of one dev batch in either form (``resolve_wav``),
        on the device and with no host read: what a CUDA graph captures
        (``training/eval_graph.py``). Returns ``scalars`` (the teacher-forced
        losses of ``eval_step`` at the compute type, ``scalar_keys
        (EVAL_SCALARS)`` stacked, float32) and ``sums`` (their numerators and
        denominators, ``sum_keys()`` stacked, float32: what the ranks of a
        sharded validation add up before ``eval_losses`` divides); with a CTC
        head ``ctc_preds`` [B, S] (the frame-wise argmax) and ``enc_len``;
        with an attention head
        ``tokens`` [B, max_step], the greedy decode (``decode/greedy.py``) of
        float32 features. As in the JAX package's validation, which jits the
        eval step, the features and the greedy decode apart
        (``e2e_asr_tpu/bin/train_asr.py``), the encoder runs twice: at the
        compute type for the losses, in float32 for the decode. ``max_step``
        (a Python int: the dev batch's token bucket times the solver's step
        ratio) sets the decode's length. With ``keep_align`` (and an
        attention head) also ``align`` [B, max_step, heads, S], the greedy
        decode's attention weights (the dev epoch's first batch: its
        ``att_align`` image)."""
        wav, wav_len = resolve_wav(batch)
        _, m = compute_loss(params, self.cfg, wav, wav_len, batch["text"], batch["text_len"],
                            tf=1.0, generator=None, train=False)
        out = {"scalars": torch.stack([m[k] for k in self.scalar_keys(EVAL_SCALARS)]),
               "sums": torch.stack([m[k] for k in self.sum_keys()])}
        if "ctc_preds" in m:
            out["ctc_preds"], out["enc_len"] = m["ctc_preds"], m["enc_len"]
        if "att_preds" in m:
            feat, feat_len = compute_features(wav, wav_len, self.cfg.data.audio)
            out["tokens"], align = greedy_decode(params, self.cfg.model, feat, feat_len, max_step,
                                                 keep_align=keep_align)
            if keep_align:
                out["align"] = align
        return out

    def validate_batch(self, params, batch: Dict[str, torch.Tensor], max_step: int,
                       graphs=None, keep_align: bool = False) -> Dict[str, torch.Tensor]:
        """``eval_device`` of one dev batch: eagerly, or with ``graphs`` (a
        ``training/eval_graph.EvalGraphs``) by a replay of the CUDA graph of
        the batch's shape, ``max_step`` and ``keep_align`` (captured at its
        first batch), whose outputs are the graph's static tensors: read or
        copy them before the next replay."""
        if graphs is not None:
            return graphs.eval(self, params, batch, max_step, keep_align)
        return self.eval_device(params, batch, max_step, keep_align)
