"""The reference's training steps: the joint CTC/attention loss, its
gradients, the global-norm clip and Adadelta, from the weights the harness
drew and the raw batches of its traffic.

Each step's random draws are made again from the step's seed on a generator
of the step's device, in the order the recipe's step makes them: the four
SpecAugment uniforms, the teacher-forcing coins (one a target position), and
on the card the seed of the speller's sampled feedback (a Philox stream keyed
by step, row and column; ``model.philox_gumbel``); on the CPU, where the
speller is a loop, one exponential draw [B, V] a position after the coins.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from asr_bench.reference import model as M


class RefBatch(NamedTuple):
    wav: torch.Tensor  # [B, N] int16
    wav_len: torch.Tensor  # [B]
    text: torch.Tensor  # [B, L] ids with <eos>, 0-padded
    text_len: torch.Tensor  # [B]
    seed: int  # the step's random stream
    tf: float  # the step's teacher-forcing rate


def tf_rate(h: dict, step: int) -> float:
    frac = min(max(step / max(h["tf_step"], 1), 0.0), 1.0)
    return h["tf_start"] + (h["tf_end"] - h["tf_start"]) * frac


def joint_loss(w: M.W, cfg: dict, bt: RefBatch, pr: M.Precision) -> torch.Tensor:
    model = cfg["model"]
    dev = bt.wav.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(bt.seed)
    feat, feat_len = M.features(bt.wav, bt.wav_len, cfg["data"]["audio"])
    if model["specaugment"]["enable"]:
        feat = M.specaugment(feat, feat_len, model["specaugment"], gen)
    enc, enc_len = M.encode(w, model, feat, feat_len, pr)
    b, big_l = bt.text.shape
    text = bt.text.long()
    coins = torch.rand((big_l,), generator=gen, device=dev) < torch.tensor(bt.tf, dtype=torch.float32, device=dev)
    use = coins.tolist()
    vocab = w["ctc.w"].shape[1]
    if dev.type == "cuda":
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev))
        rows = torch.arange(b, device=dev)
        noise = lambda t, shape: M.philox_gumbel(seed, t, rows, vocab)  # noqa: E731
    else:
        q = [torch.empty((b, vocab)).exponential_(1.0, generator=gen) for _ in range(big_l - 1)]
        noise = lambda t, shape: -torch.log(q[t])  # noqa: E731
    teacher_in = torch.cat([text.new_zeros((b, 1)), text[:, :-1]], 1)
    logits = M.speller(w, model, enc, enc_len, teacher_in, pr, use, noise)
    valid = bt.text_len > 0
    tok = M.token_mask(bt.text_len, big_l) & valid[:, None]
    nll = -torch.log_softmax(logits, -1).gather(2, text[..., None])[..., 0]
    att = (nll * tok).sum() / torch.clamp(tok.sum(), min=1)
    label_len = torch.clamp(bt.text_len.long() - 1, min=0)
    labels = torch.where(M.token_mask(label_len, big_l), text, 0)
    lp = M.ctc_log_probs(w, enc, pr)
    ctc_nll = F.ctc_loss(lp.transpose(0, 1), labels, enc_len.long(), label_len, blank=0, reduction="none",
                         zero_infinity=False)
    keep = valid if cfg["hparas"]["ctc_infeasible"] != "mask" else valid & torch.isfinite(ctc_nll)
    ctc = torch.where(keep, ctc_nll / torch.clamp(label_len, min=1), 0.0).sum() / torch.clamp(valid.sum(), min=1)
    cw = model["ctc_weight"]
    return (1.0 - cw) * att + cw * ctc


def adadelta_steps(w0: M.W, cfg: dict, batches: List[RefBatch], pr: M.Precision) -> Dict[str, object]:
    """The steps of ``batches`` from ``w0``: each step's loss, each leaf's
    clipped gradient norm at the first step (what the optimizer gets) and
    each leaf's change over all the steps."""
    h = cfg["hparas"]
    if h["optimizer"].lower() != "adadelta" or h["lr_scheduler"] != "fixed":
        raise ValueError("the reference holds Adadelta at a fixed rate")
    names = sorted(w0)
    p = {k: w0[k].detach().clone().requires_grad_(True) for k in names}
    e_g = {k: torch.zeros_like(v) for k, v in w0.items()}
    e_x = {k: torch.zeros_like(v) for k, v in w0.items()}
    rho, eps, lr, clip = 0.9, h["eps"], h["lr"], h["grad_clip"]
    losses, first = [], {}
    with pr.active():
        for i, bt in enumerate(batches):
            loss = joint_loss(p, cfg, bt, pr)
            grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            grads = [torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, grads)]
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            losses.append(float(loss.detach()))
            if not (torch.isfinite(loss) and torch.isfinite(norm)):
                continue
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    g = g * scale
                    if i == 0:
                        first[k] = float(g.double().norm())
                    e_g[k] = (1 - rho) * g ** 2 + rho * e_g[k]
                    u = torch.sqrt(e_x[k] + eps) / torch.sqrt(e_g[k] + eps) * g
                    e_x[k] = (1 - rho) * u ** 2 + rho * e_x[k]
                    p[k] -= lr * u
    change = {k: float((p[k].detach() - w0[k]).double().norm()) for k in names}
    return {"loss": losses, "grad_norm": first, "change": change}
