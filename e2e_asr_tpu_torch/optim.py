"""Optimizers, learning-rate schedules and the teacher-forcing schedule.

Counterpart of ``e2e_asr_tpu/optim.py``, which chains optax's
``clip_by_global_norm``, the core rule and ``scale_by_schedule(-lr)``.
The port writes those formulas out on flat lists of tensors, so that one
update matches optax's to float rounding:

- clipping: where norm < max, g; else (g / norm) * max (optax's formula;
  ``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead);
- Adadelta (rho 0.9): e_g = (1-rho) g^2 + rho e_g;
  u = sqrt(e_x + eps) / sqrt(e_g + eps) * g; e_x = (1-rho) u^2 + rho e_x
  (``torch.optim.Adadelta`` computes the same, but its eps defaults to
  1e-6 and its state cannot be held back when a step is skipped);
- Adam: optax ``scale_by_adam`` (b1 0.9, b2 0.999, bias correction by
  1 - b^count, u = m_hat / (sqrt(v_hat) + eps));
- SGD: u = g;
- then p <- p - lr(count) * u, with the schedule's own count.

``OptState`` holds the rule's moments and both counts; ``update`` changes
parameters and state in place, so the caller checks finiteness first
(training/step.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from e2e_asr_tpu_torch.config import HparasConfig

OptState = Dict[str, object]


def build_schedule(h: HparasConfig) -> Callable[[int], float]:
    if h.lr_scheduler == "fixed":
        return lambda step: h.lr
    if h.lr_scheduler == "warmup":
        w = float(h.warmup_step)

        def sched(step: int) -> float:
            s = float(max(step, 1))
            return h.lr * (w**0.5) * min(s**-0.5, s * w**-1.5)

        return sched
    raise ValueError(f"unknown lr_scheduler {h.lr_scheduler}")


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count`` as XLA evaluates it: an f32 power rounded
    once (the subtraction cancels most digits, so a power rounded at each
    product, as ``torch.pow`` on an f32 tensor gives it, moves Adam's early
    updates by ~1e-5)."""
    return float(np.float32(1.0) - np.float32(np.float32(decay) ** count))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """Clip by global norm, then Adadelta / Adam / SGD, then -lr(count)."""

    def __init__(self, h: HparasConfig):
        self.name = h.optimizer.lower()
        if self.name not in ("adadelta", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {h.optimizer}")
        self.eps = h.eps
        self.max_norm = h.grad_clip
        self.schedule = build_schedule(h)

    def init(self, params: List[torch.Tensor]) -> OptState:
        z = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state: OptState = {"count": 0, "sched_count": 0}
        if self.name == "adadelta":
            state["e_g"], state["e_x"] = z(), z()
        elif self.name == "adam":
            state["mu"], state["nu"] = z(), z()
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: OptState,
               g_norm: torch.Tensor) -> None:
        """One step in place; ``g_norm`` is the global norm of ``grads``."""
        clip = bool(g_norm >= self.max_norm)
        if clip:
            grads = [(g / g_norm) * self.max_norm for g in grads]
        if self.name == "adadelta":
            rho, eps = 0.9, self.eps
            upd = []
            for g, e_g, e_x in zip(grads, state["e_g"], state["e_x"]):
                e_g.copy_((1 - rho) * g**2 + rho * e_g)
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
                e_x.copy_((1 - rho) * u**2 + rho * e_x)
                upd.append(u)
        elif self.name == "adam":
            b1, b2, eps = 0.9, 0.999, self.eps
            count = state["count"] + 1
            c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
            upd = []
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * g**2 + b2 * nu)
                upd.append((mu / c1) / (torch.sqrt(nu / c2) + eps))
        else:
            upd = grads
        state["count"] = state["count"] + 1
        lr = self.schedule(state["sched_count"])
        state["sched_count"] = state["sched_count"] + 1
        for p, u in zip(params, upd):
            p.add_(-lr * u)


def tf_rate(h: HparasConfig, step: int) -> float:
    """Teacher-forcing rate: linear tf_start -> tf_end over tf_step steps."""
    frac = min(max(step / max(h.tf_step, 1), 0.0), 1.0)
    return h.tf_start + (h.tf_end - h.tf_start) * frac
