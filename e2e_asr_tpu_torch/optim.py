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

``OptState`` holds the rule's moments and both counts, the counts as 0-dim
int32 tensors on the parameters' device: the learning rate and Adam's bias
corrections are computed there from them (``device_lr``,
``bias_correction``), so that a step reads nothing back to the host and
bakes no per-step number into a captured graph. ``update`` changes
parameters and state in place; given ``ok`` (a 0-dim bool tensor) it
writes ``where(ok, new, old)`` into every parameter, moment and count,
the JAX step's select (``e2e_asr_tpu/training/step.py``). Checkpoints hold
the counts as Python ints (``checkpoint_state`` / ``restore``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

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


COUNTS = ("count", "sched_count")


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count`` with the power of the f32 decay taken in
    float64 and rounded once to f32, then subtracted in f32 (the subtraction
    cancels most digits, so a power rounded at each product, as
    ``torch.pow`` on an f32 tensor gives it, moves Adam's early updates by
    ~1e-5). ``bias_correction`` computes the same on the device."""
    return float(np.float32(1.0) - np.float32(np.float64(np.float32(decay)) ** count))


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``_bias_correction`` of the integer tensor ``count``, as float32 on
    its device: the float64 power rounded once, then the f32 subtraction
    (bitwise ``_bias_correction`` over counts 1..10^5, on the CPU and on the
    card; tests/test_torch_step_graph.py, tests/test_torch_cuda.py)."""
    base = torch.full((), float(np.float32(decay)), dtype=torch.float64, device=count.device)
    return 1.0 - torch.pow(base, count.double()).float()


def device_lr(h: HparasConfig, count: torch.Tensor) -> torch.Tensor:
    """``build_schedule(h)(count)`` of the integer tensor ``count``, as
    float32 on its device: the schedule in float64, rounded once (the f32
    value that the host schedule's Python float becomes in the update)."""
    if h.lr_scheduler == "fixed":
        return torch.full(count.shape, h.lr, dtype=torch.float32, device=count.device)
    if h.lr_scheduler == "warmup":
        w = float(h.warmup_step)
        s = torch.clamp(count, min=1).double()
        return ((h.lr * (w**0.5)) * torch.minimum(s**-0.5, s * w**-1.5)).float()
    raise ValueError(f"unknown lr_scheduler {h.lr_scheduler}")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], g_norm: torch.Tensor, max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: where norm < max, g; else
    (g / norm) * max, by a select on the device (no branch on the host)."""
    small = g_norm < max_norm
    return [torch.where(small, g, (g / g_norm) * max_norm) for g in grads]


def checkpoint_state(state: OptState) -> OptState:
    """``state`` with its counts as Python ints, as checkpoints hold them."""
    return {k: int(v) if k in COUNTS else v for k, v in state.items()}


def restore(state: OptState, device: torch.device) -> OptState:
    """A checkpoint's ``state`` (counts as ints, or as tensors) with its
    counts as 0-dim int32 tensors on ``device``."""
    return {k: torch.tensor(int(v), dtype=torch.int32, device=device) if k in COUNTS else v
            for k, v in state.items()}


class Optimizer:
    """Clip by global norm, then Adadelta / Adam / SGD, then -lr(count)."""

    def __init__(self, h: HparasConfig):
        self.name = h.optimizer.lower()
        if self.name not in ("adadelta", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {h.optimizer}")
        self.h = h
        self.eps = h.eps
        self.max_norm = h.grad_clip

    def init(self, params: List[torch.Tensor]) -> OptState:
        z = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state: OptState = {k: torch.zeros((), dtype=torch.int32, device=params[0].device) for k in COUNTS}
        if self.name == "adadelta":
            state["e_g"], state["e_x"] = z(), z()
        elif self.name == "adam":
            state["mu"], state["nu"] = z(), z()
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: OptState,
               g_norm: torch.Tensor, ok: Optional[torch.Tensor] = None) -> None:
        """One step in place; ``g_norm`` is the global norm of ``grads``.
        With ``ok`` (0-dim bool), every parameter, moment and count takes
        ``where(ok, new, old)``: a step where it is false changes nothing."""
        if ok is None:
            def put(new, old):
                old.copy_(new)
        else:
            def put(new, old):
                torch.where(ok, new, old, out=old)
        grads = clip_by_global_norm(grads, g_norm, self.max_norm)
        count = state["count"] + 1
        if self.name == "adadelta":
            rho, eps = 0.9, self.eps
            upd = []
            for g, e_g, e_x in zip(grads, state["e_g"], state["e_x"]):
                e_g_new = (1 - rho) * g**2 + rho * e_g
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g_new + eps) * g
                put(e_g_new, e_g)
                put((1 - rho) * u**2 + rho * e_x, e_x)
                upd.append(u)
        elif self.name == "adam":
            b1, b2, eps = 0.9, 0.999, self.eps
            c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
            upd = []
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu_new = (1 - b1) * g + b1 * mu
                nu_new = (1 - b2) * g**2 + b2 * nu
                upd.append((mu_new / c1) / (torch.sqrt(nu_new / c2) + eps))
                put(mu_new, mu)
                put(nu_new, nu)
        else:
            upd = grads
        lr = device_lr(self.h, state["sched_count"])
        for p, u in zip(params, upd):
            put(p - lr * u, p)
        put(count, state["count"])
        put(state["sched_count"] + 1, state["sched_count"])


def tf_rate(h: HparasConfig, step: int) -> float:
    """Teacher-forcing rate: linear tf_start -> tf_end over tf_step steps."""
    frac = min(max(step / max(h.tf_step, 1), 0.0), 1.0)
    return h.tf_start + (h.tf_end - h.tf_start) * frac
