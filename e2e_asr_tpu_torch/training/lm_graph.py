"""The RNN-LM's train step and evaluation captured as CUDA graphs and
replayed: the port's counterpart of the JAX package's jitted LM step and
LM eval (``e2e_asr_tpu/bin/train_lm.py``).

``bin/train_lm.py`` ``device_step`` (the LM forward through the
``lstm_seq`` kernel pair with one direction, the masked cross-entropy, the
gradients, clip and update with the NaN/inf skip by select;
``training/step.py`` ``device_update``) reads nothing back, and neither
does the evaluation (``lm_loss`` at ``train=False``). Each is captured
once a key, as ``training/step_graph.py`` captures the ASR step, and
replayed: one graph a ``TextLoader`` bucket shape (B, L), at most five.
Dropout draws from a CUDA generator registered with the train step's graph
and re-seeded before every replay with the seed of the step's own
generator (``Solver.step_generator``): a replay draws what an eager step
with that generator draws. The evaluation's graphs share the train
graphs' memory pool and capture stream.

A graph holds the addresses of the parameters and the optimizer state
(updated in place) and of its static ``text`` / ``text_len`` buffers:
``graph_key`` keys it by those, the batch's shapes, the LM configuration
and whether the kernels run. Capture, launch counts and failures are
``training/step_graph.py``'s: an eager warm-up on a side stream, the
capture with ``capture_error_mode="thread_local"``, the counts of the
capture added on every replay, and a failure raises. So are its
collectives under an NCCL group (the token count and the flat buffer of
gradients and loss, captured in the step's graph; the world size in
``graph_key``); a gloo group's step runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.training.step import TrainState, param_leaves
from e2e_asr_tpu_torch.training.step_graph import GraphCache, _opt_leaves, batch_key

STATIC = ("text", "text_len")  # the batch's tensors an LM step reads


def graph_key(cfg: LMConfig, params, opt_state, batch: Dict[str, torch.Tensor]) -> tuple:
    """What a captured LM step (``opt_state`` given) or evaluation (None)
    depends on: the batch's (B, L) shapes and types, whether the kernels run
    (``cuda_build.use_plain``), the LM configuration, the world size and the
    addresses of every parameter and optimizer tensor."""
    return (
        *batch_key(batch, STATIC), cuda_build.use_plain(batch["text"]), repr(cfg), dist.world(),
        tuple(p.data_ptr() for p in param_leaves(params)),
        None if opt_state is None else tuple(t.data_ptr() for t in _opt_leaves(opt_state)),
    )


def _on_card(batch: Dict[str, torch.Tensor], what: str) -> None:
    if batch["text"].device.type != "cuda":
        raise ValueError(f"CUDA graphs of the {what} need CUDA tensors, not {batch['text'].device}")


class LMGraphs(GraphCache):
    """Captured LM train steps by ``graph_key``."""

    what = "LM train step"

    def step(self, cfg: LMConfig, state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             fn: Callable) -> Dict[str, torch.Tensor]:
        """``fn(batch, generator)`` (the step's device work) with the random
        stream of ``seed``: the first batch of a key runs it eagerly and
        captures it, every later one replays."""
        _on_card(batch, self.what)
        if not dist.capturable():
            raise RuntimeError(f"a {dist.backend()} group's collectives cannot be captured: run the step eagerly")
        return self.run(graph_key(cfg, state.params, state.opt_state, batch), batch, fn, STATIC, seed)


class LMEvalGraphs(GraphCache):
    """Captured LM evaluations of a dev batch by ``graph_key``."""

    what = "LM evaluation"

    def eval(self, cfg: LMConfig, params, batch: Dict[str, torch.Tensor], fn: Callable) -> Dict[str, torch.Tensor]:
        """``fn(batch, None)`` (the evaluation's device work), captured at the
        first batch of a key and replayed for every later one."""
        _on_card(batch, self.what)
        return self.run(graph_key(cfg, params, None, batch), batch, fn, STATIC, random=False)
