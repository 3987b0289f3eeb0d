"""The validation of a dev batch captured as CUDA graphs and replayed: the
port's counterpart of the JAX package's jitted eval step, features and
greedy decode.

The JAX package compiles its validation once a dev bucket shape: the eval
step (``make_eval_step``), the features and the greedy decode as one
``lax.scan`` (``e2e_asr_tpu/bin/train_asr.py``, ``e2e_asr_tpu/decode/
greedy.py``). Here ``training/step.py`` ``Trainer.eval_device`` (the
teacher-forced losses at the compute type, the CTC head's argmax, and the
float32 features and greedy decode of ``max_step`` steps) is captured
through ``torch.cuda.graph`` once a key and replayed for every later dev
batch of that key: one host call for the batch's ~1,000 launches of the
losses and ``max_step`` x ~40 of the decode, the hand kernels among them
(``log_mel`` twice, the LSTM forward of the route twice, ``ctc_lattice``,
``decoder_scan_fwd``).

The whole decode loop is in the graph, not one step replayed ``max_step``
times (as ``decode/beam_graph.py`` replays the beam step): a dev batch is
then one replay, where a step graph would cost ``max_step`` host calls a
batch (288 in the flagship's longest bucket), and the loop's step index is
a Python int of the capture. The price is a graph of ~12,000 nodes for the
flagship's longest bucket, instantiated once.

A captured validation holds raw device pointers: to the parameters (which
the training updates in place, so they stay valid from one validation to
the next) and to its static input buffers (the dev batch is ``copy_``'d
into them on the consumer's stream). So a graph belongs to one dev bucket
shape, ``max_step``, compute type, route and set of parameters:
``graph_key`` keys it by those. The caches share the train graphs' memory
pool and capture stream (``GraphCache(share=...)``): a validation and a
train step never run at once, and the dev buckets' graphs then reuse the
train step's freed intermediates instead of holding memory of their own.

Capture, launch counts and failures are those of ``training/step_graph.py``:
an eager warm-up of the first batch on the side stream, then the capture
with ``capture_error_mode="thread_local"``; the kernel wrappers' counts of
the capture are taken back and added again on every replay; a failure to
capture or replay raises, and nothing falls back to the eager validation.
"""

from __future__ import annotations

from typing import Dict

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.training.step import Trainer, compute_dtype, param_leaves
from e2e_asr_tpu_torch.training.step_graph import GraphCache, batch_key


def graph_key(trainer: Trainer, params, batch: Dict[str, torch.Tensor], max_step: int,
              keep_align: bool = False) -> tuple:
    """What a captured validation depends on: the dev batch's shapes and
    input mode, ``max_step``, whether it keeps the alignment, the compute type, the LSTM and speller routes
    (the evaluation's), whether the kernels run (``cuda_build.use_plain``),
    the configuration it reads and the addresses of every parameter and of
    the device corpus."""
    cfg = trainer.cfg
    dev = batch["wav_len"].device
    corpus = batch.get("corpus")
    return (
        *batch_key(batch), max_step, keep_align, compute_dtype(cfg), cfg.model.encoder.rnn_impl,
        asr_mod.speller_route(params, cfg.model, False, dev), cuda_build.use_plain(batch["wav_len"]),
        repr(cfg.model), repr(cfg.data.audio), tuple(p.data_ptr() for p in param_leaves(params)),
        0 if corpus is None else corpus.data_ptr(),
    )


class EvalGraphs(GraphCache):
    """Captured validations of a dev batch by ``graph_key``."""

    what = "validation"

    def eval(self, trainer: Trainer, params, batch: Dict[str, torch.Tensor], max_step: int,
             keep_align: bool = False) -> Dict[str, torch.Tensor]:
        """``trainer.eval_device(params, batch, max_step, keep_align)``: the
        first batch of a key runs it eagerly and captures it, every later one
        replays. Returns its outputs: for a replay the graph's static
        tensors."""
        if batch["wav_len"].device.type != "cuda":
            raise ValueError(f"CUDA graphs of the validation need CUDA tensors, not {batch['wav_len'].device}")
        return self.run(graph_key(trainer, params, batch, max_step, keep_align), batch,
                        lambda b, _: trainer.eval_device(params, b, max_step, keep_align), random=False)
