"""The beam step captured as CUDA graphs and replayed: the port's
counterpart of the JAX package's jit-compiled decode scan.

The JAX package compiles a bucket's whole beam search once a bucket shape
(``jax.jit`` over ``lax.scan``, ``e2e_asr_tpu/bin/test_asr.py``,
``e2e_asr_tpu/decode/beam.py``) and runs it on the device. Here the same
``decode/beam.py`` ``beam_step`` is captured twice through
``torch.cuda.graph``: step 0 (the CTC prefix kernel's ``prefix_is_empty``
argument is 1 there) and a later step, which is replayed ``max_step - 1``
times. A replay is one host call for the step's ~110 kernel launches (~155
with an LM fused in), the hand kernels among them: ``att_step_beam_loc``
is a cooperative launch (``cudaLaunchKernelEx``), captured as a kernel
node like any other.

A captured graph holds raw device pointers: to the weights, to the static
inputs (one batch's encoder memory, CTC log-probs and length windows,
``copy_``'d in before a batch's first replay) and to the state buffers
that ``beam_step`` updates in place. So a graph belongs to one bucket
shape and one set of weights: ``BeamGraphs`` keys it by the shapes, the
scalars the step bakes in and the weights' ``data_ptr``s, and lives on its
owner (``bin/test_asr.Solver``), never in a module global.

Capture: the first batch of a key runs step 0 eagerly on a side stream
(the warm-up: cuBLAS handles, the kernels' cached launch plans), then both
steps are captured on that stream with ``capture_error_mode
="thread_local"``, so that the prefetch thread's CUDA calls
(``data/prefetch.py``: pinned copies on a stream of its own, events) may go
on meanwhile. A failure to capture or replay raises; nothing falls back to
the eager loop.

The kernel wrappers count launches where Python calls them, so a capture
would count once and the replays not at all: the capture's deltas are taken
back and added again on every replay, and a replayed decode counts what an
eager one counts.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.decode import beam
from e2e_asr_tpu_torch.decode import ctc_prefix_cuda
from e2e_asr_tpu_torch.device import graph_capture
from e2e_asr_tpu_torch.ops import att_step_cuda

# the kernel wrappers a beam step calls, whose launch counts replays carry
COUNTED = (att_step_cuda.att_step_beam_loc, ctc_prefix_cuda.prefix_scores_fused)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def graph_key(spec: beam.BeamSpec, inp: beam.StepInputs) -> tuple:
    """What a captured step depends on: the shapes, the scalars it bakes in,
    the speller's, the embedding regularizer's and the LM's configuration
    (their cells, fused decoding), whether the kernels run
    (``cuda_build.use_plain``), and the addresses of the weights it reads."""
    d = spec.dcfg
    return (
        spec.b, spec.w, spec.s, spec.n_heads, spec.vocab, spec.k_cand, spec.max_step, spec.use_lm, spec.use_ctc,
        d.ctc_weight, d.lm_weight, spec.cfg.attention.temperature,
        repr(spec.cfg.decoder), repr(spec.cfg.emb_reg), repr(spec.lm_cfg),
        tuple((tuple(x.shape), x.dtype) for x in _leaves(inp)), cuda_build.use_plain(inp.min_len),
        tuple(x.data_ptr() for x in _leaves(spec.params) + _leaves(spec.lm_params)),
    )


def _counts() -> List[int]:
    return [fn.launches for fn in COUNTED]


class BeamGraph:
    """Both captured steps of one key, with their static inputs and state."""

    def __init__(self, spec: beam.BeamSpec, inp: beam.StepInputs):
        # static inputs: a contiguous copy of the first batch's
        self.inputs = beam.StepInputs(
            {k: beam._own(v) for k, v in inp.mem.items()},
            None if inp.ctc_lp is None else beam._own(inp.ctc_lp), beam._own(inp.min_len), beam._own(inp.max_len),
        )
        self.state = beam.init_state(spec, self.inputs)
        self.stream = torch.cuda.Stream()
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.deltas: Dict[bool, List[int]] = {}
        self.capture_s = 0.0

    def capture(self, spec: beam.BeamSpec) -> None:
        """Step 0 run eagerly on the side stream (the warm-up, a real step of
        this batch), then step 0 and a later step captured there."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            beam.beam_step(spec, self.inputs, self.state, first=True)
        main.wait_stream(self.stream)
        pool = None
        for first in (True, False):
            before = _counts()
            g = torch.cuda.CUDAGraph()
            with graph_capture(g, pool, self.stream):
                beam.beam_step(spec, self.inputs, self.state, first=first)
            after = _counts()
            for fn, n in zip(COUNTED, before):
                fn.launches = n  # a capture launches nothing
            self.deltas[first] = [a - b for a, b in zip(after, before)]
            self.graphs[first] = g
            pool = g.pool()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    def load(self, spec: beam.BeamSpec, inp: beam.StepInputs) -> None:
        """A new batch's inputs and initial state into the static buffers."""
        for dst, src in zip(_leaves(self.inputs), _leaves(inp)):
            dst.copy_(src)
        for dst, src in zip(self.state, beam.init_state(spec, self.inputs)):
            if dst is not None:
                dst.copy_(src)

    def replay(self, first: bool) -> None:
        self.graphs[first].replay()
        for fn, n in zip(COUNTED, self.deltas[first]):
            fn.launches += n


class BeamGraphs:
    """Captured beam steps by ``graph_key``; ``log`` (e.g. a solver's
    ``verbose``) hears of each capture and its time, the counterpart of the
    JAX package's compile."""

    def __init__(self, log: Optional[Callable[[str], None]] = None):
        self.graphs: Dict[tuple, BeamGraph] = {}
        self.captures: List[Tuple[tuple, float]] = []  # (key's shapes, seconds) of every capture
        self.log = log

    def run(self, spec: beam.BeamSpec, inp: beam.StepInputs) -> beam.BeamState:
        """All ``max_step`` steps of one batch; returns the final state (the
        graph's static buffers: read them before the next batch)."""
        if inp.min_len.device.type != "cuda":
            raise ValueError(f"CUDA graphs of the beam step need CUDA tensors, not {inp.min_len.device}")
        key = graph_key(spec, inp)
        g = self.graphs.get(key)
        if g is None:
            g = BeamGraph(spec, inp)
            g.capture(spec)  # runs step 0 of this batch
            self.graphs[key] = g
            shape = key[:9]
            self.captures.append((shape, g.capture_s))
            if self.log is not None:
                self.log(f"Captured the beam step (B, W, S, heads, vocab, K, max_step, LM, CTC = {shape}) in "
                         f"{g.capture_s:.2f}s")
        else:
            g.load(spec, inp)
            g.replay(first=True)
        for _ in range(1, spec.max_step):
            g.replay(first=False)
        return g.state
