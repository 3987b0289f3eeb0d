"""The ASR train step captured as CUDA graphs and replayed: the port's
counterpart of the JAX package's jitted train step.

The JAX package compiles the whole train step once a bucket shape
(``jax.jit(make_train_step(...))``, ``e2e_asr_tpu/bin/train_asr.py``): the
features, the forward and backward, the update and the NaN/inf skip run as
one program on the device. Here ``training/step.py`` ``Trainer.device_step``
(the same function the eager step runs) is captured through
``torch.cuda.graph`` once a key and replayed at every later step of that
key: one host call for the step's ~2,050 kernel launches, the hand kernels
among them (``log_mel``, the LSTM pair of the route, ``ctc_lattice``, the
scan pair: cooperative and cluster launches, captured as kernel nodes).

A captured step holds raw device pointers: to the parameters and the
optimizer state (updated in place), to the static input buffers (``wav``
or ``wav_off``, ``wav_len``, ``text``, ``text_len``; the prefetched batch
is ``copy_``'d into them on the consumer's stream, after the prefetcher's
event), to the device-resident corpus and to the trainer's
teacher-forcing rate (``Trainer.tf_buf``, written with ``fill_`` before
each step). So a graph belongs to one bucket shape, input mode, compute
type, route and set of tensors: ``graph_key`` keys it by those and by the
tensors' ``data_ptr``s, and the cache lives on its owner
(``bin/train_asr.Solver``), never in a module global. The flagship's five
buckets capture at most five graphs, as JAX compiles at most five
programs.

Random draws (dither, SpecAugment, dropout, the coins, the scan's seed)
come from one CUDA generator per graph, registered with it
(``CUDAGraph.register_generator_state``) and re-seeded before every replay
with the seed of the step's own generator (``Solver.step_generator``):
a replay draws the numbers an eager step with that generator draws.

Capture: the first batch of a key runs the step eagerly on a side stream
(the warm-up, and that batch's real step: cuBLAS and cuDNN handles, the
kernels' cached plans and device constants are made there, outside any
graph), then the step is captured on that stream with
``capture_error_mode="thread_local"``, so that the prefetch thread's CUDA
calls (``data/prefetch.py``) may go on meanwhile. The graphs share one
memory pool: their outputs (the metrics) are read, or copied into the
solver's ring, before the next replay. A failure to capture or replay
raises; nothing falls back to the eager step.

The kernel wrappers count launches where Python calls them, so a capture
would count once and the replays not at all: the capture's deltas are taken
back and added again on every replay, and a replayed step counts what an
eager one counts.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.ops import ctc_cuda, decoder_cuda, frontend_cuda, rnn_cuda
from e2e_asr_tpu_torch.training.step import TrainState, Trainer, compute_dtype, param_leaves

# the kernel wrappers a train step calls, whose launch counts replays carry
COUNTED = (frontend_cuda.log_mel, ctc_cuda.ctc_lattice, decoder_cuda.decoder_scan_fwd, decoder_cuda.decoder_scan_bwd,
           rnn_cuda.lstm_seq_fwd, rnn_cuda.lstm_seq_bwd, rnn_cuda.lstm_bidir_fwd_train, rnn_cuda.lstm_bidir_bwd)
COUNTERS = ("launches", "launches_bf16")  # a wrapper's float32 and bf16 counters (cuda_build.count_launch)
STATIC = ("wav", "wav_off", "wav_len", "text", "text_len")  # the batch's tensors a step reads


def _counts() -> List[int]:
    return [getattr(fn, a, 0) for fn in COUNTED for a in COUNTERS]


def _add_counts(deltas: List[int]) -> None:
    for i, n in enumerate(deltas):
        if n:
            fn, a = COUNTED[i // len(COUNTERS)], COUNTERS[i % len(COUNTERS)]
            setattr(fn, a, getattr(fn, a) + n)


def _opt_leaves(opt_state) -> List[torch.Tensor]:
    return [t for k in sorted(opt_state) for t in param_leaves(opt_state[k]) if isinstance(t, torch.Tensor)]


def graph_key(trainer: Trainer, state: TrainState, batch: Dict[str, torch.Tensor],
              sample_decoding: bool = True) -> tuple:
    """What a captured step depends on: the batch's shapes and input mode
    (streaming ``wav`` or offsets ``wav_off`` into the device corpus with its
    ``n_samples``), the compute type, the LSTM and speller routes, whether
    the kernels run (``cuda_build.use_plain``), the configuration the step
    reads, and the addresses of every parameter, optimizer tensor, the
    corpus and the teacher-forcing buffer."""
    cfg = trainer.cfg
    corpus = batch.get("corpus")
    return (
        "stream" if batch.get("wav") is not None else "device_corpus",
        tuple((k, tuple(batch[k].shape), batch[k].dtype) for k in STATIC if batch.get(k) is not None),
        int(batch.get("n_samples") or 0), compute_dtype(cfg), cfg.model.encoder.rnn_impl,
        asr_mod.speller_route(state.params, cfg.model, True, batch["wav_len"].device), sample_decoding,
        cuda_build.use_plain(batch["wav_len"]), repr(cfg.model), repr(cfg.data.audio), cfg.hparas.ctc_infeasible,
        tuple(p.data_ptr() for p in param_leaves(state.params)),
        tuple(t.data_ptr() for t in _opt_leaves(state.opt_state)),
        0 if corpus is None else corpus.data_ptr(), trainer.tf_buf.data_ptr(),
    )


class TrainGraph:
    """The captured step of one key, with its static inputs, generator and
    outputs."""

    def __init__(self, batch: Dict[str, torch.Tensor]):
        # static inputs: a contiguous copy of the first batch's
        self.inputs = {k: batch[k].contiguous().clone() for k in STATIC if batch.get(k) is not None}
        self.batch = dict(self.inputs)
        if batch.get("wav") is None:
            self.batch["corpus"], self.batch["n_samples"] = batch["corpus"], batch["n_samples"]
        self.gen = torch.Generator(device=batch["wav_len"].device)
        self.stream = torch.cuda.Stream()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Dict[str, torch.Tensor] = {}
        self.deltas: List[int] = []
        self.capture_s = 0.0

    def capture(self, trainer: Trainer, state: TrainState, seed: int, sample_decoding: bool,
                pool=None) -> Dict[str, torch.Tensor]:
        """The step run eagerly on the side stream (the warm-up: this batch's
        real step), then captured there. Returns the warm-up's metrics."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.gen.manual_seed(seed)
            warm = trainer.device_step(state, self.batch, self.gen, sample_decoding)
        main.wait_stream(self.stream)
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(self.gen)
        before = _counts()
        with torch.cuda.graph(g, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
            self.out = trainer.device_step(state, self.batch, self.gen, sample_decoding)
        after = _counts()
        self.deltas = [a - b for a, b in zip(after, before)]
        _add_counts([-d for d in self.deltas])  # a capture launches nothing
        self.graph = g
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        return warm

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        """A new batch's tensors into the static buffers (current stream)."""
        for k, dst in self.inputs.items():
            dst.copy_(batch[k])

    def replay(self, seed: int) -> Dict[str, torch.Tensor]:
        self.gen.manual_seed(seed)
        self.graph.replay()
        _add_counts(self.deltas)
        return self.out


class TrainGraphs:
    """Captured train steps by ``graph_key``; ``log`` (e.g. a solver's
    ``verbose``) hears of each capture and its time, the counterpart of the
    JAX package's compile."""

    def __init__(self, log: Optional[Callable[[str], None]] = None):
        self.graphs: Dict[tuple, TrainGraph] = {}
        # ((input mode, {tensor: shape}, n_samples), seconds) of every capture
        self.captures: List[Tuple[tuple, float]] = []
        self.pool = None  # the graphs' shared memory pool
        self.log = log

    def step(self, trainer: Trainer, state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             sample_decoding: bool = True) -> Dict[str, torch.Tensor]:
        """The device work of one train step (``Trainer.device_step``) with
        the random stream of ``seed``: the first batch of a key runs it
        eagerly and captures it, every later one replays. Returns the
        metrics: for a replay the graph's static outputs, which the next
        replay of any graph overwrites."""
        if batch["wav_len"].device.type != "cuda":
            raise ValueError(f"CUDA graphs of the train step need CUDA tensors, not {batch['wav_len'].device}")
        key = graph_key(trainer, state, batch, sample_decoding)
        g = self.graphs.get(key)
        if g is not None:
            g.load(batch)
            return g.replay(seed)
        g = TrainGraph(batch)
        warm = g.capture(trainer, state, seed, sample_decoding, self.pool)
        self.pool = g.graph.pool()
        self.graphs[key] = g
        shape = (key[0], {k: list(s) for k, s, _ in key[1]}, key[2])
        self.captures.append((shape, g.capture_s))
        if self.log is not None:
            self.log(f"Captured the train step ({shape[0]}, {', '.join(f'{k} {s}' for k, s in shape[1].items())}"
                     f"{f', n_samples {shape[2]}' if shape[2] else ''}) in {g.capture_s:.2f}s")
        return warm
