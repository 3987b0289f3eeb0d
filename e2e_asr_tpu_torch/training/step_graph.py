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
memory pool and one capture stream (a pool's freed blocks go back to the
stream that allocated them): their outputs (the metrics) are read, or
copied into the solver's ring, before the next replay. A failure to
capture or replay raises; nothing falls back to the eager step.

The kernel wrappers count launches where Python calls them, so a capture
would count once and the replays not at all: the capture's deltas are taken
back and added again on every replay, and a replayed step counts what an
eager one counts. So are the host counters of the tracer that the wrappers
add to (``TRACED``: the speller scan's ``scan.bucket_steps``, its
backward's ``scan.bwd_frame_blocks`` and ``scan.bwd_sms``, the speller
loop's ``speller.loop_steps``); a device
counter (its ``scan.steps_run``) is added to by the replayed kernels
themselves.

Data parallelism (``parallel/dist.py``): under an NCCL group the step's two
collectives (the loss's denominators, the flat buffer of gradients and loss
metrics; ``training/step.py``) are captured inside the graph as nodes on
NCCL's stream, joined to the capture stream by events, and every replay
sums over the ranks. The communicator must exist before a capture: the
group's first all-reduce makes it (``dist.init``) and the cache issues one
more on its capture stream before every capture (``dist.warm_up``); a
capture does not hand its collectives to the group's watchdog, so the
watchdog does not time out a long capture. ``graph_key`` holds the world
size. A gloo group cannot be captured: ``TrainGraphs`` raises, and the
solver runs such a step eagerly. Every rank captures and replays the same
keys in the same order, because the shapes of a step agree on every rank.

Tracing (``utils/tracing.py``): a capture is a ``graph.capture`` span (the
warm-up included; ``Captured.capture_s`` is its duration) and a replay a
``graph.replay`` span, counted in ``graph.captures`` / ``graph.replays``.
Only the train step's captures hold its stage marks (``marks``).

``Captured`` (one program) and ``GraphCache`` (programs by key, their pool
and stream) carry all of this; the validation's and the LM's caches
(``training/eval_graph.py``, ``training/lm_graph.py``) are built on them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.device import graph_capture
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.ops import ctc_cuda, decoder_cuda, frontend_cuda, rnn_cuda
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.training.step import TrainState, Trainer, compute_dtype, param_leaves
from e2e_asr_tpu_torch.utils import tracing

# the kernel wrappers the captured programs (a train step, a validation, an
# LM step) call, whose launch counts replays carry
COUNTED = (frontend_cuda.log_mel, ctc_cuda.ctc_lattice, decoder_cuda.decoder_scan_fwd, decoder_cuda.decoder_scan_bwd,
           rnn_cuda.lstm_seq_fwd, rnn_cuda.lstm_seq_bwd, rnn_cuda.lstm_bidir_fwd, rnn_cuda.lstm_bidir_fwd_train,
           rnn_cuda.lstm_bidir_bwd)
COUNTERS = ("launches", "launches_bf16")  # a wrapper's float32 and bf16 counters (cuda_build.count_launch)
# the tracer's host counters that those wrappers and the speller's loop add to
TRACED = ("scan.bucket_steps", "scan.bwd_frame_blocks", "scan.bwd_sms", "speller.loop_steps")
STATIC = ("wav", "wav_off", "wav_len", "text", "text_len")  # the batch's tensors a step reads


def _counts() -> List[int]:
    return [getattr(fn, a, 0) for fn in COUNTED for a in COUNTERS] + [tracing.counted(n) for n in TRACED]


def _add_counts(deltas: List[int]) -> None:
    k = len(COUNTED) * len(COUNTERS)
    for i, n in enumerate(deltas[:k]):
        if n:
            fn, a = COUNTED[i // len(COUNTERS)], COUNTERS[i % len(COUNTERS)]
            setattr(fn, a, getattr(fn, a) + n)
    for name, n in zip(TRACED, deltas[k:]):
        if n:
            tracing.count(name, n)


def _opt_leaves(opt_state) -> List[torch.Tensor]:
    return [t for k in sorted(opt_state) for t in param_leaves(opt_state[k]) if isinstance(t, torch.Tensor)]


def batch_key(batch: Dict[str, torch.Tensor], keys=STATIC) -> tuple:
    """The input mode of a batch (streaming ``wav``, offsets ``wav_off``
    into the device corpus, or an LM's ``text``), its tensors' shapes and
    types, and its ``n_samples``."""
    mode = "stream" if batch.get("wav") is not None else "device_corpus" if "wav_off" in batch else "text"
    return (mode,
            tuple((k, tuple(batch[k].shape), batch[k].dtype) for k in keys if batch.get(k) is not None),
            int(batch.get("n_samples") or 0))


def graph_key(trainer: Trainer, state: TrainState, batch: Dict[str, torch.Tensor],
              sample_decoding: bool = True) -> tuple:
    """What a captured step depends on: the batch's shapes and input mode
    (streaming ``wav`` or offsets ``wav_off`` into the device corpus with its
    ``n_samples``), the compute type, the LSTM and speller routes, whether
    the kernels run (``cuda_build.use_plain``), the configuration the step
    reads, the world size (whether the step holds collectives), and the
    addresses of every parameter, optimizer tensor, the corpus and the
    teacher-forcing buffer."""
    cfg = trainer.cfg
    corpus = batch.get("corpus")
    return (
        *batch_key(batch), compute_dtype(cfg), cfg.model.encoder.rnn_impl, dist.world(), trainer.reduce is not None,
        asr_mod.speller_route(state.params, cfg.model, True, batch["wav_len"].device), sample_decoding,
        cuda_build.use_plain(batch["wav_len"]), repr(cfg.model), repr(cfg.data.audio), cfg.hparas.ctc_infeasible,
        tuple(p.data_ptr() for p in param_leaves(state.params)),
        tuple(t.data_ptr() for t in _opt_leaves(state.opt_state)),
        0 if corpus is None else corpus.data_ptr(), trainer.tf_buf.data_ptr(),
    )


class Captured:
    """One captured program: ``fn(batch, generator) -> outputs`` over static
    input buffers (a contiguous copy of the first batch's tensors of
    ``keys``; an offsets batch's corpus and ``n_samples`` as given), with a
    CUDA generator registered with it where ``random`` (re-seeded before
    every replay), captured on ``stream``; its outputs are static tensors
    that the next replay overwrites."""

    def __init__(self, batch: Dict[str, torch.Tensor], keys, stream: torch.cuda.Stream, random: bool = True):
        self.inputs = {k: batch[k].contiguous().clone() for k in keys if batch.get(k) is not None}
        self.batch = dict(self.inputs)
        if "corpus" in batch:
            self.batch["corpus"], self.batch["n_samples"] = batch["corpus"], batch["n_samples"]
        dev = next(iter(self.inputs.values())).device
        self.gen = torch.Generator(device=dev) if random else None
        self.stream = stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.deltas: List[int] = []
        self.capture_s = 0.0

    def capture(self, fn: Callable, seed: int = 0, pool=None, marks: bool = False):
        """``fn`` run eagerly on the side stream (the warm-up: this batch's
        real work, which makes the libraries' handles, the kernels' cached
        plans and device constants outside any graph), then captured there,
        with ``fn``'s device stage marks where ``marks``. Returns the
        warm-up's outputs."""
        with tracing.span("graph.capture") as sp:
            tracing.count("graph.captures")
            main = torch.cuda.current_stream()
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                if self.gen is not None:
                    self.gen.manual_seed(seed)
                warm = fn(self.batch, self.gen)
            main.wait_stream(self.stream)
            g = torch.cuda.CUDAGraph()
            if self.gen is not None:
                g.register_generator_state(self.gen)
            before = _counts()
            with tracing.marking(marks), graph_capture(g, pool, self.stream):
                self.out = fn(self.batch, self.gen)
            after = _counts()
            self.deltas = [a - b for a, b in zip(after, before)]
            _add_counts([-d for d in self.deltas])  # a capture launches nothing
            self.graph = g
            torch.cuda.synchronize()
        self.capture_s = sp.s
        return warm

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        """A new batch's tensors into the static buffers (current stream)."""
        for k, dst in self.inputs.items():
            dst.copy_(batch[k])

    def replay(self, seed: int = 0):
        with tracing.span("graph.replay"):
            tracing.count("graph.replays")
            if self.gen is not None:
                self.gen.manual_seed(seed)
            self.graph.replay()
            _add_counts(self.deltas)
        return self.out


class GraphCache:
    """Captured programs by key, sharing one memory pool and one capture
    stream (``share``: another cache whose pool and stream these graphs
    take too); ``log`` (e.g. a solver's ``verbose``) hears of each capture
    and its time, the counterpart of the JAX package's compile."""

    what = "program"

    def __init__(self, log: Optional[Callable[[str], None]] = None, share: Optional["GraphCache"] = None):
        self.graphs: Dict[tuple, Captured] = {}
        # ((input mode, {tensor: shape}, n_samples), seconds) of every capture
        self.captures: List[Tuple[tuple, float]] = []
        self.log = log
        self.share = share
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def pool(self):
        """The graphs' shared memory pool (None before the first capture)."""
        return self._pool if self.share is None else self.share.pool

    @pool.setter
    def pool(self, value):
        if self.share is None:
            self._pool = value
        else:
            self.share.pool = value

    @property
    def stream(self) -> torch.cuda.Stream:
        """The side stream every capture runs on: a pool's freed blocks go
        back to the stream they were allocated on, so graphs share memory
        only where they are captured on one stream."""
        if self.share is not None:
            return self.share.stream
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def run(self, key: tuple, batch: Dict[str, torch.Tensor], fn: Callable, keys=STATIC, seed: int = 0,
            random: bool = True, marks: bool = False):
        """``fn(batch, generator)`` for ``batch`` by the graph of ``key``: the
        first batch of a key runs it eagerly and captures it (with ``fn``'s
        stage marks where ``marks``), every later one replays it with the
        random stream of ``seed``. Returns the outputs: for a replay the
        graph's static outputs, which the next replay of a graph sharing the
        pool may overwrite."""
        g = self.graphs.get(key)
        if g is not None:
            g.load(batch)
            return g.replay(seed)
        g = Captured(batch, keys, self.stream, random)
        dist.warm_up(self.stream)  # the communicator exists before the capture
        warm = g.capture(fn, seed, self.pool, marks)
        self.pool = g.graph.pool()
        self.graphs[key] = g
        mode, shapes, n = batch_key(batch, keys)
        self.captures.append(((mode, {k: list(s) for k, s, _ in shapes}, n), g.capture_s))
        if self.log is not None:
            self.log(f"Captured the {self.what} ({mode}, {', '.join(f'{k} {list(s)}' for k, s, _ in shapes)}"
                     f"{f', n_samples {n}' if n else ''}) in {g.capture_s:.2f}s")
        return warm


class TrainGraphs(GraphCache):
    """Captured train steps by ``graph_key``, holding the step's stage
    marks."""

    what = "train step"

    def step(self, trainer: Trainer, state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             sample_decoding: bool = True) -> Dict[str, torch.Tensor]:
        """The device work of one train step (``Trainer.device_step``) with
        the random stream of ``seed``: the first batch of a key runs it
        eagerly and captures it, every later one replays. Returns the
        metrics: for a replay the graph's static outputs, which the next
        replay of any graph overwrites."""
        if batch["wav_len"].device.type != "cuda":
            raise ValueError(f"CUDA graphs of the train step need CUDA tensors, not {batch['wav_len'].device}")
        if trainer.reduce is not None and not dist.capturable():
            raise RuntimeError(f"a {dist.backend()} group's collectives cannot be captured: run the step eagerly")
        return self.run(graph_key(trainer, state, batch, sample_decoding), batch,
                        lambda b, gen: trainer.device_step(state, b, gen, sample_decoding), seed=seed, marks=True)
