"""Device selection for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the CPU;
asking for CUDA where it is absent raises instead of falling back.

The port runs in float32 and is held against the JAX package at float32
tolerances, so ``resolve_device`` turns TF32 off for both cuBLAS products
and cuDNN convolutions. cuDNN convolutions default to TF32 (about three
decimal digits), which would break parity in the VGG prenet. It also pins
cuDNN to deterministic algorithms (some of its convolutions' backward
algorithms add atomically): a train step then gives the same bits run to
run, so that a replayed CUDA graph of it can be held against an eager step
bitwise.

Under a process group (``main --multihost``, ``parallel/dist.py``) the card
is the local rank's.

``graph_capture`` is the one way the port captures a CUDA graph (the train
step, validation and the LM in ``training/step_graph.py``, the beam step in
``decode/beam_graph.py``).
"""

from __future__ import annotations

import gc
from contextlib import contextmanager

import torch

from e2e_asr_tpu_torch.parallel import dist


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (--cpu) to run on the CPU")
        if device.index is None and dist.initialized():
            device = torch.device("cuda", torch.cuda.current_device())  # the local rank's (dist.init)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device


@contextmanager
def graph_capture(graph: torch.cuda.CUDAGraph, pool=None, stream=None):
    """``torch.cuda.graph(graph, pool, stream, capture_error_mode=
    "thread_local")`` with Python's garbage collector run just before and
    held off until the capture ends. A collection inside a capture would run
    the destructors of dead cycles that hold CUDA objects (a solver's old
    graphs, its events, pinned buffers), and their CUDA calls (a graph's
    reset, an event's destruction) invalidate the capture; torch no longer
    collects at a capture's start."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()
