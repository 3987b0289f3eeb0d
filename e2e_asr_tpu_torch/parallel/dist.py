"""Data parallelism over processes with ``torch.distributed``: the port's
counterpart of ``e2e_asr_tpu/parallel/mesh.py``.

The JAX package runs one program over a mesh whose ``data`` axis spans
every device of every process: each process feeds its contiguous row block
of one global batch (``make_global_batch``), the jitted step computes the
loss of the *global* batch, and XLA inserts the gradient all-reduce. Here
each process (a rank, one card) holds its row block of that global batch
(``data/dataset.py`` ``process_index`` / ``process_count``) and runs the
same step, and the step's global quantities are made by collectives of
this module:

- the loss's normalisers (the attention head's token count, the CTC head's
  utterance count) are all-summed before the divisions, so that each rank's
  loss is its own numerator over the global count (``training/step.py``
  ``compute_loss(reduce=all_sum_)``);
- the gradients and the loss metrics, written into one flat float32
  buffer, are all-summed in one collective before the norm, the NaN/inf
  skip, the clip and the update (``device_update``): every rank then takes
  the same decisions and the same update;
- random draws of a row's tensor (dither, SpecAugment, dropout, the fused
  scan's Gumbel noise) are made at the global batch's shape and each rank
  keeps its rows (``global_draw``, ``row_block``), as JAX draws each random
  array at its global shape: a run's numbers do not depend on the world
  size.

Without a process group (a run without ``--multihost``) every function here
is the identity of a world of one: ``rank()`` 0, ``world()`` 1, no
collective, no flat buffer, and the step is bitwise what it was.

``init`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` and creates the group: ``nccl`` on the
card (one card a rank, ``LOCAL_RANK``'s), ``gloo`` on the CPU. The group has
an explicit ``timeout``, so that a rank that raises cannot hold the others in
a collective for ever. On the card the NCCL collectives of a train step are
captured into its CUDA graph (``training/step_graph.py``); a gloo group on
the card (two ranks sharing one card, which NCCL refuses) runs the step
eagerly, and gloo stages CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

TIMEOUT_S = 600.0  # the group's collective timeout
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if initialized() else 0


def world() -> int:
    return tdist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """The rank's index among the processes of its host (torchrun's
    ``LOCAL_RANK``; 0 without a group)."""
    return int(os.environ.get("LOCAL_RANK", "0")) if initialized() else 0


def backend() -> Optional[str]:
    """The group's backend (``nccl`` or ``gloo``), None without a group."""
    return str(tdist.get_backend()) if initialized() else None


def capturable() -> bool:
    """Whether a step's collectives can be captured into a CUDA graph: true
    without a group (there are none) and on NCCL, false on gloo."""
    return backend() in (None, "nccl")


def init(device: torch.device, backend_name: Optional[str] = None, timeout_s: float = TIMEOUT_S) -> None:
    """Joins the process group described by torchrun's environment
    (``ENV``): ``nccl`` for ``device`` on the card, after
    ``torch.cuda.set_device(LOCAL_RANK)``, ``gloo`` on the CPU;
    ``backend_name`` overrides the choice (``gloo`` on the card: ranks that
    share one card). One all-reduce follows, so that the communicator
    exists before any step is captured."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost: {', '.join(missing)} not set; launch with "
                           "python -m torch.distributed.run --nproc-per-node N -m e2e_asr_tpu_torch.main ...")
    if initialized():
        raise RuntimeError("the process group exists already")
    device = torch.device(device)
    name = backend_name or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    tdist.init_process_group(name, init_method="env://", rank=int(os.environ["RANK"]),
                             world_size=int(os.environ["WORLD_SIZE"]),
                             timeout=datetime.timedelta(seconds=timeout_s))
    dev = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
    all_sum_(torch.zeros(1, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()


def shutdown() -> None:
    if initialized():
        tdist.destroy_process_group()


def barrier() -> None:
    if not initialized():
        return
    if backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def local_first(fn: Callable[[], Any]) -> None:
    """``fn()`` on local rank 0 of each host while the host's other ranks
    wait in a barrier (e.g. the kernel build into the checkout's shared
    ``_build/``); without a group, ``fn()``."""
    if local_rank() == 0:
        fn()
    barrier()


def all_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place, ordered on the current stream
    (a no-op without a group)."""
    if initialized():
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t


def warm_up(stream: torch.cuda.Stream) -> None:
    """One all-reduce on ``stream``, outside any graph: the communicator of
    the stream's card is made before a capture on it (NCCL cannot create one
    inside a capture)."""
    if backend() != "nccl":
        return
    with torch.cuda.stream(stream):
        all_sum_(torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device())))
    stream.synchronize()


def _host_device() -> torch.device:
    """Where host vectors meet: the rank's card under NCCL, the CPU under gloo."""
    return torch.device("cuda", torch.cuda.current_device()) if backend() == "nccl" else torch.device("cpu")


def allsum_scalars(values: Sequence[float]) -> np.ndarray:
    """The sum over the ranks of a small host vector, float64
    (``mesh.py`` ``allsum_scalars``); a copy without a group."""
    v = np.asarray(values, np.float64)
    if not initialized():
        return v.copy()
    t = torch.from_numpy(v.copy()).to(_host_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t.cpu().numpy()


def allmean_scalars(values: Sequence[float]) -> np.ndarray:
    """The mean over the ranks of a small host vector (``mesh.py``
    ``allmean_scalars``)."""
    return allsum_scalars(values) / world()


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every rank's ``obj`` (picklable) on rank 0, in rank order; None on the
    other ranks. Without a group, ``[obj]``. The objects travel through the
    group (no shared directory is assumed)."""
    if not initialized():
        return [obj]
    out = [None] * world() if is_main() else None
    tdist.gather_object(obj, out, dst=0)
    return out


def row_block(rows: int) -> tuple:
    """(first global row, global rows) of this rank's block of ``rows``
    rows: every rank holds as many rows of the global batch (the loader
    rounds each bucket's batch up to a multiple of the world size)."""
    return rank() * rows, world() * rows


def global_draw(sample: Callable, shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """``sample(shape, generator=generator, device=generator.device)`` (e.g.
    ``torch.rand``) for a tensor whose first axis is this rank's rows: drawn
    at the global batch's shape, this rank's rows kept, so that row r of the
    global batch gets the numbers a world of one draws for it. At a world of
    one this is the plain draw."""
    shape = tuple(shape)
    row0, rows = row_block(shape[0])
    if rows == shape[0]:
        return sample(shape, generator=generator, device=generator.device)
    full = sample((rows, *shape[1:]), generator=generator, device=generator.device)
    return full[row0:row0 + shape[0]]


def check_config(dp: int, mp: int) -> None:
    """``parallel.dp`` / ``parallel.mp`` against the run's world: the data
    axis is every rank (``dp`` -1 or the world size) and there is no model
    axis (``mp`` 1). Anything else raises: nothing is reshaped silently."""
    if mp != 1:
        raise ValueError(f"parallel.mp must be 1 (no model parallelism in the port), got {mp}")
    if dp not in (-1, world()):
        raise ValueError(f"parallel.dp {dp} != the world size {world()} (-1 takes the world size)")
