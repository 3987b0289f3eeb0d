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
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (--cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device
