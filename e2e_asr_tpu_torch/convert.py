"""Carry JAX parameters over to the port, and port checkpoints on disk.

``params_from_jax`` takes the ``e2e_asr_tpu/models/asr.py`` ``asr_init``
pytree, or the ``e2e_asr_tpu/models/lm.py`` ``lm_init`` one (the RNN-LM:
embedding, a list of ``LSTMWeights`` cells, ``out`` or the tied
``out_proj``), or any tree of that structure (an optimizer's moments), as
numpy arrays (``jax.device_get`` of it; LSTM weights may
be the JAX ``LSTMWeights`` named tuple or any ``(wx, wh, b)`` triple) and
returns the port's parameter tree. Layouts that change:

- conv2d ``w``: HWIO (NHWC activations) -> OIHW (NCHW);
- every 1-D convolution's ``w`` (3-D: the CNN prenet's ``conv1`` /
  ``conv2``, the attention's ``loc_conv``): [K, I, O] (TIO) -> [O, I, K]
  (OIW);
- LSTM ``(wx [D, 4H], wh [H, 4H], b [4H])`` -> {"wx", "wh", "b"}, gate
  order i,f,g,o unchanged;
- dense ``w [in, out]`` (2-D), embeddings, the embedding regularizer's
  table and vectors are kept as they are.

The port's checkpoint is ``torch.save({"params": tree, "kind",
"vocab_size", "feat_dim"})``; a training checkpoint adds ``opt_state`` and
``step``. ``kind`` says whose parameters they are: ``"asr"`` (the
recogniser; a checkpoint without the field is one) or ``"lm"`` (the RNN-LM
of ``bin/train_lm.py``, whose ``feat_dim`` is 0: it takes no audio).
``bin/test_asr.py`` reads both with ``load_checkpoint``, checks the kind
and the vocabulary size and uses only ``params``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


CHECKPOINT_KINDS = ("asr", "lm")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _convert(tree: Any, path: str) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, f"{path}.{k}" if path else k) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 3 and not isinstance(tree[0], (dict, list, tuple)):
        wx, wh, b = tree
        return {"wx": _tensor(wx), "wh": _tensor(wh), "b": _tensor(b)}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, f"{path}[{i}]") for i, v in enumerate(tree)]
    t = _tensor(tree)
    if path.endswith(".w") and t.dim() == 3:
        return t.permute(2, 1, 0).contiguous()
    if path.endswith(".w") and t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    return t


def params_from_jax(tree: Any) -> Any:
    """JAX ``asr_init`` pytree (numpy leaves) -> the port's parameter tree."""
    return _convert(tree, "")


def params_to(tree: Any, device: torch.device) -> Any:
    """A copy of a tree of tensors (detached) on ``device``; other leaves
    (counts) are kept."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


def save_checkpoint(path: str, params: Any, vocab_size: int, feat_dim: int, kind: str = "asr",
                    **extra) -> None:
    """``extra`` (a training run's ``opt_state`` and ``step``) is saved beside
    the parameters."""
    if kind not in CHECKPOINT_KINDS:
        raise ValueError(f"checkpoint kind must be one of {CHECKPOINT_KINDS}, got {kind!r}")
    cpu = torch.device("cpu")
    payload = {"params": params_to(params, cpu), "kind": kind, "vocab_size": vocab_size,
               "feat_dim": feat_dim}
    payload.update({k: params_to(v, cpu) for k, v in extra.items()})
    torch.save(payload, path)


def load_checkpoint(path: str, device: torch.device, kind: str = "asr") -> dict:
    """The payload with its tensors on ``device``; raises unless the
    checkpoint is of ``kind``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    found = payload.get("kind", "asr")
    if found != kind:
        raise ValueError(f"{path} is a checkpoint of kind {found!r}, not {kind!r}")
    for key in ("params", "opt_state"):
        if key in payload:
            payload[key] = params_to(payload[key], device)
    return payload
