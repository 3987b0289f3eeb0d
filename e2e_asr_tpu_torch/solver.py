"""Base solver: experiment directories, messages, scalar logs, checkpoints.

Counterpart of ``e2e_asr_tpu/solver.py``. Experiment ``<name>`` (default:
the config's file name + ``_sd<seed>``) writes its logs under
``<logdir>/<name>`` and its checkpoints under ``<ckpdir>/<name>``.
Checkpoints are ``torch.save`` files of ``{params, opt_state, step}`` (plus
the kind, ``ckpt_kind``, and the vocabulary size and feature dim that
``bin/test_asr.py`` checks; ``convert.save_checkpoint``) named
``best_att``, ``best_ctc`` and ``latest`` (the LM: ``best_ppl`` and
``latest``), each with a ``.meta`` text file
(``<metric> <score>`` and ``global_step <n>``). Scalars go to
``<logdir>/<name>/scalars.jsonl``, one JSON object per line (the JAX
package's tensorboard tags; no tensorboard writer is needed); an image
(validation's ``att_align``) goes to a PNG beside it, named by its line.

Under a process group (``parallel/dist.py``) rank 0 alone prints, logs and
writes checkpoints; every rank calls ``save_checkpoint``, which ends in a
barrier, so that no rank reads a ``latest`` (auto-resume) that rank 0 is
still writing. The ``parallel`` section is checked against the world
(``dist.check_config``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Optional

from e2e_asr_tpu_torch import convert, optim
from e2e_asr_tpu_torch.align_image import write_png
from e2e_asr_tpu_torch.parallel import dist


def kernels_ready(log: Callable[[str], None]) -> None:
    """Every kernel library built (``cuda_build.build_all``), the host's
    other ranks loading what its local rank 0 built (every solver's, on the
    card); ``log`` hears the time it took (its ``setup.kernels`` span) and
    how many libraries were compiled."""
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.utils import tracing

    built = tracing.counted("kernels.built")
    with tracing.span("setup.kernels") as sp:
        dist.local_first(cuda_build.build_all)
    log(f"CUDA kernels ready in {sp.s:.1f}s ({tracing.counted('kernels.built') - built} libraries compiled)")


class BaseSolver:
    ckpt_kind = "asr"  # convert.save_checkpoint's kind
    compute_dtype = "float32"  # written into every checkpoint's .meta

    def __init__(self, config, paras, mode: str):
        self.config = config
        self.paras = paras
        self.mode = mode
        self.exp_name = paras.name
        if self.exp_name is None:
            base = os.path.basename(paras.config).replace(".yaml", "") if paras.config else "exp"
            self.exp_name = f"{base}_sd{paras.seed}"
        self.logdir = os.path.join(paras.logdir, self.exp_name)
        self.ckpdir = os.path.join(paras.ckpdir, self.exp_name)
        self.step = 0
        dist.check_config(config.parallel.dp, config.parallel.mp)
        os.makedirs(self.ckpdir, exist_ok=True)
        os.makedirs(self.logdir, exist_ok=True)
        self._log_path = os.path.join(self.logdir, "scalars.jsonl")

    def verbose(self, msg) -> None:
        if self.paras.verbose and dist.is_main():
            for m in msg if isinstance(msg, list) else [msg]:
                print("[INFO]", m, flush=True)

    def progress(self, msg: str) -> None:
        if self.paras.verbose and dist.is_main():
            sys.stdout.write("\033[K")
            print(f"[{self.step}] {msg}", flush=True)

    def write_log(self, tag: str, value) -> None:
        """A number, a dict of numbers or a string, at the current step
        (rank 0's log alone)."""
        if not dist.is_main():
            return
        with open(self._log_path, "a") as f:
            f.write(json.dumps({"step": self.step, "tag": tag, "value": value}) + "\n")

    def write_image(self, tag: str, img) -> None:
        """An [H, W, 3] uint8 image as ``<tag>_<step>.png`` beside
        ``scalars.jsonl``, and a ``tag`` line there naming the file (rank
        0's log alone)."""
        if not dist.is_main():
            return
        name = f"{tag}_{self.step:08d}.png"
        write_png(os.path.join(self.logdir, name), img)
        self.write_log(tag, name)

    def save_checkpoint(self, fname: str, metric: str, score: float, state) -> None:
        """Rank 0 writes the checkpoint; every rank then meets in a barrier."""
        if dist.is_main():
            path = os.path.join(self.ckpdir, fname)
            tmp = path + ".tmp"
            convert.save_checkpoint(tmp, state.params, self.vocab_size, self.feat_dim, kind=self.ckpt_kind,
                                    opt_state=optim.checkpoint_state(state.opt_state), step=state.step)
            os.replace(tmp, path)
            with open(path + ".meta", "w") as f:
                f.write(f"{metric} {score}\nglobal_step {state.step}\ncompute_dtype {self.compute_dtype}\n")
            self.verbose(f"Saved checkpoint (step = {state.step}, {metric} = {score:.2f}) -> {fname}")
        dist.barrier()

    def latest_ckpt_path(self) -> Optional[str]:
        """Auto-resume: the run's ``latest`` checkpoint, if there is one."""
        p = os.path.join(self.ckpdir, "latest")
        return p if os.path.isfile(p) else None
