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
package's tensorboard tags; no tensorboard writer is needed).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

from e2e_asr_tpu_torch import convert, optim


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
        os.makedirs(self.ckpdir, exist_ok=True)
        os.makedirs(self.logdir, exist_ok=True)
        self._log_path = os.path.join(self.logdir, "scalars.jsonl")

    def verbose(self, msg) -> None:
        if self.paras.verbose:
            for m in msg if isinstance(msg, list) else [msg]:
                print("[INFO]", m, flush=True)

    def progress(self, msg: str) -> None:
        if self.paras.verbose:
            sys.stdout.write("\033[K")
            print(f"[{self.step}] {msg}", flush=True)

    def write_log(self, tag: str, value) -> None:
        """A number, a dict of numbers or a string, at the current step."""
        with open(self._log_path, "a") as f:
            f.write(json.dumps({"step": self.step, "tag": tag, "value": value}) + "\n")

    def save_checkpoint(self, fname: str, metric: str, score: float, state) -> None:
        path = os.path.join(self.ckpdir, fname)
        tmp = path + ".tmp"
        convert.save_checkpoint(tmp, state.params, self.vocab_size, self.feat_dim, kind=self.ckpt_kind,
                                opt_state=optim.checkpoint_state(state.opt_state), step=state.step)
        os.replace(tmp, path)
        with open(path + ".meta", "w") as f:
            f.write(f"{metric} {score}\nglobal_step {state.step}\ncompute_dtype {self.compute_dtype}\n")
        self.verbose(f"Saved checkpoint (step = {state.step}, {metric} = {score:.2f}) -> {fname}")

    def latest_ckpt_path(self) -> Optional[str]:
        """Auto-resume: the run's ``latest`` checkpoint, if there is one."""
        p = os.path.join(self.ckpdir, "latest")
        return p if os.path.isfile(p) else None
