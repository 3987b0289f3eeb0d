"""Ranks of a data-parallel run, spawned as processes of their own, for the
checks of ``parallel/dist.py`` (the counterpart of
``e2e_asr_tpu/parallel/mp_worker.py``).

    python -m e2e_asr_tpu_torch.parallel.mp_worker MODE SPEC

``launch`` starts ``nproc`` such processes with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` 127.0.0.1 and a
free ``MASTER_PORT``), each process's output in a file of its own, and kills
them all at a time limit. Each process joins the group (``dist.init``:
gloo on the CPU, NCCL on the card unless the spec names ``backend``) and
runs ``MODE`` on the JSON file ``SPEC``:

- ``grads``: the loss (``compute_loss``, no training draws) and the
  gradients of its row block of the batch ``spec["batch"]`` (an npz of the
  global batch) under the parameters ``spec["params"]``, summed over the
  ranks: rank 0 writes the global batch's loss and flat gradients to
  ``spec["out"]`` (npz);
- ``step``: one eager train step (``Trainer.train_step``) on its row block,
  the step generator seeded with ``spec["seed"]``, from the same weights in
  each compute type of ``spec["dtypes"]`` (default: the config's): each rank
  writes its loss, grad norm and parameters to ``spec["out"]``.rank<r>.pt;
- ``train``: ``bin/train_asr.Solver`` on ``spec["config"]``: ``exec`` and
  one more ``validate``: each rank writes the summary, its step log, its
  parameters and what it found in its own log and checkpoint directories
  to ``spec["out"]``.rank<r>.pt;
- ``decode``: ``bin/test_asr.Solver`` on ``spec["config"]`` with
  ``spec["ckpt"]``: each rank writes ``{split: error rate}`` and the csvs
  it found in its own result directory;
- ``lm``: ``bin/train_lm.Solver`` ``exec``: each rank writes its dev
  perplexity, step log and parameters;
- ``world1`` (run with ``nproc`` 1): the modes of ``spec["modes"]`` first
  without a group, then in a group of one (``train`` and ``lm`` in every
  compute type of ``spec["dtypes"]``): what each gave both ways, the
  parameters compared bit for bit, to ``spec["out"]``.

A rank's configuration is ``spec["config"]`` (a YAML file), its
directories are its own (``<dir>/rank<r>``), so that a check can see that
rank 0 alone writes. The runs report the kernels' launches (counters set to
0 just before a run, read just after; a captured program's replays count).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import types
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(argv: Sequence[str], nproc: int, outdir: str, timeout: float, local_rank_zero: bool = False,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> List[str]:
    """Runs ``python argv`` as ``nproc`` ranks of one group and returns their
    outputs. ``local_rank_zero``: every rank's ``LOCAL_RANK`` is 0 (ranks
    that share one card). Raises with the tail of every rank's output when a
    rank fails or the time limit passes (the ranks are killed)."""
    os.makedirs(outdir, exist_ok=True)
    port = free_port()
    procs, files = [], []
    try:
        for r in range(nproc):
            f = open(os.path.join(outdir, f"rank{r}.out"), "w+b")
            files.append(f)
            e = {**os.environ, **(env or {}), "RANK": str(r), "WORLD_SIZE": str(nproc),
                 "LOCAL_RANK": "0" if local_rank_zero else str(r), "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen([sys.executable, *argv], env=e, stdout=f, stderr=subprocess.STDOUT,
                                          cwd=cwd))
        timed_out = False
        t_end = time.time() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(t_end - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read().decode(errors="replace"))
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or bad:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n" + "\n".join(o.splitlines()[-40:])
                          for r, (p, o) in enumerate(zip(procs, outs)))
        why = f"exceeded {timeout:.0f}s" if timed_out else f"ranks {bad} failed"
        raise RuntimeError(f"{' '.join(argv)}: {why}\n{tails}")
    return outs


def run(mode: str, spec: dict, nproc: int, outdir: str, timeout: float, **kw) -> List[str]:
    """``launch`` of this module in ``mode`` with ``spec`` (written to
    ``outdir``/spec_<mode>.json)."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"spec_{mode}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return launch(["-m", "e2e_asr_tpu_torch.parallel.mp_worker", mode, path], nproc, outdir, timeout, **kw)


def local_rows(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    """This rank's contiguous row block of a global batch."""
    b = len(next(iter(batch.values()))) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _wrappers() -> dict:
    """The kernel wrappers that count their launches, by the name of their
    row in ``chip_smoke.py``'s kernels line."""
    from e2e_asr_tpu_torch.decode.ctc_prefix_cuda import prefix_scores_fused
    from e2e_asr_tpu_torch.ops.att_step_cuda import att_step_beam_loc
    from e2e_asr_tpu_torch.training.step_graph import COUNTED

    names = {"ctc_lattice": "ctc_loss", "prefix_scores_fused": "prefix_recursion"}
    return {names.get(fn.__name__, fn.__name__): fn for fn in (*COUNTED, att_step_beam_loc, prefix_scores_fused)}


def zero_launches() -> None:
    for fn in _wrappers().values():
        for attr in ("launches", "launches_bf16"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def launches() -> Dict[str, int]:
    """{kernel (``_bf16`` for the bf16 variant): launches} of the kernels that launched."""
    out = {}
    for name, fn in _wrappers().items():
        for attr, tag in (("launches", ""), ("launches_bf16", "_bf16")):
            if getattr(fn, attr, 0):
                out[name + tag] = getattr(fn, attr)
    return out


def _config(spec: dict, **hparas):
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.load(spec["config"])
    for k, v in hparas.items():
        setattr(cfg.hparas, k, v)
    return cfg


def _device(spec: dict) -> torch.device:
    from e2e_asr_tpu_torch.device import resolve_device

    return resolve_device(spec.get("device", "cpu"))


def _batch(spec: dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    from e2e_asr_tpu_torch.parallel import dist

    with np.load(spec["batch"]) as z:
        rows = local_rows({k: z[k] for k in z.files}, dist.rank(), dist.world())
    return {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}


def _params(spec: dict, dev: torch.device):
    from e2e_asr_tpu_torch import convert

    return convert.load_checkpoint(spec["params"], dev)["params"]


def mode_grads(spec: dict) -> None:
    """The global batch's loss and gradients, summed over the ranks (and its
    embedding-regularizer loss, where the model has one)."""
    from e2e_asr_tpu_torch.parallel import dist
    from e2e_asr_tpu_torch.training.step import compute_loss, flat_all_sum, param_leaves

    dev = _device(spec)
    cfg = _config(spec)
    params = _params(spec, dev)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b = _batch(spec, dev)
    loss, m = compute_loss(params, cfg, b["wav"], b["wav_len"], b["text"], b["text_len"], 1.0, None,
                           train=False, reduce=dist.all_sum_)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    extra = [k for k in ("emb_reg_loss",) if k in m]
    grads, (loss, *sums) = flat_all_sum(grads, [loss.detach()] + [m[k].detach() for k in extra], dist.all_sum_)
    if dist.is_main():
        np.savez(spec["out"], loss=float(loss), grads=torch.cat([g.reshape(-1) for g in grads]).cpu().numpy(),
                 world=dist.world(), **{k: float(v) for k, v in zip(extra, sums)})


def step_result(trainer, state, batch, seed: int, generator_device) -> dict:
    """One eager train step: loss, grad norm and the parameters after it."""
    from e2e_asr_tpu_torch.training.step import param_leaves

    gen = torch.Generator(device=generator_device)
    gen.manual_seed(seed)
    m = trainer.train_step(state, batch, gen)
    return {"loss": m["loss"].cpu(), "grad_norm": m["grad_norm"].cpu(), "step_skipped": m["step_skipped"].cpu(),
            "params": [p.detach().cpu() for p in param_leaves(state.params)]}


def mode_step(spec: dict) -> None:
    from e2e_asr_tpu_torch.parallel import dist
    from e2e_asr_tpu_torch.training.step import Trainer

    dev = _device(spec)
    out = {}
    for dtype in spec.get("dtypes", [""]):
        trainer = Trainer(_config(spec, **({"dtype": dtype} if dtype else {})), reduce=dist.all_sum_)
        state = trainer.init_state(_params(spec, dev))
        zero_launches()
        out[dtype] = step_result(trainer, state, _batch(spec, dev), int(spec["seed"]), dev)
        out[dtype]["launches"] = launches()
    torch.save(out if "dtypes" in spec else out[""], f"{spec['out']}.rank{dist.rank()}.pt")


def _paras(spec: dict, tag: str):
    d = os.path.join(spec["dir"], tag)
    return types.SimpleNamespace(config=spec["config"], name=spec.get("name", "mp"), logdir=os.path.join(d, "log"),
                                 ckpdir=os.path.join(d, "ckpt"), outdir=os.path.join(d, "result"), load=None,
                                 seed=0, cpu=spec.get("device", "cpu") == "cpu", verbose=spec.get("verbose", False),
                                 auto_resume=False, njobs=0, multihost=False)


def _files(d: str) -> List[str]:
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def train_run(spec: dict, tag: str, dtype: str = "") -> dict:
    """``Solver.exec`` and one more ``validate`` on the spec's recipe, logs
    and checkpoints under ``<dir>/<tag>``: the summary, the step log, the
    files the run wrote, its captures and its parameters."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver
    from e2e_asr_tpu_torch.training.step import param_leaves

    cfg = _config(spec, **({"dtype": dtype} if dtype else {}))
    paras = _paras(spec, tag)
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    dev = solver.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    zero_launches()
    t0 = time.time()
    solver.exec()
    summary = solver.validate()
    wall = time.time() - t0
    counted = launches()
    graphs = [(g.what, [t for _, t in g.captures]) for g in (solver.train_graphs, solver.eval_graphs)
              if g is not None]
    return {"summary": summary, "step_log": list(solver.step_log), "input_mode": solver.input_mode,
            "files": _files(os.path.join(spec["dir"], tag)), "wall_s": wall, "captures_s": graphs,
            "peak_mb_above": (torch.cuda.max_memory_allocated() - before) / 2 ** 20 if dev.type == "cuda" else 0.0,
            "params": [p.detach().cpu() for p in param_leaves(solver.state.params)],
            "train_graphs": solver.train_graphs is not None, "launches": counted}


def decode_run(spec: dict, tag: str) -> dict:
    """``bin/test_asr.Solver.exec`` of the spec's decode config and
    checkpoint, results under ``<dir>/<tag>``: {split: error rate}, and the
    csvs rank 0 wrote."""
    from e2e_asr_tpu_torch.bin.test_asr import Solver
    from e2e_asr_tpu_torch.config import Config

    paras = _paras(spec, tag)
    paras.load = spec["ckpt"]
    solver = Solver(Config.load(spec["config"]), paras, "test")
    solver.load_data()
    solver.set_model()
    zero_launches()
    t0 = time.time()
    ers = solver.exec()
    wall, counted = time.time() - t0, launches()
    csvs = {}
    if os.path.isdir(solver.outdir):
        for name in sorted(os.listdir(solver.outdir)):
            with open(os.path.join(solver.outdir, name)) as f:
                csvs[name] = f.read()
    return {"er": ers, "csvs": csvs, "files": _files(os.path.join(spec["dir"], tag)), "launches": counted,
            "wall_s": wall, "stats": solver.stats}


def lm_run(spec: dict, tag: str) -> dict:
    from e2e_asr_tpu_torch.bin.train_lm import Solver
    from e2e_asr_tpu_torch.training.step import param_leaves

    solver = Solver(_config(spec), _paras(spec, tag), "train")
    solver.load_data()
    solver.set_model()
    zero_launches()
    solver.exec()
    return {"dev_ppl": solver.dev_ppl, "launches": launches(), "step_log": list(solver.step_log), "graphs": solver.graphs is not None,
            "files": _files(os.path.join(spec["dir"], tag)),
            "params": [p.detach().cpu() for p in param_leaves(solver.state.params)]}


RUNS = {"train": train_run, "decode": decode_run, "lm": lm_run}


def mode_run(mode: str, spec: dict) -> None:
    from e2e_asr_tpu_torch.parallel import dist

    res = RUNS[mode](spec, f"rank{dist.rank()}")
    torch.save(res, f"{spec['out']}.rank{dist.rank()}.pt")


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def world1_compare(spec: dict) -> dict:
    """Each run of ``spec["modes"]`` (at every ``spec["dtypes"]`` for
    ``train``) without a group and then in a group of one: {run: {"same":
    bitwise equal summary / step log losses / parameters / csvs, "without",
    "with"}}."""
    from e2e_asr_tpu_torch.parallel import dist

    plan = [(m, d) for m in spec["modes"] for d in (spec.get("dtypes", [""]) if m == "train" else [""])]
    without = {(m, d): RUNS[m](spec, f"nogroup_{m}{d}") if m != "train" else train_run(spec, f"nogroup_{m}{d}", d)
               for m, d in plan}
    dist.init(_device(spec), spec.get("backend"))
    try:
        out = {}
        for m, d in plan:
            got = RUNS[m](spec, f"group_{m}{d}") if m != "train" else train_run(spec, f"group_{m}{d}", d)
            want = without[(m, d)]
            keys = {"train": ("summary", "params"), "lm": ("dev_ppl", "params"), "decode": ("er", "csvs")}[m]
            same = {k: _same(got[k], want[k]) for k in keys}
            if m in ("train", "lm"):
                drop = ("wall_s",)
                same["step_log"] = _same([{k: v for k, v in r.items() if k not in drop and "_s" not in k}
                                          for r in got["step_log"]],
                                         [{k: v for k, v in r.items() if k not in drop and "_s" not in k}
                                          for r in want["step_log"]])
            strip = lambda r: {k: v for k, v in r.items() if k not in ("params", "csvs")}  # noqa: E731
            out[f"{m}{'_' + d if d else ''}"] = {"same": same, "without": strip(want), "with": strip(got)}
        return out
    finally:
        dist.shutdown()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    mode, spec_path = argv
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    from e2e_asr_tpu_torch.parallel import dist

    if mode == "world1":
        torch.save(world1_compare(spec), spec["out"])
        return
    dist.init(_device(spec), spec.get("backend"))
    try:
        if mode == "grads":
            mode_grads(spec)
        elif mode == "step":
            mode_step(spec)
        elif mode in RUNS:
            mode_run(mode, spec)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        dist.barrier()
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
