"""Convert a checkpoint that the JAX package trained into one the PyTorch
port serves or resumes.

    python convert_jax_checkpoint.py --config cfg.yaml --ckpt ckpt/exp/latest --out port/latest [--lm]

``--ckpt`` is an orbax checkpoint written by ``e2e_asr_tpu/solver.py``
``BaseSolver.save_checkpoint`` (``bin/train_asr.py``'s ``best_att`` /
``best_ctc`` / ``latest``, or with ``--lm`` those of ``bin/train_lm.py``);
``--config`` is the yaml it was trained with. It is restored against a
template built from the config, as the JAX solvers restore it (a restore
without one loses the ``LSTMWeights`` named tuples and the lists that
``e2e_asr_tpu_torch/convert.py`` keys on), and written with
``convert.save_checkpoint`` (``kind`` ``"asr"`` or ``"lm"``, the vocabulary
size, ``feat_dim``), with a ``.meta`` beside it in the port's form (the
metric and score of the JAX ``.meta``, ``global_step``, ``compute_dtype``).
A ``tokenizer.vocab`` beside the JAX checkpoint is copied beside the
output, where the port's decode looks for it.

Where the checkpoint holds ``opt_state`` and ``step``, they are carried
over, so that ``e2e_asr_tpu_torch.main --load <out>`` resumes the JAX run:
optax's Adadelta ``e_g`` / ``e_x`` or Adam ``mu`` / ``nu`` become the port's
moment lists, each converted tree by tree like the parameters and flattened
in the port's parameter order (``training/step.py`` ``param_leaves``, not
``jax.tree.leaves``: the named tuples' field order is another); the counts
come from optax's chain state (the schedule's count, and Adam's own).

This script is the one place that imports both packages. It runs where JAX
and orbax are installed (the CPU is enough), not on a machine with the
port alone; its output is a ``torch.save`` file.
"""

from __future__ import annotations

import argparse
import os
import shutil

import jax
import numpy as np

from e2e_asr_tpu.config import Config
from e2e_asr_tpu.models import asr as asr_mod
from e2e_asr_tpu.models import lm as lm_mod
from e2e_asr_tpu.optim import build_optimizer
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.training.step import param_leaves

MOMENTS = {"adadelta": ("e_g", "e_x"), "adam": ("mu", "nu"), "sgd": ()}


def _tree(metadata):
    """The tree of array metadata of an orbax checkpoint's metadata."""
    item = getattr(metadata, "item_metadata", metadata)
    return getattr(item, "tree", item)


def _field(opt_state, name: str):
    """The first field ``name`` of an optax chain's states."""
    for s in opt_state:
        if name in getattr(s, "_fields", ()):
            return getattr(s, name)
    raise KeyError(f"no optimizer state holds '{name}'")


def vocab_size(meta: dict, lm: bool) -> int:
    p = meta["params"]
    if lm:
        return int(p["embed"]["table"].shape[0])
    head = p["decoder"]["char"] if "decoder" in p else p["ctc"]
    return int(head["w"].shape[1])


def restore(cfg: Config, ckpt: str, lm: bool):
    """(restored tree: params, and opt_state and step where saved; vocab
    size; feat_dim) of the checkpoint, against a template from ``cfg``."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(ckpt)
    with ocp.PyTreeCheckpointer() as ckptr:
        meta = _tree(ckptr.metadata(path))
        vocab = vocab_size(meta, lm)
        key = jax.random.PRNGKey(cfg.hparas.seed)
        if lm:
            params, feat_dim = lm_mod.lm_init(key, vocab, cfg.lm), 0
        else:
            feat_dim = cfg.data.audio.output_dim
            params, _ = asr_mod.asr_init(key, feat_dim, vocab, cfg.model)
        template = {"params": params}
        if "opt_state" in meta and "step" in meta:
            template["opt_state"] = build_optimizer(cfg.hparas).init(params)
            template["step"] = np.int32(0)
        tree = ckptr.restore(path, args=ocp.args.PyTreeRestore(item=template, partial_restore=True))
    return jax.device_get(tree), vocab, feat_dim


def opt_state_to_port(opt_state, optimizer: str) -> dict:
    """optax's chain state -> the port's ``OptState`` as checkpoints hold it
    (counts as ints, moments as lists in ``param_leaves`` order)."""
    out = {f: param_leaves(convert.params_from_jax(_field(opt_state, f))) for f in MOMENTS[optimizer.lower()]}
    # the schedule's count is the chain's last state's; the port's update
    # count is Adam's own where there is one (the first state with a count),
    # else the same
    out["count"] = int(_field(opt_state, "count"))
    out["sched_count"] = int(opt_state[-1].count)
    return out


def read_meta(ckpt: str, step: int):
    """(metric, score) of the JAX ``.meta`` beside ``ckpt``, else ("step", step)."""
    path = ckpt.rstrip("/") + ".meta"
    if os.path.isfile(path):
        with open(path) as f:
            metric, score = f.readline().split()
        return metric, float(score)
    return "step", float(step)


def convert_checkpoint(config: str, ckpt: str, out: str, lm: bool = False) -> dict:
    """Writes the port checkpoint ``out`` (and ``out.meta``); returns its payload."""
    cfg = Config.load(config)
    tree, vocab, feat_dim = restore(cfg, ckpt, lm)
    extra = {}
    if "opt_state" in tree:
        extra = {"opt_state": opt_state_to_port(tree["opt_state"], cfg.hparas.optimizer),
                 "step": int(tree["step"])}
    params = convert.params_from_jax(tree["params"])
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    convert.save_checkpoint(out, params, vocab, feat_dim, kind="lm" if lm else "asr", **extra)
    step = extra.get("step", 0)
    metric, score = read_meta(ckpt, step)
    dtype = "float32" if lm else cfg.hparas.dtype
    with open(out + ".meta", "w") as f:
        f.write(f"{metric} {score}\nglobal_step {step}\ncompute_dtype {dtype}\n")
    vocab_file = os.path.join(os.path.dirname(os.path.abspath(ckpt.rstrip("/"))), "tokenizer.vocab")
    if os.path.isfile(vocab_file):
        shutil.copyfile(vocab_file, os.path.join(os.path.dirname(os.path.abspath(out)), "tokenizer.vocab"))
    return {"params": params, "vocab_size": vocab, "feat_dim": feat_dim, **extra}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="convert a JAX-trained orbax checkpoint to a port checkpoint")
    ap.add_argument("--config", required=True, help="the yaml the JAX run trained with")
    ap.add_argument("--ckpt", required=True, help="the orbax checkpoint directory (e.g. ckpt/<name>/latest)")
    ap.add_argument("--out", required=True, help="the port checkpoint to write (a torch.save file)")
    ap.add_argument("--lm", action="store_true", help="an RNN-LM checkpoint of bin/train_lm.py")
    args = ap.parse_args(argv)
    payload = convert_checkpoint(args.config, args.ckpt, args.out, args.lm)
    print(f"{args.ckpt} -> {args.out}: kind {'lm' if args.lm else 'asr'}, vocab {payload['vocab_size']}, "
          f"feat_dim {payload['feat_dim']}, step {payload.get('step', 'none (parameters only)')}")


if __name__ == "__main__":
    main()
