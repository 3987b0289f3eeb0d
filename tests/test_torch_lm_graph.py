"""The LM solver re-cut for CUDA graphs, on the CPU: the step loop with its
metrics ring against per-step reads, the dev perplexity from device sums
against the host sums it replaces, and ``training/lm_graph.py``'s key (the
graphs themselves run on the card: tests/test_torch_cuda.py).

- ``Solver.exec`` (the ring read at every log step and at the end, dropout
  on) writes the ``step_log`` that the same steps read one by one write:
  every metric bitwise, one record a step.
- ``Solver.validate`` (token-weighted nll and token counts summed in
  float64 on the device, read once) gives the perplexity of the host sums,
  bitwise.
- ``graph_key`` follows the bucket shape, the route, the configuration and
  the tensors' addresses, and tells a train step from an evaluation.
"""

import types

import numpy as np
import pytest
import torch
from unittest import mock

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.bin import train_lm
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.training import lm_graph

torch.set_num_threads(1)


def _solver(tmp_path, name, max_step=5, log_step=2, valid_step=1000, dropout=0.2):
    cfg = TConfig.from_dict({
        "data": {"corpus": {"name": "synthetic", "train_split": ["train:48"], "dev_split": ["dev:24"]},
                 "text": {"mode": "character"}},
        "hparas": {"valid_step": valid_step, "max_step": max_step, "optimizer": "Adam", "lr": 3e-3,
                   "log_step": log_step},
        "lm": {"emb_dim": 16, "dim": 24, "n_layers": 2, "batch_size": 8, "dropout": dropout},
    })
    paras = types.SimpleNamespace(config="lm.yaml", name=name, logdir=str(tmp_path / "log"),
                                  ckpdir=str(tmp_path / "ckpt"), load=None, seed=0, cpu=True, verbose=False)
    s = train_lm.Solver(cfg, paras, "train")
    s.load_data()
    s.set_model()
    return s


@pytest.mark.parametrize("log_step", [1, 2, 7])
def test_lm_exec_ring_equals_per_step_reads(tmp_path, log_step):
    """Seven steps through ``exec`` against the same seven through
    ``train_step`` with every metric read after its step, dropout 0.2
    drawn from each step's generator: the records' metrics bitwise."""
    solver = _solver(tmp_path, "ring", max_step=7, log_step=log_step)
    assert solver.graphs is None and solver.eval_graphs is None  # the CPU runs eagerly
    solver.exec()
    got = list(solver.step_log)
    ref = _solver(tmp_path, "ref", max_step=7)
    it = ref.tr_set.forever()
    assert len(got) == 7
    for step, rec in enumerate(got):
        m = train_lm.train_step(ref.state, ref.opt, ref.config.lm, ref._put(next(it)), ref.step_generator(step))
        want = {k: float(m[k]) for k in train_lm.SCALARS}
        assert {k: rec[k] for k in train_lm.SCALARS} == want and rec["step"] == step + 1
        assert set(rec) == set(train_lm.SCALARS) | {"step", "wall_s"} and rec["wall_s"] > 0.0
        assert rec["step_skipped"] == 0.0 and rec["n_tokens"] > 0
    assert ref.state.step == solver.state.step == 7


def _host_ppl(solver):
    """The dev perplexity as validate read it before: two reads a batch,
    summed on the host."""
    tot_nll, tot_tok = 0.0, 0.0
    for batch in solver.dv_set.epoch(0):
        m = solver.eval_step(solver._put(batch))
        n = float(m["n_tokens"])
        tot_nll += float(m["loss"]) * n
        tot_tok += n
    return float(np.exp(tot_nll / max(tot_tok, 1)))


@pytest.mark.parametrize("steps", [0, 3])
def test_lm_validate_device_sums_equal_the_host_sums(tmp_path, steps):
    solver = _solver(tmp_path, "val", max_step=steps)
    assert len(solver.dv_set) >= 2
    solver.exec()
    want = _host_ppl(solver)
    assert solver.validate() == want == solver.dev_ppl
    assert solver.validate(graphs=False) == want and solver.best_ppl == want


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def test_lm_graph_key_follows_shapes_routes_config_and_pointers(tmp_path):
    """Two batches of one bucket shape share a key; another length or batch
    size, the plain versions, another LM configuration, the parameters or
    the optimizer state at other addresses, or an evaluation (no optimizer
    state) make another."""
    solver = _solver(tmp_path, "key")
    batches = [solver._put(b) for b in solver.tr_set.epoch(0)]
    by_shape = {}
    for b in batches:
        by_shape.setdefault(tuple(b["text"].shape), []).append(b)
    shape, (b0, b1) = next((s, bs[:2]) for s, bs in by_shape.items() if len(bs) >= 2)
    cfg, state = solver.config.lm, solver.state
    key = lambda b=b0, p=state.params, o=state.opt_state, c=cfg: lm_graph.graph_key(c, p, o, b)  # noqa: E731
    k0 = key()
    assert key(b=b1) == k0
    assert key(b={k: v[:, :-1] if k == "text" else v for k, v in b0.items()}) != k0
    assert key(b={k: v[:-1] for k, v in b0.items()}) != k0
    assert key(o=None) != k0 and key(o=None) == key(b=b1, o=None)
    assert key(p=_clone(state.params)) != k0
    assert key(o=_clone(state.opt_state)) != k0
    other = TConfig.from_dict({"lm": {**{f: getattr(cfg, f) for f in ("emb_dim", "dim", "n_layers", "batch_size")},
                                      "dropout": 0.0}}).lm
    assert key(c=other) != k0
    with mock.patch.object(cuda_build, "use_plain", lambda x: False):
        assert key() != k0


def test_lm_graphs_share_one_pool_and_refuse_cpu_tensors(tmp_path):
    graphs = lm_graph.LMGraphs()
    evals = lm_graph.LMEvalGraphs(share=graphs)
    evals.pool = (0, 3)
    assert graphs.pool == (0, 3)
    solver = _solver(tmp_path, "cpu")
    b = solver._put(next(solver.tr_set.epoch(0)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.step(solver.config.lm, solver.state, b, 0, lambda *a: None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        evals.eval(solver.config.lm, solver.state.params, b, lambda *a: None)
