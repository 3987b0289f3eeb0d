"""Checkpoints that the JAX package trained, served and resumed by the port
(``convert_jax_checkpoint.py``).

- The JAX solver trains 2 steps on the synthetic corpus and saves an orbax
  ``latest``; the script converts it; the port's ``main --test`` decode of
  dev and test writes the JAX decode's csvs (every hypothesis and score).
- The port resumes the converted ``latest`` (``Solver.set_model`` with
  ``--load``) and takes one step that matches the JAX solver's next step
  from the same checkpoint on the same batch: loss, gradient norm, the
  parameters and the optimizer's moments and counts, under Adadelta and
  Adam (the tolerances of tests/test_torch_train.py).
- A JAX LM (``bin/train_lm.py``), converted with ``--lm``, fused into the
  decode (lm_weight 0.3) gives the JAX fused decode's csvs.

The recipe is tests/test_solver.py's tiny one (one BiLSTM layer, dot
attention, Adam), dither 0 and teacher forcing 1.0 (its defaults), so that
the two packages' random draws do not enter.
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import convert_jax_checkpoint
from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.optim import build_optimizer
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.main import main as port_main
from e2e_asr_tpu_torch.training.step import param_leaves
from tests.test_solver import asr_config, make_paras
from tests.test_torch_train import LOSS_RTOL, RTOL, _close, _find

torch.set_num_threads(1)


def _jax_train(tmp_path, name, optimizer="Adam", max_step=2):
    from e2e_asr_tpu.bin.train_asr import Solver

    cfg = asr_config(max_step=max_step, valid_step=100)
    cfg.hparas.optimizer = optimizer
    cfg.hparas.lr = 1.0 if optimizer == "Adadelta" else 1e-3
    s = Solver(cfg, make_paras(tmp_path, name=name), "train")
    s.load_data()
    s.set_model()
    s.exec()
    s.finish_checkpoints()
    return cfg, s


def _yaml(cfg_dict, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg_dict, f)
    return str(path)


def _decode_dict(cfg, **decode):
    d = cfg.to_dict()
    d["data"]["corpus"]["test_split"] = ["test:6"]
    d["decode"].update(beam_size=2, max_len_ratio=0.5, batch_size=4, **decode)
    return d


def _jax_decode(tmp_path, d, ckpt, name):
    from e2e_asr_tpu.bin.test_asr import Solver

    dcfg = JConfig.from_dict(d)
    dcfg.src.ckpt = ckpt
    sd = Solver(dcfg, make_paras(tmp_path, name=name), "test")
    sd.load_data()
    sd.set_model()
    sd.exec()
    return sd.outdir


def _port_decode(tmp_path, d, ckpt, name):
    path = _yaml(d, tmp_path / f"{name}.yaml")
    port_main(["--config", path, "--test", "--load", ckpt, "--cpu", "--name", name, "--njobs", "0",
               "--outdir", str(tmp_path / "port_out"), "--no-msg"])
    return str(tmp_path / "port_out" / name)


def _csvs(outdir):
    out = {}
    for split in ("dev", "test"):
        for kind in ("output", "beam"):
            with open(os.path.join(outdir, f"{kind}_{split}.csv")) as f:
                out[f"{kind}_{split}"] = list(csv.reader(f, delimiter="\t"))
    return out


def _same_csvs(got, want):
    """Every hypothesis equal; beam scores within rtol 1e-4."""
    assert got.keys() == want.keys()
    for k in want:
        assert len(got[k]) == len(want[k]) > 1, k
        assert got[k][0] == want[k][0], k
        for g, w in zip(got[k][1:], want[k][1:]):
            assert g[:3] == w[:3], (k, g, w)
            if len(w) > 3:
                np.testing.assert_allclose(float(g[3]), float(w[3]), rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def jax_asr(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_asr")
    cfg, s = _jax_train(tmp, "tr")
    return tmp, cfg, os.path.join(s.ckpdir, "latest")


def test_converted_jax_checkpoint_decodes_as_jax_does(jax_asr, tmp_path):
    tmp, cfg, ckpt = jax_asr
    out = str(tmp_path / "port_ckpt" / "latest")
    convert_jax_checkpoint.main(["--config", _yaml(cfg.to_dict(), tmp_path / "train.yaml"), "--ckpt", ckpt,
                                 "--out", out])
    payload = convert.load_checkpoint(out, torch.device("cpu"))
    assert payload["kind"] == "asr" and payload["feat_dim"] == 40 and payload["step"] == 2
    assert os.path.isfile(os.path.join(tmp_path / "port_ckpt", "tokenizer.vocab"))
    with open(out + ".meta") as f:
        meta = f.read().split("\n")
    assert meta[1:3] == ["global_step 2", "compute_dtype float32"]
    d = _decode_dict(cfg)
    _same_csvs(_csvs(_port_decode(tmp_path, d, out, "port")), _csvs(_jax_decode(tmp_path, d, ckpt, "jax")))


def _close_adam_resumed(state, jnew, jparams0, lr):
    """Adam's update m_hat / (sqrt(v_hat) + eps) follows the gradient's
    rounding where every gradient so far was near it (sqrt(nu) <= 1e-6,
    |g| below ~3e-5 at step 3): there only |update| <= 3 lr is checked;
    elsewhere the parameters agree to rtol 1e-4, atol 1e-2 * lr (the bounds
    of tests/test_torch_train.py's first Adam step)."""
    leaves_of = lambda tree: param_leaves(convert.params_from_jax(jax.device_get(tree)))  # noqa: E731
    nu = leaves_of(_find(jnew.opt_state, "nu"))
    for p, w, p0, v in zip(param_leaves(state.params), leaves_of(jnew.params), leaves_of(jparams0), nu):
        p, big = p.detach(), v.sqrt() > 1e-6
        np.testing.assert_allclose(p[big].numpy(), w[big].numpy(), rtol=RTOL, atol=1e-2 * lr)
        assert float((p - p0).abs().max()) <= 3 * lr


@pytest.mark.parametrize("optimizer", ["Adadelta", "Adam"])
def test_port_resumes_a_converted_jax_run(tmp_path, optimizer):
    from e2e_asr_tpu.bin.train_asr import Solver as JSolver
    from e2e_asr_tpu_torch.bin.train_asr import Solver as TSolver
    from e2e_asr_tpu_torch.config import Config as TConfig

    cfg, s = _jax_train(tmp_path, "jx", optimizer)
    ckpt = os.path.join(s.ckpdir, "latest")
    out = str(tmp_path / "port" / "latest")
    convert_jax_checkpoint.convert_checkpoint(_yaml(cfg.to_dict(), tmp_path / "train.yaml"), ckpt, out)

    # JAX: the next step from the checkpoint, on the batch its loader gives next
    js = JSolver(cfg, make_paras(tmp_path, name="jx_resume", load=ckpt), "train")
    js.load_data()
    js.set_model()
    assert int(js.state.step) == 2
    js.tr_set.emit_offsets = False  # the batch's waves on the host, for both packages
    batch = next(js.tr_set.forever(skip_steps=2))
    b = {k: getattr(batch, k) for k in ("wav", "wav_len", "text", "text_len")}
    tx = build_optimizer(cfg.hparas)
    jnew, jm = jstep.make_train_step(cfg, tx)(js.state, {k: jnp.asarray(v) for k, v in b.items()},
                                              jax.random.PRNGKey(5))

    # the port: resume the converted checkpoint, one step on the same batch
    paras = types.SimpleNamespace(config="train.yaml", name="port_resume", logdir=str(tmp_path / "plog"),
                                  ckpdir=str(tmp_path / "pck"), load=out, seed=0, cpu=True, verbose=False,
                                  auto_resume=False, njobs=0)
    ts = TSolver(TConfig.from_dict(cfg.to_dict()), paras, "train")
    ts.load_data()
    ts.set_model()
    assert ts.step == ts.state.step == 2
    assert int(ts.state.opt_state["sched_count"]) == 2 and int(ts.state.opt_state["count"]) == 2
    gen = torch.Generator()
    gen.manual_seed(0)
    tm = ts.trainer.train_step(ts.state, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
    assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    leaves_of = lambda tree: param_leaves(convert.params_from_jax(jax.device_get(tree)))  # noqa: E731
    if optimizer == "Adam":
        _close_adam_resumed(ts.state, jnew, js.state.params, cfg.hparas.lr)
    else:
        _close(param_leaves(ts.state.params), leaves_of(jnew.params), "params")
    for f in (("e_g", "e_x") if optimizer == "Adadelta" else ("mu", "nu")):
        _close(ts.state.opt_state[f], leaves_of(_find(jnew.opt_state, f)), f)
    assert int(ts.state.opt_state["count"]) == int(_find(jnew.opt_state, "count")) == 3


def test_converted_jax_lm_fused_decode_equals_jax(jax_asr, tmp_path):
    from e2e_asr_tpu.bin.train_lm import Solver as LMSolver

    tmp, cfg, ckpt = jax_asr
    lm_d = {"data": {"corpus": {"name": "synthetic", "train_split": ["train:32"], "dev_split": ["dev:8"]},
                     "text": {"mode": "character",
                              "vocab_file": os.path.join(os.path.dirname(ckpt), "tokenizer.vocab")}},
            "hparas": {"valid_step": 3, "max_step": 4, "optimizer": "Adam", "lr": 3e-3, "log_step": 10},
            "lm": {"module": "GRU", "emb_dim": 16, "dim": 24, "n_layers": 2, "batch_size": 8, "dropout": 0.0}}
    ls = LMSolver(JConfig.from_dict(lm_d), make_paras(tmp_path, name="lm"), "train")
    ls.load_data()
    ls.set_model()
    ls.exec()
    ls.finish_checkpoints()
    jlm = os.path.join(ls.ckpdir, "best_ppl")
    lm_yaml = _yaml(lm_d, tmp_path / "lm.yaml")
    port_lm = str(tmp_path / "port_lm" / "best_ppl")
    convert_jax_checkpoint.main(["--config", lm_yaml, "--ckpt", jlm, "--out", port_lm, "--lm"])
    port_asr = str(tmp_path / "port_asr" / "latest")
    convert_jax_checkpoint.main(["--config", _yaml(cfg.to_dict(), tmp_path / "train.yaml"), "--ckpt", ckpt,
                                 "--out", port_asr])
    assert convert.load_checkpoint(port_lm, torch.device("cpu"), kind="lm")["feat_dim"] == 0
    with open(port_lm + ".meta") as f:
        assert f.readline().split()[0] == "ppl"
    jd = _decode_dict(cfg, lm_weight=0.3, lm_config=lm_yaml, lm_path=jlm)
    pd = _decode_dict(cfg, lm_weight=0.3, lm_config=lm_yaml, lm_path=port_lm)
    _same_csvs(_csvs(_port_decode(tmp_path, pd, port_asr, "port_lm")),
               _csvs(_jax_decode(tmp_path, jd, ckpt, "jax_lm")))
