"""The train step re-cut for CUDA graphs, on the CPU: nothing in it reads
the device or bakes in a per-step number, so the same code runs eagerly and
as a captured graph (training/step_graph.py, held on the card in
tests/test_torch_cuda.py).

- ``update_step`` over six Adam steps with the warmup schedule and one
  non-finite step in the middle against JAX's ``make_train_step``: the
  skipped step leaves parameters and optimizer state bit for bit (the
  counts too), and the run ends where JAX's ends (losses rtol 1e-5, grad
  norms rtol 1e-4, parameters rtol 1e-4 with atol 1e-4 of each tensor's
  largest entry, Adam's moments rtol 1e-2 with atol 1e-2 of it: after the
  first update the two runs' parameters differ at float32 rounding and the
  later gradients follow them, 0.3% of a moment's largest entry after five
  updates; Adam's eps 1e-3, so that an update whose gradient is near its
  rounding is not a sign flip). The JAX side runs its default routes.
- Clipping and the whole update by select against the branch the optimizer
  took before (a copy of it below): bitwise, on both sides of max_norm.
- The device bias corrections and learning rate against the host formulas
  over counts 1..10^5: bitwise.
- The solver's metrics ring, read once a log window, against per-step reads
  of the same run: bitwise.
- ``graph_key`` follows the shapes, input mode, routes and the tensors'
  addresses.
- A checkpoint with the counts as ints, as every checkpoint holds them,
  resumes with device counts.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from e2e_asr_tpu.optim import build_optimizer
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert, cuda_build, optim
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.config import HparasConfig
from e2e_asr_tpu_torch.optim import Optimizer, _bias_correction, bias_correction, build_schedule, device_lr, global_norm
from e2e_asr_tpu_torch.training import step_graph
from e2e_asr_tpu_torch.training.step import Trainer, param_leaves
from tests.test_torch_train import (LOSS_RTOL, RTOL, _batch, _cfg_dict, _close, _find, _gen, _jbatch,
                                    _leaves_of_jax, _models, _tbatch)

torch.set_num_threads(1)
MOMENT_TOL = 1e-2  # Adam's moments after six steps (module docstring)


def test_update_step_with_a_skip_matches_jax_over_six_adam_steps():
    cfg = _cfg_dict(ctc_infeasible="skip")
    cfg["hparas"].update(optimizer="Adam", lr=1e-3, eps=1e-3, lr_scheduler="warmup", warmup_step=4)
    jc, tc, jp, tp = _models(cfg)
    batches = [_batch(seed=i) for i in range(6)]
    batches[2] = _batch(text_len=[8, 6, 9], seed=2)  # row 2: 8 labels over 6 encoder frames: loss +inf
    tx = build_optimizer(jc.hparas)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    jfn = jax.jit(jstep.make_train_step(jc, tx))
    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    for i, b in enumerate(batches):
        jstate, jm = jfn(jstate, _jbatch(b), jax.random.PRNGKey(i))
        before = [p.detach().clone() for p in param_leaves(state.params)], copy.deepcopy(state.opt_state)
        tm = trainer.train_step(state, _tbatch(b), _gen(i))
        skipped = i == 2
        assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == float(skipped)
        assert tm["step_skipped"].shape == () and state.step == int(jstate.step) == i + 1
        if skipped:
            assert torch.isinf(tm["loss"])
            for p, q in zip(param_leaves(state.params), before[0]):
                assert torch.equal(p.detach(), q)
            for k, v in before[1].items():
                for a, c in zip(param_leaves(state.opt_state[k]), param_leaves(v)):
                    assert torch.equal(a, c), k
            continue
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    counts = [int(_find(jstate.opt_state, "count"))]
    assert int(state.opt_state["count"]) == int(state.opt_state["sched_count"]) == counts[0] == 5
    assert state.opt_state["count"].dtype == torch.int32
    for f in ("mu", "nu"):
        for i, (g, w) in enumerate(zip(state.opt_state[f], _leaves_of_jax(_find(jstate.opt_state, f)))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=MOMENT_TOL,
                                       atol=MOMENT_TOL * max(float(w.abs().max()), 1e-6), err_msg=f"{f} leaf {i}")
    _close(param_leaves(state.params), _leaves_of_jax(jstate.params), "params")


def _old_clip(grads, g_norm, max_norm):
    """The branch the optimizer took before clipping moved to a select."""
    if bool(g_norm >= max_norm):
        return [(g / g_norm) * max_norm for g in grads]
    return grads


def _old_update(opt, params, grads, state, g_norm):
    """The update as the optimizer made it before its counts moved to the
    device: host counts, the schedule and bias corrections as Python floats."""
    grads = _old_clip(grads, g_norm, opt.max_norm)
    if opt.name == "adadelta":
        rho, eps = 0.9, opt.eps
        upd = []
        for g, e_g, e_x in zip(grads, state["e_g"], state["e_x"]):
            e_g.copy_((1 - rho) * g**2 + rho * e_g)
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.copy_((1 - rho) * u**2 + rho * e_x)
            upd.append(u)
    elif opt.name == "adam":
        b1, b2, eps = 0.9, 0.999, opt.eps
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        upd = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g**2 + b2 * nu)
            upd.append((mu / c1) / (torch.sqrt(nu / c2) + eps))
    else:
        upd = grads
    state["count"] += 1
    lr = build_schedule(opt.h)(state["sched_count"])
    state["sched_count"] += 1
    for p, u in zip(params, upd):
        p.add_(-lr * u)


@pytest.mark.parametrize("norm_scale", [0.5, 40.0])
def test_clip_by_select_equals_the_branch_bitwise(norm_scale):
    rng = np.random.RandomState(7)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32) * norm_scale) for s in ((4, 3), (5,), (2, 2, 2))]
    g_norm = global_norm(grads)
    assert bool(g_norm >= 5.0) == (norm_scale > 1)
    for a, b in zip(optim.clip_by_global_norm(grads, g_norm, 5.0), _old_clip(grads, g_norm, 5.0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adadelta", "adam", "sgd"])
@pytest.mark.parametrize("norm_scale", [0.5, 40.0])
def test_update_by_select_equals_the_old_update_bitwise(name, norm_scale):
    """Four updates (warmup schedule) with ``ok`` true, by select, against
    the old in-place branch with host counts: parameters and moments bitwise;
    a fifth with ``ok`` false changes nothing, counts included."""
    h = HparasConfig(optimizer=name, lr=0.5, eps=1e-6, grad_clip=5.0, lr_scheduler="warmup", warmup_step=3)
    opt = Optimizer(h)
    rng = np.random.RandomState(3)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((6,), (2, 3))]
    ref = [p.clone() for p in params]
    st, ref_st = opt.init(params), opt.init(ref)
    ref_st.update(count=0, sched_count=0)
    for _ in range(4):
        gs = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * norm_scale) for p in params]
        opt.update(params, gs, st, global_norm(gs), torch.tensor(True))
        _old_update(opt, ref, [g.clone() for g in gs], ref_st, global_norm(gs))
        for a, b in zip(params + [t for k in ("e_g", "e_x", "mu", "nu") for t in st.get(k, [])],
                        ref + [t for k in ("e_g", "e_x", "mu", "nu") for t in ref_st.get(k, [])]):
            assert torch.equal(a, b)
    assert int(st["count"]) == ref_st["count"] == 4 and int(st["sched_count"]) == 4
    frozen = [p.clone() for p in params], copy.deepcopy(st)
    gs = [torch.full_like(p, float("nan")) for p in params]
    opt.update(params, gs, st, global_norm(gs), torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(params, frozen[0]))
    for k, v in frozen[1].items():
        assert all(torch.equal(a, b) for a, b in zip(param_leaves(st[k]), param_leaves(v))), k


def test_device_bias_corrections_and_lr_equal_the_host_formulas():
    counts = torch.arange(1, 100_001, dtype=torch.int32)
    for decay in (0.9, 0.999):
        got = bias_correction(decay, counts).numpy()
        want = np.array([_bias_correction(decay, int(c)) for c in counts], np.float32)
        assert got.dtype == np.float32 and np.array_equal(got, want), (decay, np.nonzero(got != want)[0][:5] + 1)
    counts = torch.arange(0, 100_001, dtype=torch.int32)
    for h in (HparasConfig(lr_scheduler="warmup", lr=1.0, warmup_step=25000),
              HparasConfig(lr_scheduler="warmup", lr=2.0, warmup_step=25),
              HparasConfig(lr_scheduler="fixed", lr=0.7)):
        sched = build_schedule(h)
        want = np.array([sched(int(c)) for c in counts], np.float32)
        got = device_lr(h, counts).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), (h, np.nonzero(got != want)[0][:5])
        assert device_lr(h, counts[7]).shape == ()


def _tiny_solver(tmp_path, name, **hparas):
    from e2e_asr_tpu_torch.bin.train_asr import Solver
    from tests.test_torch_cli import _tiny_train_yaml

    cfg = TConfig.load(str(_tiny_train_yaml(tmp_path)))
    for k, v in hparas.items():
        setattr(cfg.hparas, k, v)
    paras = types.SimpleNamespace(config="tiny.yaml", name=name, logdir=str(tmp_path / "log"),
                                  ckpdir=str(tmp_path / "ckpt"), load=None, seed=0, cpu=True, verbose=False,
                                  auto_resume=True, njobs=0)
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


def test_metrics_ring_equals_per_step_reads(tmp_path):
    """Five steps through ``Solver.exec`` (the ring read at steps 2, 4 and
    5) against the same five steps through ``train_step`` with every metric
    read after its step: the step_log records are the reads, bitwise."""
    solver = _tiny_solver(tmp_path, "ring", max_step=5, log_step=2, valid_step=1000)
    assert solver.train_graphs is None  # the CPU runs the eager step
    solver.exec()
    got = list(solver.step_log)
    ref = _tiny_solver(tmp_path, "ref", max_step=5, log_step=2, valid_step=1000)
    keys = ref.trainer.scalar_keys()
    assert keys == ("loss", "att_loss", "ctc_loss", "grad_norm", "tf_rate", "step_skipped")
    it = ref.tr_set.forever(curriculum_epochs=1)
    for step, rec in enumerate(got):
        m = ref.trainer.train_step(ref.state, ref._put(next(it)), ref.step_generator(step))
        want = {k: float(m[k]) for k in keys}
        assert {k: rec[k] for k in keys} == want and rec["step"] == step + 1
        assert rec["wall_s"] >= rec["rd_s"] >= 0.0 and rec["audio_s"] > 0
        assert "dev_s" not in rec
    assert len(got) == 5 and any(r["tf_rate"] < 1.0 for r in got)


def _key_setup(tmp_path):
    """The tiny solver's trainer and state, and two of its batches as
    offsets into its device-resident corpus (the CPU takes it under
    ``device_cache: auto``) and as streaming batches."""
    from e2e_asr_tpu_torch.training.step import resolve_wav

    solver = _tiny_solver(tmp_path, "key")
    it = solver.tr_set.forever(curriculum_epochs=1)
    solver.trainer.set_tf(0, solver.device)
    offs = [solver._put(next(it)) for _ in range(2)]
    assert all(b.get("wav") is None for b in offs)
    streams = [{"wav": resolve_wav(b)[0], **{k: b[k] for k in ("wav_len", "text", "text_len")}} for b in offs]
    return solver.trainer, solver.state, offs, streams


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def test_graph_key_follows_shapes_routes_and_pointers(tmp_path):
    """Two batches of one bucket shape share a key; another batch size or
    token length, an offsets batch, another compute type, LSTM route or
    speller route, the plain versions, or the same parameters or optimizer
    state at other addresses, make a new key."""
    trainer, state, (o0, o1), (b0, b1) = _key_setup(tmp_path)
    trainer.cfg.model.decoder.dropout = 0.0  # inside the fused scan's envelope, so that its route can be forced
    key = lambda st=state, b=b0: step_graph.graph_key(trainer, st, b)  # noqa: E731
    k0 = key()
    assert key(b=b1) == k0
    assert key(b={k: v[:3] for k, v in b0.items()}) != k0
    assert key(b={**b0, "text": torch.cat([b0["text"], b0["text"][:, :1]], 1)}) != k0
    assert key(b=o0) == key(b=o1) != k0
    assert key(b={**o0, "corpus": o0["corpus"].clone()}) != key(b=o0)
    assert key(b={**o0, "n_samples": o0["n_samples"] + 160}) != key(b=o0)
    assert key(st=types.SimpleNamespace(params=_clone(state.params), opt_state=state.opt_state)) != k0
    assert key(st=types.SimpleNamespace(params=state.params, opt_state=_clone(state.opt_state))) != k0
    cfg = trainer.cfg
    other_dtype = "float32" if cfg.hparas.dtype == "bfloat16" else "bfloat16"
    for section, field, value in ((cfg.hparas, "dtype", other_dtype), (cfg.model.encoder, "rnn_impl", "pallas"),
                                  (cfg.model.decoder, "fused_scan", "pallas")):
        old = getattr(section, field)
        setattr(section, field, value)
        try:
            assert key() != k0, field
        finally:
            setattr(section, field, old)
    assert key() == k0
    with mock.patch.object(cuda_build, "use_plain", lambda x: False):
        assert key() != k0


def test_counts_as_ints_resume_as_device_counts(tmp_path):
    """A checkpoint's counts are ints (as every checkpoint holds them); a
    solver resuming from one holds them as 0-dim int32 device tensors and
    counts on from there."""
    solver = _tiny_solver(tmp_path, "resume", max_step=2, valid_step=1000)
    solver.exec()
    payload = torch.load(tmp_path / "ckpt" / "resume" / "latest", weights_only=True)
    assert type(payload["opt_state"]["count"]) is int and payload["opt_state"]["count"] == 2
    assert type(payload["opt_state"]["sched_count"]) is int and payload["step"] == 2
    resumed = _tiny_solver(tmp_path, "resume", max_step=3, valid_step=1000)
    counts = {k: resumed.state.opt_state[k] for k in optim.COUNTS}
    assert all(c.dtype == torch.int32 and c.shape == () and int(c) == 2 for c in counts.values())
    assert resumed.step == 2
    resumed.exec()
    assert int(resumed.state.opt_state["count"]) == 3
    assert convert.load_checkpoint(str(tmp_path / "ckpt" / "resume" / "latest"), torch.device("cpu"))[
        "opt_state"]["count"] == 3
