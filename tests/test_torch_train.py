"""The port's joint CTC/attention training step against the JAX package's.

The model has the flagship's structure at test size (tests/torch_parity.py:
VGG prenet on 40-dim fbank, two BiLSTM layers with tanh projections,
location attention, an LSTM speller, ctc_weight 0.5), weights from JAX
``asr_init`` carried over by ``convert.params_from_jax``, and one batch of
numpy audio and targets. The JAX side runs in float32 with its Pallas
kernels in interpret mode (``E2E_RNN_IMPL`` / ``E2E_CTC_IMPL`` = pallas,
and the Pallas log-mel frontend), as the chip would run them.

Random draws cannot match ``jax.random``, so the parity cases use the
deterministic extremes: tf_rate 1.0 (every coin True), tf_rate 0.0 with
argmax feedback, dither 0 and SpecAugment off. SpecAugment's mask
application is checked on masks handed to both packages.

Tolerances (f32; the packages sum in other orders through the whole
model): losses rtol 1e-5; each gradient, parameter and optimizer moment
rtol 1e-4 with atol 1e-4 of that tensor's largest entry (ATOL_REL); the
parameters after one Adam step as ``_close_adam_params`` says; forward
outputs rtol 1e-4, atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.decode import greedy as jgreedy
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu.ops import specaugment as jspec
from e2e_asr_tpu.optim import build_optimizer, build_schedule as jschedule, tf_rate as jtf_rate
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.config import HparasConfig, SpecAugmentConfig
from e2e_asr_tpu_torch.decode import greedy as tgreedy
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.ops import specaugment as tspec
from e2e_asr_tpu_torch.optim import Optimizer, build_schedule, global_norm, tf_rate
from e2e_asr_tpu_torch.training.step import Trainer, compute_loss, param_leaves
from tests.torch_parity import FEAT_DIM, VOCAB, small_config

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
RTOL, ATOL_REL = 1e-4, 1e-4
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5

FRAMES = [64, 52, 24]  # -> 16, 13, 6 encoder frames after the VGG prenet
TEXT_LEN = [8, 6, 5]
L_PAD = 10


@pytest.fixture
def pallas_env(monkeypatch):
    monkeypatch.setenv("E2E_RNN_IMPL", "pallas")
    monkeypatch.setenv("E2E_CTC_IMPL", "pallas")


def _cfg_dict(**hparas):
    d = small_config()
    d["data"]["audio"].update(use_pallas=True, dither=0.0)
    d["hparas"] = dict(dtype="float32", tf_start=1.0, tf_end=1.0, optimizer="Adadelta", lr=1.0,
                       eps=1e-8, grad_clip=5.0, **hparas)
    d["model"]["specaugment"] = {"enable": False}
    return d


def _models(cfg_dict):
    jc, tc = JConfig.from_dict(cfg_dict), TConfig.from_dict(cfg_dict)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    return jc, tc, jp, convert.params_from_jax(jax.device_get(jp))


def _batch(text_len=TEXT_LEN, frames=FRAMES, seed=0):
    """Audio and targets; the targets repeat no token, so that every row
    fits its CTC lattice unless its text is made longer than its frames."""
    rng = np.random.RandomState(seed)
    n = (max(frames) - 1) * 160 + 400
    wav_len = np.array([(f - 1) * 160 + 400 for f in frames], np.int32)
    wav = (0.1 * rng.randn(len(frames), n)).astype(np.float32)
    for i, m in enumerate(wav_len):
        wav[i, m:] = 0.0
    steps = rng.randint(1, VOCAB - 2, size=(len(frames), L_PAD))
    text = (1 + np.cumsum(steps, axis=1) % (VOCAB - 1)).astype(np.int32)
    text_len = np.asarray(text_len, np.int32)
    for i, m in enumerate(text_len):
        text[i, m:] = 0
    return {"wav": wav, "wav_len": wav_len, "text": text, "text_len": text_len}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _leaves_of_jax(tree):
    return param_leaves(convert.params_from_jax(jax.device_get(tree)))


def _close(got, want, what, floor=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), w.numpy()
        assert g.shape == w.shape, (what, i)
        tol = max(ATOL_REL * max(float(np.abs(w).max()), 1e-6), floor)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=tol, err_msg=f"{what} leaf {i}")


def _find(opt_state, field):
    """The first field of that name in an optax chain's state."""
    for s in opt_state:
        if field in getattr(s, "_fields", ()):
            return getattr(s, field)
    raise KeyError(field)


def test_compute_loss_and_every_gradient_match_jax(pallas_env):
    """compute_loss at tf 1.0: joint, attention and CTC losses, and the
    gradient of every parameter, against jax.value_and_grad."""
    jc, tc, jp, tp = _models(_cfg_dict())
    b = _batch()

    def jloss(p):
        return jstep.compute_loss(p, jc, *(_jbatch(b)[k] for k in ("wav", "wav_len", "text", "text_len")),
                                  1.0, jax.random.PRNGKey(1), train=True)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = _tbatch(b)
    tl, tm = compute_loss(tp, tc, tb["wav"], tb["wav_len"], tb["text"], tb["text_len"], 1.0,
                          _gen(), train=True)
    for k in ("loss", "att_loss", "ctc_loss"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    assert np.isfinite(float(tl.detach()))
    grads = torch.autograd.grad(tl, leaves)
    want = _leaves_of_jax(jg)
    assert len(grads) == len(want) == len(leaves)
    _close(grads, want, "grad")
    np.testing.assert_array_equal(tm["enc_len"].numpy(), np.asarray(jm["enc_len"]))


def test_eval_step_matches_jax(pallas_env):
    """make_eval_step: teacher-forced losses and both heads' argmax."""
    jc, tc, jp, tp = _models(_cfg_dict())
    b = _batch()
    jm = jstep.make_eval_step(jc)(jp, _jbatch(b))
    tm = Trainer(tc).eval_step(tp, _tbatch(b))
    for k in ("loss", "att_loss", "ctc_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    for k in ("att_preds", "ctc_preds"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)


def test_forward_tf0_argmax_feedback_matches_jax():
    """forward at tf_rate 0.0 with sample_decoding=False: every step feeds
    back the argmax of the last one, in training mode."""
    jc, tc, jp, tp = _models(_cfg_dict())
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 40, FEAT_DIM).astype(np.float32)
    feat_len = np.array([40, 29], np.int32)
    feat[1, 29:] = 0.0
    teacher = _batch(text_len=[7, 5], frames=[40, 29])["text"]
    jo = jasr.forward(jp, jc.model, jnp.asarray(feat), jnp.asarray(feat_len), L_PAD, tf_rate=0.0,
                      teacher=jnp.asarray(teacher), rng=jax.random.PRNGKey(2), train=True,
                      sample_decoding=False)
    to = tasr.forward(tp, tc.model, torch.from_numpy(feat), torch.from_numpy(feat_len), L_PAD,
                      tf_rate=0.0, teacher=torch.from_numpy(teacher), generator=_gen(),
                      train=True, sample_decoding=False)
    for k in ("att_logits", "align", "att_hidden", "ctc_log_probs"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]), rtol=FWD_RTOL,
                                   atol=FWD_ATOL, err_msg=k)
    # the fed-back tokens differ from the teacher's: the run really was free
    fed = to["att_logits"].argmax(-1)[:, :-1].numpy()
    assert (fed != teacher[:, :-1]).any()


OPTIMIZERS = {
    "adadelta": dict(optimizer="Adadelta", grad_clip=5.0),
    "adadelta_clipped": dict(optimizer="Adadelta", grad_clip=0.05),
    "adam": dict(optimizer="Adam", lr=1e-3, grad_clip=5.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_step_matches_jax(pallas_env, name):
    """One full train_step against make_train_step: loss, pre-clip grad
    norm, the updated parameters and the optimizer state."""
    cfg = _cfg_dict()
    cfg["hparas"].update(OPTIMIZERS[name])
    jc, tc, jp, tp = _models(cfg)
    b = _batch()
    tx = build_optimizer(jc.hparas)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    jnew, jm = jstep.make_train_step(jc, tx)(jstate, _jbatch(b), jax.random.PRNGKey(1))

    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    tm = trainer.train_step(state, _tbatch(b), _gen())
    assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    if name == "adadelta_clipped":
        assert float(tm["grad_norm"]) > cfg["hparas"]["grad_clip"]
    if name == "adam":
        _close_adam_params(state, jnew, jp, jc.hparas.lr)
    else:
        _close(param_leaves(state.params), _leaves_of_jax(jnew.params), "params")
    fields = ("e_g", "e_x") if name.startswith("adadelta") else ("mu", "nu")
    for f in fields:
        _close(state.opt_state[f], _leaves_of_jax(_find(jnew.opt_state, f)), f)
    if name == "adam":
        assert state.opt_state["count"] == int(_find(jnew.opt_state, "count")) == 1
    assert state.step == int(jnew.step) == 1


def _close_adam_params(state, jnew, jparams0, lr):
    """Adam's first update is lr * g / (|g| + eps): where |g| is near the
    gradient's rounding (1e-6 here) the sign and size of the update follow
    the rounding, so there only |update| <= lr is checked; elsewhere the
    parameters agree to rtol 1e-4, atol 1e-2 * lr."""
    g = [10.0 * m for m in _leaves_of_jax(_find(jnew.opt_state, "mu"))]  # mu = 0.1 g
    for p, w, p0, gj in zip(param_leaves(state.params), _leaves_of_jax(jnew.params),
                            _leaves_of_jax(jparams0), g):
        p, big = p.detach(), gj.abs() > 1e-6
        np.testing.assert_allclose(p[big].numpy(), w[big].numpy(), rtol=RTOL, atol=1e-2 * lr)
        assert float((p - p0).abs().max()) <= lr * (1 + 1e-5)


def _snapshot(state):
    return [p.detach().clone() for p in param_leaves(state.params)], copy.deepcopy(state.opt_state)


def test_skip_policy_leaves_params_and_state_untouched(pallas_env):
    """ctc_infeasible 'skip': a row with no CTC alignment makes the loss
    +inf; the step is skipped (as in JAX) and params and optimizer state
    stay bit-identical. The next feasible step trains."""
    cfg = _cfg_dict(ctc_infeasible="skip")
    jc, tc, jp, tp = _models(cfg)
    bad = _batch(text_len=[8, 6, 9])  # row 2: 8 labels over 6 encoder frames
    tx = build_optimizer(jc.hparas)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    _, jm = jstep.make_train_step(jc, tx)(jstate, _jbatch(bad), jax.random.PRNGKey(1))
    assert float(jm["step_skipped"]) == 1.0

    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    # one real step first, so the optimizer state is not all zeros
    trainer.train_step(state, _tbatch(_batch()), _gen())
    params0, opt0 = _snapshot(state)
    tm = trainer.train_step(state, _tbatch(bad), _gen(1))
    assert float(tm["step_skipped"]) == 1.0 and torch.isinf(tm["loss"])
    for p, q in zip(param_leaves(state.params), params0):
        assert torch.equal(p.detach(), q)
    for f in ("e_g", "e_x"):
        for a, c in zip(state.opt_state[f], opt0[f]):
            assert torch.equal(a, c)
    assert state.opt_state["count"] == opt0["count"] and state.step == 2
    tm = trainer.train_step(state, _tbatch(_batch(seed=1)), _gen(2))
    assert float(tm["step_skipped"]) == 0.0
    assert any(not torch.equal(p.detach(), q) for p, q in zip(param_leaves(state.params), params0))


def test_mask_policy_trains_on_feasible_rows(pallas_env):
    """ctc_infeasible 'mask': the infeasible row leaves the CTC mean, the
    step trains, and loss and grad norm match JAX's."""
    cfg = _cfg_dict(ctc_infeasible="mask")
    jc, tc, jp, tp = _models(cfg)
    bad = _batch(text_len=[8, 6, 9])
    tx = build_optimizer(jc.hparas)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    jnew, jm = jstep.make_train_step(jc, tx)(jstate, _jbatch(bad), jax.random.PRNGKey(1))
    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    tm = trainer.train_step(state, _tbatch(bad), _gen())
    assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ctc_loss"]), float(jm["ctc_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    _close(param_leaves(state.params), _leaves_of_jax(jnew.params), "params")


def test_prenetless_step_through_fused_scan_and_lstm_seq_matches_jax(monkeypatch):
    """One whole train step of a tiny recipe without a prenet (pyramidal
    BiLSTM on the fbank features) with the speller through the fused scan
    (decoder.fused_scan 'pallas') and every BiLSTM layer through lstm_seq
    ('pallas_xw': the port by encoder.rnn_impl, JAX by E2E_RNN_IMPL), both
    sides' kernels as their CPU versions (plain / Pallas interpret mode):
    loss, pre-clip grad norm, updated parameters and Adadelta's state.
    The attention bias loc_b starts at zero and its gradient is a sum over
    L*B*S terms that cancel to ~1e-6, so its first update carries their
    rounding: an absolute floor of 1e-9 on the parameters' tolerance.
    (Layers 32 wide: the JAX dispatch takes lstm_seq only where 4H is a
    multiple of 128.)"""
    monkeypatch.setenv("E2E_RNN_IMPL", "pallas_xw")
    monkeypatch.setenv("E2E_CTC_IMPL", "pallas")
    d = _cfg_dict()
    d["model"]["encoder"] = {"prenet": "", "dim": [32, 32], "dropout": [0.0, 0.0],
                             "layer_norm": [False, False], "proj": [True, True],
                             "sample_rate": [2, 2], "sample_style": "drop"}
    d["model"]["decoder"]["fused_scan"] = "pallas"
    jc = JConfig.from_dict(d)
    d["model"]["encoder"]["rnn_impl"] = "pallas_xw"
    tc = TConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    tp = convert.params_from_jax(jax.device_get(jp))
    b = _batch()
    tx = build_optimizer(jc.hparas)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    jnew, jm = jstep.make_train_step(jc, tx)(jstate, _jbatch(b), jax.random.PRNGKey(1))

    from e2e_asr_tpu_torch.ops import decoder_cuda, rnn_cuda
    counts = {"scan": 0, "seq": 0}
    real_scan, real_seq = decoder_cuda.decoder_scan_bwd, rnn_cuda.lstm_seq_bwd
    monkeypatch.setattr(decoder_cuda, "decoder_scan_bwd",
                        lambda *a, **k: counts.__setitem__("scan", counts["scan"] + 1) or real_scan(*a, **k))
    monkeypatch.setattr(rnn_cuda, "lstm_seq_bwd",
                        lambda *a: counts.__setitem__("seq", counts["seq"] + 1) or real_seq(*a))
    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    tm = trainer.train_step(state, _tbatch(b), _gen())
    assert counts == {"scan": 1, "seq": 2}  # the step went through both new routes
    assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
    for k in ("loss", "att_loss", "ctc_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    _close(param_leaves(state.params), _leaves_of_jax(jnew.params), "params", floor=1e-9)
    for f in ("e_g", "e_x"):
        _close(state.opt_state[f], _leaves_of_jax(_find(jnew.opt_state, f)), f)


def test_greedy_decode_matches_jax():
    """Free-running argmax decode: identical tokens, close alignments; and
    the CTC head's frame-wise argmax."""
    jc, tc, jp, tp = _models(_cfg_dict())
    rng = np.random.RandomState(4)
    feat = rng.randn(3, 48, FEAT_DIM).astype(np.float32)
    feat_len = np.array([48, 33, 20], np.int32)
    for i, n in enumerate(feat_len):
        feat[i, n:] = 0.0
    jt, ja = jgreedy.greedy_decode(jp, jc.model, jnp.asarray(feat), jnp.asarray(feat_len), 9)
    tt, ta = tgreedy.greedy_decode(tp, tc.model, torch.from_numpy(feat), torch.from_numpy(feat_len), 9)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=FWD_RTOL, atol=FWD_ATOL)
    ji, jl = jgreedy.ctc_greedy_decode(jp, jc.model, jnp.asarray(feat), jnp.asarray(feat_len))
    ti, tl = tgreedy.ctc_greedy_decode(tp, tc.model, torch.from_numpy(feat), torch.from_numpy(feat_len))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _jax_masks(feat_len, d, cfg, rng):
    """The widths and starts JAX specaugment draws from ``rng`` (its own key
    schedule, repeated here)."""
    b = len(feat_len)
    fl = jnp.asarray(feat_len)
    kf, kt = jax.random.split(rng)
    fs, fw, ts, tw = [], [], [], []
    for i in range(cfg.freq_mask_num):
        k1, k2, kf = jax.random.split(jax.random.fold_in(kf, i), 3)
        fw.append(jax.random.randint(k1, (b, 1), 0, cfg.freq_mask_width + 1))
        fs.append(jax.random.randint(k2, (b, 1), 0, max(d - cfg.freq_mask_width, 1)))
    for i in range(cfg.time_mask_num):
        k1, k2, kt = jax.random.split(jax.random.fold_in(kt, i), 3)
        max_w = jnp.minimum(cfg.time_mask_width, (fl * cfg.time_mask_ratio).astype(jnp.int32))[:, None]
        w = (jax.random.uniform(k1, (b, 1)) * (max_w + 1)).astype(jnp.int32)
        tw.append(w)
        ts.append((jax.random.uniform(k2, (b, 1)) * jnp.maximum(fl[:, None] - w, 1)).astype(jnp.int32))
    cat = lambda xs: torch.from_numpy(np.array(jnp.concatenate(xs, 1))).long()  # noqa: E731
    return tspec.Masks(cat(fs), cat(fw), cat(ts), cat(tw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_specaugment_apply_matches_jax(seed):
    """apply_masks on the masks JAX draws gives JAX's output exactly."""
    cfg = SpecAugmentConfig(enable=True, freq_mask_num=2, freq_mask_width=10, time_mask_num=2,
                            time_mask_width=50, time_mask_ratio=0.5)
    rng = np.random.RandomState(seed)
    feat = rng.randn(3, 90, FEAT_DIM).astype(np.float32)
    feat_len = np.array([90, 61, 17], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jspec.specaugment(jnp.asarray(feat), jnp.asarray(feat_len), cfg, key))
    masks = _jax_masks(feat_len, FEAT_DIM, cfg, key)
    got = tspec.apply_masks(torch.from_numpy(feat), masks).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()


def test_specaugment_draw_ranges():
    """Widths and starts of draw_masks stay in the JAX package's ranges, and
    time masks inside each utterance."""
    cfg = SpecAugmentConfig(enable=True, freq_mask_num=2, freq_mask_width=10, time_mask_num=2,
                            time_mask_width=50, time_mask_ratio=0.4)
    feat_len = torch.tensor([300, 120, 7, 1] * 256)
    m = tspec.draw_masks(feat_len, FEAT_DIM, cfg, _gen(5))
    assert m.freq_width.min() >= 0 and m.freq_width.max() == cfg.freq_mask_width
    assert m.freq_start.min() == 0 and m.freq_start.max() == FEAT_DIM - cfg.freq_mask_width - 1
    max_w = torch.clamp((feat_len.float() * cfg.time_mask_ratio).long(), max=cfg.time_mask_width)
    assert bool((m.time_width >= 0).all()) and bool((m.time_width <= max_w[:, None]).all())
    assert int(m.time_width.max()) == cfg.time_mask_width
    assert bool((m.time_start >= 0).all())
    assert bool((m.time_start < torch.clamp(feat_len[:, None] - m.time_width, min=1)).all())
    assert bool((m.time_start + m.time_width <= torch.clamp(feat_len, min=1)[:, None]).all())
    out = tspec.specaugment(torch.ones(4, 30, FEAT_DIM), feat_len[:4] // 10, cfg, _gen(6))
    assert out.shape == (4, 30, FEAT_DIM) and (out == 0).any()


@pytest.mark.parametrize("norm_scale", [0.5, 40.0])
def test_clip_by_global_norm_is_optax(norm_scale):
    """Clipping scales by max / norm only above max (optax's formula)."""
    rng = np.random.RandomState(7)
    grads = [rng.randn(4, 3).astype(np.float32) * norm_scale, rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    h = HparasConfig(optimizer="SGD", lr=1.0, grad_clip=5.0)
    params = [torch.zeros(g.shape) for g in grads]
    tg = [torch.from_numpy(g) for g in grads]
    opt = Optimizer(h)
    opt.update(params, tg, opt.init(params), global_norm(tg))
    for p, w in zip(params, want):
        np.testing.assert_allclose(-p.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adadelta", "adam"])
def test_update_rule_matches_optax_over_steps(name):
    """Three updates of the core rule with lr 1 and no clipping against
    optax.scale_by_adadelta(rho 0.9, eps 1e-8) / scale_by_adam(eps 1e-8)."""
    rng = np.random.RandomState(8)
    steps = [[rng.randn(6).astype(np.float32), rng.randn(2, 3).astype(np.float32)] for _ in range(3)]
    core = optax.scale_by_adadelta(rho=0.9, eps=1e-8) if name == "adadelta" else optax.scale_by_adam(eps=1e-8)
    jparams = [jnp.zeros(g.shape) for g in steps[0]]
    jst = core.init(jparams)
    h = HparasConfig(optimizer=name, lr=1.0, eps=1e-8, grad_clip=1e9)
    opt = Optimizer(h)
    params = [torch.zeros(g.shape) for g in steps[0]]
    st = opt.init(params)
    for gs in steps:
        upd, jst = core.update([jnp.asarray(g) for g in gs], jst, jparams)
        jparams = optax.apply_updates(jparams, [-u for u in upd])
        tg = [torch.from_numpy(g) for g in gs]
        opt.update(params, tg, st, global_norm(tg))
        for p, w in zip(params, jparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_schedules_match_jax():
    for h in (HparasConfig(lr_scheduler="fixed", lr=0.7),
              HparasConfig(lr_scheduler="warmup", lr=2.0, warmup_step=25)):
        js, ts = jschedule(h), build_schedule(h)
        for step in (0, 1, 10, 25, 26, 400):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    h = HparasConfig(tf_start=1.0, tf_end=0.5, tf_step=40)
    for step in (0, 1, 20, 40, 41, 1000):
        np.testing.assert_allclose(tf_rate(h, step), float(jtf_rate(h, step)), rtol=1e-6)


@pytest.mark.parametrize("curriculum,skip,wire,workers", [
    pytest.param(1, 0, "int16", 0, id="1-0"),
    pytest.param(0, 5, "int16", 0, id="0-5"),
    pytest.param(1, 0, "float32", 0, id="1-0-float32"),
    pytest.param(1, 0, "int16", 2, id="1-0-w2"),
    pytest.param(0, 5, "int16", 2, id="0-5-w2"),
    pytest.param(0, 5, "float32", 2, id="0-5-float32-w2"),
    pytest.param(1, 0, "int16", 4, id="1-0-w4"),
    pytest.param(0, 5, "int16", 4, id="0-5-w4"),
    pytest.param(1, 0, "float32", 4, id="1-0-float32-w4"),
])
def test_train_loader_order_matches_jax(curriculum, skip, wire, workers):
    """The training data trajectory: a length-ascending first epoch with
    curriculum, shuffled epochs (RandomState(seed + epoch)) after it, and a
    resumed run's skip_steps, batch for batch as the JAX loader gives it;
    with either wire dtype (float32 waves pass through int16 as in JAX),
    filled on the calling thread or by ``workers`` threads."""
    from e2e_asr_tpu.data.dataset import load_dataset as jload

    from e2e_asr_tpu_torch.data.dataset import load_dataset as tload

    d = {"corpus": {"name": "synthetic", "train_split": ["train:40"], "dev_split": ["dev:4"],
                    "batch_size": 4, "buckets": [208, 416, 816], "token_buckets": [32, 48, 64],
                    "wire_dtype": wire},
         "audio": {"feat_dim": FEAT_DIM}, "text": {"mode": "character"}}
    jc, tc = JConfig.from_dict({"data": d}), TConfig.from_dict({"data": d})
    jtr = jload(jc.data, ascending=curriculum > 0, num_workers=workers)[0]
    ttr = tload(tc.data, ascending=curriculum > 0, num_workers=workers)[0]
    assert ttr.num_workers == workers
    assert len(ttr) == len(jtr)
    ji = jtr.forever(curriculum_epochs=curriculum, skip_steps=skip)
    ti = ttr.forever(curriculum_epochs=curriculum, skip_steps=skip)
    for _ in range(2 * len(ttr) + 3):
        jb, tb = next(ji), next(ti)
        assert tb.uids == jb.uids
        for k in ("wav", "wav_len", "text", "text_len"):
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), err_msg=k)
