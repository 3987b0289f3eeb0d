"""The port's RNN-LM against the JAX package's at test size: ``lm_init``'s
layout, the one-direction ``ops/rnn.py`` ``lstm`` (the ``lstm_seq`` pair's
plain versions here), ``apply_seq``, ``step``, ``lm_loss`` and its
gradients, one ``train_lm`` step with Adam and clipping, and ``TextLoader``;
then the port's LM solver trains on the CPU.

Weights come from the JAX ``lm_init`` through ``convert.params_from_jax``,
inputs from numpy with a seed, every case with the embedding tied and
untied. Dropout is 0 wherever the two are compared (``jax.random`` and
``torch.Generator`` draw other numbers). Tolerances (f32, sums in other
orders): values rtol 1e-5 / atol 1e-6; gradients and optimizer moments
rtol 1e-4 with atol 1e-4 of the tensor's largest entry; parameters after
one Adam step rtol 2e-5 / atol 1e-6 where the gradient is above its
rounding (``_close_adam_params``).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.bin import train_lm as jtrain_lm
from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.data import corpus as jcorpus
from e2e_asr_tpu.data.dataset import TextLoader as JTextLoader
from e2e_asr_tpu.data.dataset import build_tokenizer as jbuild_tokenizer
from e2e_asr_tpu.models import lm as jlm
from e2e_asr_tpu.ops import rnn as jrnn
from e2e_asr_tpu.optim import build_optimizer
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.bin import train_lm
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.data import corpus
from e2e_asr_tpu_torch.data.dataset import TextLoader, build_tokenizer
from e2e_asr_tpu_torch.models import lm as tlm
from e2e_asr_tpu_torch.ops import rnn as trnn
from e2e_asr_tpu_torch.optim import Optimizer
from e2e_asr_tpu_torch.training.step import TrainState, param_leaves

torch.set_num_threads(1)
VOCAB = 12
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
LENS = [9, 4, 1, 7]
L_PAD = 9
TYING = [pytest.param(False, id="untied"), pytest.param(True, id="tied")]


def _cfg(tying, **hparas):
    d = {"lm": {"emb_tying": tying, "emb_dim": 16, "dim": 24, "n_layers": 2, "dropout": 0.0, "batch_size": 4},
         "hparas": {"optimizer": "Adam", "lr": 1e-3, "eps": 1e-8, "grad_clip": 5.0, **hparas}}
    return JConfig.from_dict(d), TConfig.from_dict(d)


def _models(tying, **hparas):
    jc, tc = _cfg(tying, **hparas)
    jp = jlm.lm_init(jax.random.PRNGKey(0), VOCAB, jc.lm)
    return jc, tc, jp, convert.params_from_jax(jax.device_get(jp))


def _text(seed=0):
    """[B, L] ids in [1, V) (<eos> = 1 among them) and ragged lengths, zero past each."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, VOCAB, size=(len(LENS), L_PAD)).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    for i, m in enumerate(lens):
        text[i, m:] = 0
    return text, lens


def _valid(lens, length):
    return np.arange(length)[None, :] < np.asarray(lens)[:, None]


def _close(got, want, rtol, atol_rel, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * max(float(np.abs(w).max()), 1e-6),
                                   err_msg=f"{what} leaf {i}")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("tying", TYING)
def test_lm_init_has_the_converted_jax_layout(tying):
    """The port's seeded lm_init builds the tree convert.py makes of the JAX
    lm_init pytree (same names and shapes; ``out`` or the tied ``out_proj``)
    with forget-gate biases 1 in every layer."""
    jc, tc, jp, tp = _models(tying)
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = tlm.lm_init(gen, VOCAB, tc.lm, torch.device("cpu"))
    assert _shapes(mine) == _shapes(tp)
    assert ("out_proj" in mine) == tying and ("out" in mine) != tying
    h = tc.lm.dim
    for cells in (mine["cells"], tp["cells"]):
        assert [tuple(c["wx"].shape) for c in cells] == [(16, 4 * h), (h, 4 * h)]
        for c in cells:
            assert torch.equal(c["b"][h : 2 * h], torch.ones(h))


def test_gru_lm_is_not_ported():
    _, tc = _cfg(False)
    tc.lm.module = "GRU"
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tlm.lm_init(torch.Generator(), VOCAB, tc.lm, torch.device("cpu"))


def test_lstm_matches_jax_scan():
    """ops/rnn.py lstm (one direction through lstm_seq's plain versions)
    against the JAX lstm's outputs, and the gradients of x, Wx, Wh and b of
    a weighted sum of them, with ragged lengths (one of 1)."""
    rng = np.random.RandomState(3)
    b, t, d, h = 4, 9, 10, 16
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    w = [((rng.rand(*s) * 2 - 1) / np.sqrt(h)).astype(np.float32) for s in ((d, 4 * h), (h, 4 * h), (4 * h,))]
    dy = rng.randn(b, t, h).astype(np.float32)

    def jloss(x, wx, wh, bias):
        ys = jrnn.lstm(x, jnp.asarray(lens), jrnn.LSTMWeights(wx, wh, bias))[0]
        return jnp.sum(ys * dy), ys

    (_, jys), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, w))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + w]
    ys = trnn.lstm(leaves[0], torch.from_numpy(lens), dict(zip(("wx", "wh", "b"), leaves[1:])))
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=VAL_RTOL, atol=VAL_ATOL)
    assert not ys.detach().numpy()[~_valid(lens, t)].any()  # zero past each length
    grads = torch.autograd.grad((ys * torch.from_numpy(dy)).sum(), leaves)
    _close(grads, jgrads, GRAD_RTOL, GRAD_ATOL_REL, "lstm grads")


@pytest.mark.parametrize("tying", TYING)
def test_apply_seq_matches_jax(tying):
    jc, tc, jp, tp = _models(tying)
    text, lens = _text()
    want = np.asarray(jlm.apply_seq(jp, jc.lm, jnp.asarray(text), jnp.asarray(lens)))
    got = tlm.apply_seq(tp, tc.lm, torch.from_numpy(text), torch.from_numpy(lens)).numpy()
    assert got.shape == (len(LENS), L_PAD, VOCAB)
    valid = _valid(lens, L_PAD)
    np.testing.assert_allclose(got[valid], want[valid], rtol=VAL_RTOL, atol=VAL_ATOL)


@pytest.mark.parametrize("tying", TYING)
def test_step_matches_jax_over_five_steps(tying):
    """step's log-probs and (h, c) state, fed its own previous state, for 5
    tokens from <sos>."""
    jc, tc, jp, tp = _models(tying)
    toks = np.random.RandomState(1).randint(0, VOCAB, size=(5, 6))
    toks[0] = 0
    jstate, tstate = jlm.init_state(6, jc.lm), tlm.init_state(6, tc.lm, torch.device("cpu"))
    for tok in toks:
        jlp, jstate = jlm.step(jp, jc.lm, jnp.asarray(tok), jstate)
        tlp, tstate = tlm.step(tp, tc.lm, torch.from_numpy(tok), tstate)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=VAL_RTOL, atol=VAL_ATOL)
        for g, w in zip(tstate, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VAL_RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(torch.exp(tlp).sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("tying", TYING)
def test_lm_loss_and_every_gradient_match_jax(tying):
    jc, tc, jp, tp = _models(tying)
    text, lens = _text(2)
    (jl, jm), jg = jax.value_and_grad(jtrain_lm.lm_loss, has_aux=True)(
        jp, jc, jnp.asarray(text), jnp.asarray(lens), None, False)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = train_lm.lm_loss(tp, tc.lm, torch.from_numpy(text), torch.from_numpy(lens), None, False)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=VAL_RTOL, atol=VAL_ATOL)
    assert float(m["n_tokens"]) == float(jm["n_tokens"]) == sum(LENS)
    _close(grads, param_leaves(convert.params_from_jax(jax.device_get(jg))), GRAD_RTOL, GRAD_ATOL_REL,
           "lm grads")


def _close_adam_params(got, want, p0, g, lr):
    """Adam's first update is lr * g / (|g| + eps): where |g| is near the
    gradient's rounding (1e-6 here) its sign and size follow the rounding,
    so there only |update| <= lr is checked; elsewhere the parameters agree
    to rtol 2e-5, atol 1e-6."""
    for p, w, q, gj in zip(got, want, p0, g):
        p, big = p.detach(), gj.abs() > 1e-6
        np.testing.assert_allclose(p[big].numpy(), w[big].numpy(), rtol=2e-5, atol=1e-6)
        assert float((p - q).abs().max()) <= lr * (1 + 1e-5)


@pytest.mark.parametrize("tying", TYING)
def test_train_step_matches_jax(tying):
    """One train_lm step (Adam, clip 0.1: the clip is on) against the JAX
    solver's step: loss, pre-clip gradient norm, Adam's moments and the
    updated parameters."""
    jc, tc, jp, tp = _models(tying, grad_clip=0.1)
    text, lens = _text(4)
    tx = build_optimizer(jc.hparas)
    (jl, jm), jg = jax.value_and_grad(jtrain_lm.lm_loss, has_aux=True)(
        jp, jc, jnp.asarray(text), jnp.asarray(lens), None, True)
    jgnorm = float(optax.global_norm(jg))
    updates, jopt = tx.update(jg, tx.init(jp), jp)
    jnew = optax.apply_updates(jp, updates)

    p0 = [p.clone() for p in param_leaves(tp)]
    for p in param_leaves(tp):
        p.requires_grad_(True)
    opt = Optimizer(tc.hparas)
    state = TrainState(tp, opt.init(param_leaves(tp)), 0)
    m = train_lm.train_step(state, opt, tc.lm,
                            {"text": torch.from_numpy(text), "text_len": torch.from_numpy(lens)}, None)
    assert float(m["step_skipped"]) == 0.0 and state.step == 1 and state.opt_state["count"] == 1
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=VAL_RTOL, atol=VAL_ATOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jgnorm, rtol=GRAD_RTOL)
    assert float(m["grad_norm"]) > tc.hparas.grad_clip
    leaves = lambda tree: param_leaves(convert.params_from_jax(jax.device_get(tree)))  # noqa: E731
    mu, nu = jopt[1].mu, jopt[1].nu
    _close(state.opt_state["mu"], leaves(mu), GRAD_RTOL, GRAD_ATOL_REL, "mu")
    _close(state.opt_state["nu"], leaves(nu), GRAD_RTOL, GRAD_ATOL_REL, "nu")
    g = [10.0 * x for x in leaves(mu)]  # mu = 0.1 clipped g
    _close_adam_params(param_leaves(state.params), leaves(jnew), p0, g, tc.hparas.lr)


def test_a_non_finite_step_keeps_params_and_opt_state(monkeypatch):
    """A step whose loss is not finite leaves the parameters and the whole
    optimizer state (moments and counts) bit for bit as they were, counts
    the step and reports ``step_skipped`` 1; the next finite step trains.
    (The JAX LM step keeps the parameters but advances the optimizer state;
    the port keeps both, as the JAX ASR step does: ROADMAP Queue 3.)"""
    _, tc, _, tp = _models(False)
    text, lens = _text(4)
    batch = {"text": torch.from_numpy(text), "text_len": torch.from_numpy(lens)}
    for p in param_leaves(tp):
        p.requires_grad_(True)
    opt = Optimizer(tc.hparas)
    state = TrainState(tp, opt.init(param_leaves(tp)), 0)
    train_lm.train_step(state, opt, tc.lm, batch, None)  # a real step first: moments not all zero
    params0 = [p.detach().clone() for p in param_leaves(state.params)]
    opt0 = {k: [t.clone() for t in param_leaves(v)] for k, v in state.opt_state.items()}
    loss_fn = train_lm.lm_loss

    def inf_loss(*args, **kw):
        loss, metrics = loss_fn(*args, **kw)
        return loss * float("inf"), metrics

    monkeypatch.setattr(train_lm, "lm_loss", inf_loss)
    m = train_lm.train_step(state, opt, tc.lm, batch, None)
    assert float(m["step_skipped"]) == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert state.step == 2
    assert all(torch.equal(p.detach(), q) for p, q in zip(param_leaves(state.params), params0))
    for k, v in opt0.items():
        assert all(torch.equal(a, b) for a, b in zip(param_leaves(state.opt_state[k]), v)), k
    assert int(state.opt_state["count"]) == int(state.opt_state["sched_count"]) == 1
    monkeypatch.undo()
    m = train_lm.train_step(state, opt, tc.lm, batch, None)
    assert float(m["step_skipped"]) == 0.0 and int(state.opt_state["count"]) == 2
    assert any(not torch.equal(p.detach(), q) for p, q in zip(param_leaves(state.params), params0))


def _loaders(cls, build, corpus_mod, **kw):
    cfg = TConfig.from_dict({"data": {"text": {"mode": "character"}}}).data
    utts = corpus_mod.load_corpus("synthetic", "", ["train:45"])
    tok = build(cfg, utts)
    return cls(utts, tok, 4, token_buckets=(24, 40, 64), **kw)


@pytest.mark.parametrize("shuffle,index,count", [
    pytest.param(True, 0, 1, id="shuffled"),
    pytest.param(False, 0, 1, id="in-order"),
    pytest.param(True, 0, 2, id="process0of2"),
    pytest.param(True, 1, 2, id="process1of2"),
])
def test_text_loader_matches_jax(shuffle, index, count):
    """TextLoader gives the JAX loader's batches, batch for batch, over two
    epochs: the buckets, the per-bucket batches padded to one size, the
    shuffle by RandomState(seed + epoch), and each process's block of
    rows."""
    kw = dict(shuffle=shuffle, seed=3, process_index=index, process_count=count)
    jl = _loaders(JTextLoader, jbuild_tokenizer, jcorpus, **kw)
    tl = _loaders(TextLoader, build_tokenizer, corpus, **kw)
    assert len(tl) == len(jl) > 4
    for e in (0, 1):
        got, want = list(tl.epoch(e)), list(jl.epoch(e))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    it, jit_ = tl.forever(), jl.forever()
    for _ in range(len(tl) + 2):  # into the second epoch
        np.testing.assert_array_equal(next(it)["text"], next(jit_)["text"])


def test_lm_solver_trains_and_improves(tmp_path):
    """The port's LM solver on the CPU, as the JAX package's solver test:
    31 steps of Adam on synthetic transcripts bring the dev perplexity
    under 30, and best_ppl, latest and tokenizer.vocab are written."""
    cfg = TConfig.from_dict({
        "data": {"corpus": {"name": "synthetic", "train_split": ["train:64"], "dev_split": ["dev:16"]},
                 "text": {"mode": "character"}},
        "hparas": {"valid_step": 30, "max_step": 31, "optimizer": "Adam", "lr": 3e-3, "log_step": 10},
        "lm": {"emb_dim": 32, "dim": 48, "n_layers": 1, "batch_size": 8, "dropout": 0.0},
    })
    paras = types.SimpleNamespace(config="lm.yaml", name="lm", logdir=str(tmp_path / "log"),
                                  ckpdir=str(tmp_path / "ckpt"), load=None, seed=0, cpu=True, verbose=False)
    s = train_lm.Solver(cfg, paras, "train")
    s.load_data()
    s.set_model()
    s.exec()
    assert s.best_ppl < 30, f"LM ppl did not improve: {s.best_ppl}"
    for f in ("best_ppl", "latest", "tokenizer.vocab"):
        assert os.path.isfile(os.path.join(s.ckpdir, f)), f
    payload = convert.load_checkpoint(os.path.join(s.ckpdir, "latest"), torch.device("cpu"), kind="lm")
    assert (payload["vocab_size"], payload["feat_dim"], payload["step"]) == (s.vocab_size, 0, 31)
    assert all(r["step_skipped"] == 0.0 and np.isfinite(r["loss"]) for r in s.step_log)
    with pytest.raises(ValueError, match="kind 'lm'"):
        convert.load_checkpoint(os.path.join(s.ckpdir, "best_ppl"), torch.device("cpu"))
