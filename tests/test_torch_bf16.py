"""The port at the bfloat16 compute type (``hparas.dtype: bfloat16``, every
shipped training recipe's) against the JAX package at bfloat16, on the CPU.

The model and batch are ``tests/test_torch_train.py``'s, weights from JAX
``asr_init`` carried over by ``convert.params_from_jax``. JAX's encoder runs
its Pallas kernels in interpret mode (``E2E_RNN_IMPL``), by the route the
port's ``encoder.rnn_impl`` names: ``lstm_seq`` (port ``pallas_xw``, the
default ``auto``) on a recipe without a prenet, whose layer widths are not
lane-aligned (JAX then takes ``lstm_seq`` for every layer), and the fused
layer (port ``pallas``) on the VGG recipe 64 units wide (JAX takes the fused
kernel for every layer whose input and gate widths are multiples of 128).
The speller runs either as the Python loop (``decoder.fused_scan: scan``)
against JAX's ``lax.scan``, or as the fused scan (``pallas``: the port's
plain versions) against JAX's ``decoder_scan_fused`` in interpret mode.

Both sides get the same features: the port's step takes JAX's log-mel
features (the frontend stays float32 in both and is held elsewhere; their
last-bit differences would flip 0.4% of the bfloat16 features).

From the same bf16 features the encoder and the CTC head give JAX's values
bit for bit on the ``lstm_seq`` route. What shows that the port rounds
where the reference rounds elsewhere (HALF): its
distance from JAX at bfloat16 is at most half of JAX's own distance between
float32 and bfloat16, for the joint and the CTC loss (the attention loss
moves ~1e-4 between the two types: ATT_LOSS_ATOL instead) and for every
output and gradient of each kernel module (the plain versions against the
Pallas kernels in interpret mode). For compute_loss's gradient as one
vector the bound is a whole such distance (GRAD_VEC), not half: JAX's
autodiff sums its bfloat16 cotangents (the bias gradients, the transposes
of broadcasts) on XLA's CPU backend rounding to bfloat16 after every add,
where the port sums them in float32, so the two differ by about one
rounding point there whatever the kernels do. The speller's gradients on
the fused scan, whose sums run in float32 on both sides (its kernels and
their VJPs), are held to HALF. That the port does round is
shown by its distance from JAX's float32 gradient (at least ROUNDS of JAX's
own float32-to-bfloat16 distance; the port at float32 sits ~1e-6 of it).
Per leaf (bfloat16 stores 8 significant bits, 2^-8 = 0.39% relative a
rounding): each gradient's distance from JAX's within LEAF_RTOL of its
norm; the attention's leaves, whose gradients nearly cancel at tf 1.0
(``proj_q``, ``loc_b``, ``loc_conv.b`` are 1e-5 of the largest leaf and their
bfloat16 gradients several times their float32 ones), within a floor of
NEAR_ZERO_REL of the largest leaf's norm instead.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu.ops import decoder_pallas, rnn_pallas
from e2e_asr_tpu.optim import build_optimizer
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.ops import decoder_cuda, rnn_cuda
from e2e_asr_tpu_torch.training.step import Trainer, compute_loss, param_leaves
from tests.test_torch_train import _batch, _cfg_dict, _gen, _jbatch, _tbatch
from tests.torch_parity import FEAT_DIM, VOCAB

torch.set_num_threads(1)
BF16 = torch.bfloat16
HALF = 0.5
GRAD_VEC, ROUNDS = 1.0, 0.25
LEAF_RTOL = 0.05
NEAR_ZERO_REL = 1e-4
ATT_LOSS_ATOL = 1e-3
PRED_AGREE = 0.95
GN_RTOL = 2.0 ** -7  # two bfloat16 roundings

ENCODERS = {
    # port rnn_impl, JAX E2E_RNN_IMPL, encoder section
    "lstm_seq": ("pallas_xw", "pallas_xw", {
        "prenet": "", "dim": [32, 32], "dropout": [0.0, 0.0], "layer_norm": [False, False],
        "proj": [True, True], "sample_rate": [2, 2], "sample_style": "drop"}),
    "fused": ("pallas", "pallas", {
        "prenet": "vgg", "dim": [64, 64], "dropout": [0.0, 0.0], "layer_norm": [False, False],
        "proj": [True, True], "sample_rate": [1, 1], "sample_style": "drop"}),
}
SPELLERS = {"loop": "scan", "kernel": "pallas"}


def _recipe(encoder, speller, dtype="bfloat16"):
    """(JAX config, port config) of the test recipe."""
    impl, _, enc = ENCODERS[encoder]
    d = _cfg_dict()
    d["hparas"]["dtype"] = dtype
    d["model"]["encoder"] = copy.deepcopy(enc)
    d["model"]["decoder"]["fused_scan"] = SPELLERS[speller]
    jc = JConfig.from_dict(d)
    d["model"]["encoder"]["rnn_impl"] = impl
    return jc, TConfig.from_dict(d)


def _jax_env(monkeypatch, rnn_impl):
    monkeypatch.setenv("E2E_RNN_IMPL", rnn_impl)
    monkeypatch.setenv("E2E_CTC_IMPL", "pallas")


def _leaf_names(tree, prefix=""):
    """Dotted names of the port's parameter leaves, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


@functools.lru_cache(maxsize=None)
def _jax_grads(encoder, speller, dtype, rnn_impl):
    """JAX compute_loss at tf 1.0: (losses, gradient leaves as numpy in the
    port's order). Cached: the tests of this file share them."""
    import os

    old = {k: os.environ.get(k) for k in ("E2E_RNN_IMPL", "E2E_CTC_IMPL")}
    os.environ["E2E_CTC_IMPL"] = "pallas"
    os.environ["E2E_RNN_IMPL"] = rnn_impl
    try:
        jc, _ = _recipe(encoder, speller, dtype)
        jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
        b = _jbatch(_batch())

        def loss(p):
            return jstep.compute_loss(p, jc, b["wav"], b["wav_len"], b["text"], b["text_len"], 1.0,
                                      jax.random.PRNGKey(1), train=True)

        (_, m), g = jax.value_and_grad(loss, has_aux=True)(jp)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = {k: float(m[k]) for k in ("loss", "att_loss", "ctc_loss")}
    leaves = [t.numpy() for t in param_leaves(convert.params_from_jax(jax.device_get(g)))]
    return losses, leaves


@functools.lru_cache(maxsize=None)
def _jax_features(encoder):
    """JAX's features of the test batch (its Pallas frontend, interpret mode)."""
    from e2e_asr_tpu.ops.frontend import compute_features

    jc, _ = _recipe(encoder, "loop")
    b = _batch()
    f, fl = compute_features(jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]), jc.data.audio)
    return np.array(f), np.array(fl)


def _same_features(monkeypatch, encoder):
    """The port's step computes JAX's features."""
    from e2e_asr_tpu_torch.training import step

    f, fl = _jax_features(encoder)
    monkeypatch.setattr(step, "compute_features",
                        lambda *a, **k: (torch.from_numpy(f.copy()), torch.from_numpy(fl.copy())))


def _port_params(encoder, speller):
    jc, tc = _recipe(encoder, speller)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    return tc, convert.params_from_jax(jax.device_get(jp))


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in leaves])


def _dist(a, b):
    return float(np.linalg.norm(_flat(a) - _flat(b)))


def _check_leaves(got, want, names):
    """Each leaf within LEAF_RTOL of its norm; the attention's leaves within
    a floor of NEAR_ZERO_REL of the largest leaf's norm."""
    norm = lambda x: float(np.linalg.norm(np.asarray(x, np.float64)))
    top = max(norm(w) for w in want)
    for g, w, n in zip(got, want, names):
        floor = NEAR_ZERO_REL * top if n.startswith("attention.") else 0.0
        assert norm(g - w) <= LEAF_RTOL * norm(w) + floor, (n, norm(g - w), norm(w), floor)


@pytest.mark.parametrize("speller", list(SPELLERS))
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_compute_loss_and_gradients_match_jax_at_bf16(encoder, speller, monkeypatch):
    """compute_loss at bf16, tf 1.0: the three losses and every gradient
    against JAX's at bf16 (HALF on the losses, GRAD_VEC and ROUNDS on the
    gradient, per leaf); the encoder's output, the logits and the CTC
    log-probs are bf16, the loss and the gradients float32."""
    _, jax_impl, _ = ENCODERS[encoder]
    want_l, want_g = _jax_grads(encoder, speller, "bfloat16", jax_impl)
    f32_l, f32_g = _jax_grads(encoder, speller, "float32", jax_impl)
    tc, tp = _port_params(encoder, speller)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = _tbatch(_batch())
    _same_features(monkeypatch, encoder)
    from e2e_asr_tpu_torch.models import asr as tasr

    seen = {}
    real_heads = tasr.heads  # compute_loss: encode, then the heads

    def heads(*a, **k):
        out = real_heads(*a, **k)
        seen.update({n: out[n].dtype for n in ("att_logits", "ctc_log_probs", "enc")})
        return out

    monkeypatch.setattr(tasr, "heads", heads)
    tl, tm = compute_loss(tp, tc, tb["wav"], tb["wav_len"], tb["text"], tb["text_len"], 1.0, _gen(),
                          train=True)
    assert seen == {"att_logits": BF16, "ctc_log_probs": BF16, "enc": BF16}
    grads = [g.numpy() for g in torch.autograd.grad(tl, leaves)]
    assert all(g.dtype == np.float32 for g in grads)
    got_l = {k: float(tm[k].detach()) for k in ("loss", "att_loss", "ctc_loss")}
    assert tm["loss"].dtype == torch.float32

    assert abs(got_l["loss"] - want_l["loss"]) <= HALF * abs(f32_l["loss"] - want_l["loss"]), (
        got_l, want_l, f32_l)
    assert abs(got_l["att_loss"] - want_l["att_loss"]) <= ATT_LOSS_ATOL
    assert abs(got_l["ctc_loss"] - want_l["ctc_loss"]) <= HALF * abs(f32_l["ctc_loss"] - want_l["ctc_loss"])
    d_port, d_dtype = _dist(grads, want_g), _dist(f32_g, want_g)
    assert d_port <= GRAD_VEC * d_dtype, (d_port, d_dtype)
    assert _dist(grads, f32_g) >= ROUNDS * d_dtype, (_dist(grads, f32_g), d_dtype)
    names = _leaf_names(tp)
    _check_leaves(grads, want_g, names)
    if speller == "kernel":  # the fused scan's gradients, its own sums in float32 on both sides: HALF
        sp = [i for i, n in enumerate(names) if n.split(".")[0] in ("attention", "decoder", "embed")]
        pick = lambda leaves: [leaves[i] for i in sp]
        assert _dist(pick(grads), pick(want_g)) <= HALF * _dist(pick(f32_g), pick(want_g))


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_eval_step_matches_jax_at_bf16(encoder, monkeypatch):
    """make_eval_step at bf16 (the fused speller): HALF on the joint and the
    CTC loss, ATT_LOSS_ATOL on the attention loss, and both heads' argmax
    equal on at least PRED_AGREE of the tokens."""
    _, jax_impl, _ = ENCODERS[encoder]
    _jax_env(monkeypatch, jax_impl)
    jc, tc = _recipe(encoder, "kernel")
    jc32, _ = _recipe(encoder, "kernel", "float32")
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    b = _batch()
    want = jstep.make_eval_step(jc)(jp, _jbatch(b))
    f32 = jstep.make_eval_step(jc32)(jp, _jbatch(b))
    _same_features(monkeypatch, encoder)
    got = Trainer(tc).eval_step(convert.params_from_jax(jax.device_get(jp)), _tbatch(b))
    for k in ("loss", "ctc_loss"):
        assert abs(float(got[k]) - float(want[k])) <= HALF * abs(float(f32[k]) - float(want[k])), k
    assert abs(float(got["att_loss"]) - float(want["att_loss"])) <= ATT_LOSS_ATOL
    for k in ("att_preds", "ctc_preds"):
        assert np.mean(got[k].numpy() == np.asarray(want[k])) >= PRED_AGREE, k


def test_train_step_matches_jax_at_bf16(monkeypatch):
    """One Adadelta train_step at bf16 (lstm_seq encoder, fused speller):
    loss (HALF), the pre-clip grad norm (GN_RTOL: a norm of the gradient,
    which GRAD_VEC bounds) and the parameter update as one vector
    (GRAD_VEC); parameters and the optimizer state stay float32."""
    _jax_env(monkeypatch, "pallas_xw")
    runs = {}
    for dtype in ("bfloat16", "float32"):
        jc, _ = _recipe("lstm_seq", "kernel", dtype)
        jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
        tx = build_optimizer(jc.hparas)
        jstate = jstep.TrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
        jnew, jm = jstep.make_train_step(jc, tx)(jstate, _jbatch(_batch()), jax.random.PRNGKey(1))
        runs[dtype] = ([t.numpy() for t in param_leaves(convert.params_from_jax(jax.device_get(jnew.params)))],
                       float(jm["loss"]), float(jm["grad_norm"]))
    _same_features(monkeypatch, "lstm_seq")
    tc, tp = _port_params("lstm_seq", "kernel")
    p0 = [p.detach().clone().numpy() for p in param_leaves(tp)]
    trainer = Trainer(tc)
    state = trainer.init_state(tp)
    tm = trainer.train_step(state, _tbatch(_batch()), _gen())
    assert float(tm["step_skipped"]) == 0.0
    params = [p.detach().numpy() for p in param_leaves(state.params)]
    assert all(p.dtype == np.float32 for p in params)
    assert all(t.dtype == torch.float32 for f in ("e_g", "e_x") for t in state.opt_state[f])
    want, f32 = runs["bfloat16"], runs["float32"]
    assert abs(float(tm["loss"]) - want[1]) <= HALF * abs(f32[1] - want[1])
    assert abs(float(tm["grad_norm"]) - want[2]) <= GN_RTOL * want[2]
    upd = lambda ps: [p - q for p, q in zip(ps, p0)]
    assert _dist(upd(params), upd(want[0])) <= GRAD_VEC * _dist(upd(f32[0]), upd(want[0]))


# ------------------------------------------------- (d) each kernel module
def _bf(a):
    """numpy float32 -> (the bfloat16 values as a JAX bfloat16 array, as a
    JAX float32 array, as a torch bfloat16 tensor)."""
    t = torch.from_numpy(a).to(BF16)
    f = t.float().numpy()
    return jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(f), t


def _half(got, want_bf, want_f32, what):
    """HALF on each output, and the port's output in bfloat16 where JAX's is."""
    for i, (g, w, f) in enumerate(zip(got, want_bf, want_f32)):
        assert (g.dtype == BF16) == (w.dtype == jnp.bfloat16), (what, i, g.dtype, w.dtype)
        g = g.detach().float().numpy()
        w, f = np.asarray(w, np.float32), np.asarray(f, np.float32)
        assert g.shape == w.shape, (what, i)
        d_port, d_dtype = np.linalg.norm(g - w), np.linalg.norm(f - w)
        assert d_port <= HALF * d_dtype, (what, i, d_port, d_dtype)


@pytest.mark.parametrize("dirs", [1, 2])
def test_lstm_seq_plain_matches_pallas_at_bf16(dirs):
    """lstm_seq forward (ys, c) and VJP (dxw, dWh) at bf16: the plain
    versions against the Pallas kernel in interpret mode (HALF); acts stay
    float32."""
    rng = np.random.RandomState(0)
    t, bsz, h = 13, 3, 16
    r = dirs * bsz
    lens = np.asarray([13, 9, 4] * dirs)
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    xw, wh, dy = (_bf(a) for a in (rng.randn(t, r, 4 * h).astype(np.float32),
                                  (rng.randn(dirs, h, 4 * h) * 0.3).astype(np.float32),
                                  rng.randn(t, r, h).astype(np.float32)))
    jm = jnp.asarray(mask)
    outs = {}
    for k in (0, 1):  # bfloat16, float32
        fwd = rnn_pallas._lstm_seq_fwd_call(xw[k], jm, wh[k])
        _, vjp = jax.vjp(lambda a, w: rnn_pallas.lstm_seq(a, jm, w), xw[k], wh[k])
        outs[k] = list(fwd) + list(vjp(dy[k]))
    tm = torch.from_numpy(mask)
    ys, c, acts = rnn_cuda.lstm_seq_fwd(xw[2], tm, wh[2], train=True)
    assert acts.dtype == torch.float32
    dxw, dwh = rnn_cuda.lstm_seq_bwd(tm, wh[2], ys, c, acts, dy[2])
    _half([ys, c, dxw, dwh], outs[0], outs[1], "lstm_seq")


def test_lstm_seq_fused_plain_matches_pallas_at_bf16():
    """The fused layer's forward (ys, c, acts) and VJP (dx, dWx, dWh, db) at
    bf16: the plain versions against the Pallas kernel in interpret mode
    (HALF)."""
    rng = np.random.RandomState(1)
    t, bsz, d, h = 16, 3, 24, 16
    lens = np.asarray([16, 11, 5])
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    x, wx, wh, b, dy = (_bf(a) for a in (rng.randn(t, bsz, d).astype(np.float32),
                                         (rng.randn(2, d, 4 * h) * 0.2).astype(np.float32),
                                         (rng.randn(2, h, 4 * h) * 0.3).astype(np.float32),
                                         (rng.randn(2, 4 * h) * 0.1).astype(np.float32),
                                         rng.randn(t, 2 * bsz, h).astype(np.float32)))
    jm = jnp.asarray(mask)
    outs = {}
    for k in (0, 1):
        fwd = rnn_pallas._fused_fwd_call(x[k], jm, wx[k], wh[k], b[k])
        _, vjp = jax.vjp(lambda *a: rnn_pallas.lstm_seq_fused(a[0], jm, *a[1:]), x[k], wx[k], wh[k], b[k])
        outs[k] = list(fwd) + list(vjp(dy[k]))
    tm = torch.from_numpy(mask)
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train(x[2], tm, wx[2], wh[2], b[2])
    grads = rnn_cuda.lstm_bidir_bwd(x[2], tm, wx[2], wh[2], ys, c, acts, dy[2])
    _half([ys, c, acts, *grads], outs[0], outs[1], "lstm_seq_fused")


@pytest.mark.parametrize("feedback", ["teacher", "argmax"])
def test_decoder_scan_plain_matches_pallas_at_bf16(feedback):
    """The fused speller scan at bf16 through ``run_decode_scan`` on both
    sides (the port's plain versions, JAX's decoder_scan_fused in interpret
    mode): logits, alignments and hidden states (bf16), and the gradients of
    the encoder output (bf16) and of every parameter of the attention, the
    speller and the embedding (float32), of a loss on all three outputs;
    HALF on each. Teacher forcing (every coin true) and argmax feedback
    (every coin false)."""
    from tests.test_torch_decoder_scan import inputs, models, model_cfg

    jc, tc, jp, tp = models(model_cfg(), "pallas")
    rng = np.random.RandomState(4)
    b, s, l = 2, 19, 11
    _, _, teacher = inputs(lens=(37, 28), t=37, l=l)
    enc_len = np.asarray([19, 14], np.int32)
    enc = (rng.randn(b, s, 16) * 0.5).astype(np.float32)
    enc[1, 14:] = 0.0
    teacher_in = np.concatenate([np.zeros((b, 1), np.int32), teacher[:, :-1]], axis=1)
    coins = np.full((l,), feedback == "teacher")
    parts = ("attention", "decoder", "embed")

    def jloss(p, e):
        lg, al, hid = decoder_pallas.run_decode_scan(
            p, jc, e, jnp.asarray(enc_len), jnp.asarray(teacher_in), jnp.asarray(coins),
            jax.random.PRNGKey(0), train=True, sample_decoding=False)
        return jnp.sum(lg.astype(jnp.float32) ** 2) + jnp.sum(al.astype(jnp.float32)) + jnp.sum(
            jnp.tanh(hid.astype(jnp.float32))), (lg, al, hid)

    outs = {}
    for k, dt in ((0, jnp.bfloat16), (1, jnp.float32)):
        e = jnp.asarray(torch.from_numpy(enc).to(BF16).float().numpy()).astype(dt)
        (_, fwd), (gp, ge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jp, e)
        gp = convert.params_from_jax(jax.device_get({n: gp[n] for n in parts}))
        outs[k] = list(fwd) + [ge] + [jnp.asarray(t.numpy()) for t in param_leaves(gp)]
    leaves = param_leaves({n: tp[n] for n in parts})
    for p in leaves:
        p.requires_grad_(True)
    te = torch.from_numpy(enc).to(BF16).requires_grad_(True)
    lg, al, hid = decoder_cuda.run_decode_scan(tp, tc, te, torch.from_numpy(enc_len),
                                               torch.from_numpy(teacher_in).long(), torch.from_numpy(coins),
                                               generator=_gen(), train=True, sample_decoding=False)
    loss = (lg.float() ** 2).sum() + al.float().sum() + torch.tanh(hid.float()).sum()
    grads = torch.autograd.grad(loss, [te] + leaves)
    assert all(g.dtype == torch.float32 for g in grads[1:])
    _half([lg, al, hid, *grads], outs[0], outs[1], f"decoder_scan {feedback}")


def test_a_left_out_rounding_point_is_told_apart_from_noise():
    """The card's kernel-against-plain check at bf16 (chip_smoke
    ``_bf16_state``: at most BF16_ULPS ulp of the tensor's scale apart on at
    most BF16_SHARE of the elements) tells a different rounding point from
    float32 noise: lstm_seq's plain version at bf16 (T=200, B=8, H=128, two
    directions) against itself with its gates perturbed by 1e-7 relative
    (sums in another order) differs on less than BF16_SHARE of ys, at one
    ulp; the same recurrence with h or c carried unrounded differs on more
    than BF16_SHARE."""
    from chip_smoke import BF16_SHARE, BF16_ULPS

    gen = torch.Generator()
    gen.manual_seed(0)
    t, b, h = 200, 8, 128
    r = 2 * b
    xw = (torch.randn((t, r, 4 * h), generator=gen) * 0.5).to(BF16)
    wh = (torch.randn((2, h, 4 * h), generator=gen) / h ** 0.5).to(BF16)
    mask = torch.ones((t, r))
    ys = rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)[0]

    def variant(noise=0.0, round_h=True, round_c=True):
        hh, cc, out = torch.zeros((r, h)), torch.zeros((r, h)), []
        for k in range(t):
            g = xw[k].float() + torch.bmm(hh.view(2, b, h), wh.float()).view(r, -1)
            g = g * (1 + noise * torch.randn(g.shape, generator=gen))
            i, f, gg, o = g.chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(gg)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            hh = h2.to(BF16).float() if round_h else h2
            cc = c2.to(BF16).float() if round_c else c2
            out.append(h2.to(BF16))
        return torch.stack(out)

    share = lambda y: float((y != ys).float().mean())
    ulp = 2.0 ** (np.floor(np.log2(float(ys.float().abs().max()))) - 7)
    noisy = variant(noise=1e-7)
    assert share(noisy) <= BF16_SHARE
    assert float((noisy.float() - ys.float()).abs().max()) <= BF16_ULPS * ulp
    assert share(variant(round_h=False)) > BF16_SHARE
    assert share(variant(round_c=False)) > BF16_SHARE


def test_encoder_and_ctc_head_forward_bitwise_at_bf16(monkeypatch):
    """From the same bf16 features, the encoder (the lstm_seq route: the
    projections, the plain lstm_seq at the TPU kernel's rounding points, the
    tanh projections) and the CTC head's log-softmax give JAX's bf16 values
    bit for bit: the rounding points are the same, not merely close."""
    _jax_env(monkeypatch, "pallas_xw")
    jc, tc = _recipe("lstm_seq", "loop")
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    tp = convert.params_from_jax(jax.device_get(jp))
    f, fl = _jax_features("lstm_seq")
    b = _batch()
    jo = jasr.forward(jp, jc.model, jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(fl), b["text"].shape[1],
                      teacher=jnp.asarray(b["text"]), rng=jax.random.PRNGKey(2), train=False)
    from e2e_asr_tpu_torch.models import asr as tasr

    to = tasr.forward(tp, tc.model, torch.from_numpy(f).to(BF16), torch.from_numpy(fl), b["text"].shape[1],
                      teacher=torch.from_numpy(b["text"]), train=False)
    for k in ("enc", "ctc_log_probs"):
        assert to[k].dtype == BF16
        np.testing.assert_array_equal(to[k].float().numpy(), np.asarray(jo[k].astype(jnp.float32)), err_msg=k)
