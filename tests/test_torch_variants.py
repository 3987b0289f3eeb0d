"""The port's encoder and speller variants against the JAX package's: the
CNN prenet, GRU layers (one direction and two), LSTM layers with one
direction, a GRU speller and a GRU LM fused into the beam search.

Two test-size variants of the flagship structure (tests/torch_parity.py):
V1 (CNN prenet, bidirectional GRU layers, GRU speller) and V2 (VGG prenet,
one-direction LSTM layers, LSTM speller). Weights are JAX's (``asr_init``
/ ``lm_init``) carried over by ``convert.params_from_jax``; inputs are
seeded numpy. The JAX side runs its XLA paths (a GRU is a ``lax.scan``
under every impl; a one-direction LSTM layer too).

Tolerances (float32): values rtol 1e-4 / atol 1e-5; losses rtol 1e-5 and
gradients rtol 1e-4 with atol 1e-4 of the tensor's largest entry, the
bounds of tests/test_torch_train.py, with its absolute floor of 1e-9 for
gradients that cancel to ~1e-7 (the attention bias ``loc_b``, whose
gradient is a sum over L*B*S terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.config import LMConfig as JLMConfig
from e2e_asr_tpu.decode.beam import beam_search as jbeam
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu.models import decoder as jdec
from e2e_asr_tpu.models import encoder as jenc
from e2e_asr_tpu.models import layers as jL
from e2e_asr_tpu.models import lm as jlm
from e2e_asr_tpu.ops import rnn as jrnn
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.decode.beam import beam_search
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.models import decoder as tdec
from e2e_asr_tpu_torch.models import encoder as tenc
from e2e_asr_tpu_torch.models import layers as tL
from e2e_asr_tpu_torch.ops import rnn as trnn
from e2e_asr_tpu_torch.training.step import compute_loss, param_leaves
from tests.torch_parity import FEAT_DIM, VOCAB, small_config

torch.set_num_threads(1)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
RTOL, ATOL_REL = 1e-4, 1e-4
LENS = [9, 1, 6, 4]  # ragged, one of length 1


def variant(name: str, **extra) -> dict:
    """The test-size config of a variant: V1 (CNN prenet, BiGRU layers, GRU
    speller) or V2 (VGG prenet, one-direction LSTM layers, LSTM speller);
    dither 0, SpecAugment off, teacher forcing 1.0."""
    d = small_config()
    d["data"]["audio"].update(dither=0.0)
    d["hparas"] = dict(dtype="float32", tf_start=1.0, tf_end=1.0, optimizer="Adadelta", lr=1.0, eps=1e-8)
    d["model"]["specaugment"] = {"enable": False}
    enc, dec = d["model"]["encoder"], d["model"]["decoder"]
    if name == "V1":
        enc.update(prenet="cnn", module="GRU", bidirection=True)
        dec.update(module="GRU")
    else:
        enc.update(prenet="vgg", module="LSTM", bidirection=False)
    for k, v in extra.items():
        d["model"][k] = {**d["model"].get(k, {}), **v}
    return d


def models(d: dict, seed: int = 0):
    jc, tc = JConfig.from_dict(d), TConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(seed), FEAT_DIM, VOCAB, jc.model)
    return jc, tc, jp, convert.params_from_jax(jax.device_get(jp))


def _padded(b, t, d, lens, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    return x, np.asarray(lens, np.int32)


def _close(got, want, what, floor=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        tol = max(ATOL_REL * max(float(np.abs(w).max()), 1e-6), floor)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=tol, err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("t", [40, 41])
def test_cnn_prenet_matches_jax(t):
    """The CNN prenet (two stride-2 convolutions, 3 taps) at an even and an
    odd T: JAX's SAME padding puts (0, 1) frames around an even T and (1, 1)
    around an odd one; the frames are ceil(ceil(T/2)/2), the lengths T // 4."""
    jp, _ = jenc.cnn_init(jax.random.PRNGKey(3), FEAT_DIM, 16)
    tp = convert.params_from_jax(jax.device_get(jp))
    assert tuple(tp["conv1"]["w"].shape) == (16, FEAT_DIM, 3)  # OIW
    x, lens = _padded(2, t, FEAT_DIM, [t, t - 7], seed=t)
    jy, jl = jenc.cnn_apply(jp, jnp.asarray(x), jnp.asarray(lens))
    ty, tl = tenc.cnn_apply(tp, torch.from_numpy(x), torch.from_numpy(lens))
    assert ty.shape[1] == -(-(-(-t // 2)) // 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("which", ["gru", "bidir"])
def test_gru_and_its_gradients_match_jax(which):
    """``gru`` and ``bidir(cell="gru")`` with ragged lengths (one of length
    1): outputs (zero past each length) and the gradients of x and every
    weight under a random cotangent."""
    d, h = 6, 8
    ks = jax.random.split(jax.random.PRNGKey(7), 2)
    jw = [jL.lstm_init(k, d, h, gates=3) for k in ks]
    tw = [convert.params_from_jax(jax.device_get(w)) for w in jw]
    x, lens = _padded(len(LENS), max(LENS), d, LENS, seed=1)
    out_dim = h if which == "gru" else 2 * h
    wloss = np.random.RandomState(2).randn(len(LENS), max(LENS), out_dim).astype(np.float32)

    def jrun(xx, ws):
        if which == "gru":
            return jrnn.gru(xx, jnp.asarray(lens), ws[0])[0]
        return jrnn.bidir(xx, jnp.asarray(lens), ws[0], ws[1], cell="gru")

    jy = jrun(jnp.asarray(x), jw)
    jgx, jgw = jax.grad(lambda xx, ws: jnp.sum(jrun(xx, ws) * wloss), argnums=(0, 1))(jnp.asarray(x), jw)
    tx = torch.from_numpy(x).requires_grad_(True)
    for w in tw:
        for v in w.values():
            v.requires_grad_(True)
    ty = trnn.gru(tx, torch.from_numpy(lens), tw[0]) if which == "gru" else trnn.bidir(
        tx, torch.from_numpy(lens), tw[0], tw[1], cell="gru")
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=FWD_RTOL, atol=FWD_ATOL)
    for i, n in enumerate(LENS):
        assert not ty[i, n:].detach().any()
    used = tw[:1] if which == "gru" else tw
    leaves = [tx] + [w[k] for w in used for k in ("wx", "wh", "b")]
    grads = torch.autograd.grad(torch.sum(ty * torch.from_numpy(wloss)), leaves)
    want = [jgx] + [getattr(w, k) for w in jgw[:len(used)] for k in ("wx", "wh", "b")]
    _close(grads, want, which)


@pytest.mark.parametrize("module", ["LSTM", "GRU"])
def test_one_direction_encoder_layer_matches_jax(module):
    """An encoder layer with one direction (LSTM: ``lstm``, the lstm_seq
    pair's plain versions here; GRU: ``gru``) and a tanh projection."""
    jp, jdim = jenc.rnn_layer_init(jax.random.PRNGKey(4), 10, 8, module, False, False, True, 1, "drop")
    tp = convert.params_from_jax(jax.device_get(jp))
    assert jdim == 8 and "bwd" not in tp
    x, lens = _padded(len(LENS), max(LENS), 10, LENS, seed=5)
    jy, jl = jenc.rnn_layer_apply(jp, jnp.asarray(x), jnp.asarray(lens), module, 1, "drop", 0.0, None, False)
    ty, tl = tenc.rnn_layer_apply(tp, torch.from_numpy(x), torch.from_numpy(lens), 1, "drop", module=module)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("name", ["V1", "V2"])
def test_encoder_apply_matches_jax(name):
    jc, tc, jp, tp = models(variant(name))
    x, lens = _padded(3, 41, FEAT_DIM, [41, 30, 17], seed=6)
    je, jl = jenc.encoder_apply(jp["encoder"], jc.model.encoder, jnp.asarray(x), jnp.asarray(lens))
    te, tl = tenc.encoder_apply(tp["encoder"], tc.model.encoder, torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_gru_speller_step_matches_jax():
    """Three steps of a two-layer GRU speller: logits, hidden, and the state,
    whose c passes through unchanged."""
    d = variant("V1")
    d["model"]["decoder"]["layer"] = 2
    jc, tc = JConfig.from_dict(d), TConfig.from_dict(d)
    in_dim = 24
    jp = jdec.decoder_init(jax.random.PRNGKey(8), in_dim, VOCAB, jc.model.decoder)
    tp = convert.params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(9)
    c0 = rng.randn(2, 3, 32).astype(np.float32)
    js = (jnp.zeros((2, 3, 32)), jnp.asarray(c0))
    ts = (torch.zeros(2, 3, 32), torch.from_numpy(c0))
    for _ in range(3):
        x = rng.randn(3, in_dim).astype(np.float32)
        jlog, jh, js = jdec.step(jp, jc.model.decoder, js, jnp.asarray(x))
        tlog, th, ts = tdec.step(tp, tc.model.decoder, ts, torch.from_numpy(x))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=FWD_RTOL, atol=FWD_ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=FWD_RTOL, atol=FWD_ATOL)
        np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(ts[1].numpy(), c0)


# ----------------------------------------------------------- training loss
def _batch(seed=0):
    rng = np.random.RandomState(seed)
    frames, text_len, l_pad = [64, 52, 33], [8, 6, 5], 10
    n = (max(frames) - 1) * 160 + 400
    wav_len = np.array([(f - 1) * 160 + 400 for f in frames], np.int32)
    wav = (0.1 * rng.randn(len(frames), n)).astype(np.float32)
    for i, m in enumerate(wav_len):
        wav[i, m:] = 0.0
    steps = rng.randint(1, VOCAB - 2, size=(len(frames), l_pad))
    text = (1 + np.cumsum(steps, axis=1) % (VOCAB - 1)).astype(np.int32)
    for i, m in enumerate(text_len):
        text[i, m:] = 0
    return {"wav": wav, "wav_len": wav_len, "text": text, "text_len": np.asarray(text_len, np.int32)}


def loss_and_grads(d: dict, keys=("loss", "att_loss", "ctc_loss"), route=None):
    """compute_loss at tf 1.0 and the gradient of every parameter, the port's
    against jax.value_and_grad, on one batch; ``route`` a
    ``decoder.fused_scan`` for the port alone. Returns the port's metrics."""
    jc, tc, jp, tp = models(d)
    if route is not None:
        tc.model.decoder.fused_scan = route
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jm), jg = jax.value_and_grad(lambda p: jstep.compute_loss(
        p, jc, jb["wav"], jb["wav_len"], jb["text"], jb["text_len"], 1.0, jax.random.PRNGKey(1), train=True),
        has_aux=True)(jp)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    tl, tm = compute_loss(tp, tc, tb["wav"], tb["wav_len"], tb["text"], tb["text_len"], 1.0, gen, train=True)
    for k in keys:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    want = param_leaves(convert.params_from_jax(jax.device_get(jg)))
    assert len(grads) == len(want)
    _close(grads, want, "grad", floor=1e-9)
    return tm


@pytest.mark.parametrize("name", ["V1", "V2"])
def test_compute_loss_and_gradients_match_jax(name):
    loss_and_grads(variant(name))


def test_beam_search_gru_speller_with_gru_lm_matches_jax():
    """A V1 model with a two-layer GRU LM fused in (lm_weight 0.4, ctc 0.3):
    identical tokens and lengths, scores within rtol 1e-4."""
    d = variant("V1")
    d["decode"].update(lm_weight=0.4)
    jc, tc, jp, tp = models(d)
    lm = dict(module="GRU", emb_tying=True, emb_dim=8, dim=16, n_layers=2, dropout=0.0)
    jlm_cfg, tlm_cfg = JLMConfig(**lm), LMConfig(**lm)
    jlm_p = jlm.lm_init(jax.random.PRNGKey(5), VOCAB, jlm_cfg)
    tlm_p = convert.params_from_jax(jax.device_get(jlm_p))
    x, lens = _padded(2, 64, FEAT_DIM, [64, 45], seed=0)
    jr = jbeam(jp, jc.model, jc.decode, jnp.asarray(x), jnp.asarray(lens), 10, lm_params=jlm_p, lm_cfg=jlm_cfg)
    tr = beam_search(tp, tc.model, tc.decode, torch.from_numpy(x), torch.from_numpy(lens), 10,
                     lm_params=tlm_p, lm_cfg=tlm_cfg)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), rtol=1e-4)


def test_fused_scan_pallas_with_a_gru_speller_raises():
    """A GRU speller is outside the fused scan's envelope: ``auto`` takes the
    loop, ``pallas`` raises."""
    _, tc, _, tp = models(variant("V1"))
    assert tasr.speller_route(tp, tc.model, True, torch.device("cpu")) == "loop"
    tc.model.decoder.fused_scan = "pallas"
    with pytest.raises(ValueError, match="envelope"):
        tasr.speller_route(tp, tc.model, True, torch.device("cpu"))


def test_convert_permutes_conv1d_weights():
    """Every 3-D ``w`` goes TIO [K, I, O] -> OIW [O, I, K] (the CNN prenet's
    and the attention's location filters); 2-D dense ``w`` stays [in, out]."""
    jc, tc, jp, tp = models(variant("V1"))
    for name in ("conv1", "conv2"):
        w = np.asarray(jp["encoder"]["prenet"][name]["w"])
        assert w.ndim == 3
        np.testing.assert_array_equal(tp["encoder"]["prenet"][name]["w"].numpy(), w.transpose(2, 1, 0))
    loc = np.asarray(jp["attention"]["loc_conv"]["w"])
    np.testing.assert_array_equal(tp["attention"]["loc_conv"]["w"].numpy(), loc.transpose(2, 1, 0))
    np.testing.assert_array_equal(tp["ctc"]["w"].numpy(), np.asarray(jp["ctc"]["w"]))
    x, lens = _padded(2, 20, FEAT_DIM, [20, 13], seed=2)
    jy = jL.conv1d(jp["encoder"]["prenet"]["conv1"], jnp.asarray(x), stride=1)
    ty = tL.conv1d(tp["encoder"]["prenet"]["conv1"], torch.from_numpy(x), stride=1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FWD_RTOL, atol=FWD_ATOL)
