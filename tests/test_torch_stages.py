"""The port's stage table (``e2e_asr_tpu_torch/utils/stages.py``) against
the JAX package's ``utils/stages.py``.

- The work counts the two share are equal: ``_lstm_layer_flops``,
  ``_vgg_flops`` and the speller's FLOPs (JAX's ``decoder_fb`` ceiling times
  its MXU peak) at the flagship's and asr_960h.yaml's shapes.
- Each stage program's value on the CPU, from weights carried over by
  ``convert.py`` and the JAX package's stage inputs, equals the same
  objective built from the JAX package's functions as
  ``e2e_asr_tpu/utils/stages.py`` ``measure_stages`` builds it (features in
  float32 here on both sides; the JAX program casts them to bf16). A
  program's value is a sum (the features, or the objective plus every
  gradient element), so the tolerance is the parity tests' per element,
  summed over the elements: features rtol 1e-3, atol 2e-3
  (tests/test_torch_frontend.py); the encoder's and the CTC objective's
  values rtol 1e-4 / 1e-5, gradients rtol 1e-4 with atol 1e-4 of the
  tensor's largest entry (tests/test_torch_train.py); the speller's
  gradients rtol 1e-3 with that atol (tests/test_torch_decoder_scan.py).
- ``measure_stages`` on the CPU times every stage; ``stage_report`` has the
  JAX package's keys and rounding; ``stage_ceilings`` follows the encoder's
  route and counts the model's own parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu.models import attention as jatt
from e2e_asr_tpu.models import decoder as jdec
from e2e_asr_tpu.ops.ctc import ctc_loss as jctc_loss
from e2e_asr_tpu.ops.frontend import compute_features as jfeatures
from e2e_asr_tpu.utils import stages as jstages
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.training.step import param_leaves
from e2e_asr_tpu_torch.utils import profiling as prof
from e2e_asr_tpu_torch.utils import stages
from tests.torch_parity import VOCAB, models, small_config

torch.set_num_threads(1)
FLAGSHIP = "configs/libri/asr_example.yaml"
R960 = "configs/libri/asr_960h.yaml"
B, FRAMES, L_TOK = 2, 64, 8


@pytest.mark.parametrize("b,t,d_in,h", [(16, 204, 1280, 320), (16, 204, 640, 320), (16, 764, 1280, 512),
                                        (2, 16, 40, 32)])
def test_lstm_layer_flops_equal_jax(b, t, d_in, h):
    assert stages._lstm_layer_flops(b, t, d_in, h) == jstages._lstm_layer_flops(b, t, d_in, h)


@pytest.mark.parametrize("b,t,mel", [(16, 816, 40), (16, 3056, 40), (32, 416, 80)])
def test_vgg_flops_equal_jax(b, t, mel):
    assert stages._vgg_flops(b, t, mel) == jstages._vgg_flops(b, t, mel)


@pytest.mark.parametrize("path,b,frames,l_tok", [(FLAGSHIP, 16, 816, 240), (R960, 16, 3056, 520)])
def test_decoder_fb_flops_equal_jax(path, b, frames, l_tok):
    """The speller's FLOPs: JAX's ceiling times its MXU peak."""
    want = jstages.stage_ceilings(JConfig.load(path), b, frames, l_tok, 26)["decoder_fb"]["ceiling_ms"]
    got = stages.stage_ceilings(TConfig.load(path), b, frames, l_tok, 26, "bfloat16", n_params=1)["decoder_fb"]
    np.testing.assert_allclose(got["flops"], want * jstages.MXU_PEAK / 1e3, rtol=1e-12)
    np.testing.assert_allclose(got["ceiling_ms"], max(got["flops"] / 989e12, got["bytes"] / 3.35e12) * 1e3,
                               rtol=1e-12)


# ---------------------------------------------------------------- programs
def _jax_programs(jc, jp, inputs):
    """{stage: (value, the arrays it sums)}: the JAX package's stage
    objectives (``e2e_asr_tpu/utils/stages.py`` ``measure_stages``) with
    float32 features."""
    wav, wl = jnp.asarray(inputs["wav"]), jnp.asarray(inputs["wav_len"])
    text, tl = jnp.asarray(inputs["text"]), jnp.asarray(inputs["text_len"])
    b, l_tok = inputs["text"].shape
    out = {}

    def vg(f, *args):
        v, gr = jax.value_and_grad(f)(*args)
        leaves = [x.astype(jnp.float32) for x in jax.tree.leaves(gr)]
        return float(v + sum(jnp.sum(x) for x in leaves)), [np.asarray(v)], [np.asarray(x) for x in leaves]

    feat, feat_len = jfeatures(wav, wl, jc.data.audio)
    out["frontend_fwd"] = (float(feat.astype(jnp.float32).sum()), [np.asarray(feat)], [])
    out["encoder_fb"] = vg(lambda p, f, fl: jasr.encode(p, jc.model, f, fl)[0].astype(jnp.float32).sum(),
                           jp, feat, feat_len)
    enc, enc_len = jasr.encode(jp, jc.model, feat, feat_len)

    def ctc_obj(p):
        lp = jasr.ctc_log_probs(p, enc).astype(jnp.float32)
        lab_len = jnp.maximum(tl - 1, 0)
        pos = jnp.arange(text.shape[1])[None, :]
        labels = jnp.where(pos < lab_len[:, None], text, 0)
        nll = jctc_loss(lp, enc_len, labels, lab_len, impl="auto")
        return jnp.sum(nll / jnp.maximum(lab_len, 1)) / b

    out["ctc_fb"] = vg(ctc_obj, jp)
    key = jax.random.PRNGKey(0)

    def dec_obj(pe):
        p, e = pe
        mem = jatt.prepare(p["attention"], jc.model.attention, e, enc_len)
        carry0 = jasr.DecodeCarry(
            jdec.init_state(b, jc.model.decoder, e.dtype),
            jatt.init_align(jc.model.attention, mem).astype(e.dtype),
            jnp.zeros((b,), jnp.int32),
        )
        teacher_in = jnp.concatenate([jnp.zeros((b, 1), text.dtype), text[:, : l_tok - 1]], 1)
        rngs = jax.random.split(key, l_tok)
        coins = jnp.ones((l_tok,), bool)

        def body(carry, inp):
            tok, coin, r = inp
            logits, align, hidden, nc = jasr.attend_and_step(p, jc.model, mem, carry, tok, rng=r, train=True)
            return nc._replace(prev_tok=tok), logits

        _, logits = jax.lax.scan(body, carry0, (jnp.moveaxis(teacher_in, 0, 1), coins, rngs))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.moveaxis(text, 0, 1)[..., None], -1))

    out["decoder_fb"] = vg(dec_obj, (jp, enc))
    return out


# (per-element value rtol, atol; gradient rtol, atol as a share of the tensor's largest entry)
TOL = {"frontend_fwd": (1e-3, 2e-3, 0.0, 0.0), "encoder_fb": (1e-4, 1e-5, 1e-4, 1e-4),
       "ctc_fb": (1e-5, 1e-4, 1e-4, 1e-4), "decoder_fb": (1e-4, 1e-5, 1e-3, 1e-4)}


@pytest.mark.parametrize("stage,cmvn", [("frontend_fwd", True), ("frontend_fwd", False), ("encoder_fb", True),
                                        ("ctc_fb", True), ("decoder_fb", True)])
def test_stage_program_equals_the_jax_objective(stage, cmvn):
    """(Per-utterance CMVN makes the features' sum about 0: the frontend is
    also held without it.)"""
    d = small_config()
    d["data"]["audio"]["apply_cmvn"] = cmvn
    jc, tc, jp, tp = models(d)
    inputs = stages.stage_inputs(tc, B, FRAMES, L_TOK, VOCAB)
    progs = stages.stage_programs(tc, tp, inputs, "float32", "cpu")
    assert set(progs) == set(stages.MEASURED)
    fn, batch = progs[stage]
    got = float(fn(batch, None))
    want, values, grads = _jax_programs(jc, jp, inputs)[stage]
    v_rtol, v_atol, g_rtol, g_rel = TOL[stage]
    tol = sum(v_rtol * np.abs(v).sum() + v_atol * v.size for v in values)
    tol += sum(g_rtol * np.abs(g).sum() + g_rel * np.abs(g).max() * g.size for g in grads if g.size)
    assert abs(got - want) <= tol, (stage, got, want, tol)
    assert np.isfinite(got)


def test_stage_inputs_are_the_jax_packages():
    """RandomState(seed) waves x 0.1 at the bucket's samples and teacher ids
    in [3, vocab) ending in <eos> = 1, as the JAX package's measure_stages
    draws them."""
    tc = TConfig.from_dict(small_config())
    x = stages.stage_inputs(tc, 3, 10, 5, 9, seed=4)
    rng = np.random.RandomState(4)
    n = 9 * 160 + 400
    np.testing.assert_array_equal(x["wav"], (rng.randn(3, n) * 0.1).astype(np.float32))
    np.testing.assert_array_equal(x["text"][:, :4], rng.randint(3, 9, (3, 4)))
    assert (x["text"][:, 4] == 1).all() and (x["wav_len"] == n).all() and (x["text_len"] == 5).all()


def test_optimizer_program_updates_every_parameter():
    _, tc, _, tp = models(small_config())
    progs = stages.stage_programs(tc, tp, stages.stage_inputs(tc, B, FRAMES, L_TOK, VOCAB), "float32", "cpu")
    fn, batch = progs["optimizer"]
    before = [p.detach().clone() for p in param_leaves(tp)]
    fn(batch, None)
    fn(batch, None)
    assert torch.equal(batch["grads"], torch.full_like(batch["grads"], 1e-4))
    # the program updates its own copy: the model's parameters stay
    assert all(torch.equal(a, b) for a, b in zip(before, param_leaves(tp)))


def test_stage_programs_turn_dropout_off():
    d = small_config()
    d["model"]["encoder"]["dropout"] = [0.5, 0.5]
    d["model"]["decoder"]["dropout"] = 0.5
    _, tc, _, tp = models(d)
    inputs = stages.stage_inputs(tc, B, FRAMES, L_TOK, VOCAB)
    fn, batch = stages.stage_programs(tc, tp, inputs, "float32", "cpu")["encoder_fb"]
    gen = torch.Generator()
    assert float(fn(batch, gen)) == float(fn(batch, gen))
    assert tc.model.encoder.dropout == [0.5, 0.5]  # the caller's config is left as it was


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_measure_stages_on_the_cpu_times_every_stage(dtype):
    tc = TConfig.from_dict(small_config())
    got = stages.measure_stages(tc, B, FRAMES, L_TOK, VOCAB, iters=1, dtype=dtype, device="cpu")
    assert set(got) == set(stages.MEASURED)
    assert all(np.isfinite(v) and v > 0 for v in got.values()), got


def test_stage_report_has_jaxs_keys_and_rounding():
    """The same measured seconds: the same stages, keys, ms and rounding
    (ms and ceiling_ms to 0.1, sol to 0.001 from the unrounded numbers)."""
    jc = JConfig.from_dict(small_config())
    tc = TConfig.from_dict(small_config())
    measured = {"frontend_fwd": 0.00123456, "encoder_fb": 0.0234567, "ctc_fb": 0.00034567,
                "decoder_fb": 0.0191234}
    want = jstages.stage_report(jc, B, FRAMES, L_TOK, VOCAB, measured, n_params=1000)
    got = stages.stage_report(tc, B, FRAMES, L_TOK, VOCAB, measured, n_params=1000)
    ceil = stages.stage_ceilings(tc, B, FRAMES, L_TOK, VOCAB, n_params=1000)
    assert list(got) == list(want)
    for k in measured:
        assert set(got[k]) == set(want[k]) == {"ms", "ceiling_ms", "sol", "bound"}
        assert got[k]["ms"] == want[k]["ms"] == round(measured[k] * 1e3, 1)
        assert got[k]["ceiling_ms"] == round(ceil[k]["ceiling_ms"], 1)
        assert got[k]["sol"] == round(ceil[k]["ceiling_ms"] / (measured[k] * 1e3), 3)
        assert got[k]["bound"] in ("bytes", "operations")


def test_stage_ceilings_follow_the_encoders_route():
    """The LSTM pair of encoder.rnn_impl gives the recurrence its bytes; a
    GRU layer has no kernel and is held against its operations alone (3
    gates of 4); one-direction layers count half; the CNN prenet has its own
    operations."""
    base = TConfig.load(FLAGSHIP)
    c = lambda: stages.stage_ceilings(base, 16, 816, 240, 26, "bfloat16", n_params=1)  # noqa: E731
    auto = c()
    base.model.encoder.rnn_impl = "pallas"
    pallas = c()
    assert auto["recurrence_fb"]["flops"] == pallas["recurrence_fb"]["flops"]
    assert auto["recurrence_fb"]["bytes"] != pallas["recurrence_fb"]["bytes"] > 0
    base.model.encoder.module = "GRU"
    gru = c()
    assert gru["recurrence_fb"]["bytes"] == 0.0 and gru["recurrence_fb"]["bound"] == "operations"
    base.model.encoder.module, base.model.encoder.bidirection = "LSTM", False
    one = c()
    assert 0 < one["recurrence_fb"]["bytes"] < auto["recurrence_fb"]["bytes"]
    assert one["recurrence_fb"]["flops"] < auto["recurrence_fb"]["flops"]
    base.model.encoder.prenet = "cnn"
    cnn = c()
    assert 0 < cnn["vgg_fb"]["flops"] < auto["vgg_fb"]["flops"]
    assert cnn["encoder_fb"]["flops"] == cnn["vgg_fb"]["flops"] + cnn["recurrence_fb"]["flops"]


def test_frontend_and_ctc_ceilings_are_the_kernels_least_work():
    cfg = TConfig.load(FLAGSHIP)
    ceil = stages.stage_ceilings(cfg, 16, 816, 240, 26, n_params=1)
    a = cfg.data.audio
    assert (ceil["frontend_fwd"]["bytes"], ceil["frontend_fwd"]["flops"]) == prof.log_mel_work(a, 16, 130800, 400,
                                                                                                 512)
    nb, nf = prof.ctc_work(torch.empty((16, 204, 26), device="meta"),
                           torch.empty((16, 239), dtype=torch.int64, device="meta"),
                           torch.full((16,), 204), torch.full((16,), 239))
    assert (ceil["ctc_fb"]["bytes"], ceil["ctc_fb"]["flops"]) == (nb, nf)


def test_optimizer_ceiling_counts_the_models_parameters():
    tc = TConfig.from_dict(small_config())
    _, _, _, tp = models(small_config())
    n = sum(p.numel() for p in param_leaves(tp))
    assert stages.param_count(tc, VOCAB) == n
    ceil = stages.stage_ceilings(tc, B, FRAMES, L_TOK, VOCAB)
    assert ceil["optimizer"]["bytes"] == 7 * n * 4
    assert ceil["optimizer"]["ceiling_ms"] == 7 * n * 4 / 3.35e12 * 1e3
