"""The embedding-regularizer plugin (``models/plugin.py``) against the JAX
package's (``e2e_asr_tpu/models/plugin.py``): its table from a ``.npy``
file, its loss and fused log-probs, the training loss with its term (the
Python-loop speller and the fused scan, whose backward takes the plugin's
hidden-state cotangent), greedy and beam decoding with fused decoding, the
fused scan's gate, and two gloo ranks giving the global batch's loss.

Weights are JAX's carried over by ``convert.params_from_jax``. Tolerances
as tests/test_torch_variants.py states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import EmbRegConfig as JEmbRegConfig
from e2e_asr_tpu.decode import greedy as jgreedy
from e2e_asr_tpu.decode.beam import beam_search as jbeam
from e2e_asr_tpu.models import plugin as jplugin
from e2e_asr_tpu.parallel.mp_worker import _tiny_config
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.config import EmbRegConfig
from e2e_asr_tpu_torch.decode import greedy as tgreedy
from e2e_asr_tpu_torch.decode.beam import beam_search
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.models import plugin as tplugin
from e2e_asr_tpu_torch.ops import decoder_cuda
from e2e_asr_tpu_torch.parallel import mp_worker
from e2e_asr_tpu_torch.training.step import compute_loss
from tests.test_torch_variants import FWD_ATOL, FWD_RTOL, LOSS_RTOL, _padded, loss_and_grads, models, variant
from tests.torch_parity import FEAT_DIM, VOCAB

torch.set_num_threads(1)


def _er(**kw) -> dict:
    return {"emb_reg": {"enable": True, "weight": 0.5, **kw}}


def test_emb_reg_init_reads_a_npy_table(tmp_path):
    """A .npy table [vocab, E] is normalised by row as JAX does it, bit for
    bit; the projection goes to its width; a table of other rows raises."""
    path = tmp_path / "emb.npy"
    np.save(path, np.random.RandomState(0).randn(VOCAB, 7) * 3.0)
    jp = jplugin.emb_reg_init(jax.random.PRNGKey(0), 32, VOCAB, JEmbRegConfig(enable=True, src=str(path)))
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tplugin.emb_reg_init(gen, 32, VOCAB, EmbRegConfig(enable=True, src=str(path)))
    np.testing.assert_array_equal(tp["table"].numpy(), np.asarray(jp["table"]))
    np.testing.assert_allclose(torch.linalg.vector_norm(tp["table"], dim=1).numpy(), 1.0, rtol=1e-6)
    assert tuple(tp["proj"]["w"].shape) == (32, 7)
    with pytest.raises(ValueError, match="rows"):
        tplugin.emb_reg_init(gen, 32, VOCAB + 1, EmbRegConfig(enable=True, src=str(path)))


@pytest.mark.parametrize("freeze", [True, False])
def test_emb_reg_loss_and_fused_log_probs_match_jax(freeze):
    """The loss (masked mean of 1 - cos) and its gradients (the table's zero
    when frozen), and the fused log-probs at fuse 0.3 and 0."""
    jcfg = JEmbRegConfig(enable=True, weight=0.5, fuse=0.3, temperature=0.7, freeze=freeze)
    tcfg = EmbRegConfig(enable=True, weight=0.5, fuse=0.3, temperature=0.7, freeze=freeze)
    jp = jplugin.emb_reg_init(jax.random.PRNGKey(1), 16, VOCAB, jcfg)
    tp = convert.params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(2)
    hidden = rng.randn(3, 5, 16).astype(np.float32)
    targets = rng.randint(0, VOCAB, (3, 5)).astype(np.int32)
    lens = np.array([5, 2, 0], np.int32)
    jl, jg = jax.value_and_grad(lambda p: jplugin.emb_reg_loss(
        p, jcfg, jnp.asarray(hidden), jnp.asarray(targets), jnp.asarray(lens)))(jp)
    leaves = [tp["proj"]["w"], tp["proj"]["b"], tp["table"]]
    for t in leaves:
        t.requires_grad_(True)
    tl = tplugin.emb_reg_loss(tp, tcfg, torch.from_numpy(hidden), torch.from_numpy(targets), torch.from_numpy(lens))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, torch.autograd.grad(tl, leaves, allow_unused=True))]
    for g, w in zip(grads, (jg["proj"]["w"], jg["proj"]["b"], jg["table"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1e-6))
    assert bool((grads[2] == 0).all()) == freeze
    logits = rng.randn(3, 5, VOCAB).astype(np.float32)
    for fuse in (0.3, 0.0):
        jcfg.fuse = tcfg.fuse = fuse
        want = jplugin.fused_log_probs(jp, jcfg, jnp.asarray(logits), jnp.asarray(hidden))
        got = tplugin.fused_log_probs(tp, tcfg, torch.from_numpy(logits), torch.from_numpy(hidden))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("fuse,route", [(0.0, None), (0.0, "pallas"), (0.3, None)],
                         ids=["weight-loop", "weight-fused-scan", "weight-and-fuse-loop"])
def test_compute_loss_with_the_plugin_matches_jax(fuse, route, monkeypatch):
    """V2 with the plugin's loss at weight 0.5, without fused decoding (the
    speller by the Python loop, and by the fused scan's plain versions, whose
    backward takes the plugin's non-zero hidden-state cotangent) and with it
    (fuse 0.3: the renormalised mixture in the attention loss): every loss
    and every gradient."""
    calls = []
    real = decoder_cuda.decoder_scan_bwd
    monkeypatch.setattr(decoder_cuda, "decoder_scan_bwd", lambda *a, **k: calls.append(a[-2]) or real(*a, **k))
    tm = loss_and_grads(variant("V2", **_er(fuse=fuse)), keys=("loss", "att_loss", "ctc_loss", "emb_reg_loss"),
                        route=route)
    assert float(tm["emb_reg_loss"].detach()) > 0
    if route == "pallas":
        assert len(calls) == 1 and bool(calls[0].abs().max() > 0)  # dhidden: the plugin's cotangent
    else:
        assert not calls


def _feats(seed=0):
    return _padded(2, 64, FEAT_DIM, [64, 45], seed)


@pytest.mark.parametrize("search", ["greedy", "beam"])
def test_decoding_with_fused_decoding_matches_jax(search):
    """emb_reg.fuse 0.3 in decoding: greedy tokens (and alignments), and the
    beam search's tokens, lengths and scores (ctc 0.3)."""
    jc, tc, jp, tp = models(variant("V2", **_er(fuse=0.3, temperature=0.5)))
    x, lens = _feats()
    if search == "greedy":
        jt, ja = jgreedy.greedy_decode(jp, jc.model, jnp.asarray(x), jnp.asarray(lens), 9)
        tt, ta = tgreedy.greedy_decode(tp, tc.model, torch.from_numpy(x), torch.from_numpy(lens), 9)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=FWD_RTOL, atol=FWD_ATOL)
        plain = tgreedy.greedy_decode(tp, TConfig.from_dict(variant("V2")).model, torch.from_numpy(x),
                                      torch.from_numpy(lens), 9)[0]
        assert not torch.equal(plain, tt)  # the fused log-probs chose other tokens
        return
    jr = jbeam(jp, jc.model, jc.decode, jnp.asarray(x), jnp.asarray(lens), 10)
    tr = beam_search(tp, tc.model, tc.decode, torch.from_numpy(x), torch.from_numpy(lens), 10)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), rtol=1e-4)


def test_fused_scan_gate_leaves_out_fused_decoding():
    """``decoder_cuda.supported`` (the JAX gate's clause): false with
    emb_reg.fuse > 0, where ``auto`` takes the loop and ``pallas`` raises;
    true with the plugin's loss alone."""
    _, tc, _, tp = models(variant("V2", **_er(fuse=0.3)))
    assert not decoder_cuda.supported(tc.model, True) and not decoder_cuda.supported(tc.model, False)
    tc.model.decoder.fused_scan = "pallas"
    with pytest.raises(ValueError, match="emb_reg"):
        tasr.speller_route(tp, tc.model, True, torch.device("cpu"))
    tc.model.emb_reg.fuse = 0.0
    assert decoder_cuda.supported(tc.model, True)
    assert tasr.speller_route(tp, tc.model, True, torch.device("cpu")) == "fused"


def test_two_ranks_give_the_global_batch_emb_reg_loss(tmp_path):
    """Two gloo ranks whose rows hold 24 and 12 target tokens: the summed
    emb_reg_loss (each rank's numerator over the global count) and the joint
    loss are the one-process port's and JAX's on the global batch."""
    from tests.test_torch_parallel import _global_batch, _run, _save_config

    from e2e_asr_tpu.models import asr as jasr

    jcfg = _tiny_config()
    jcfg.model.emb_reg = JEmbRegConfig(enable=True, weight=0.5)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, 16, jcfg.model)
    tp = convert.params_from_jax(jax.device_get(jp))
    batch = _global_batch()
    ckpt = str(tmp_path / "params.pt")
    convert.save_checkpoint(ckpt, tp, 16, 40)
    np.savez(tmp_path / "batch.npz", **batch)
    spec = {"config": _save_config(jcfg.to_dict(), tmp_path / "tiny.yaml"), "params": ckpt,
            "batch": str(tmp_path / "batch.npz"), "out": str(tmp_path / "grads.npz")}
    _run("grads", spec, tmp_path)
    got = np.load(tmp_path / "grads.npz")
    assert int(got["world"]) == 2
    tcfg = TConfig.from_dict(jcfg.to_dict())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, m = compute_loss(tp, tcfg, tb["wav"], tb["wav_len"], tb["text"], tb["text_len"], 1.0, None,
                               train=False)
        halves = [float(compute_loss(tp, tcfg, *(mp_worker.local_rows(tb, r, 2)[k] for k in
                                                 ("wav", "wav_len", "text", "text_len")),
                                     1.0, None, train=False)[1]["emb_reg_loss"]) for r in (0, 1)]
    _, jm = jstep.compute_loss(jp, jcfg, *(jnp.asarray(batch[k]) for k in ("wav", "wav_len", "text", "text_len")),
                               1.0, jax.random.PRNGKey(0), train=False)
    for want in (float(m["emb_reg_loss"]), float(jm["emb_reg_loss"])):
        np.testing.assert_allclose(float(got["emb_reg_loss"]), want, rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(jm["loss"]), rtol=1e-5)
    # the mean of the ranks' own losses misses the global one
    assert abs(np.mean(halves) - float(got["emb_reg_loss"])) > 1e-4 * float(got["emb_reg_loss"])
