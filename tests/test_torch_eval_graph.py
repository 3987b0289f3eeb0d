"""The validation re-cut for CUDA graphs, on the CPU: ``Trainer.eval_device``
(losses, CTC argmax and the greedy decode of one dev batch, reading nothing
back) against the JAX package's validation pieces, the greedy loop with
preallocated outputs against the loop it replaces, ``Solver.validate`` from
device rows and overlapped scoring against the per-batch host path, and
``training/eval_graph.py``'s key (the graphs themselves run on the card:
tests/test_torch_cuda.py).

- float32, tiny config (tests/test_torch_train.py's model and batch, the
  JAX side's Pallas kernels in interpret mode): the losses within
  LOSS_RTOL of ``make_eval_step``'s, the CTC argmax and encoder lengths
  equal, and the greedy tokens equal to JAX ``greedy_decode`` on JAX's
  features.
- bfloat16 (tests/test_torch_bf16.py's recipes and bounds, both packages
  on JAX's features): the joint and CTC losses within HALF of JAX's own
  float32-to-bf16 distance, the attention loss within ATT_LOSS_ATOL; the
  greedy decode, float32 in both packages, gives JAX's tokens.
- The greedy loop writing into [B, max_step] buffers equals the loop that
  stacked lists, bitwise (tokens and alignments).
- The summary and the dev sample of ``Solver.validate`` equal the
  per-batch host path's (a copy of it below) exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from unittest import mock

from e2e_asr_tpu.decode import greedy as jgreedy
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu.ops.frontend import compute_features as jfeatures
from e2e_asr_tpu.training import step as jstep
from e2e_asr_tpu_torch import convert, cuda_build
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.decode import greedy as tgreedy
from e2e_asr_tpu_torch.metrics import cal_er
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.ops.frontend import compute_features
from e2e_asr_tpu_torch.training import eval_graph
from e2e_asr_tpu_torch.training.step import EVAL_SCALARS, Trainer
from e2e_asr_tpu_torch.training.step_graph import GraphCache, TrainGraphs
from tests.test_torch_train import LOSS_RTOL, _batch, _cfg_dict, _jbatch, _models, _tbatch
from tests.torch_parity import FEAT_DIM, VOCAB

torch.set_num_threads(1)
MAX_STEP = 9


def _jax_tokens(jc, jp, b, max_step=MAX_STEP):
    """JAX's validation decode: its features, then its greedy decode."""
    feat, feat_len = jfeatures(jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]), jc.data.audio)
    return np.asarray(jgreedy.greedy_decode(jp, jc.model, feat, feat_len, max_step)[0])


def test_eval_device_matches_jax(monkeypatch):
    monkeypatch.setenv("E2E_RNN_IMPL", "pallas")
    monkeypatch.setenv("E2E_CTC_IMPL", "pallas")
    jc, tc, jp, tp = _models(_cfg_dict())
    b = _batch()
    jm = jstep.make_eval_step(jc)(jp, _jbatch(b))
    trainer = Trainer(tc)
    out = trainer.eval_device(tp, _tbatch(b), MAX_STEP)
    keys = trainer.scalar_keys(EVAL_SCALARS)
    assert keys == ("loss", "att_loss", "ctc_loss") and out["scalars"].dtype == torch.float32 and out["scalars"].shape == (3,)
    for k, v in zip(keys, out["scalars"].tolist()):
        np.testing.assert_allclose(v, float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_array_equal(out["ctc_preds"].numpy(), np.asarray(jm["ctc_preds"]))
    np.testing.assert_array_equal(out["enc_len"].numpy(), np.asarray(jm["enc_len"]))
    assert out["tokens"].shape == (3, MAX_STEP)
    np.testing.assert_array_equal(out["tokens"].numpy(), _jax_tokens(jc, jp, b))


@pytest.mark.parametrize("encoder", ["lstm_seq", "fused"])
def test_eval_device_matches_jax_at_bf16(encoder, monkeypatch):
    from tests import test_torch_bf16 as tb

    _, jax_impl, _ = tb.ENCODERS[encoder]
    tb._jax_env(monkeypatch, jax_impl)
    jc, tc = tb._recipe(encoder, "kernel")
    jc32, _ = tb._recipe(encoder, "kernel", "float32")
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), FEAT_DIM, VOCAB, jc.model)
    b = _batch()
    want = jstep.make_eval_step(jc)(jp, _jbatch(b))
    f32 = jstep.make_eval_step(jc32)(jp, _jbatch(b))
    feat, feat_len = tb._jax_features(encoder)
    jtok = np.asarray(jgreedy.greedy_decode(jp, jc32.model, jnp.asarray(feat), jnp.asarray(feat_len), MAX_STEP)[0])
    tb._same_features(monkeypatch, encoder)
    out = Trainer(tc).eval_device(convert.params_from_jax(jax.device_get(jp)), _tbatch(b), MAX_STEP)
    got = dict(zip(EVAL_SCALARS, out["scalars"].tolist()))
    for k in ("loss", "ctc_loss"):
        assert abs(got[k] - float(want[k])) <= tb.HALF * abs(float(f32[k]) - float(want[k])), k
    assert abs(got["att_loss"] - float(want["att_loss"])) <= tb.ATT_LOSS_ATOL
    assert np.mean(out["ctc_preds"].numpy() == np.asarray(want["ctc_preds"])) >= tb.PRED_AGREE
    np.testing.assert_array_equal(out["tokens"].numpy(), jtok)


@torch.no_grad()
def _stacked_greedy(params, cfg, feat, feat_len, max_step):
    """The greedy loop as it was before its outputs were preallocated."""
    enc, enc_len = tasr.encode(params, cfg, feat, feat_len)
    mem, carry = tasr.init_carry(params, cfg, enc, enc_len)
    toks, aligns = [], []
    for _ in range(max_step):
        logits, align, _, carry = tasr.attend_and_step(params, cfg, mem, carry, carry.prev_tok)
        tok = torch.argmax(logits, -1)
        carry = carry._replace(prev_tok=tok)
        toks.append(tok)
        aligns.append(align)
    return torch.stack(toks, 1), torch.stack(aligns, 1)


@pytest.mark.parametrize("max_step", [1, 9, 23])
@pytest.mark.parametrize("heads", [1, 2])
def test_greedy_loop_equals_the_stacked_loop_bitwise(max_step, heads):
    d = _cfg_dict()
    d["model"]["attention"]["num_head"] = heads
    _, tc, _, tp = _models(d)
    rng = np.random.RandomState(4 + heads)
    feat = rng.randn(3, 48, FEAT_DIM).astype(np.float32)
    feat_len = np.array([48, 33, 20], np.int32)
    for i, n in enumerate(feat_len):
        feat[i, n:] = 0.0
    args = (tp, tc.model, torch.from_numpy(feat), torch.from_numpy(feat_len), max_step)
    toks, aligns = tgreedy.greedy_decode(*args)
    want_t, want_a = _stacked_greedy(*args)
    assert toks.dtype == want_t.dtype and torch.equal(toks, want_t)
    assert aligns.shape == want_a.shape == (3, max_step, heads, 12) and torch.equal(aligns, want_a)
    lone, none = tgreedy.greedy_decode(*args, keep_align=False)
    assert none is None and torch.equal(lone, want_t)


def _solver(tmp_path, name, dev_utts=12):
    """The tiny training recipe (tests/test_torch_cli.py) on the CPU, its dev
    split widened to several batches."""
    from e2e_asr_tpu_torch.bin.train_asr import Solver
    from tests.test_torch_cli import _tiny_train_yaml

    d = yaml.safe_load(_tiny_train_yaml(tmp_path).read_text())
    d["data"]["corpus"]["dev_split"] = [f"dev:{dev_utts}"]
    cfg = TConfig.from_dict(d)
    paras = types.SimpleNamespace(config="tiny.yaml", name=name, logdir=str(tmp_path / "log"),
                                  ckpdir=str(tmp_path / "ckpt"), load=None, seed=0, cpu=True, verbose=False,
                                  auto_resume=False, njobs=0)
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver


def _per_batch_validation(solver):
    """The validation loop as it read each dev batch back: (summary, dev
    sample, [(tokens, ctc ids)] a batch)."""
    from e2e_asr_tpu_torch.bin.train_asr import DEV_STEP_RATIO

    cfg, params = solver.config, solver.state.params
    losses, er, sample, outs = {}, np.zeros(6, np.float64), None, []
    for batch in solver.dv_set.epoch():
        dbatch = solver._put(batch)
        m = solver.trainer.eval_step(params, dbatch)
        for k in ("loss", "att_loss", "ctc_loss"):
            losses.setdefault(k, []).append(float(m[k]))
        text, valid = batch.text, batch.text_len > 0
        feat, feat_len = compute_features(dbatch["wav"], dbatch["wav_len"], cfg.data.audio)
        toks = tgreedy.greedy_decode(params, cfg.model, feat, feat_len, int(text.shape[1] * DEV_STEP_RATIO))[0]
        toks = toks.numpy()
        er[0:2] += cal_er(solver.tokenizer, toks[valid], text[valid], mode=solver._er_mode())
        er[2:4] += cal_er(solver.tokenizer, toks[valid], text[valid], mode=solver._er_mode(alt=True))
        if sample is None and valid.any():
            i = int(np.argmax(valid))
            sample = f"hyp: {solver.tokenizer.decode(toks[i])}\n\nref: {solver.tokenizer.decode(text[i])}"
        ids, enc_len = m["ctc_preds"].numpy(), m["enc_len"].numpy()
        er[4:6] += cal_er(solver.tokenizer, ids[valid], text[valid], mode=solver._er_mode(), ctc=True,
                          pred_len=enc_len[valid])
        outs.append((toks, ids))
    summary = {k: float(np.mean(v)) for k, v in losses.items()}
    summary["dev_er_att"] = float(er[0] / max(er[1], 1))
    summary[f"dev_{solver._er_mode(alt=True)}_att"] = float(er[2] / max(er[3], 1))
    summary["dev_er_ctc"] = float(er[4] / max(er[5], 1))
    return summary, sample, outs


def test_validate_summary_equals_the_per_batch_host_path(tmp_path):
    """Two training steps, then ``validate`` (losses read once, scoring a
    batch behind) against the per-batch host path on the same weights: the
    same summary and dev sample, bitwise; ``dev_epoch`` hands back each
    batch's tokens and CTC ids as that path computed them."""
    solver = _solver(tmp_path, "val")
    assert solver.eval_graphs is None and len(solver.dv_set) >= 2  # the CPU validates eagerly
    solver.max_step, solver.valid_step = 2, 1000
    solver.exec()
    logged = []
    with mock.patch.object(solver, "write_log", lambda tag, value: logged.append((tag, value))):
        summary = solver.validate()
    want, sample, outs = _per_batch_validation(solver)
    assert summary == want and solver.dev_summary == want
    assert set(want) == {"loss", "att_loss", "ctc_loss", "dev_er_att", "dev_wer_att", "dev_er_ctc"}
    assert ("dev_sample", sample) in logged and logged[0][0] == "dev_sample"
    kept = []
    assert solver.dev_epoch(keep=kept) == (want, sample)
    assert len(kept) == len(outs) == len(solver.dv_set)
    for got, (toks, ids) in zip(kept, outs):
        np.testing.assert_array_equal(got["tokens"], toks)
        np.testing.assert_array_equal(got["ctc_preds"], ids)


def _key_setup(tmp_path):
    from e2e_asr_tpu_torch.training.step import resolve_wav

    solver = _solver(tmp_path, "key", dev_utts=4)
    solver.config.model.decoder.dropout = 0.0
    streams = [solver._put(b) for b in list(solver.dv_set.epoch()) * 2]
    it = solver.tr_set.forever(curriculum_epochs=1)
    offs = [solver._put(next(it)) for _ in range(2)]
    assert all(b.get("wav") is None for b in offs) and streams[0].get("wav") is not None
    assert resolve_wav(offs[0])[0].shape[1] == streams[0]["wav"].shape[1]
    return solver, streams, offs


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def test_eval_graph_key_follows_shapes_dtypes_routes_and_pointers(tmp_path):
    """Two dev batches of one bucket share a key; another batch size, token
    length or max_step, an offsets batch (and its corpus), another compute
    type, LSTM route or speller route, the plain versions, or the same
    parameters at other addresses, make a new key."""
    solver, (b0, b1), (o0, o1) = _key_setup(tmp_path)
    trainer, params = solver.trainer, solver.state.params
    key = lambda b=b0, p=params, n=MAX_STEP: eval_graph.graph_key(trainer, p, b, n)  # noqa: E731
    k0 = key()
    assert key(b=b1) == k0 and key(n=MAX_STEP + 1) != k0
    assert key(b={k: v[:2] for k, v in b0.items()}) != k0
    assert key(b={**b0, "text": torch.cat([b0["text"], b0["text"][:, :1]], 1)}) != k0
    assert key(b=o0) == key(b=o1) != k0
    assert key(b={**o0, "corpus": o0["corpus"].clone()}) != key(b=o0)
    assert key(p=_clone(params)) != k0
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


def test_eval_graphs_share_the_train_graphs_pool_and_refuse_cpu_tensors(tmp_path):
    """An ``EvalGraphs`` made with ``share`` reads and sets the train
    graphs' memory pool; the caches take CUDA tensors only (no fallback)."""
    train = TrainGraphs()
    graphs = eval_graph.EvalGraphs(share=train)
    assert graphs.pool is None and isinstance(graphs, GraphCache)
    train.pool = (0, 7)
    assert graphs.pool == (0, 7)
    graphs.pool = (0, 9)
    assert train.pool == (0, 9) and eval_graph.EvalGraphs().pool is None
    solver, (b0, _), _ = _key_setup(tmp_path)
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.eval(solver.trainer, solver.state.params, b0, MAX_STEP)
