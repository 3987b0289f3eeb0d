"""Data parallelism over processes (``e2e_asr_tpu_torch/parallel/dist.py``)
on the CPU: ranks over gloo, each a process of its own spawned with a free
port and a time limit (``parallel/mp_worker.py``, as
``tests/test_multiprocess.py`` spawns the JAX package's workers).

- The loaders' row blocks are the JAX loaders' bit for bit, and a batch's
  blocks put together are the one-process batch.
- Two ranks give the JAX package's single-process loss and gradients of the
  global batch (``e2e_asr_tpu.parallel.mp_worker.global_batch``, its
  ``_tiny_config``, weights from the JAX ``asr_init``) and the one-rank
  port's, on a batch whose ranks hold different token counts, so that a
  mean of per-rank losses would not do.
- A two-rank train step with dither, SpecAugment and dropout equals the
  one-rank step on the global batch (the draws at the global shape).
- Two-rank ``Solver.exec`` + ``validate``, LM training and decode give the
  one-rank summary, perplexity and csvs; rank 0 alone writes.
- A group of one gives the bits of a run without a group.
- The loop speller's sampled feedback draws at the rank's own shape
  (ROADMAP Queue 3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.parallel import dist, mp_worker
from e2e_asr_tpu_torch.training.step import Trainer, compute_loss, param_leaves
from tests.torch_parity import small_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds a spawned group may take


def _run(mode, spec, tmp_path, nproc=2):
    return mp_worker.run(mode, spec, nproc, str(tmp_path / f"{mode}_{nproc}"), TIMEOUT, cwd=ROOT)


def _save_config(d, path):
    TConfig.from_dict(d).save(path)
    return str(path)


# ------------------------------------------------------------------ loaders
def _loader_data(wire="int16"):
    return {"corpus": {"name": "synthetic", "train_split": ["train:30"], "dev_split": ["dev:10"],
                       "batch_size": 4, "buckets": [208, 416, 816], "token_buckets": [32, 48, 64],
                       "wire_dtype": wire},
            "audio": {"feat_dim": 40}, "text": {"mode": "character"}}


@pytest.mark.parametrize("index,workers,wire", [
    pytest.param(0, 0, "int16", id="rank0"),
    pytest.param(1, 0, "int16", id="rank1"),
    pytest.param(1, 2, "float32", id="rank1-threads-float32"),
])
def test_asr_loader_row_blocks_match_jax(index, workers, wire):
    """``load_dataset(process_index, process_count=2)``: every train and dev
    batch, its shapes and ``batch_shapes()`` (local rows) are the JAX
    loader's bit for bit, over a shuffled epoch and a resumed one."""
    from e2e_asr_tpu.data.dataset import load_dataset as jload

    from e2e_asr_tpu_torch.data.dataset import load_dataset as tload

    d = _loader_data(wire)
    kw = dict(process_index=index, process_count=2, num_workers=workers)
    jtr, jdv = jload(JConfig.from_dict({"data": d}).data, **kw)[:2]
    ttr, tdv = tload(TConfig.from_dict({"data": d}).data, **kw)[:2]
    for t, j in ((ttr, jtr), (tdv, jdv)):
        assert len(t) == len(j) > 2
        assert t.batch_shapes() == j.batch_shapes()
        assert all(rows % 2 == 0 for rows in t._pad_bs.values())
        for e, skip in ((0, 0), (1, 3)):
            got, want = list(t.epoch(e, skip_first=skip)), list(j.epoch(e, skip_first=skip))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.uids == w.uids
                for k in ("wav", "wav_len", "text", "text_len"):
                    np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=k)


def test_asr_row_blocks_put_together_are_the_one_process_batch(monkeypatch):
    """Rank 0's and rank 1's blocks of each batch, one after the other, are
    the one-process batch (padded to the same rows), and a rank loads the
    waves of its own rows only."""
    from e2e_asr_tpu_torch.data.dataset import BucketedLoader, load_dataset

    cfg = TConfig.from_dict({"data": _loader_data()}).data
    one = load_dataset(cfg, num_workers=0)[0]
    loaded = []
    real = BucketedLoader._cached_wav_i16
    monkeypatch.setattr(BucketedLoader, "_cached_wav_i16", lambda self, idx: loaded.append(idx) or real(self, idx))
    ranks = [load_dataset(cfg, num_workers=0, process_index=r, process_count=2)[0] for r in (0, 1)]
    rank1 = {u for b in ranks[1].epoch(0) for u in b.uids if u}
    assert rank1 and {ranks[1]._items[i][0].uid for i in loaded} == rank1  # its own rows' waves, no other
    for e in (0, 1):
        for b1, b0, bb in zip(one.epoch(e), ranks[0].epoch(e), ranks[1].epoch(e)):
            uids = b0.uids + bb.uids
            assert [u for u in uids if u] == [u for u in b1.uids if u]
            for k in ("wav", "wav_len", "text", "text_len"):
                both = np.concatenate([getattr(b0, k), getattr(bb, k)])
                np.testing.assert_array_equal(both[:len(b1.uids)], getattr(b1, k), err_msg=k)
                assert not both[len(b1.uids):].any()  # the rows padding to a multiple of 2


def test_decode_shards_choose_batches_before_loading():
    """``epoch(shard=(r, n))`` keeps batches r, r + n, ... of the epoch's
    order, and together the shards are the epoch."""
    from e2e_asr_tpu_torch.data.dataset import load_dataset

    tr = load_dataset(TConfig.from_dict({"data": _loader_data()}).data, num_workers=0)[0]
    full = [b.uids for b in tr.epoch(2)]
    shards = [[b.uids for b in tr.epoch(2, shard=(r, 3))] for r in range(3)]
    assert sorted(sum(shards, [])) == sorted(full)
    assert all(shards[i % 3][i // 3] == u for i, u in enumerate(full))


def test_text_loader_row_blocks_put_together_are_the_one_process_batch():
    from e2e_asr_tpu_torch.data import corpus
    from e2e_asr_tpu_torch.data.dataset import TextLoader, build_tokenizer

    utts = corpus.load_corpus("synthetic", "", ["train:24"])
    tok = build_tokenizer(TConfig.from_dict({"data": {"text": {"mode": "character"}}}).data, utts)
    one = TextLoader(utts, tok, 4, seed=2)
    ranks = [TextLoader(utts, tok, 4, seed=2, process_index=r, process_count=2) for r in (0, 1)]
    for b1, b0, bb in zip(one.epoch(1), ranks[0].epoch(1), ranks[1].epoch(1)):
        for k in b1:
            both = np.concatenate([b0[k], bb[k]])
            np.testing.assert_array_equal(both[:len(b1[k])], b1[k])


# --------------------------------------------------- the global-batch loss
def _global_batch():
    """``mp_worker.global_batch`` with rank 1's rows (4-7 of 8) cut to two
    labels: the ranks hold 24 and 12 target tokens."""
    from e2e_asr_tpu.parallel.mp_worker import global_batch

    b = global_batch(b=8, vocab=16)
    for i in range(4, 8):
        b["text"][i, 2] = 1
        b["text"][i, 3:] = 0
        b["text_len"][i] = 3
    return b


def test_two_ranks_give_the_global_batch_loss_and_gradients(tmp_path):
    from e2e_asr_tpu.parallel.mp_worker import _tiny_config, loss_and_grads

    jcfg = _tiny_config()
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, 16, jcfg.model)
    tp = convert.params_from_jax(jax.device_get(jp))
    batch = _global_batch()
    assert batch["text_len"][:4].sum() != batch["text_len"][4:].sum()
    ckpt = str(tmp_path / "params.pt")
    convert.save_checkpoint(ckpt, tp, 16, 40)
    np.savez(tmp_path / "batch.npz", **batch)
    spec = {"config": _save_config(jcfg.to_dict(), tmp_path / "tiny.yaml"), "params": ckpt,
            "batch": str(tmp_path / "batch.npz"), "out": str(tmp_path / "grads.npz")}
    _run("grads", spec, tmp_path)
    got = np.load(tmp_path / "grads.npz")
    assert int(got["world"]) == 2

    # the one-rank port on the global batch
    tcfg = TConfig.from_dict(jcfg.to_dict())
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = compute_loss(tp, tcfg, tb["wav"], tb["wav_len"], tb["text"], tb["text_len"], 1.0, None, train=False)
    grads = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, leaves)]).numpy()
    np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(got["grads"], grads, rtol=1e-4, atol=1e-6)

    # the JAX package's single-process loss and gradients (tests/test_multiprocess.py's tolerances)
    jloss, jgrads = loss_and_grads(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = torch.cat([g.reshape(-1) for g in param_leaves(convert.params_from_jax(jax.device_get(jgrads)))]).numpy()
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(got["grads"], want, rtol=1e-4, atol=1e-6)

    # a mean of the ranks' own losses is not the global batch's loss here:
    # it misses by more than 10x the tolerance above
    halves = []
    with torch.no_grad():
        for r in (0, 1):
            rows = mp_worker.local_rows(tb, r, 2)
            halves.append(float(compute_loss(tp, tcfg, rows["wav"], rows["wav_len"], rows["text"], rows["text_len"],
                                             1.0, None, train=False)[0]))
    assert abs(np.mean(halves) - float(got["loss"])) > 1e-4 * abs(float(got["loss"]))


def _step_config(**hparas):
    """The flagship's structure at test size with dither, SpecAugment,
    encoder and speller dropout on (the loop speller, teacher forcing 1)."""
    d = small_config()
    d["data"]["audio"].update(use_pallas=True, dither=1e-3)
    d["hparas"] = dict(dtype="float32", tf_start=1.0, tf_end=1.0, optimizer="Adadelta", lr=1.0, eps=1e-8,
                       grad_clip=5.0, **hparas)
    d["model"]["encoder"]["dropout"] = [0.2, 0.1]
    d["model"]["decoder"]["dropout"] = 0.1
    d["model"]["specaugment"] = {"enable": True, "freq_mask_width": 5, "time_mask_width": 10}
    return d


def test_two_rank_step_with_dropout_and_specaugment_is_the_global_step(tmp_path):
    """One eager train step on two ranks (dither, SpecAugment, dropout at
    the global shape; the global loss; one summed buffer of gradients)
    against the one-rank step on the global batch from the same weights and
    seed; the two ranks' parameters are equal bit for bit."""
    d = _step_config()
    jc = JConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, 16, jc.model)
    ckpt = str(tmp_path / "params.pt")
    convert.save_checkpoint(ckpt, convert.params_from_jax(jax.device_get(jp)), 16, 40)
    batch = _global_batch()
    np.savez(tmp_path / "batch.npz", **batch)
    spec = {"config": _save_config(d, tmp_path / "step.yaml"), "params": ckpt, "batch": str(tmp_path / "batch.npz"),
            "seed": 5, "out": str(tmp_path / "step")}
    _run("step", spec, tmp_path)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=True) for r in (0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    assert float(ranks[0]["step_skipped"]) == 0.0

    trainer = Trainer(TConfig.from_dict(d))
    state = trainer.init_state(convert.load_checkpoint(ckpt, torch.device("cpu"))["params"])
    params0 = [p.detach().clone() for p in param_leaves(state.params)]
    one = mp_worker.step_result(trainer, state, {k: torch.from_numpy(v) for k, v in batch.items()}, 5, "cpu")
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(one["grad_norm"]), rtol=1e-4)
    moved = max(float((a - b).abs().max()) for a, b in zip(one["params"], params0))
    assert moved > 1e-5  # the step moved the parameters
    for a, b in zip(got["params"], one["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ solvers over ranks
def _train_yaml(tmp_path, max_step=3):
    """The flagship's structure at test size on the synthetic corpus (one
    bucket, batches of 4 = 2 rows a rank), dither, SpecAugment, dropout and
    a validation in the middle and at the end."""
    d = _step_config(max_step=max_step, valid_step=2, log_step=1, curriculum=0)
    d["data"]["corpus"] = {"name": "synthetic", "train_split": ["train:8"], "dev_split": ["dev:4"],
                           "batch_size": 4, "buckets": [416], "token_buckets": [48], "half_batch_len": 1000,
                           "num_workers": 0}
    d["data"]["text"] = {"mode": "character"}
    return _save_config(d, tmp_path / "train.yaml")


def test_two_rank_solver_exec_and_validate_give_the_one_rank_summary(tmp_path):
    """``Solver.exec`` (3 steps, a validation at step 2) + ``validate`` on
    two ranks: the summary of the one-rank run (error rates exact, losses
    within rtol 1e-6), the same summary on both ranks, the steps' losses and
    the global audio; rank 0 alone wrote logs and checkpoints."""
    spec = {"config": _train_yaml(tmp_path), "dir": str(tmp_path / "runs"), "out": str(tmp_path / "train")}
    _run("train", spec, tmp_path)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    one = mp_worker.train_run({**spec, "dir": str(tmp_path / "one")}, "single")
    assert ranks[0]["summary"] == ranks[1]["summary"]
    got, want = ranks[0]["summary"], one["summary"]
    assert set(got) == set(want) and {"dev_er_att", "dev_er_ctc", "loss"} <= set(got)
    for k in want:
        if "loss" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:
            assert got[k] == want[k], k
    assert len(ranks[0]["step_log"]) == len(one["step_log"]) == 3
    for g, w in zip(ranks[0]["step_log"], one["step_log"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["audio_s"], w["audio_s"], rtol=1e-12)  # the global batch's audio
    assert all(a.shape == b.shape for a, b in zip(ranks[0]["params"], one["params"]))
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    written = set(ranks[0]["files"])
    assert {"log/mp/scalars.jsonl", "ckpt/mp/latest", "ckpt/mp/best_att", "ckpt/mp/tokenizer.vocab"} <= written
    assert ranks[1]["files"] == []


def test_two_rank_throughput_tag_is_the_ranks_own_audio_over_the_window(tmp_path):
    """``throughput_audio_sec_per_sec_chip`` (the JAX solver's tag) is per
    card under two ranks: rank 0's own rows' audio over the window's wall
    (one step a window here), not the global batch's audio summed over the
    ranks; the step log keeps both counts."""
    import json

    spec = {"config": _train_yaml(tmp_path, max_step=2), "dir": str(tmp_path / "runs"),
            "out": str(tmp_path / "thr")}
    _run("train", spec, tmp_path)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    with open(tmp_path / "runs" / "rank0" / "log" / "mp" / "scalars.jsonl") as f:
        thr = {r["step"]: r["value"] for r in map(json.loads, f) if r["tag"] == "throughput_audio_sec_per_sec_chip"}
    assert sorted(thr) == [1, 2]
    for rec, other in zip(ranks[0]["step_log"], ranks[1]["step_log"]):
        own, glob = rec["rank_audio_s"], rec["audio_s"]
        assert 0 < own < glob and own + other["rank_audio_s"] == pytest.approx(glob, rel=1e-12)
        np.testing.assert_allclose(thr[rec["step"]], own / rec["wall_s"], rtol=0.05)
        assert thr[rec["step"]] < 0.95 * glob / rec["wall_s"]


def _decode_yaml(tmp_path):
    """configs/synthetic_decode.yaml on 6 dev and 6 test utterances in
    batches of 2 (3 a split: rank 0 decodes batches 0 and 2, rank 1 batch
    1), src pointed at a small training config; and a checkpoint of JAX
    weights."""
    from e2e_asr_tpu_torch.data import corpus
    from e2e_asr_tpu_torch.data.dataset import build_tokenizer

    train_d = small_config()
    train_d["data"] = {"corpus": {"name": "synthetic", "train_split": ["train:16"]},
                       "audio": {"feat_dim": 40, "use_pallas": True}, "text": {"mode": "character"}}
    train_yaml = tmp_path / "dtrain.yaml"
    train_yaml.write_text(yaml.safe_dump(train_d))
    with open(os.path.join(ROOT, "configs", "synthetic_decode.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"]["corpus"].update(train_split=["train:16"], dev_split=["dev:6"], test_split=["test:6"],
                               buckets=[416], token_buckets=[48], num_workers=0)
    d["src"] = {"ckpt": "", "config": str(train_yaml)}
    d["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    path = tmp_path / "decode.yaml"
    path.write_text(yaml.safe_dump(d))
    tok = build_tokenizer(TConfig.from_dict(train_d).data, corpus.load_corpus("synthetic", "", ["train:16"]))
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, tok.vocab_size, JConfig.from_dict(train_d).model)
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, convert.params_from_jax(jax.device_get(jp)), tok.vocab_size, 40)
    return str(path), ckpt


def test_two_rank_decode_writes_the_one_rank_csvs(tmp_path):
    """A two-rank decode (batches sharded before loading, rows gathered to
    rank 0): both splits' csvs bit for bit the one-rank decode's, one error
    rate on both ranks, the one-rank run's; rank 1 wrote nothing."""
    cfg, ckpt = _decode_yaml(tmp_path)
    spec = {"config": cfg, "ckpt": ckpt, "dir": str(tmp_path / "runs"), "out": str(tmp_path / "decode")}
    _run("decode", spec, tmp_path)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    one = mp_worker.decode_run({**spec, "dir": str(tmp_path / "one")}, "single")
    assert set(one["csvs"]) == {"output_dev.csv", "beam_dev.csv", "output_test.csv", "beam_test.csv"}
    assert ranks[0]["csvs"] == one["csvs"]
    assert ranks[0]["er"] == ranks[1]["er"] == one["er"]
    assert len(one["csvs"]["output_dev.csv"].splitlines()) >= 4  # 3 batches or more: rank 1 decoded one
    assert ranks[1]["files"] == []


def _lm_yaml(tmp_path):
    with open(os.path.join(ROOT, "configs", "synthetic_lm.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"]["corpus"].update(train_split=["train:16"], dev_split=["dev:4"])
    d["hparas"].update(max_step=4, valid_step=2, log_step=1)
    d["lm"].update(emb_dim=16, dim=24, n_layers=2, batch_size=4)
    return _save_config(d, tmp_path / "lm.yaml")


def test_two_rank_lm_training_gives_the_one_rank_loss_and_perplexity(tmp_path):
    """``bin/train_lm.Solver.exec`` (4 steps with dropout, validations at 2
    and 4) on two ranks: the one-rank steps' losses and dev perplexity."""
    spec = {"config": _lm_yaml(tmp_path), "dir": str(tmp_path / "runs"), "out": str(tmp_path / "lm")}
    _run("lm", spec, tmp_path)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    one = mp_worker.lm_run({**spec, "dir": str(tmp_path / "one")}, "single")
    assert ranks[0]["dev_ppl"] == ranks[1]["dev_ppl"]
    np.testing.assert_allclose(ranks[0]["dev_ppl"], one["dev_ppl"], rtol=1e-5)
    assert len(ranks[0]["step_log"]) == len(one["step_log"]) == 4
    for g, w in zip(ranks[0]["step_log"], one["step_log"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert g["n_tokens"] == w["n_tokens"]  # the global batch's tokens
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    assert "ckpt/mp/best_ppl" in ranks[0]["files"] and ranks[1]["files"] == []


def test_a_group_of_one_gives_the_bits_of_no_group(tmp_path):
    """Training (with its validations) and the LM trainer without a group,
    then in a gloo group of one (the collectives and the flat buffer in the
    step): summary, step log and parameters bit for bit."""
    spec = {"config": _train_yaml(tmp_path), "dir": str(tmp_path / "runs"), "out": str(tmp_path / "w1.pt"),
            "modes": ["train"]}
    _run("world1", spec, tmp_path, nproc=1)
    res = torch.load(spec["out"], weights_only=False)
    assert res["train"]["same"] == {"summary": True, "params": True, "step_log": True}
    lm = {"config": _lm_yaml(tmp_path), "dir": str(tmp_path / "lmruns"), "out": str(tmp_path / "w1lm.pt"),
          "modes": ["lm"]}
    _run("world1", lm, tmp_path / "lm", nproc=1)
    assert torch.load(lm["out"], weights_only=False)["lm"]["same"] == {"dev_ppl": True, "params": True,
                                                                      "step_log": True}


def test_eval_losses_of_the_sums_are_eval_devices_losses_bitwise():
    """A dev batch's losses divided from its summed numerators and
    denominators (``Trainer.eval_losses``, what a sharded validation
    divides) are ``eval_device``'s ``scalars`` bit for bit in a world of
    one, and rows of two halves' sums give the whole batch's losses."""
    d = small_config()
    tc = TConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, 16, JConfig.from_dict(d).model)
    trainer = Trainer(tc)
    tp = convert.params_from_jax(jax.device_get(jp))
    batch = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    out = trainer.eval_device(tp, batch, 8)
    assert trainer.sum_keys() == ("att_num", "att_den", "ctc_num", "ctc_den")
    assert torch.equal(trainer.eval_losses(out["sums"][None])[0], out["scalars"])
    halves = [trainer.eval_device(tp, mp_worker.local_rows(batch, r, 2), 8)["sums"] for r in (0, 1)]
    torch.testing.assert_close(trainer.eval_losses((halves[0] + halves[1])[None])[0], out["scalars"],
                               rtol=1e-6, atol=0)


def test_loop_speller_samples_at_the_ranks_own_shape(monkeypatch):
    """The Python-loop speller's sampled feedback (``asr.sample_tokens``)
    takes this rank's rows' probabilities (its noise is drawn at the global
    shape, as the dropout masks before it are, so that the generator stays
    in step with a world of one's)."""
    from e2e_asr_tpu_torch.models import asr as tasr

    d = small_config()
    tc = TConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, 16, JConfig.from_dict(d).model)
    tp = convert.params_from_jax(jax.device_get(jp))
    shapes, draws = [], []
    real_sample, real_rand = tasr.sample_tokens, torch.rand
    monkeypatch.setattr(tasr, "sample_tokens", lambda p, *a, **k: shapes.append(tuple(p.shape)) or
                        real_sample(p, *a, **k))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: draws.append(tuple(a[0])) or real_rand(*a, **k))
    monkeypatch.setattr(dist, "world", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    feat = torch.randn(3, 24, 40)
    gen = torch.Generator()
    gen.manual_seed(0)
    tasr.forward(tp, tc.model, feat, torch.tensor([24, 20, 16]), decode_step=4, tf_rate=0.0,
                 teacher=torch.ones(3, 4, dtype=torch.long), generator=gen, train=True)
    assert shapes and all(s[0] == 3 for s in shapes)  # the rank's 3 rows
    gen1 = torch.Generator()
    gen1.manual_seed(7)
    gen2 = torch.Generator()
    gen2.manual_seed(7)
    logits = torch.randn(3, 16)
    monkeypatch.setattr(dist, "world", lambda: 1)
    monkeypatch.setattr(dist, "rank", lambda: 0)
    one = real_sample(torch.cat([torch.randn(3, 16), logits]), gen1)
    monkeypatch.setattr(dist, "world", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    assert torch.equal(real_sample(logits, gen2), one[3:])  # rank 1's rows sample as in a world of one
    assert torch.equal(gen1.get_state(), gen2.get_state())
    assert (4,) in draws  # the coins: one a step, alike on every rank


def test_main_multihost_under_torchrun_trains_and_rank0_writes(tmp_path):
    """The documented launch, ``python -m torch.distributed.run
    --nproc-per-node 2 -m e2e_asr_tpu_torch.main --config ... --cpu
    --multihost``: both ranks train to max_step and shut the group down;
    rank 0's ``latest`` holds the step and the optimizer's count."""
    import subprocess
    import sys

    cfg = _train_yaml(tmp_path, max_step=2)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "e2e_asr_tpu_torch.main", "--config", cfg, "--cpu", "--multihost", "--name", "tr",
         "--logdir", str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt"), "--no-auto-resume"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = torch.load(tmp_path / "ckpt" / "tr" / "latest", weights_only=True)
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    assert proc.stdout.count("Data parallel: 2 ranks (gloo)") == 1  # rank 0 alone prints


@pytest.mark.parametrize("dp,mp,ok", [(-1, 1, True), (1, 1, True), (2, 1, False), (-1, 2, False)])
def test_parallel_config_is_checked_against_the_world(dp, mp, ok):
    """``parallel.dp`` is the world size (-1 takes it) and ``parallel.mp`` 1;
    anything else raises, in a world of one here."""
    if ok:
        dist.check_config(dp, mp)
    else:
        with pytest.raises(ValueError):
            dist.check_config(dp, mp)


def test_without_a_group_every_collective_is_the_identity():
    """A world of one without a group: rank 0 of 1, no-op sums, the plain
    draw, rank 0 gathering its own object."""
    assert not dist.initialized() and (dist.rank(), dist.world(), dist.is_main()) == (0, 1, True)
    t = torch.arange(3.0)
    assert dist.all_sum_(t) is t and torch.equal(t, torch.arange(3.0))
    np.testing.assert_array_equal(dist.allsum_scalars([1.0, 2.5]), [1.0, 2.5])
    np.testing.assert_array_equal(dist.allmean_scalars([1.0, 2.5]), [1.0, 2.5])
    calls = []
    dist.local_first(lambda: calls.append(1))
    assert calls == [1]
    assert dist.gather_to_main({"a": 1}) == [{"a": 1}] and dist.row_block(4) == (0, 4)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    assert torch.equal(dist.global_draw(torch.rand, (2, 5), g1), torch.rand((2, 5), generator=g2))
