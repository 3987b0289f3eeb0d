"""The ESPnet LibriSpeech RNN recipe on the port, held on the CPU to its
plain reference ``asr_bench/reference/espnet_rnn.py`` at test size, from the
weights the benchmark draws: the VGG2L listener with its output projection
(ceil lengths, odd T), the CTC head, the two-layer speller queried by its
first layer (teacher-forced logits, the joint loss and every leaf's
gradient), and the beam search through ``decode/beam.py`` against the
reference's search, over a units vocabulary. A control: the same port with
the query from the top layer misses the reference by far more than the
tolerance. The existing recipes keep their parameter trees and the ``vgg`` /
``proj`` route's outputs bitwise. The recipe trains through ``main`` and
decodes through ``bin/test_asr.py``.

Tolerances: every comparison is float32 against float32 (TF32 is off on the
CPU); the two sides sum in other orders (cuDNN-style packed LSTM against the
port's loop, ``F.ctc_loss`` against the port's lattice, a conv2d against
another), so each is float32 round-off grown through the layers: 1e-5
absolute on the listener's tanh outputs and the log-probs (values of order
1, a few hundred products deep), 2e-5 relative on the loss, 1e-4 relative
(over the largest gradient of the leaf) on the gradients, whose leaves sum
many products."""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from asr_bench import weights
from asr_bench.reference import decode as ref_decode
from asr_bench.reference import espnet_rnn as A
from asr_bench.reference import model as M
from asr_bench.reference import search as ref_search
from asr_bench.reference import train as ref_train
from e2e_asr_tpu_torch.config import Config
from e2e_asr_tpu_torch.decode import beam as beam_mod
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.models import encoder as enc_mod
from e2e_asr_tpu_torch.ops import decoder_cuda
from e2e_asr_tpu_torch.training import step as step_mod
from e2e_asr_tpu_torch.training.step import param_leaves
from e2e_asr_tpu_torch.utils import tracing

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT, VOCAB = 40, 43  # 40 units and the three reserved ids
FP32 = M.Precision("fp32")


def recipe(**decoder) -> dict:
    """The benchmark's espnet_rnn recipe at test size: its structure (VGG2L,
    BLSTM layers without projections, one output projection, location
    attention, a two-layer speller queried by layer 0, CTC 0.5), float32."""
    with open(os.path.join(ROOT, "asr_bench", "configs", "espnet_rnn.json")) as f:
        r = copy.deepcopy(json.load(f)["recipe"])
    r["data"]["audio"]["feat_dim"] = FEAT
    r["hparas"]["dtype"] = "float32"
    m = r["model"]
    m["encoder"].update(dim=[16, 16], dropout=[0.0] * 2, layer_norm=[False] * 2, proj=[False] * 2,
                        sample_rate=[1] * 2, out_proj=12)
    m["attention"].update(dim=8, loc_kernel_size=3, loc_kernel_num=2)
    m["decoder"].update(dim=16, **decoder)
    m["specaugment"]["enable"] = False
    r["decode"].update(beam_size=4, ctc_weight=0.3, lm_weight=0.0, max_len_ratio=0.8)
    return r


# weights scaled so that the speller's two layers' states differ and the
# attention's query moves its output: the query and key projections and the
# energies' vector x8 (a sharper alignment), layer 0's input weights, layer
# 1's weights and the output x3. At the drawn scale a query from either layer
# gives logits within 7e-6 of each other (the tolerance is 1e-5)
SHARPEN = {"att.proj_q.w": 8.0, "att.proj_q.b": 8.0, "att.proj_k.w": 8.0, "att.loc_v": 8.0,
           "dec.l0.wx": 3.0, "dec.l1.wx": 3.0, "dec.l1.wh": 3.0, "dec.l1.b": 3.0, "dec.char.w": 3.0}


def model(r: dict, seed: int = 5, sharpen: bool = False):
    """(config, the reference's flat weights, the port's tree over them);
    with ``sharpen`` the weights scaled by ``SHARPEN``."""
    flat = weights.draw(A.leaves(r["model"], FEAT, VOCAB), seed, "cpu")
    if sharpen:
        flat.update({k: flat[k] * s for k, s in SHARPEN.items()})
    return Config.from_dict(r), flat, A.port_tree(flat, r["model"])


def feats(t: int, lens, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((len(lens), t, FEAT), generator=g)
    lens = torch.tensor(lens)
    mask = (torch.arange(t)[None, :] < lens[:, None])[..., None]
    return torch.where(mask, x, 0.0), lens


def texts(lens, seed: int = 1):
    """Targets [B, L] (units, then <eos> = 1, 0-padded) and their lengths."""
    g = torch.Generator().manual_seed(seed)
    big_l = max(lens)
    out = torch.zeros((len(lens), big_l), dtype=torch.long)
    for i, n in enumerate(lens):
        out[i, : n - 1] = torch.randint(3, VOCAB, (n - 1,), generator=g)
        out[i, n - 1] = 1
    return out, torch.tensor(lens)


@pytest.mark.parametrize("t, lens", [(64, [64, 41, 33]), (61, [61, 58, 7])])
def test_listener_matches_the_reference_with_ceil_lengths(t, lens):
    r = recipe()
    cfg, flat, tree = model(r)
    x, x_len = feats(t, lens)
    enc, enc_len = enc_mod.encoder_apply(tree["encoder"], cfg.model.encoder, x, x_len)
    ref, ref_len = A.encode(flat, r["model"], x, x_len, FP32)
    want = [math.ceil(math.ceil(n / 2) / 2) for n in lens]
    assert enc_len.tolist() == ref_len.tolist() == want
    assert enc.shape == (len(lens), math.ceil(math.ceil(t / 2) / 2), 12)
    torch.testing.assert_close(enc, ref, rtol=0, atol=1e-5)
    assert not enc[1, want[1]:].any()


def test_vgg2l_takes_one_channel_and_pools_in_ceil_mode():
    cfg, _, tree = model(recipe())
    assert tree["encoder"]["prenet"]["conv1"]["w"].shape == (64, 1, 3, 3)
    _, dim = enc_mod.vgg2l_init(torch.Generator().manual_seed(0), 80)
    assert dim == 2560  # ESPnet's 128 x 20 over 80 fbank bins
    x, x_len = feats(7, [7, 5, 1])
    out, out_len = enc_mod.vgg2l_apply(tree["encoder"]["prenet"], x, x_len)
    assert out.shape == (3, 2, 128 * 10) and out_len.tolist() == [2, 2, 1]


def test_ctc_log_probs_match_the_reference():
    r = recipe()
    _, flat, tree = model(r)
    enc = torch.randn((3, 9, 12), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(asr_mod.ctc_log_probs(tree, enc), A.ctc_log_probs(flat, enc, FP32), rtol=0, atol=1e-5)


def _spell(cfg, tree, r, flat, x, x_len, text):
    """(port logits, reference logits) teacher-forced over ``text``."""
    out = asr_mod.forward(tree, cfg.model, x, x_len, decode_step=text.shape[1], teacher=text)
    enc, enc_len = A.encode(flat, r["model"], x, x_len, FP32)
    tokens_in = torch.cat([text.new_zeros((text.shape[0], 1)), text[:, :-1]], 1)
    return out["att_logits"], M.speller(A, flat, r["model"], enc, enc_len, tokens_in, FP32)


def test_teacher_forced_logits_match_the_reference():
    r = recipe()
    cfg, flat, tree = model(r, sharpen=True)
    assert asr_mod.speller_route(tree, cfg.model, True, torch.device("cpu")) == "loop"
    x, x_len = feats(48, [48, 30])
    text, _ = texts([9, 6])
    port, ref = _spell(cfg, tree, r, flat, x, x_len, text)
    torch.testing.assert_close(port, ref, rtol=0, atol=1e-5)


def test_a_top_layer_query_misses_the_first_layer_reference():
    """The control: with the second layer's weights scaled so that its state
    is not the first's, the port queried by the top layer is far from the
    reference queried by the first (the tolerance above is 1e-5)."""
    r = recipe()
    cfg, flat, tree = model(r, sharpen=True)
    cfg.model.decoder.query_layer = "top"
    x, x_len = feats(48, [48, 30])
    text, _ = texts([9, 6])
    port, ref = _spell(cfg, tree, r, flat, x, x_len, text)
    assert float((port - ref).abs().max()) > 1e-2  # 1,000 times the tolerance
    cfg.model.decoder.query_layer = "first"
    port, _ = _spell(cfg, tree, r, flat, x, x_len, text)
    torch.testing.assert_close(port, ref, rtol=0, atol=1e-5)


def test_one_layer_reads_the_same_query_from_either_end():
    r = recipe(layer=1)
    cfg = Config.from_dict(r)
    tree, _ = asr_mod.asr_init(0, FEAT, VOCAB, cfg.model, torch.device("cpu"))
    x, x_len = feats(24, [24, 17])
    text, _ = texts([5, 4])
    top = asr_mod.forward(tree, cfg.model, x, x_len, decode_step=5, teacher=text)["att_logits"]
    cfg.model.decoder.query_layer = "first"
    first = asr_mod.forward(tree, cfg.model, x, x_len, decode_step=5, teacher=text)["att_logits"]
    assert torch.equal(top, first)
    cfg.model.decoder.query_layer = "middle"
    with pytest.raises(ValueError, match="query_layer"):
        asr_mod.forward(tree, cfg.model, x, x_len, decode_step=5, teacher=text)


def test_the_fused_scan_takes_one_layer_only():
    cfg = Config.from_dict(recipe())
    assert not decoder_cuda.supported(cfg.model, True) and not decoder_cuda.supported(cfg.model, False)
    cfg.model.decoder.layer = 1
    assert decoder_cuda.supported(cfg.model, True)


def test_loss_and_every_gradient_match_the_reference(monkeypatch):
    r = recipe()
    cfg, flat, tree = model(r, sharpen=True)
    x, x_len = feats(64, [64, 45, 29])
    text, text_len = texts([11, 7, 4])
    wav = torch.zeros((3, 10), dtype=torch.int16)  # features are given: both sides read x
    monkeypatch.setattr(step_mod, "compute_features", lambda *a, **k: (x, x_len))
    monkeypatch.setattr(M, "features", lambda *a, **k: (x, x_len))
    leaves = param_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = step_mod.compute_loss(tree, cfg, wav, x_len, text, text_len, tf=1.0, generator=None, train=True)
    grads = torch.autograd.grad(loss, leaves)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    ref = ref_train.joint_loss(A, w, r, ref_train.RefBatch(wav, x_len, text, text_len, 7, 1.0), FP32)
    names = param_leaves(A.port_tree({k: k for k in flat}, r["model"]))
    ref_grads = torch.autograd.grad(ref, [w[n] for n in names])
    assert math.isclose(float(loss.detach()), float(ref.detach()), rel_tol=2e-5)
    assert len(names) == len(flat)
    for n, g, rg in zip(names, grads, ref_grads):
        scale = float(rg.abs().max())
        assert scale > 0, n
        assert float((g - rg).abs().max()) <= 1e-4 * scale, n


def test_beam_search_holds_to_the_reference_search(monkeypatch):
    """The port's batched beam search (beam 4, CTC 0.3) over units: the
    same n-best lists as the reference's float64 search, every returned
    score within float32 round-off of the reference's rescoring."""
    r = recipe()
    cfg, flat, tree = model(r, sharpen=True)
    x, x_len = feats(96, [96, 71, 40])
    monkeypatch.setattr(M, "features", lambda *a, **k: (x, x_len))
    max_step = 12
    got = beam_mod.beam_search(tree, cfg.model, cfg.decode, x, x_len, max_step)
    wav = torch.zeros((3, 10), dtype=torch.int16)
    dcfg = r["decode"]
    want = ref_search.search(A, flat, r, wav, x_len, dcfg, max_step, FP32)
    assert torch.equal(got.tokens, want["tokens"]) and torch.equal(got.lengths, want["lengths"])
    np.testing.assert_allclose(got.scores.double().numpy(), want["scores"].numpy(), rtol=0, atol=2e-5)
    res = ref_decode.rescore(A, flat, r, wav, x_len, got.tokens, got.lengths, dcfg, FP32)
    assert ref_decode.check(got.tokens, got.lengths, got.scores, res, VOCAB, max_step) is None
    np.testing.assert_allclose(got.scores.numpy(), res["score"].numpy(), rtol=0, atol=2e-6)


def test_the_loop_counts_its_steps_and_the_fused_scan_does_not():
    cfg = Config.from_dict(recipe(layer=1))
    tree, _ = asr_mod.asr_init(0, FEAT, VOCAB, cfg.model, torch.device("cpu"))
    x, x_len = feats(24, [24, 17])
    text, _ = texts([5, 4])
    before = tracing.counted("speller.loop_steps")
    asr_mod.forward(tree, cfg.model, x, x_len, decode_step=5, teacher=text)
    assert tracing.counted("speller.loop_steps") == before + 5
    cfg.model.decoder.fused_scan = "pallas"
    asr_mod.forward(tree, cfg.model, x, x_len, decode_step=5, teacher=text)
    assert tracing.counted("speller.loop_steps") == before + 5


# ------------------------------------------- the existing recipes, unchanged
def _flagship_tree():
    from tests.torch_parity import small_config

    cfg = Config.from_dict(small_config())
    return cfg, asr_mod.asr_init(3, FEAT, 30, cfg.model, torch.device("cpu"))[0]


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def test_existing_recipes_keep_their_parameter_trees():
    """The flagship's structure (``vgg``, per-layer ``proj``, one speller
    layer) draws the tree it drew before ``vgg2l``, ``out_proj`` and
    ``query_layer``: the same names, shapes and values (the sums of the
    seed-3 draws, recorded before the change)."""
    cfg, tree = _flagship_tree()
    names = _names(tree)
    assert "encoder/out_proj/w" not in names and len(names) == len(param_leaves(tree)) == 40
    assert tree["encoder"]["prenet"]["conv1"]["w"].shape == (64, 1, 3, 3)
    sums = [float(p.double().sum()) for p in param_leaves(tree)]
    assert math.isclose(sum(abs(s) for s in sums), GOLDEN_ABS_SUM, rel_tol=1e-12)


def _parent_encoder(p, cfg, x, x_len):
    """The ``vgg`` route as it stood before ``vgg2l`` and ``out_proj``:
    floor-mode pools, lengths // 4, each layer's BiLSTM, tanh projection and
    mask."""
    from e2e_asr_tpu_torch.models import layers as L
    from e2e_asr_tpu_torch.ops import rnn as rnn_ops

    b, t, d = x.shape
    ch, base = enc_mod.infer_vgg_channels(d)
    h = x.reshape(b, t, ch, base).permute(0, 2, 1, 3)
    pp = p["prenet"]
    h = F.max_pool2d(torch.relu(L.conv2d(pp["conv2"], torch.relu(L.conv2d(pp["conv1"], h)))), 2, 2)
    h = F.max_pool2d(torch.relu(L.conv2d(pp["conv4"], torch.relu(L.conv2d(pp["conv3"], h)))), 2, 2)
    b2, c2, t2, f2 = h.shape
    out, lens = h.permute(0, 2, 1, 3).reshape(b2, t2, c2 * f2), torch.div(x_len, 4, rounding_mode="floor")
    for lp in p["layers"]:
        out = rnn_ops.bidir(out, lens, lp["fwd"], lp["bwd"], cell="lstm", impl=cfg.rnn_impl)
        out = torch.tanh(L.dense(lp["proj"], out))
        out = torch.where((torch.arange(out.shape[1])[None, :] < lens[:, None])[..., None], out, 0.0)
    return out, torch.clamp(lens, min=1)


@pytest.mark.parametrize("t, lens", [(64, [64, 41]), (63, [63, 21])])
def test_the_vgg_and_proj_route_is_bitwise_unchanged(t, lens):
    cfg, tree = _flagship_tree()
    x, x_len = feats(t, lens)
    enc, enc_len = enc_mod.encoder_apply(tree["encoder"], cfg.model.encoder, x, x_len)
    old, old_len = _parent_encoder(tree["encoder"], cfg.model.encoder, x, x_len)
    assert torch.equal(enc, old) and torch.equal(enc_len, old_len)


# the flagship test tree's sum of |sum of each leaf| at seed 3, before the change
GOLDEN_ABS_SUM = 322.31644150401974


# ------------------------------------------------- main and bin/test_asr.py
def test_the_recipe_trains_through_main_and_decodes_through_test_asr(tmp_path):
    from e2e_asr_tpu_torch.main import main as cli_main

    r = recipe()
    r["data"] = {"corpus": {"name": "synthetic", "train_split": ["train:8"], "dev_split": ["dev:4"],
                            "test_split": ["test:4"], "batch_size": 4, "buckets": [416], "token_buckets": [48],
                            "half_batch_len": 1000},
                 "audio": {"feat_dim": FEAT}, "text": {"mode": "character"}}
    r["hparas"].update(valid_step=2, max_step=2, log_step=1)
    r["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    train_yaml = tmp_path / "espnet_tiny.yaml"
    train_yaml.write_text(yaml.safe_dump(r))
    dirs = ["--logdir", str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"]
    cli_main(["--config", str(train_yaml), "--cpu", "--name", "esp", *dirs])
    payload = torch.load(tmp_path / "ckpt" / "esp" / "latest", weights_only=True)
    assert payload["step"] == 2 and "out_proj" in payload["params"]["encoder"]
    assert len(payload["params"]["decoder"]["cells"]) == 2
    d = copy.deepcopy(r)
    d["src"] = {"ckpt": "", "config": str(train_yaml)}
    decode_yaml = tmp_path / "decode.yaml"
    decode_yaml.write_text(yaml.safe_dump(d))
    ers = cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", str(tmp_path / "ckpt" / "esp" / "latest"),
                    "--name", "esp", "--outdir", str(tmp_path / "res"), "--no-msg"])
    assert set(ers) == {"dev", "test"} and all(np.isfinite(v) for v in ers.values())


def test_a_large_vocabulary_takes_the_ctc_log_softmax_in_float32():
    """Below float32 the CTC head's log-softmax runs in float32 on the
    compute type's logits from ``CTC_FLOAT32_VOCAB`` classes on, and keeps
    the bfloat16 rounding points bit for bit below it."""
    g = torch.Generator().manual_seed(4)
    enc = torch.randn((2, 9, 12), generator=g).bfloat16()
    w, b = torch.randn((12, 64), generator=g), torch.randn((64,), generator=g)
    for v in (asr_mod.CTC_FLOAT32_VOCAB - 1, asr_mod.CTC_FLOAT32_VOCAB):
        logits = enc @ w[:, :v].bfloat16() + b[:v].bfloat16()
        got = asr_mod.ctc_log_probs({"ctc": {"w": w[:, :v], "b": b[:v]}}, enc)
        want = (torch.log_softmax(logits.float(), -1) if v >= asr_mod.CTC_FLOAT32_VOCAB
                else asr_mod.L.log_softmax(logits, -1))
        assert got.dtype == want.dtype and torch.equal(got, want), v
