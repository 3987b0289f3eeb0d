"""The port's fused speller scan (``ops/decoder_cuda.py``; on CPU tensors its
plain versions) against the JAX package's fused Pallas scan (interpret
mode) and its ``lax.scan``, and against the port's own Python loop.

The model is the one of ``tests/test_decoder_pallas.py`` (no prenet, one
BiLSTM layer with 2x time reduction, location attention at temperature 0.5,
a 16-wide LSTM speller, no CTC head), weights from JAX ``asr_init`` carried
over by ``convert.params_from_jax``, inputs from numpy seeds. Random draws
cannot match ``jax.random``, so the cases against JAX are the deterministic
ones: tf_rate 1.0 and tf_rate 0.0 with argmax feedback.

Tolerances (f32 on both sides, sums in other orders): values rtol 1e-4,
atol 1e-5; gradients rtol 1e-3 with atol 1e-4 of the tensor's largest entry
(tighter than ``tests/test_decoder_pallas.py``'s 2e-3 and 1e-2 / 1e-3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.ops import decoder_cuda as dc
from e2e_asr_tpu_torch.training.step import param_leaves

torch.set_num_threads(1)
VOCAB = 9
V_RTOL, V_ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL_REL = 1e-3, 1e-4
OUTS = ("att_logits", "align", "att_hidden")


def cfg_dict(temperature=0.5, **decoder):
    return {
        "data": {"audio": {"feat_dim": 40, "use_pallas": False}},
        "hparas": {"dtype": "float32"},
        "model": {
            "ctc_weight": 0.0,
            "encoder": {"prenet": "", "dim": [8], "dropout": [0.0], "layer_norm": [False],
                        "proj": [True], "sample_rate": [2], "sample_style": "drop"},
            "attention": {"mode": "location", "dim": 12, "num_head": 1, "temperature": temperature,
                          "loc_kernel_size": 5, "loc_kernel_num": 3},
            "decoder": {"dim": 16, "layer": 1, **decoder},
        },
    }


def models(d, fused_jax="scan", fused_port="pallas"):
    """(jax model cfg, port model cfg, jax params, port params)."""
    dj, dt = copy.deepcopy(d), copy.deepcopy(d)
    dj["model"]["decoder"]["fused_scan"] = fused_jax
    dt["model"]["decoder"]["fused_scan"] = fused_port
    jc, tc = JConfig.from_dict(dj).model, TConfig.from_dict(dt).model
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, VOCAB, jc)
    return jc, tc, jp, convert.params_from_jax(jax.device_get(jp))


def inputs(lens=(37, 28), t=37, l=11, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lens)
    feat = (rng.randn(b, t, 40) * 0.3).astype(np.float32)
    teacher = np.zeros((b, l), np.int32)
    for i in range(b):
        k = max(l - 2 - i, 0)
        teacher[i, :k] = rng.randint(3, VOCAB, size=k)
        teacher[i, k] = 1
    return feat, np.asarray(lens, np.int32), teacher


def gen(seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def port_forward(params, cfg, feat, feat_len, teacher, tf, sample, train=True, seed=3):
    return tasr.forward(params, cfg, torch.from_numpy(feat), torch.from_numpy(feat_len),
                        teacher.shape[1], tf_rate=tf, teacher=torch.from_numpy(teacher),
                        generator=gen(seed) if train else None, train=train, sample_decoding=sample)


def all_outputs_loss(out, teacher):
    """The loss of tests/test_decoder_pallas.py: it touches all three outputs."""
    logp = torch.log_softmax(out["att_logits"], -1)
    nll = -logp.gather(2, torch.from_numpy(teacher).long()[..., None])[..., 0]
    return nll.sum() + 0.01 * (out["align"] ** 2).sum() + 0.01 * torch.tanh(out["att_hidden"]).sum()


def close_grads(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=G_RTOL, atol=G_ATOL_REL * max(float(np.abs(w).max()), 1e-6),
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------ (a) against JAX
def model_cfg(taps="default"):
    """``cfg_dict()``; with taps "wide", 8 filters of 33 taps over 18 encoder
    frames: the convergence recipe's 8 x 65 taps over the 52 frames of its
    shortest bucket, at test size."""
    d = cfg_dict()
    if taps == "wide":
        d["model"]["attention"].update(loc_kernel_size=16, loc_kernel_num=8)
    return d


@pytest.mark.parametrize("fused_jax", ["pallas", "scan"])
@pytest.mark.parametrize("tf,sample,taps", [
    pytest.param(1.0, True, "default", id="1.0-True"), pytest.param(0.0, False, "default", id="0.0-False"),
    pytest.param(1.0, True, "wide", id="1.0-True-wide_taps"),
    pytest.param(0.0, False, "wide", id="0.0-False-wide_taps")])
def test_fused_forward_matches_jax(fused_jax, tf, sample, taps):
    jc, tc, jp, tp = models(model_cfg(taps), fused_jax)
    feat, feat_len, teacher = inputs()
    jo = jasr.forward(jp, jc, jnp.asarray(feat), jnp.asarray(feat_len), teacher.shape[1], tf_rate=tf,
                      teacher=jnp.asarray(teacher), rng=jax.random.PRNGKey(5), train=True,
                      sample_decoding=sample)
    to = port_forward(tp, tc, feat, feat_len, teacher, tf, sample)
    for k in OUTS:
        assert tuple(to[k].shape) == tuple(jo[k].shape), k
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=V_RTOL, atol=V_ATOL, err_msg=k)
    s_valid = int(to["enc_len"][1])
    assert s_valid < to["align"].shape[-1]
    if taps == "wide":
        assert to["align"].shape[-1] < 2 * tc.attention.loc_kernel_size + 1
    assert float(to["align"][1, :, 0, s_valid:].abs().max()) == 0.0
    if tf == 0.0:  # the run really fed its own predictions
        assert (to["att_logits"].argmax(-1)[:, :-1].numpy() != teacher[:, :-1]).any()


# ------------------------------------------------------------ (b) every gradient
@pytest.mark.parametrize("fused_jax,taps", [
    pytest.param("pallas", "default", id="pallas"), pytest.param("scan", "default", id="scan"),
    pytest.param("pallas", "wide", id="pallas-wide_taps"), pytest.param("scan", "wide", id="scan-wide_taps")])
def test_fused_gradients_match_jax(fused_jax, taps):
    jc, tc, jp, tp = models(model_cfg(taps), fused_jax)
    feat, feat_len, teacher = inputs()

    def jloss(params):
        out = jasr.forward(params, jc, jnp.asarray(feat), jnp.asarray(feat_len), teacher.shape[1],
                           tf_rate=1.0, teacher=jnp.asarray(teacher), rng=jax.random.PRNGKey(5),
                           train=True, sample_decoding=True)
        logp = jax.nn.log_softmax(out["att_logits"], -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(teacher)[..., None], -1)[..., 0]
        return (jnp.sum(nll) + 0.01 * jnp.sum(out["align"] ** 2)
                + 0.01 * jnp.sum(jnp.tanh(out["att_hidden"])))

    want = param_leaves(convert.params_from_jax(jax.device_get(jax.grad(jloss)(jp))))
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    loss = all_outputs_loss(port_forward(tp, tc, feat, feat_len, teacher, 1.0, True), teacher)
    got = torch.autograd.grad(loss, leaves)
    close_grads(got, want, f"grad vs jax {fused_jax}")


# ------------------------------------------- (c) against the port's own loop
LOOP_CASES = {
    "ragged_tf1": dict(lens=(37, 28, 19), tf=1.0),
    "enc_len_1": dict(lens=(37, 2, 3), tf=1.0),
    "one_step": dict(lens=(37, 28), tf=1.0, l=1),
    "temperature_2": dict(lens=(37, 21), tf=1.0, temperature=2.0),
    "argmax_feedback": dict(lens=(37, 28), tf=0.0),
    "mixed_coins": dict(lens=(37, 2, 30), tf=0.5),
    "eval": dict(lens=(37, 28), tf=1.0, train=False),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_fused_route_matches_loop(case):
    c = dict(LOOP_CASES[case])
    d = cfg_dict(c.pop("temperature", 0.5))
    train = c.pop("train", True)
    _, tc_f, _, tp = models(d, fused_port="pallas")
    _, tc_l, _, _ = models(d, fused_port="scan")
    feat, feat_len, teacher = inputs(c["lens"], l=c.get("l", 11))
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    res = []
    for cfg in (tc_f, tc_l):
        out = port_forward(tp, cfg, feat, feat_len, teacher, c["tf"], False, train=train)
        grads = torch.autograd.grad(all_outputs_loss(out, teacher), leaves)
        res.append((out, grads))
    (of, gf), (ol, gl) = res
    assert of["align"].shape == ol["align"].shape == (len(c["lens"]), teacher.shape[1], 1, 18)
    for k in OUTS:
        np.testing.assert_allclose(of[k].detach().numpy(), ol[k].detach().numpy(), rtol=V_RTOL,
                                   atol=V_ATOL, err_msg=k)
        assert torch.isfinite(of[k]).all()
    close_grads([g.numpy() for g in gf], [g.numpy() for g in gl], case)
    for i, n in enumerate(of["enc_len"].tolist()):
        assert float(of["align"].detach()[i, :, 0, n:].abs().max() if n < 18 else 0.0) == 0.0


# ------------------------ (d) the explicit backward sweep against autograd
def _scan_args(seed=0, b=3, s=9, dk=6, e_dim=10, kk=2, p=5, h=8, emb=4, v=7, l=5):
    rng = np.random.RandomState(seed)
    r = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return [torch.tanh(r(b, s, dk)), torch.tanh(r(b, s, e_dim)), torch.tensor([s, 4, 1]),
            0.5 * r(kk, p), 0.4 * r(h, dk), 0.1 * r(dk), 0.5 * r(kk, dk), 0.5 * r(dk), 0.1 * r(dk),
            0.5 * r(v, emb), 0.3 * r(emb + e_dim, 4 * h), 0.3 * r(h, 4 * h), 0.1 * r(4 * h),
            0.4 * r(h, v), 0.1 * r(v), torch.from_numpy(rng.randint(0, v, (l, b)).astype(np.int32))]


def test_backward_sweep_matches_autograd_of_plain_forward():
    """decoder_scan_bwd_plain's streams and sums against autograd through
    the plain forward loop: dk, dWlp, dlocv directly; dgates and dq through
    the bias gradients they sum to; dfpre through the taps' gradient."""
    args = _scan_args()
    use = torch.ones(5, dtype=torch.bool)
    names = "k v enc_len taps wq bq wlp locv locb embed wx wh bl wout bout".split()
    leaves = {n: a.clone().requires_grad_() for n, a in zip(names, args) if n != "enc_len"}
    call = [leaves.get(n, a) for n, a in zip(names, args)] + [args[-1]]
    logits, align, hidden, (cseq, tokens, acts, qs, ctxs) = dc.decoder_scan_fwd_plain(*call, use, 0.7)
    rng = np.random.RandomState(1)
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in (logits, align, hidden)]
    want = dict(zip(leaves, torch.autograd.grad(
        sum((o * c).sum() for o, c in zip((logits, align, hidden), cots)), list(leaves.values()))))
    k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout, _ = args
    with torch.no_grad():
        dgates, dq, dfpre, dk, dwlp, dlocv = dc.decoder_scan_bwd_plain(
            k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
            ctxs, *cots, 0.7)
    got = {"k": dk, "wlp": dwlp, "locv": dlocv, "bl": dgates.sum((0, 1)), "bq": dq.sum((0, 1)),
           "locb": dq.sum((0, 1))}
    for n, g in got.items():
        close_grads([g.numpy()], [want[n].numpy()], n)
    # and the whole autograd function (the sweep plus the outside contractions)
    leaves2 = {n: a.clone().requires_grad_() for n, a in zip(names, args) if n != "enc_len"}
    call2 = [leaves2.get(n, a) for n, a in zip(names, args)] + [args[-1]]
    outs = dc.decoder_scan(*call2, use, 0.7)
    got2 = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), list(leaves2.values()))
    close_grads([g.numpy() for g in got2], [w.numpy() for w in want.values()], "DecoderScanFn")


# ------------------------------------------------ (e) envelope and dispatch
def test_supported_envelope():
    cfg = TConfig.from_dict(cfg_dict()).model
    assert dc.supported(cfg, train=True)
    for section, key, val in (("attention", "mode", "dot"), ("attention", "num_head", 2),
                              ("attention", "v_proj", True), ("decoder", "layer", 2)):
        bad = copy.deepcopy(cfg)
        setattr(getattr(bad, section), key, val)
        assert not dc.supported(bad, train=True), (section, key)
    drop = copy.deepcopy(cfg)
    drop.decoder.dropout = 0.5
    assert not dc.supported(drop, train=True)
    assert dc.supported(drop, train=False)
    assert dc.fits(320, 300) and dc.fits(256, 128)
    assert not dc.fits(324, 300) and not dc.fits(1024, 300) and not dc.fits(320, 600)


@pytest.mark.parametrize("what", ["dot", "two_layers", "dropout"])
def test_pallas_raises_outside_envelope_and_others_take_the_loop(what, monkeypatch):
    d = cfg_dict()
    if what == "dot":
        d["model"]["attention"]["mode"] = "dot"
    elif what == "two_layers":
        d["model"]["decoder"]["layer"] = 2
    else:
        d["model"]["decoder"]["dropout"] = 0.5
    feat, feat_len, teacher = inputs()
    _, tc, _, tp = models(d, fused_port="pallas")
    with pytest.raises(ValueError, match="envelope"):
        port_forward(tp, tc, feat, feat_len, teacher, 1.0, False)
    calls = []
    monkeypatch.setattr(dc, "run_decode_scan", lambda *a, **k: calls.append(1))
    for fused in ("auto", "scan"):
        tc.decoder.fused_scan = fused
        out = port_forward(tp, tc, feat, feat_len, teacher, 1.0, False)
        assert out["att_logits"].shape == (2, 11, VOCAB)
    assert not calls
    tc.decoder.fused_scan = "fused"
    with pytest.raises(ValueError, match="fused_scan"):
        port_forward(tp, tc, feat, feat_len, teacher, 1.0, False)


def test_dispatch_inside_envelope(monkeypatch):
    """'pallas' takes the fused scan, 'scan' the loop, and 'auto' the loop
    for CPU tensors (the kernels are for CUDA tensors)."""
    feat, feat_len, teacher = inputs()
    _, tc, _, tp = models(cfg_dict())
    calls = []
    real = dc.run_decode_scan
    monkeypatch.setattr(dc, "run_decode_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    for fused, n in (("pallas", 1), ("scan", 1), ("auto", 1)):
        tc.decoder.fused_scan = fused
        port_forward(tp, tc, feat, feat_len, teacher, 1.0, False)
        assert len(calls) == n, fused


def test_sampled_feedback_draws_valid_ids():
    """tf 0 with sampling: the tokens fed are ids below the vocabulary size,
    <sos> first, they follow the generator's seed, and the outputs are finite."""
    args = _scan_args(v=7, l=12)
    use = torch.zeros(12, dtype=torch.bool)
    runs = [dc.decoder_scan_fwd(*args, use, 1.0, True, generator=gen(s)) for s in (1, 1, 2)]
    toks = [r[3][1] for r in runs]
    assert toks[0].dtype == torch.int32 and tuple(toks[0].shape) == (12, 3)
    assert int(toks[0].min()) >= 0 and int(toks[0].max()) < 7 and bool((toks[0][0] == 0).all())
    assert torch.equal(toks[0], toks[1]) and not torch.equal(toks[0], toks[2])
    greedy = dc.decoder_scan_fwd(*args, use, 1.0, False)[3][1]
    assert not torch.equal(toks[0], greedy)
    assert all(torch.isfinite(o).all() for o in runs[0][:3])
    # a given noise buffer decides the draw
    noise = torch.zeros((12, 3, 7))
    noise[:, :, 4] = 100.0
    fed = dc.decoder_scan_fwd(*args, use, 1.0, True, noise=noise)[3][1]
    assert bool((fed[1:] == 4).all())


# ----------------------------------------- (f) the grid's cluster size
@pytest.mark.parametrize("b,s,want", [(16, 204, 6), (1, 204, 8), (32, 204, 6), (16, 764, 6), (40, 61, 5)])
def test_pick_cluster_size(b, s, want):
    """The cluster size the kernels run at, from the resident-cluster counts
    of a 132-SM H100 at one block an SM: every utterance of a flagship batch
    gets its own cluster where a size allows it; a size that fits no
    cluster is never taken."""
    h100 = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30}
    assert dc.pick_cluster_size(b, s, h100.get) == want
    assert dc.pick_cluster_size(b, s, lambda cl: 0 if cl == want else h100[cl]) != want


# ------------------------- (f2) the backward's grid: frames over every block
H100_BWD = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 39, 2: 66, 1: 132}  # clusters resident, one block an SM
BWD_SHAPES = [(8, 408), (8, 764), (16, 408), (16, 764), (16, 204), (16, 52), (1, 3000), (1, 5), (32, 204),
              (40, 61), (140, 204), (200, 61)]


def _bwd_plan(b, s, lens=None):
    """(cluster size, clusters, deal) the backward takes for B utterances of
    S frames (``lens``: their lengths, all S if None) on a 132-SM H100."""
    cl = dc.pick_bwd_cluster_size(b, s, H100_BWD.get)
    g = H100_BWD[cl]
    return cl, g, dc.bwd_deal([s] * b if lens is None else lens, g, cl)


def _ragged(b, s, seed):
    """Lengths in [0, S], one of S and, past one utterance, one of 0."""
    lens = np.random.default_rng(seed).integers(0, s + 1, b).tolist()
    lens[0] = s
    if b > 1:
        lens[-1] = 0
    return lens


@pytest.mark.parametrize("b,s", BWD_SHAPES)
@pytest.mark.parametrize("ragged", [False, True])
def test_bwd_deal_holds_every_frame_once(b, s, ragged):
    """Every valid frame of every utterance falls in exactly one (block,
    slot), each block's frames are consecutive and at most the plan's bound
    (the kernel's per-frame buffers), and an utterance's blocks hold frames
    that differ by at most one."""
    lens = _ragged(b, s, b * 7919 + s) if ragged else [s] * b
    cl, g, blocks = _bwd_plan(b, s, lens)
    assert len(blocks) == g * cl and all(len(row) == dc._cdiv(b, g) for row in blocks)
    held = [np.zeros(n, dtype=int) for n in lens]
    per_utt = [[] for _ in range(b)]
    for row in blocks:
        for seg in row:
            if seg is None:
                continue
            u, s0, nv = seg
            assert 0 <= s0 and s0 + nv <= lens[u] and nv <= dc.bwd_frames(b, s, g, cl)
            held[u][s0:s0 + nv] += 1
            per_utt[u].append(nv)
    assert all((h == 1).all() for h in held)
    assert all(max(n) - min(n) <= 1 for n in per_utt)


@pytest.mark.parametrize("b,s,frames", [(8, 408, 26), (8, 764, 48), (16, 408, 51), (16, 764, 96)])
def test_bwd_deal_gives_every_block_of_the_grid_frames(b, s, frames):
    """At the training cells' long buckets (B 8 flagship, B 16 asr960h) the
    backward's grid takes every SM of the card (66 clusters of 2) and every
    block holds frames: 16 or 8 blocks an utterance, half to three quarters
    of the frames a block of one 8- or 6-block cluster an utterance (51, 96,
    68, 128)."""
    cl, g, blocks = _bwd_plan(b, s)
    assert g * cl == 132 and dc._cdiv(b, g) == 1
    assert all(row[0] is not None and row[0][2] > 0 for row in blocks)
    assert max(row[0][2] for row in blocks) == dc.bwd_frames(b, s, g, cl) == frames
    utts = [sum(row[0][0] == u for row in blocks) for u in range(b)]
    assert min(utts) >= 132 // b - 1 and sum(utts) == 132


def test_bwd_deal_gives_longer_utterances_more_blocks():
    """Ragged lengths: the deal gives an utterance blocks as its frames
    need, so the longest holds no more frames a block than an even split of
    S would give it, and a short one takes fewer blocks."""
    lens = [408, 400, 300, 250, 220, 210, 205, 60]
    cl, g, blocks = _bwd_plan(8, 408, lens)
    count = [sum(row[0][0] == u for row in blocks) for u in range(8)]
    frames = max(row[0][2] for row in blocks)
    assert count[0] >= count[3] >= count[7] and count[7] < 132 // 8
    assert frames <= dc.bwd_frames(8, 408, g, cl)


@pytest.mark.parametrize("b,cl", [(16, 8), (32, 6), (140, 4), (200, 1), (15, 8)])
def test_bwd_deal_keeps_one_cluster_a_slot_where_b_reaches_the_clusters(b, cl):
    """B >= G (the clusters of the size): ceil(B / G) slots, each utterance
    in one slot of one cluster, its frames over that cluster's blocks, the
    ranks dealt in a snake order (rank G is in the last cluster's second
    slot)."""
    g, s = H100_BWD[cl], 204
    lens = [s - u for u in range(b)]  # ranked by index
    blocks = dc.bwd_deal(lens, g, cl)
    ns = dc._cdiv(b, g)
    where = {}
    for j, row in enumerate(blocks):
        assert len(row) == ns
        for i, seg in enumerate(row):
            if seg is not None:
                where.setdefault(seg[0], set()).add((j // cl, i))
    assert sorted(where) == list(range(b)) and all(len(v) == 1 for v in where.values())
    assert where[0] == {(0, 0)} and (b <= g or where[g] == {(g - 1, 1)})


@pytest.mark.parametrize("b,s,want", [(8, 408, 2), (16, 764, 2), (16, 52, 6), (1, 3000, 8), (40, 61, 1),
                                      (140, 204, 4)])
def test_pick_bwd_cluster_size(b, s, want):
    """The backward's cluster size from the same resident counts, sizes 1 to
    8: the fewest frames a block, slots and parts of dq weighed; a size
    that fits no cluster is never taken."""
    assert dc.pick_bwd_cluster_size(b, s, H100_BWD.get) == want
    assert dc.pick_bwd_cluster_size(b, s, lambda cl: 0 if cl == want else H100_BWD[cl]) != want


# ------------------------------- (g) the steps run: a batch's longest label
SCAN_L = 8
STEPS = (0, 1, SCAN_L // 2, SCAN_L)
NAMES = "k v enc_len taps wq bq wlp locv locb embed wx wh bl wout bout".split()


def _steps(n):
    return torch.tensor([n], dtype=torch.int32)


def _label_mask(text_len, l=SCAN_L):
    """[L, B, 1]: 1 where the step is inside the utterance's label."""
    return (torch.arange(l)[:, None] < torch.as_tensor(text_len)[None, :]).float()[..., None]


def _text_len(n, b=3):
    """Label lengths whose longest is n (a padding row of 0 among them)."""
    return [n, max(n - 3, 0), 0][:b]


@pytest.mark.parametrize("n", STEPS)
def test_plain_scan_runs_the_first_n_steps_and_zeros_the_rest(n):
    """Every output and residual of the plain forward: bitwise the uncut
    run's on steps < n, zero past them; n = L and None give today's result."""
    args = _scan_args(l=SCAN_L)
    use = torch.tensor([True, False] * (SCAN_L // 2))
    flat = lambda out: list(out[:3]) + list(out[3])
    full = flat(dc.decoder_scan_fwd(*args, use, 0.7))
    cut = flat(dc.decoder_scan_fwd(*args, use, 0.7, steps=_steps(n)))
    for i, (c, f) in enumerate(zip(cut, full)):
        assert c.shape == f.shape and c.dtype == f.dtype, i
        assert torch.equal(c[:n], f[:n]), i
        assert not c[n:].any(), i
    if n == SCAN_L:
        assert all(torch.equal(c, f) for c, f in zip(cut, full))


@pytest.mark.parametrize("n", STEPS)
def test_plain_backward_sweep_over_n_steps_is_the_uncut_sweep_of_a_masked_loss(n):
    """The plain backward sweep from step n - 1 back, given cotangents that
    are zero past each utterance's label (the longest n): its streams and
    sums bitwise the uncut sweep's (up to the sign of an exact zero, which
    torch.equal does not see), the streams zero past n."""
    args = _scan_args(l=SCAN_L)
    k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout, _ = args
    use = torch.ones(SCAN_L, dtype=torch.bool)
    logits, align, hidden, (cseq, _, acts, qs, ctxs) = dc.decoder_scan_fwd_plain(*args, use, 0.7)
    rng = np.random.RandomState(2)
    mask = _label_mask(_text_len(n))
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) * mask for o in (logits, align, hidden)]
    common = (k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctxs,
              *cots, 0.7)
    full = dc.decoder_scan_bwd(*common)
    cut = dc.decoder_scan_bwd(*common, steps=_steps(n))
    for i, (c, f) in enumerate(zip(cut, full)):
        assert torch.equal(c, f), i
    for c in cut[:3]:
        assert not c[n:].any()


@pytest.mark.parametrize("n", STEPS)
def test_scan_gradients_of_a_masked_loss_are_the_uncut_ones(n):
    """Through the autograd function (the sweeps and the products over L*B
    outside them): the gradients of every input of a loss masked past each
    utterance's label are bitwise those of the uncut scan."""
    args = _scan_args(l=SCAN_L)
    use = torch.ones(SCAN_L, dtype=torch.bool)
    mask = _label_mask(_text_len(n))
    rng = np.random.RandomState(3)
    cots = None
    grads = []
    for steps in (None, _steps(n)):
        leaves = {nm: a.clone().requires_grad_() for nm, a in zip(NAMES, args) if nm != "enc_len"}
        call = [leaves.get(nm, a) for nm, a in zip(NAMES, args)] + [args[-1]]
        outs = dc.decoder_scan(*call, use, 0.7, steps=steps)
        if cots is None:
            cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) * mask for o in outs]
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for name, g_full, g_cut in zip([nm for nm in NAMES if nm != "enc_len"], *grads):
        assert torch.equal(g_cut, g_full), name
    assert n == 0 or any(g.abs().sum() > 0 for g in grads[1])


def test_scan_counts_the_bucket_and_the_steps_run():
    """Each forward adds L to the host counter ``scan.bucket_steps`` and the
    steps it ran to the device counter ``scan.steps_run``, in the bank the
    tracer is in; the backward counts nothing."""
    from e2e_asr_tpu_torch.utils import tracing

    args = _scan_args(l=SCAN_L)
    use = torch.ones(SCAN_L, dtype=torch.bool)
    counts = lambda bank="untraced": {k: tracing.snapshot(bank)["counts"].get(k, 0)
                                      for k in ("scan.bucket_steps", "scan.steps_run")}
    before = counts()
    dc.decoder_scan_fwd(*args, use, 0.7)
    dc.decoder_scan_fwd(*args, use, 0.7, steps=_steps(3))
    dc.decoder_scan_fwd(*args, use, 0.7, steps=_steps(SCAN_L + 5))  # clamped to L
    out = dc.decoder_scan(args[0].clone().requires_grad_(), *args[1:], use, 0.7, steps=_steps(2))
    after = counts()
    assert after["scan.bucket_steps"] - before["scan.bucket_steps"] == 4 * SCAN_L
    assert after["scan.steps_run"] - before["scan.steps_run"] == SCAN_L + 3 + SCAN_L + 2
    sum(o.sum() for o in out).backward()
    assert counts() == after
    from torch.profiler import ProfilerActivity, profile

    counter = tracing.device_counter("scan.steps_run", "cpu")
    traced = counts("traced")
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("train.step"):  # the tracer's bank follows the profiler at a span's entry
            dc.decoder_scan_fwd(*args, use, 0.7, steps=_steps(5))
            assert int(counter[0]) == 1
    with tracing.span("train.step"):
        assert int(counter[0]) == 0
    now = counts("traced")
    assert [now[k] - traced[k] for k in ("scan.bucket_steps", "scan.steps_run")] == [SCAN_L, 5]
    assert counts() == after


def _wav_batch(text_len=(7, 4, 0), l=SCAN_L, seed=0):
    rng = np.random.RandomState(seed)
    wav_len = np.array([4000, 2600, 3000], np.int32)
    wav = (0.1 * rng.randn(3, 4000)).astype(np.float32)
    text = np.zeros((3, l), np.int32)
    for i, m in enumerate(text_len):
        wav[i, wav_len[i]:] = 0.0
        if m:
            text[i, : m - 1] = rng.randint(3, VOCAB, size=m - 1)
            text[i, m - 1] = 1
    return {"wav": torch.from_numpy(wav), "wav_len": torch.from_numpy(wav_len), "text": torch.from_numpy(text),
            "text_len": torch.tensor(text_len, dtype=torch.int32)}


def test_training_loss_takes_the_cut_and_evaluation_does_not(monkeypatch):
    """compute_loss(train=True) on the fused route (plain versions) runs the
    batch's longest label of the bucket's L steps, with the loss and every
    gradient bitwise those of all L steps; eval_step runs all L."""
    from e2e_asr_tpu_torch.training.step import Trainer, compute_loss
    from e2e_asr_tpu_torch.utils import tracing

    d = cfg_dict()
    d["model"]["decoder"]["fused_scan"] = "pallas"
    cfg = TConfig.from_dict(d)
    _, _, _, tp = models(d)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    b = _wav_batch()
    counts = lambda: [tracing.snapshot()["counts"].get(k, 0) for k in ("scan.steps_run", "scan.bucket_steps")]

    def loss_and_grads():
        loss, _ = compute_loss(tp, cfg, b["wav"], b["wav_len"], b["text"], b["text_len"], 1.0, gen(), train=True)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    c0 = counts()
    cut = loss_and_grads()
    c1 = counts()
    assert [a - z for a, z in zip(c1, c0)] == [7, SCAN_L]
    real_heads = tasr.heads
    monkeypatch.setattr(tasr, "heads", lambda *a, **k: real_heads(*a, **{**k, "steps": None}))
    full = loss_and_grads()
    assert [a - z for a, z in zip(counts(), c1)] == [SCAN_L, SCAN_L]
    monkeypatch.undo()
    assert torch.equal(cut[0], full[0])
    for i, (g, w) in enumerate(zip(cut[1], full[1])):
        assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), i
    c2 = counts()
    with torch.no_grad():
        m = Trainer(cfg).eval_step(tp, b)
    assert [a - z for a, z in zip(counts(), c2)] == [SCAN_L, SCAN_L]
    assert m["att_preds"].shape == (3, SCAN_L)
