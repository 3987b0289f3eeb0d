"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes the flagship run does not reach: odd batch (one row per
LSTM block), T not a multiple of the kernels' tiles, a wave shorter than
one window, S large enough to need more than 48 KB of shared memory, N not
a multiple of the block size, B = 1, CTC rows with no alignment and with no
labels. Marked ``cuda``: they skip without a card. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import math
from unittest import mock

import pytest
import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.decode import ctc_prefix
from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc
from e2e_asr_tpu_torch.ops import att_step_cuda as asc
from e2e_asr_tpu_torch.ops import ctc_cuda
from e2e_asr_tpu_torch.ops import frontend_cuda as fec
from e2e_asr_tpu_torch.ops import rnn_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [100, 400, 7000, 24160])
def test_log_mel_kernel(gen, n):
    cfg = AudioConfig(feat_dim=40)
    wav = 0.1 * torch.randn((3, n), generator=gen, device="cuda")
    before = fec.log_mel.launches
    got = fec.log_mel(wav, cfg, 400, 160, 512)
    assert fec.log_mel.launches == before + 1
    _close(got, fec.log_mel_plain(wav, cfg, 400, 160, 512), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("b,t,d,h", [(3, 11, 40, 32), (2, 17, 1280, 320), (5, 9, 24, 104), (16, 30, 640, 320)])
def test_lstm_kernel(gen, b, t, d, h):
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1.0 / math.sqrt(h)
    x = torch.randn((t, b, d), generator=gen, device="cuda")
    wx = (torch.rand((2, d, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    wh = (torch.rand((2, h, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    bias = (torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    args = (x, mask, wx, wh, bias)
    _close(rnn_cuda.lstm_bidir_fwd(*args), rnn_cuda.lstm_bidir_fwd_plain(*args), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,e_dim", [(7, 16), (300, 64), (1100, 48)])
def test_att_step_kernel(gen, s, e_dim):
    b, w, dk, kk, p = 2, 3, 20, 10, 2 * 50 + 1
    q = torch.randn((b, w, dk), generator=gen, device="cuda")
    prev = torch.softmax(torch.randn((b, w, s), generator=gen, device="cuda"), -1)
    k = torch.tanh(torch.randn((b, s, dk), generator=gen, device="cuda"))
    v = torch.randn((b, s, e_dim), generator=gen, device="cuda")
    lens = torch.tensor([s, max(1, s // 3)], device="cuda")
    taps = torch.randn((kk, p), generator=gen, device="cuda") / math.sqrt(p)
    wlp = torch.randn((kk, dk), generator=gen, device="cuda") / math.sqrt(kk)
    locv = torch.randn((dk,), generator=gen, device="cuda") / math.sqrt(dk)
    locb = torch.randn((dk,), generator=gen, device="cuda")
    args = (q, prev, k, v, lens, taps, wlp, locv, locb, 0.5)
    got, want = asc.att_step_beam_loc(*args), asc.att_step_beam_loc_plain(*args)
    _close(got[0], want[0], rtol=1e-4, atol=1e-6)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,w,k,t", [(1, 1, 3, 5), (3, 4, 7, 61)])
def test_prefix_recursion_kernel(gen, b, w, k, t):
    v = 9
    lp = torch.log_softmax(3.0 * torch.randn((b, t, v), generator=gen, device="cuda"), -1)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    r_g = ctc_prefix.init_empty_prefix(lp, lens, w)
    cand = torch.randint(1, v, (b, w, k), generator=gen, device="cuda")
    ins = ctc_prefix.recursion_inputs(lp, lens, r_g, torch.zeros((b, w), dtype=torch.long, device="cuda"), cand, True)
    for g, want in zip(cpc.prefix_recursion(*ins), cpc.prefix_recursion_plain(*ins)):
        keep = want > -1e20
        assert torch.equal(g > -1e20, keep)
        _close(g[keep], want[keep], rtol=1e-5, atol=2e-3)


def _lstm_args(gen, b, t, d, h, full=False):
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    if full:
        lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1.0 / math.sqrt(h)
    x = torch.tanh(torch.randn((t, b, d), generator=gen, device="cuda"))
    wx = (torch.rand((2, d, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    wh = (torch.rand((2, h, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    bias = (torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    return x, mask, wx, wh, bias


LSTM_TRAIN_SHAPES = [(1, 9, 40, 64), (3, 11, 24, 64), (3, 17, 1280, 320), (1, 33, 640, 320)]


@pytest.mark.parametrize("b,t,d,h", LSTM_TRAIN_SHAPES)
def test_lstm_train_fwd_kernel(gen, b, t, d, h):
    """ys, the c carry and the gate activations of the training variant."""
    args = _lstm_args(gen, b, t, d, h)
    before = rnn_cuda.lstm_bidir_fwd_train.launches
    got = rnn_cuda.lstm_bidir_fwd_train(*args)
    assert rnn_cuda.lstm_bidir_fwd_train.launches == before + 1
    for g, w in zip(got, rnn_cuda.lstm_bidir_fwd_train_plain(*args)):
        _close(g, w, rtol=1e-4, atol=1e-4)


def _close_scaled(got, want, rtol):
    """allclose with atol = rtol * max|want|: sums over many rows whose
    terms cancel."""
    _close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("b,t,d,h", LSTM_TRAIN_SHAPES)
def test_lstm_bwd_kernel(gen, b, t, d, h):
    """dx, dWx, dWh, db of the backward kernel against the plain reverse
    sweep, and the autograd function against autograd of the plain forward
    (tolerance rtol 1e-4, atol 1e-4 of the largest entry)."""
    x, mask, wx, wh, bias = _lstm_args(gen, b, t, d, h, full=True)
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, bias)
    dy = torch.randn(ys.shape, generator=gen, device="cuda")
    before = rnn_cuda.lstm_bidir_bwd.launches
    got = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
    assert rnn_cuda.lstm_bidir_bwd.launches == before + 1
    for g, w in zip(got, rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)):
        _close_scaled(g, w, 1e-4)
    leaves = [a.clone().requires_grad_() for a in (x, wx, wh, bias)]
    want = torch.autograd.grad(
        (rnn_cuda.lstm_bidir_fwd_plain(leaves[0], mask, *leaves[1:]) * dy).sum(), leaves)
    ys_k = rnn_cuda.lstm_bidir_train(leaves[0], mask, *leaves[1:])
    got = torch.autograd.grad((ys_k * dy).sum(), leaves)
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-4)


@pytest.mark.parametrize("b,t,v,l", [(1, 7, 5, 3), (4, 61, 12, 20), (3, 204, 30, 199)])
def test_ctc_lattice_kernel(gen, b, t, v, l):
    """nll and gamma against the plain lattice, with one row that has no
    alignment (+inf, zero gradient) and one with no labels; the gradient of
    CTCLossFn against the plain route (scatter order differs on the card)."""
    lp = torch.log_softmax(3.0 * torch.randn((b, t, v), generator=gen, device="cuda"), -1)
    labels = torch.randint(1, v, (b, l), generator=gen, device="cuda")
    labels[:, 1:3] = labels[:, :1]  # repeated labels forbid the skip
    inlen = torch.randint(max(1, t // 2), t + 1, (b,), generator=gen, device="cuda")
    lablen = torch.randint(0, l + 1, (b,), generator=gen, device="cuda")
    lablen[0] = l
    inlen[0] = max(1, l - 1)  # too few frames: no alignment
    if b > 1:
        lablen[1] = 0
    labels = torch.where(torch.arange(l, device="cuda")[None] < lablen[:, None], labels, 0)
    before = ctc_cuda.ctc_lattice.launches
    nll, gamma = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)
    assert ctc_cuda.ctc_lattice.launches == before + 1
    nll_p, gamma_p = ctc_cuda.ctc_lattice_plain(lp, labels, inlen, lablen)
    assert float(nll[0]) > ctc_cuda.BIG and float(nll_p[0]) > ctc_cuda.BIG
    _close(nll[1:], nll_p[1:], rtol=1e-5, atol=1e-4)
    # row 0 has no alignment: its gamma is never used (zero gradient)
    low = gamma_p[1:] < ctc_cuda.NEG / 2
    assert torch.equal(gamma[1:] < ctc_cuda.NEG / 2, low)
    _close(gamma[1:][~low], gamma_p[1:][~low], rtol=1e-5, atol=1e-3)
    lp_k = lp.clone().requires_grad_()
    loss_k = ctc_cuda.CTCLossFn.apply(lp_k, inlen, labels, lablen)
    assert torch.isinf(loss_k[0])
    (g_k,) = torch.autograd.grad(torch.where(torch.isfinite(loss_k), loss_k, 0.0).sum(), lp_k)
    assert float(g_k[0].abs().max()) == 0.0
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        lp_p = lp.clone().requires_grad_()
        loss_p = ctc_cuda.CTCLossFn.apply(lp_p, inlen, labels, lablen)
        (g_p,) = torch.autograd.grad(torch.where(torch.isfinite(loss_p), loss_p, 0.0).sum(), lp_p)
    _close(g_k, g_p, rtol=1e-5, atol=1e-5)
