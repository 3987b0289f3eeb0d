"""The BiLSTM layer's training forward and backward in the port
(``ops/rnn_cuda.py``: ``lstm_bidir_fwd_train_plain``, ``lstm_bidir_bwd_plain``
and the autograd function ``lstm_bidir_train``, which run their plain
versions on CPU tensors) against the JAX package's Pallas kernel
``rnn_pallas.lstm_seq_fused`` in interpret mode: its residuals, and
``jax.vjp`` of it, with ragged lengths. Then ``ops/rnn.py`` ``bidir``
gradients against ``jax.grad`` of the JAX ``bidir`` on the Pallas path.

Layouts: the Pallas kernel pads T to a multiple of its time block T_pad
and runs the backward direction in kernel time over T_pad; the port's
kernel time is over T. Original time t is Pallas row T_pad-1-t and port
row T-1-t, so the port's backward rows sit at Pallas rows [T_pad-T, T_pad).

Tolerance: rtol 1e-4, atol 1e-5 (f32, sums over T*B rows in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.models import layers as jL
from e2e_asr_tpu.ops import rnn as jrnn
from e2e_asr_tpu.ops import rnn_pallas
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.ops import rnn as trnn
from e2e_asr_tpu_torch.ops import rnn_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5

# (T, lengths, D, H): odd T, a length-1 row, T not a multiple of the
# Pallas time block
SHAPES = [(13, [13, 6], 24, 16), (10, [10, 1, 7], 32, 32), (17, [9, 17], 16, 8)]


def _inputs(t, lens, d, h, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lens)
    x = rng.randn(t, b, d).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.asarray(lens)[None, :]).astype(np.float32)
    k = jax.random.split(jax.random.PRNGKey(seed), 2)
    wf, wb = jL.lstm_init(k[0], d, h), jL.lstm_init(k[1], d, h)
    wx = np.stack([np.asarray(wf.wx), np.asarray(wb.wx)])
    wh = np.stack([np.asarray(wf.wh), np.asarray(wb.wh)])
    bias = np.stack([np.asarray(wf.b), np.asarray(wb.b)])
    # weight every output row differently; zero where the output is masked
    dy = rng.randn(t, 2 * b, h).astype(np.float32)
    return x, mask, wx, wh, bias, dy


def _pallas_time(t, b, d, h):
    ts = rnn_pallas._pick_ts_fused(b, d, h)
    return ((t + ts - 1) // ts) * ts


def _pad_rows(a, t, t_pad, b):
    out = np.zeros((t_pad,) + a.shape[1:], a.dtype)
    out[:t, :b] = a[:, :b]
    out[t_pad - t:, b:] = a[:, b:]
    return out


def _port_rows(a, t, t_pad, b):
    return np.concatenate([a[:t, :b], a[t_pad - t:, b:]], axis=1)


@pytest.mark.parametrize("t,lens,d,h", SHAPES)
def test_train_forward_residuals_match_pallas(t, lens, d, h):
    """ys, the frozen c carry and the gate activations (i, f, g, o)."""
    x, mask, wx, wh, bias, _ = _inputs(t, lens, d, h)
    want = rnn_pallas._fused_fwd_call(*(jnp.asarray(a) for a in (x, mask, wx, wh, bias)))
    got = rnn_cuda.lstm_bidir_fwd_train(*(torch.from_numpy(a) for a in (x, mask, wx, wh, bias)))
    b = len(lens)
    t_pad = _pallas_time(t, b, d, h)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _port_rows(np.asarray(w), t, t_pad, b),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,lens,d,h", SHAPES)
def test_backward_matches_pallas_vjp(t, lens, d, h):
    """lstm_bidir_bwd_plain (the explicit reverse sweep) and the autograd
    function against jax.vjp of lstm_seq_fused: dx, dWx, dWh, db."""
    x, mask, wx, wh, bias, dy = _inputs(t, lens, d, h, seed=1)
    b = len(lens)
    t_pad = _pallas_time(t, b, d, h)
    _, vjp = jax.vjp(lambda *a: rnn_pallas.lstm_seq_fused(a[0], jnp.asarray(mask), *a[1:]),
                     *(jnp.asarray(a) for a in (x, wx, wh, bias)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(_pad_rows(dy, t, t_pad, b)))]

    tx, tm, twx, twh, tb, tdy = (torch.from_numpy(a) for a in (x, mask, wx, wh, bias, dy))
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train_plain(tx, tm, twx, twh, tb)
    got = rnn_cuda.lstm_bidir_bwd(tx, tm, twx, twh, ys, c, acts, tdy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)

    leaves = [a.clone().requires_grad_() for a in (tx, twx, twh, tb)]
    out = rnn_cuda.lstm_bidir_train(leaves[0], tm, *leaves[1:])
    got = torch.autograd.grad((out * tdy).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,lens,d,h", SHAPES[:2])
def test_backward_matches_autograd_of_plain_forward(t, lens, d, h):
    """The explicit sweep agrees with autograd through the plain forward
    loop; the mask gets no gradient."""
    x, mask, wx, wh, bias, dy = (torch.from_numpy(a) for a in _inputs(t, lens, d, h, seed=2))
    leaves = [a.clone().requires_grad_() for a in (x, wx, wh, bias)]
    want = torch.autograd.grad(
        (rnn_cuda.lstm_bidir_fwd_plain(leaves[0], mask, *leaves[1:]) * dy).sum(), leaves)
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, bias)
    got = rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
    m = mask.clone().requires_grad_()
    out = rnn_cuda.lstm_bidir_train(x, m, wx, wh, bias)
    (gm,) = torch.autograd.grad((out * dy).sum(), [m], allow_unused=True)
    assert gm is None


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_bidir_grads_match_jax(impl):
    """ops/rnn.py bidir with autograd (the training route) against jax.grad
    of the JAX bidir, on the Pallas kernel and on the scan."""
    rng = np.random.RandomState(4)
    b, t, d, h = 3, 11, 24, 16
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.array([11, 6, 1], np.int32)
    wloss = rng.randn(b, t, 2 * h).astype(np.float32)
    k = jax.random.split(jax.random.PRNGKey(5), 2)
    wf, wb = jL.lstm_init(k[0], d, h), jL.lstm_init(k[1], d, h)

    def jloss(xx, a, c):
        return jnp.sum(jrnn.bidir(xx, jnp.asarray(lens), a, c, impl=impl) * wloss)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), wf, wb)
    want_x = np.asarray(want[0])
    want_w = [convert.params_from_jax(jax.device_get(w)) for w in want[1:]]

    tx = torch.from_numpy(x).requires_grad_()
    tw = [convert.params_from_jax(jax.device_get(w)) for w in (wf, wb)]
    for w in tw:
        for v in w.values():
            v.requires_grad_()
    y = trnn.bidir(tx, torch.from_numpy(lens), *tw)
    (y * torch.from_numpy(wloss)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=RTOL, atol=ATOL)
    for got_w, w in zip(tw, want_w):
        for key in ("wx", "wh", "b"):
            np.testing.assert_allclose(got_w[key].grad.numpy(), w[key].numpy(), rtol=RTOL, atol=ATOL)


def test_bidir_routes_inference_without_grad():
    """Without autograd recording, bidir keeps the inference forward (no
    residuals), and both routes give the same outputs."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 7, 8).astype(np.float32))
    lens = torch.tensor([7, 4])
    k = jax.random.split(jax.random.PRNGKey(6), 2)
    w = [convert.params_from_jax(jax.device_get(jL.lstm_init(kk, 8, 8))) for kk in k]
    with torch.no_grad():
        y0 = trnn.bidir(x, lens, *w)
    assert y0.grad_fn is None
    xg = x.clone().requires_grad_()
    y1 = trnn.bidir(xg, lens, *w)
    assert y1.grad_fn is not None
    torch.testing.assert_close(y1.detach(), y0, rtol=0, atol=0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of float32 x (what a TF32 tensor-core input reads)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as csrc/lstm_bidir_bwd.cu's GEMM forms it: each operand split
    into hi (its top 19 bits) and lo (the exact rest, of which the tensor
    core reads the top 19 bits), three products a_lo b_hi + a_hi b_lo +
    a_hi b_hi accumulated in float32, K in tiles of 32 added in order."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 32):
        ks = slice(k0, k0 + 32)
        out = out + ((al[:, ks].double() @ bh[ks].double() + ah[:, ks].double() @ bl[ks].double())
                     + ah[:, ks].double() @ bh[ks].double()).float()
    return out


@pytest.mark.parametrize("which", ["dWh", "dWx"])
def test_3xtf32_products_hold_rtol_1e4_at_flagship_k(which):
    """The numerics the tensor-core products rely on: the 3xTF32 split,
    applied to the plain dWh = h_prev^T dg and dWx = x^T dg at the flagship
    layer's K (T=204 frames x B=16: 3,248 rows for dWh, 3,264 for dWx; a
    slice of the M x N outputs), stays within the tests' rtol 1e-4 (atol 1e-4
    of the largest entry) of float64, where a single TF32 product does not."""
    rng = np.random.RandomState(9)
    t, b, h = 204, 16, 320
    k = (t - 1) * b if which == "dWh" else t * b
    lens = rng.randint(t // 2, t + 1, size=b)
    lens[0] = t
    valid = (np.arange(t)[:, None] < lens[None, :]).reshape(-1)[-k:]
    if which == "dWh":  # h_prev: LSTM outputs in (-1, 1), zero on masked steps
        a = np.tanh(rng.randn(k, 64)) * valid[:, None]
    else:  # x: the VGG prenet's features
        a = np.maximum(rng.randn(k, 64) * 0.5, 0.0)
    dg = rng.randn(k, 128) * 1e-2 * valid[:, None]
    at = torch.from_numpy(a.T.astype(np.float32)).contiguous()
    dgt = torch.from_numpy(dg.astype(np.float32))
    want = at.double() @ dgt.double()
    got = _matmul_3xtf32(at, dgt)
    tol = dict(rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(got.double(), want, **tol)
    one = (_tf32(at).double() @ _tf32(dgt).double())
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, want, **tol)


@pytest.mark.parametrize("m", [8, 127, 128, 320, 1281])
@pytest.mark.parametrize("k", [0, 1, 31, 32, 255, 3248, 26080])
def test_split_k_plan_covers_k(m, k):
    """rnn_cuda.split_k over M, N and K tails: every k-tile of 32 belongs to
    exactly one split, no split is empty, at least 8 k-tiles a split once K
    is split, and a split only where the tiles alone fill fewer than two
    blocks an SM."""
    for n, problems, sms in ((32, 2, 132), (1280, 2, 132), (1024, 1, 132), (200, 2, 16)):
        splits, chunk = rnn_cuda.split_k(m, n, k, problems, sms)
        ktiles = -(-k // 32)
        assert splits >= 1
        if ktiles == 0:
            assert splits == 1
            continue
        ranges = [range(s * chunk, min(ktiles, (s + 1) * chunk)) for s in range(splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(i for r in ranges for i in r) == list(range(ktiles))
        tiles = -(-m // 128) * -(-n // 64) * problems
        if splits > 1:
            assert chunk >= 8 and tiles < 2 * sms
