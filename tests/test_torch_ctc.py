"""Port CTC loss (``ops/ctc.py`` ``ctc_loss`` through ``ops/ctc_cuda.py``
``CTCLossFn``, whose lattice runs its plain version on CPU tensors) against
the JAX package: ``ctc_loss_pallas`` (the Pallas lattice in interpret mode)
and ``ctc_forward_scan``, and against ``torch.nn.CTCLoss``. Cases cover
repeated labels (no s-2 skip), a row with no alignment (+inf, zero
gradient) and a row with no labels (blank path only).

Tolerances (f32): nll rtol 1e-5, atol 1e-4; gradients w.r.t. the logits
rtol 1e-4, atol 1e-5; lattice occupations exp(gamma) atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.ops import ctc as jctc
from e2e_asr_tpu.ops import ctc_pallas
from e2e_asr_tpu_torch.ops import ctc as tctc
from e2e_asr_tpu_torch.ops import ctc_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-4
G_RTOL, G_ATOL = 1e-4, 1e-5

# (seed, B, T, V, L, row 0 without alignment, last row without labels)
CASES = {
    "ragged": (0, 3, 20, 7, 6, False, False),
    "infeasible": (1, 3, 24, 9, 8, True, False),
    "empty_labels": (2, 2, 17, 5, 4, False, True),
    "long": (3, 2, 64, 12, 20, True, True),
}


def _case(name):
    seed, b, t, v, l, infeasible, empty = CASES[name]
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(b, t, v)).astype(np.float32)
    labels = rng.randint(1, v, size=(b, l)).astype(np.int32)
    labels[:, 1] = labels[:, 0]  # a repeat: the skip into it is forbidden
    label_len = rng.randint(2, l + 1, size=b).astype(np.int32)
    label_len[0] = l
    input_len = rng.randint(max(2 * l + 1, t // 2), t + 1, size=b).astype(np.int32)
    if infeasible:
        input_len[0] = l - 1  # fewer frames than labels: no path
    if empty:
        label_len[-1] = 0
    for i in range(b):
        labels[i, label_len[i]:] = 0
    return logits, input_len, labels, label_len


def _port(logits, input_len, labels, label_len):
    lg = torch.from_numpy(logits).requires_grad_()
    nll = tctc.ctc_loss(torch.log_softmax(lg, -1), *(torch.from_numpy(a) for a in
                                                     (input_len, labels, label_len)))
    (g,) = torch.autograd.grad(torch.where(torch.isfinite(nll), nll, 0.0).sum(), lg)
    return nll.detach().numpy(), g.numpy()


def _jax(impl, logits, input_len, labels, label_len):
    def f(lg):
        nll = jctc.ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(input_len),
                            jnp.asarray(labels), jnp.asarray(label_len), impl=impl)
        return jnp.where(jnp.isfinite(nll), nll, 0.0).sum(), nll

    (_, nll), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    return np.asarray(nll), np.asarray(g)


def test_extend_labels():
    ext = ctc_cuda.extend_labels(torch.tensor([[3, 5, 0]]))
    assert ext.tolist() == [[0, 3, 0, 5, 0, 0, 0]]
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(jctc.extend_labels(jnp.asarray([[3, 5, 0]]))))


@pytest.mark.parametrize("name", list(CASES))
def test_ctc_loss_matches_jax_pallas(name):
    """Value and gradient against ctc_loss_pallas (interpret mode)."""
    args = _case(name)
    nll, g = _port(*args)
    nll_j, g_j = _jax("pallas", *args)
    feasible = np.isfinite(nll_j)
    np.testing.assert_array_equal(np.isfinite(nll), feasible)
    assert feasible.all() == (not CASES[name][5])
    np.testing.assert_allclose(nll[feasible], nll_j[feasible], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, g_j, rtol=G_RTOL, atol=G_ATOL)
    assert np.all(g[~feasible] == 0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_ctc_loss_matches_jax_scan(name):
    """Value against the semantics-defining ctc_forward_scan, and the port's
    own scan against it too."""
    logits, input_len, labels, label_len = _case(name)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    want = np.asarray(jctc.ctc_forward_scan(lp, jnp.asarray(input_len), jnp.asarray(labels),
                                            jnp.asarray(label_len)))
    targs = [torch.from_numpy(a) for a in (input_len, labels, label_len)]
    lp_t = torch.log_softmax(torch.from_numpy(logits), -1)
    for got in (tctc.ctc_loss(lp_t, *targs), tctc.ctc_forward_scan(lp_t, *targs)):
        got = got.numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ctc_loss_matches_torch_ctcloss(name):
    """Against torch.nn.CTCLoss: +inf rows with zero_infinity=False, and the
    gradient of the summed loss with zero_infinity=True (zero for the rows
    with no alignment, as the port's gradient)."""
    logits, input_len, labels, label_len = _case(name)
    nll, g = _port(logits, input_len, labels, label_len)
    targets = torch.from_numpy(np.concatenate([labels[i, :label_len[i]] for i in range(len(labels))]))
    lg = torch.from_numpy(logits).requires_grad_()
    lp = torch.log_softmax(lg, -1).transpose(0, 1)
    lens = (torch.from_numpy(input_len), torch.from_numpy(label_len))
    want = torch.nn.CTCLoss(blank=0, reduction="none")(lp, targets, *lens).detach().numpy()
    np.testing.assert_array_equal(np.isinf(nll), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(nll[ok], want[ok], rtol=RTOL, atol=ATOL)
    torch.nn.CTCLoss(blank=0, reduction="sum", zero_infinity=True)(lp, targets, *lens).backward()
    np.testing.assert_allclose(g, lg.grad.numpy(), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("name", ["ragged", "infeasible", "empty_labels"])
def test_lattice_plain_matches_pallas_gamma(name):
    """ctc_lattice_plain's nll and occupations exp(gamma) against the Pallas
    kernel's raw outputs (which pad T and S), over the feasible rows."""
    logits, input_len, labels, label_len = _case(name)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    lp_ext, skip, _, _ = ctc_pallas._prepare(lp, jnp.asarray(labels))
    nll_j, gamma_j = ctc_pallas._ctc_pallas_raw(lp_ext, skip, jnp.asarray(input_len),
                                                 jnp.asarray(label_len))
    b, t, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    nll_j, gamma_j = np.asarray(nll_j), np.asarray(gamma_j)[:, :t, :s]
    nll, gamma = ctc_cuda.ctc_lattice_plain(torch.from_numpy(np.array(lp)), *(
        torch.from_numpy(a) for a in (labels, input_len, label_len)))
    nll, gamma = nll.numpy(), gamma.numpy()
    ok = nll_j <= ctc_cuda.BIG
    np.testing.assert_array_equal(nll <= ctc_cuda.BIG, ok)
    np.testing.assert_allclose(nll[ok], nll_j[ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.exp(gamma[ok]), np.exp(gamma_j[ok]), atol=1e-5)
    # each valid frame's occupations sum to 1 (one state at a time)
    for i in np.flatnonzero(ok):
        np.testing.assert_allclose(np.exp(gamma[i, :input_len[i]]).sum(-1), 1.0, atol=1e-4)


def test_zero_infinity():
    logits, input_len, labels, label_len = _case("infeasible")
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = [torch.from_numpy(a) for a in (input_len, labels, label_len)]
    raw = tctc.ctc_loss(lp, *args)
    zi = tctc.ctc_loss(lp, *args, zero_infinity=True)
    assert torch.isinf(raw[0]) and zi[0] == 0.0
    assert torch.equal(zi[1:], raw[1:])


@pytest.mark.parametrize("bad", ["label_ge_vocab", "negative_label", "label_len_gt_l"])
def test_lattice_refuses_out_of_range_labels(bad):
    """Labels index log_probs and label lengths the lattice: both are
    checked before any kernel could read out of bounds."""
    logits, input_len, labels, label_len = _case("ragged")
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    labels, label_len = labels.copy(), label_len.copy()
    if bad == "label_ge_vocab":
        labels[0, 0] = logits.shape[2]
    elif bad == "negative_label":
        labels[1, 0] = -1
    else:
        label_len[0] = labels.shape[1] + 1
    with pytest.raises(ValueError, match="ctc_lattice"):
        ctc_cuda.ctc_lattice(lp, *(torch.from_numpy(a) for a in (labels, input_len, label_len)))


# (seed, B, T, V, L): row 0 has no alignment, row 1 no labels, row 2
# input_len > T; T a multiple of the Pallas kernel's 8-frame padding or not
ROUTE_CASES = {"t24": (7, 5, 24, 7, 6), "t21": (8, 4, 21, 9, 5)}


def _route_case(name):
    seed, b, t, v, l = ROUTE_CASES[name]
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(b, t, v)).astype(np.float32)
    labels = rng.randint(1, v, size=(b, l)).astype(np.int32)
    labels[:, 2] = labels[:, 1]
    label_len = rng.randint(2, l + 1, size=b).astype(np.int32)
    label_len[0] = l
    label_len[1] = 0
    input_len = rng.randint(2 * l + 1, t + 1, size=b).astype(np.int32)
    input_len[0] = l - 1
    input_len[2] = t + 3
    for i in range(b):
        labels[i, label_len[i]:] = 0
    weights = rng.uniform(0.5, 2.0, size=b).astype(np.float32)
    return logits, input_len, labels, label_len, weights


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_plain_route_matches_jax_pallas_with_upstream_weights(name):
    """The CPU route of the loss (ctc_lattice_grad_plain: nll and G in the
    forward; the backward G times the upstream gradient) against
    ctc_loss_pallas in interpret mode, with a per-utterance upstream
    gradient, a row with no alignment, one with no labels and one with
    input_len > T. The port clamps input_len to T, as ctc_forward_scan
    does; the Pallas kernel does not (it runs on into its zero-padded frames
    and leaves beta out of its last row), so it gets the clamped lengths."""
    logits, input_len, labels, label_len, w = _route_case(name)
    t = logits.shape[1]
    lp_np = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))

    lp = torch.from_numpy(lp_np.copy()).requires_grad_()
    targs = [torch.from_numpy(a) for a in (input_len, labels, label_len)]
    nll = tctc.ctc_loss(lp, *targs)
    (g,) = torch.autograd.grad((torch.where(torch.isfinite(nll), nll, 0.0) * torch.from_numpy(w)).sum(), lp)
    nll, g = nll.detach().numpy(), g.numpy()

    def f(lp_j):
        n = jctc.ctc_loss(lp_j, jnp.minimum(jnp.asarray(input_len), t), jnp.asarray(labels),
                          jnp.asarray(label_len), impl="pallas")
        return jnp.sum(jnp.where(jnp.isfinite(n), n, 0.0) * w), n

    (_, nll_j), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(lp_np))
    nll_j, g_j = np.asarray(nll_j), np.asarray(g_j)
    feasible = np.isfinite(nll_j)
    assert not feasible[0] and feasible[1:].all()
    np.testing.assert_array_equal(np.isfinite(nll), feasible)
    np.testing.assert_allclose(nll[feasible], nll_j[feasible], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, g_j, rtol=G_RTOL, atol=G_ATOL)
    assert np.all(g[0] == 0.0)
    # and the unclamped lengths against the semantics-defining scan
    want = np.asarray(jctc.ctc_forward_scan(jnp.asarray(lp_np), jnp.asarray(input_len),
                                            jnp.asarray(labels), jnp.asarray(label_len)))
    np.testing.assert_allclose(nll[feasible], want[feasible], rtol=RTOL, atol=ATOL)


def test_backward_is_g_times_upstream():
    """CTCLossFn's backward is G (the forward's gradient for a unit upstream
    gradient, zero on the row with no alignment) times the upstream
    gradient, exactly."""
    logits, input_len, labels, label_len, w = _route_case("t21")
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    targs = [torch.from_numpy(a) for a in (labels, input_len, label_len)]
    raw, grad = ctc_cuda.ctc_lattice_grad_plain(lp, *targs)
    assert raw[0] > ctc_cuda.BIG and float(grad[0].abs().max()) == 0.0
    assert float(grad[1, input_len[1]:].abs().max()) == 0.0  # nothing past input_len
    lp_g = lp.clone().requires_grad_()
    nll = ctc_cuda.CTCLossFn.apply(lp_g, targs[1], targs[0], targs[2])
    ct = torch.from_numpy(w)
    (g,) = torch.autograd.grad(nll, lp_g, ct)
    assert torch.equal(g, grad * ct[:, None, None])
