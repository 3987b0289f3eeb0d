"""Port CTC prefix scoring vs the JAX package: ``prefix_scores`` against
``prefix_scores_scan`` and the Pallas ``impl="pallas"`` path (interpret
mode), for empty and non-empty prefixes, with enc_len < T, plus
``eos_score``, ``init_empty_prefix`` and the kernel module's plain
version against the Pallas ``prefix_recursion`` itself.

Tolerance: the JAX suite's own for this function, rtol 1e-5, atol 2e-3
(tests/test_decode.py), compared on lattice cells reachable in the
reference (> -1e20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.decode import ctc_prefix as jcp
from e2e_asr_tpu.decode import ctc_prefix_pallas
from e2e_asr_tpu_torch.decode import ctc_prefix as tcp
from e2e_asr_tpu_torch.decode import ctc_prefix_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 2e-3
B, W, K, T, V = 2, 3, 4, 41, 12


def _close(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    fin = want > -1e20
    np.testing.assert_array_equal(got > -1e20, fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.RandomState(7)
    logits = rng.randn(B, T, V).astype(np.float32) * 3.0
    logits[:, :, 0] += 2.0  # blank-dominant like a trained CTC head
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    enc_len = np.array([T, T - 13], np.int32)
    return rng, lp, enc_len


def test_init_empty_prefix_and_eos_score(lattice):
    _, lp, enc_len = lattice
    want = jcp.init_empty_prefix(jnp.asarray(lp), jnp.asarray(enc_len), W)
    got = tcp.init_empty_prefix(torch.from_numpy(lp), torch.from_numpy(enc_len), W)
    _close(got.numpy(), want)
    _close(tcp.eos_score(got, torch.from_numpy(enc_len)).numpy(),
           jcp.eos_score(want, jnp.asarray(enc_len)))


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("empty", [True, False])
def test_prefix_scores_matches_jax(lattice, impl, empty):
    rng, lp, enc_len = lattice
    lp_j, len_j = jnp.asarray(lp), jnp.asarray(enc_len)
    r_g = jcp.init_empty_prefix(lp_j, len_j, W)
    last = np.zeros((B, W), np.int32)
    cand = rng.randint(1, V, (B, W, K)).astype(np.int32)
    if not empty:  # parents = real one-token prefixes, one candidate repeats
        _, r_h = jcp.prefix_scores_scan(lp_j, len_j, r_g, jnp.asarray(last), jnp.asarray(cand), True)
        r_g = r_h[:, :, 0]
        last = cand[:, :, 0].copy()
        cand = rng.randint(1, V, (B, W, K)).astype(np.int32)
        cand[:, :, 1] = last
    args = (lp_j, len_j, r_g, jnp.asarray(last), jnp.asarray(cand), empty)
    if impl == "scan":
        psi_j, rh_j = jcp.prefix_scores_scan(*args)
    else:
        psi_j, rh_j = jcp.prefix_scores(*args, impl="pallas")
    psi_t, rh_t = tcp.prefix_scores(
        torch.from_numpy(lp), torch.from_numpy(enc_len), torch.from_numpy(np.array(r_g)),
        torch.from_numpy(last).long(), torch.from_numpy(cand).long(), empty,
    )
    _close(psi_t.numpy(), psi_j)
    _close(rh_t.numpy(), rh_j)


def test_recursion_plain_matches_pallas_kernel(lattice):
    """prefix_recursion_plain (the stream-level building block of the fused
    function's plain version) on the [T, N] streams against
    ctc_prefix_pallas.prefix_recursion on the same streams."""
    rng, lp, enc_len = lattice
    lp_t, len_t = torch.from_numpy(lp), torch.from_numpy(enc_len)
    r_g = tcp.init_empty_prefix(lp_t, len_t, W)
    cand = torch.from_numpy(rng.randint(1, V, (B, W, K))).long()
    ins = tcp.recursion_inputs(lp_t, len_t, r_g, torch.zeros((B, W), dtype=torch.long), cand, True)
    got = ctc_prefix_cuda.prefix_recursion_plain(*ins)
    want = ctc_prefix_pallas.prefix_recursion(*(jnp.asarray(x.numpy()) for x in ins))
    for g, wv in zip(got, want):
        _close(g.numpy(), wv)
