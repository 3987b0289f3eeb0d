"""The fused CTC prefix entry (``decode/ctc_prefix_cuda.py``
``prefix_scores_fused``: psi, r_h in [B, W, K, T, 2] and psi_eos from one
call) on its plain route, against the JAX functions it stands for:
``prefix_scores`` (impl ``scan``, and ``pallas``: the Pallas
``prefix_recursion`` kernel in interpret mode) and ``eos_score``, from the
same numpy inputs. Cases: the empty prefix, parents that emitted a token
with a candidate equal to the beam's last token, ``enc_len`` of 1 and of T,
K = 1 and K = V - 1.

Tolerance: the JAX suite's own for these functions, rtol 1e-5, atol 2e-3
(tests/test_decode.py), on the cells reachable in the reference (> -1e20);
the unreachable cells must be unreachable in the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.decode import ctc_prefix as jcp
from e2e_asr_tpu_torch.decode import ctc_prefix_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 2e-3
B, W, T, V = 2, 3, 23, 9

CASES = {  # name: (empty prefix, enc_len, K)
    "empty": (True, (T, T - 7), 4),
    "after_one_token": (False, (T, T - 7), 4),
    "enc_len_1_and_T": (False, (1, T), 4),
    "k_1": (False, (T - 2, T), 1),
    "k_v_minus_1": (False, (T, 11), V - 1),
}


def _close(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    fin = want > -1e20
    np.testing.assert_array_equal(got > -1e20, fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _inputs(case):
    empty, lens, k = CASES[case]
    rng = np.random.RandomState(11)
    logits = rng.randn(B, T, V).astype(np.float32) * 3.0
    logits[:, :, 0] += 2.0  # blank-dominant like a trained CTC head
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    enc_len = np.array(lens, np.int32)
    lp_j, len_j = jnp.asarray(lp), jnp.asarray(enc_len)
    r_g = jcp.init_empty_prefix(lp_j, len_j, W)
    last = np.zeros((B, W), np.int32)
    if not empty:  # parents = one-token prefixes; candidate 0 of each beam repeats its last token
        first = rng.randint(1, V, (B, W, 1)).astype(np.int32)
        _, r_h = jcp.prefix_scores_scan(lp_j, len_j, r_g, jnp.asarray(last), jnp.asarray(first), True)
        r_g = r_h[:, :, 0]
        last = first[:, :, 0].copy()
    cand = np.stack([rng.permutation(np.arange(1, V))[:k] for _ in range(B * W)]).reshape(B, W, k)
    cand = cand.astype(np.int32)
    if not empty:
        cand[:, :, 0] = last
    return empty, lp, enc_len, np.array(r_g), last, cand


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_route_matches_jax(impl, case):
    empty, lp, enc_len, r_g, last, cand = _inputs(case)
    args = (jnp.asarray(lp), jnp.asarray(enc_len), jnp.asarray(r_g), jnp.asarray(last), jnp.asarray(cand),
            empty)
    if impl == "scan":
        psi_j, rh_j = jcp.prefix_scores_scan(*args)
    else:
        psi_j, rh_j = jcp.prefix_scores(*args, impl="pallas")
    eos_j = jcp.eos_score(jnp.asarray(r_g), jnp.asarray(enc_len))
    before = ctc_prefix_cuda.prefix_scores_fused.launches
    psi_t, rh_t, eos_t = ctc_prefix_cuda.prefix_scores_fused(
        torch.from_numpy(lp), torch.from_numpy(enc_len), torch.from_numpy(r_g),
        torch.from_numpy(last).long(), torch.from_numpy(cand).long(), int(empty),
    )
    assert ctc_prefix_cuda.prefix_scores_fused.launches == before  # CPU tensors: the plain route
    k = cand.shape[-1]
    assert psi_t.shape == (B, W, k) and rh_t.shape == (B, W, k, T, 2) and eos_t.shape == (B, W)
    _close(psi_t.numpy(), psi_j)
    _close(rh_t.numpy(), rh_j)
    _close(eos_t.numpy(), eos_j)


def test_columns_per_block_cover_every_candidate():
    """The kernel's column runs: every (beam, candidate) column of an
    utterance in exactly one block, at most 96 a block, about 128 blocks
    at the flagship's B=16, W=16, K=24 (two beams a block)."""
    assert ctc_prefix_cuda.columns_per_block(16, 16, 24) == (48, 8)
    for b, w, k in ((1, 1, 1), (3, 4, 7), (16, 16, 24), (64, 16, 24), (2, 40, 30), (1, 16, 500)):
        cpb, nbu = ctc_prefix_cuda.columns_per_block(b, w, k)
        assert 1 <= cpb <= ctc_prefix_cuda.MAX_COLUMNS
        assert cpb * nbu >= w * k > cpb * (nbu - 1)
