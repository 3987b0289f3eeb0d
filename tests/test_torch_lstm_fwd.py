"""The fused BiLSTM layer's forward in the port as two steps (``ops/rnn_cuda.py``:
the input projection into an xw scratch in kernel time, then the recurrence's
sweep over it; on CPU tensors ``_kernel_time_inputs`` and the plain loop)
against the JAX package: the JAX Pallas kernel ``rnn_pallas.lstm_seq``
(interpret mode) run over the port's kernel-time projection and row mask
gives the port's ``lstm_bidir_fwd`` and the JAX fused kernel
``rnn_pallas.lstm_seq_fused`` gives the same ys, with ragged lengths. Then the
ablated sources of ``bin/sweep_split.py``: every part it compiles out of
either sweep is found once and wrapped whole.

Tolerance: rtol 1e-4, atol 1e-5 (f32, sums in other orders).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.ops import rnn_pallas
from e2e_asr_tpu_torch.bin import sweep_split
from e2e_asr_tpu_torch.ops import rnn_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5

# (T, lengths, D, H): a length-1 row, H = 8, odd D
SHAPES = [(13, [13, 6], 24, 16), (10, [10, 1, 7], 37, 8), (9, [9, 4], 16, 32)]


def _inputs(t, lens, d, h, seed=0):
    rng = np.random.RandomState(seed)
    mask = (np.arange(t)[:, None] < np.asarray(lens)[None, :]).astype(np.float32)
    x = rng.randn(t, len(lens), d).astype(np.float32)
    wx = (rng.randn(2, d, 4 * h) * 0.3).astype(np.float32)
    wh = (rng.randn(2, h, 4 * h) * 0.3).astype(np.float32)
    b = (rng.randn(2, 4 * h) * 0.1).astype(np.float32)
    return x, mask, wx, wh, b


@pytest.mark.parametrize("t,lens,d,h", SHAPES)
def test_projection_then_sweep_matches_pallas(t, lens, d, h):
    x, mask, wx, wh, b = _inputs(t, lens, d, h)
    tx, tm, twx, twh, tb = (torch.from_numpy(a) for a in (x, mask, wx, wh, b))
    xw, m2 = rnn_cuda._kernel_time_inputs(tx, tm, twx, tb)
    want = np.asarray(rnn_pallas.lstm_seq(jnp.asarray(xw.numpy()), jnp.asarray(m2.float().numpy()),
                                          jnp.asarray(wh)))
    ys = rnn_cuda.lstm_bidir_fwd(tx, tm, twx, twh, tb)
    np.testing.assert_allclose(ys.numpy(), want, rtol=RTOL, atol=ATOL)
    fused = np.asarray(rnn_pallas.lstm_seq_fused(*(jnp.asarray(a) for a in (x, mask, wx, wh, b))))
    # the fused kernel pads T to its time block; its backward rows sit at
    # kernel times [T_pad - T, T_pad)
    np.testing.assert_allclose(ys.numpy()[:, : len(lens)], fused[:t, : len(lens)], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ys.numpy()[:, len(lens):], fused[fused.shape[0] - t:, len(lens):],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sweep", sorted(sweep_split.SWEEPS))
def test_sweep_split_wraps_each_part(sweep):
    """Each define of the ablation wraps each of its parts once, whole: the
    ablated source less the inserted lines is the source, and every
    ``#ifndef`` opens right before a part's first line."""
    name, cuts, variants = sweep_split.SWEEPS[sweep]
    with open(f"{sweep_split.cuda_build.CSRC_DIR}/{name}.cu") as f:
        src = f.read()
    ablated = sweep_split.ablated_source(sweep)
    stripped = re.sub(r"^(#ifndef NO_[A-Z]+|#endif)\n", "", ablated, flags=re.M)
    assert stripped == src
    for define, parts in cuts.items():
        assert ablated.count(f"#ifndef {define}\n") == len(parts)
        for marker, _ in parts:
            assert f"#ifndef {define}\n{marker}" in ablated
    assert "full" in variants and all(set(d) <= set(cuts) for d in variants.values())
