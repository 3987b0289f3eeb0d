"""The whole port beam search vs the JAX ``beam_search`` on the same
weights (JAX ``asr_init``, and for the fused cases JAX ``lm_init``, through
``convert.py``) and the same features, with ctc_weight 0.3 (and once 0),
without an LM and with one fused in at lm_weight 0.4 (tied and untied):
identical tokens and lengths, top scores within rtol 1e-4 (f32 sums in
another order). Plus the ``top_k`` tie order the beam depends on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import LMConfig as JLMConfig
from e2e_asr_tpu.decode.beam import beam_search as jbeam
from e2e_asr_tpu.models import lm as jlm
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.decode.beam import NEG, beam_search, top_k
from tests.torch_parity import FEAT_DIM, VOCAB, models, small_config

torch.set_num_threads(1)


def _feats(seed=0):
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, 64, FEAT_DIM).astype(np.float32)
    feat_len = np.array([64, 45], np.int32)
    feat[1, 45:] = 0.0
    return feat, feat_len


@pytest.mark.parametrize(
    "eos_bias,decode",
    [
        (0.0, {}),  # random weights: live leftovers, the frozen-step normalisation
        (2.5, dict(min_len_ratio=0.2)),  # <eos> likely: finished-set routing in a window
        (2.5, dict(ctc_weight=0.0)),  # attention only: no prefix scoring, full-vocab candidates
        # an RNN-LM fused in (its "lm_tying" picks the output form)
        pytest.param(0.0, dict(lm_weight=0.4, lm_tying=False), id="lm-ctc"),
        pytest.param(2.5, dict(lm_weight=0.4, lm_tying=True, min_len_ratio=0.2), id="lm-tied-ctc-window"),
        pytest.param(0.0, dict(lm_weight=0.4, lm_tying=False, ctc_weight=0.0), id="lm-attention-only"),
    ],
)
def test_beam_search_matches_jax(eos_bias, decode):
    decode = dict(decode)
    tying = decode.pop("lm_tying", None)
    jc, tc, jp, tp = models(small_config(**decode))
    jp["decoder"]["char"]["b"] = jp["decoder"]["char"]["b"].at[EOS_ID].add(eos_bias)
    tp["decoder"]["char"]["b"][EOS_ID] += eos_bias
    feat, feat_len = _feats()
    max_step = 10
    jlm_p = tlm_p = jlm_cfg = tlm_cfg = None
    if tying is not None:
        lm = dict(emb_tying=tying, emb_dim=8, dim=16, n_layers=2, dropout=0.0)
        jlm_cfg, tlm_cfg = JLMConfig(**lm), LMConfig(**lm)
        jlm_p = jlm.lm_init(jax.random.PRNGKey(5), VOCAB, jlm_cfg)
        tlm_p = convert.params_from_jax(jax.device_get(jlm_p))
    jr = jbeam(jp, jc.model, jc.decode, jnp.asarray(feat), jnp.asarray(feat_len), max_step,
               lm_params=jlm_p, lm_cfg=jlm_cfg)
    tr = beam_search(tp, tc.model, tc.decode, torch.from_numpy(feat), torch.from_numpy(feat_len), max_step,
                     lm_params=tlm_p, lm_cfg=tlm_cfg)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), rtol=1e-4)
    if eos_bias:
        assert (tr.tokens.numpy() == EOS_ID).any(), "no hypothesis finished"


def test_top_k_tie_order_matches_lax():
    """Ties come out lowest index first, as jax.lax.top_k gives them; at
    t = 0 every beam but the first scores NEG."""
    rng = np.random.RandomState(0)
    x = np.where(rng.rand(4, 40) < 0.7, NEG, rng.randint(0, 3, (4, 40))).astype(np.float32)
    x[0] = NEG
    for k in (1, 5, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_port_init_has_the_converted_jax_layout():
    """The port's own seeded asr_init builds the tree convert.py makes from
    the JAX asr_init: same names, same (converted) shapes."""
    from e2e_asr_tpu_torch.models import asr as tasr

    d = small_config()
    d["model"]["encoder"]["layer_norm"] = [True, False]
    jc, tc, _, tp = models(d)
    mine, shapes = tasr.asr_init(0, FEAT_DIM, 12, tc.model, torch.device("cpu"))
    assert _shapes(mine) == _shapes(tp)
    assert shapes.enc_dim == 64 and shapes.vocab == 12
