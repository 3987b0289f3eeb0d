"""The beam search's parts on the CPU: ``beam_step`` with the step index a
0-d tensor updates the state's buffers in place and advances the index;
the eager loop over ``beam_step`` is what ``beam_search`` runs on CPU
tensors, whose graph path (decode/beam_graph.py) is never taken; the
graphs' key follows the shapes, the scalars a step bakes in and the
weights' addresses. Replay against the eager loop is held on the card
(tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.decode import beam, beam_graph
from tests.test_torch_beam import _feats
from tests.torch_parity import models, small_config

torch.set_num_threads(1)


def _setup(**decode):
    _, tc, _, tp = models(small_config(**decode))
    feat, feat_len = _feats()
    return tp, tc, torch.from_numpy(feat), torch.from_numpy(feat_len)


@pytest.mark.parametrize("decode", [{}, dict(ctc_weight=0.0)])
def test_beam_step_writes_the_state_in_place(decode):
    """Two steps leave every buffer where it was (same data_ptr, shape and
    dtype), change the state and advance t from 0 to 2."""
    tp, tc, feat, feat_len = _setup(**decode)
    spec, inp = beam.prepare(tp, tc.model, tc.decode, feat, feat_len, 10)
    st = beam.init_state(spec, inp)
    fields = {k: v for k, v in st._asdict().items() if v is not None}
    assert all(v.is_contiguous() for v in fields.values())
    ptrs = {k: v.data_ptr() for k, v in fields.items()}
    assert len(set(ptrs.values())) == len(ptrs), "two fields share a buffer"
    before = {k: v.clone() for k, v in fields.items()}
    with torch.inference_mode():
        for i in range(2):
            beam.beam_step(spec, inp, st, first=i == 0)
    for k, v in st._asdict().items():
        if v is not None:
            assert v.data_ptr() == ptrs[k] and v.shape == before[k].shape and v.dtype == before[k].dtype, k
    assert int(st.t) == 2 and st.t.dim() == 0
    assert not torch.equal(st.tokens, before["tokens"]) and not torch.equal(st.scores, before["scores"])
    assert not torch.equal(st.dec_h, before["dec_h"])
    assert bool((st.tokens[:, :, 2:] == 0).all()), "a token written past step 1"


def test_eager_loop_is_beam_search_on_the_cpu(monkeypatch):
    """On CPU tensors ``beam_search`` never reaches the graphs, whatever
    ``graphs`` says, and equals the loop over ``beam_step`` run by hand;
    ``BeamGraphs.run`` refuses CPU tensors."""
    tp, tc, feat, feat_len = _setup(min_len_ratio=0.2)

    def refuse(*a, **k):
        raise AssertionError("graph path taken for CPU tensors")

    monkeypatch.setattr(beam_graph.BeamGraphs, "run", refuse)
    cache = beam_graph.BeamGraphs()
    a = beam.beam_search(tp, tc.model, tc.decode, feat, feat_len, 10, graph_cache=cache)
    b = beam.beam_search(tp, tc.model, tc.decode, feat, feat_len, 10, graphs=False)
    spec, inp = beam.prepare(tp, tc.model, tc.decode, feat, feat_len, 10)
    st = beam.init_state(spec, inp)
    with torch.inference_mode():
        for i in range(10):
            beam.beam_step(spec, inp, st, first=i == 0)
        c = beam.rank(spec, inp, st)
    for x, y in ((a, b), (a, c)):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    assert cache.graphs == {}
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensors"):
        beam_graph.BeamGraphs().run(spec, inp)


def test_graph_key_follows_shapes_scalars_and_weights():
    """Two batches of one bucket shape share a key; another batch size,
    max_step, lm_weight or ctc_weight, or the same weights at other
    addresses, make a new key."""
    tp, tc, feat, feat_len = _setup()

    def key(params=tp, dcfg=tc.decode, f=feat, fl=feat_len, max_step=10):
        return beam_graph.graph_key(*beam.prepare(params, tc.model, dcfg, f, fl, max_step))

    k0 = key()
    rng = np.random.RandomState(1)
    other = torch.from_numpy(rng.randn(*feat.shape).astype(np.float32))
    assert key(f=other, fl=torch.tensor([50, 64], dtype=feat_len.dtype)) == k0
    assert key(f=feat[:1], fl=feat_len[:1]) != k0
    assert key(max_step=11) != k0
    assert key(params=_clone(tp)) != k0
    for change in (dict(lm_weight=0.3), dict(ctc_weight=0.5)):
        assert key(dcfg=dataclasses.replace(tc.decode, **change)) != k0


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree
