"""The traffic generator: the same seed gives the same corpus, every seed
the same lengths, and the lengths follow the mix's stated law."""

import numpy as np
import pytest

from asr_bench import spec, traffic


@pytest.mark.parametrize("name", ["train.clean100", "train.960mix", "decode.lm"])
def test_lengths_follow_the_stated_law(name):
    mix = spec.load_mix(name)
    d = traffic.durations(mix)
    assert len(d) == mix["utterances"] and np.all(np.diff(d) >= 0)
    bins = np.asarray(mix["duration_s"]["bins"])
    shares = bins[:, 2] / bins[:, 2].sum()
    for (lo, hi, _), share in zip(bins, shares):
        inside = np.mean((d >= lo) & (d <= hi))
        assert abs(inside - share) <= 2.0 / len(d)
    expect = float((shares * (bins[:, 0] + bins[:, 1]) / 2).sum())
    assert abs(d.mean() - expect) < 0.05
    rates = traffic.char_rates(mix)
    lo, hi = mix["chars_per_s"]
    assert rates.min() >= lo and rates.max() <= hi


def test_same_seed_same_corpus_other_seed_same_work():
    mix = dict(spec.load_mix("decode.lm"), utterances=60)
    a, b, c = (traffic.make(mix, s, 16000) for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    assert [(u.uid, u.text, u.n_samples) for u in a] == [(u.uid, u.text, u.n_samples) for u in b]
    assert all(np.array_equal(x.load(), y.load()) for x, y in zip(a, b))
    assert sorted((u.n_samples, len(u.text)) for u in a) == sorted((u.n_samples, len(u.text)) for u in c)
    assert [u.text for u in a] != [u.text for u in c]


def test_waves_round_trip_through_int16():
    mix = dict(spec.load_mix("train.clean100"), utterances=8)
    utts = traffic.make(mix, 3, 16000)
    x = utts[0].load()
    assert x.dtype == np.float32 and len(x) == utts[0].n_samples
    assert np.array_equal(np.round(x * 32768.0), x * 32768.0)
    rows = traffic.waves_i16({u.uid: u for u in utts}, [utts[1].uid, ""], 50000)
    assert rows.shape == (2, 50000) and not rows[1].any()
    n = min(utts[1].n_samples, 50000)
    assert np.array_equal(rows[0, :n], (utts[1].load()[:n] * 32768.0).astype(np.int16))
