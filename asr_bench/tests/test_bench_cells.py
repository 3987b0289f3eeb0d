"""A run on the CPU at a tiny size, the harness's look for a chip skipped,
for each tiny configuration (``tiny.CONFIGS``: the default architecture with
characters, and a test architecture of its own with a unit vocabulary):
sound, each compared number is inside its cell's limit; with the timed path
broken underneath (a step that returns its state unchanged, half of the
batch left out, a token altered where it is produced, the search's best
extension pruned), ``correct`` comes out false."""

import math
import time

import pytest
import torch

from asr_bench import cells, spec, vocab
from asr_bench.tests import tiny

TRAIN, DECODE = "flagship.train.clean100", "flagship.decode.lm"
SEED = 2 ** 31 + 11


def correct(run, workload):
    lim = spec.limits(workload)
    return not run.problems and all(math.isfinite(v) and v <= lim[k] for k, v in run.numbers.items())


def train(name="default", **kw):
    conf = tiny.config(name)
    return cells.run_train(conf, tiny.mix("train", conf), SEED, 0.5, False, "cpu", time.time(), **kw)


def decode(name="default", **kw):
    conf = tiny.config(name)
    return cells.run_decode(conf, tiny.mix("decode", conf), SEED, 0.5, False, "cpu", time.time(), **kw)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_a_sound_training_run_is_correct(name):
    run = train(name)
    assert run.attempted > 0 and run.audio_s > 0 and run.failed == 0
    assert set(run.numbers) == set(spec.limits(TRAIN))
    assert correct(run, TRAIN), run.numbers


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_a_sound_decode_is_correct(name):
    run = decode(name)
    assert run.attempted > 0 and run.checked["hypotheses"] > 0
    assert correct(run, DECODE), (run.numbers, run.problems)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch, name):
    from e2e_asr_tpu_torch import optim

    monkeypatch.setattr(optim.Optimizer, "update", lambda self, *a, **k: None)
    run = train(name)
    assert run.numbers["param_change_gap"] == pytest.approx(1.0)
    assert not correct(run, TRAIN)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_half_of_the_batch_left_out_is_not_correct(monkeypatch, name):
    from e2e_asr_tpu_torch.training import step

    real = step.compute_loss

    def half(params, cfg, wav, wav_len, text, text_len, *a, **k):
        h = max(1, wav.shape[0] // 2)
        return real(params, cfg, wav[:h], wav_len[:h], text[:h], text_len[:h], *a, **k)

    monkeypatch.setattr(step, "compute_loss", half)
    assert not correct(train(name), TRAIN)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch, name):
    from e2e_asr_tpu_torch.decode import beam

    real = beam.rank
    others = vocab.of(tiny.config(name)).size - 3  # the ids past the reserved three

    def altered(spec_, inp, st):
        res = real(spec_, inp, st)
        tokens = res.tokens.clone()
        tokens[0, 0, 0] = 3 + (int(tokens[0, 0, 0]) - 2) % others
        return res._replace(tokens=tokens)

    monkeypatch.setattr(beam, "rank", altered)
    assert not correct(decode(name), DECODE)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_a_search_that_prunes_its_best_extension_is_not_correct(monkeypatch, name):
    from e2e_asr_tpu_torch.decode import beam

    from asr_bench import shapes

    conf = tiny.config(name)
    r = conf["recipe"]
    live = r["decode"]["beam_size"] * shapes.k_cand(r, vocab.of(conf).size)  # the live candidates' list's width
    real = beam.top_k

    def skip_best(x, k):
        if x.dim() == 2 and x.shape[-1] == live:
            vals, idx = real(x, k + 1)
            return vals[..., 1:], idx[..., 1:]
        return real(x, k)

    monkeypatch.setattr(beam, "top_k", skip_best)
    run = decode(name)
    assert run.numbers["score_gap"] <= spec.limits(DECODE)["score_gap"]  # its scores are its hypotheses'
    assert not correct(run, DECODE)


def test_the_decode_controls_read_at_the_tiny_size():
    run = decode(control=True)
    assert set(run.control) == {"tf32", "token_altered", "skip_best"}
    assert run.control["token_altered"]["score_gap"] > 10 * run.numbers["score_gap"]
    assert run.control["skip_best"]["prefix_miss"] > run.numbers["prefix_miss"]
    assert run.checked["prefixes"] > 0


def test_the_controls_read_at_the_tiny_size():
    run = train(control=True)
    assert set(run.control) == {"fp8", "half_batch", "state_unchanged"}
    assert run.control["state_unchanged"]["param_change_gap"] == pytest.approx(1.0)
    assert run.control["fp8"]["grad_norm_gap"] > 10 * run.numbers["grad_norm_gap"]
    assert torch.isfinite(torch.tensor(run.control["half_batch"]["grad_norm_gap"]))
    assert run.detail["program"]["loss_rel"] < 1e-5
