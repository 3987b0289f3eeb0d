"""The frozen work formulas at hand-worked shapes, the default
architecture's model FLOPs, and the percentile."""

import pytest

from asr_bench import work
from asr_bench.reference import model as M
from asr_bench.run import p95
from asr_bench.tests import speller2


def test_lstm_seq_counts_by_hand():
    # T 2, B 1, H 8, both directions, one valid frame a row a direction twice
    b, f = work.lstm_seq_fwd(2, 1, 8, 2.0, 2, "float32")
    assert b == 4 * (2 * 2 * 32 + 2 * 8 * 32 + 2 * 2 * 2 * 8) + 4 * (2 * 2 + 2 * 2 * 32) == 3344
    assert f == 2 * 2 * (2 * 8 * 32 + 12 * 8) == 2432
    bb, fb = work.lstm_seq_bwd(2, 1, 8, 2.0, 2, "bfloat16")
    assert fb == 2 * 2 * (16 * 64 + 20 * 8)
    assert bb == 2 * (2 * 2 * 8 * 32 + 3 * 2 * 2 * 8 + 2 * 2 * 32) + 4 * (2 * 2 + 2 * 2 * 32)


def test_conv_taps_count_only_taps_on_valid_frames():
    assert work.conv_taps([3], 3) == 2 + 3 + 2
    assert work.conv_taps([1, 2], 5) == 1 + 2 + 2


def test_least_time_is_the_larger_bound():
    assert work.least_s((3.35e12, 1.0), "float32") == pytest.approx(1.0)
    assert work.least_s((1.0, 989e12), "bfloat16") == pytest.approx(1.0)
    assert work.least_s((1.0, 67e12), "float32") == pytest.approx(1.0)


MODEL = {"encoder": {"dim": [8]}, "attention": {"dim": 4, "loc_kernel_num": 2, "loc_kernel_size": 1},
         "decoder": {"dim": 8}}


def test_encoder_flops_by_hand():
    vgg = 2 * 9 * 40 * 4 * (64 + 64 * 64) + 2 * 9 * 20 * 2 * (64 * 128 + 128 * 128)
    lstm = 2 * 1 * (2 * 1280 * 32 + 2 * 8 * 32 + 12 * 8) + 1 * 2 * 16 * 16
    heads = 2 * 1 * 16 * (4 + 5)  # the key projection and the CTC head over one frame
    assert M.utterance_flops(MODEL, 40, 5, 4) == vgg + lstm + heads


def test_a_speller_step_by_hand():
    # H 8, Dk 4, E 16, 2 x 3 taps, V 5, 2 frames; the second layer adds its products and cell
    one = 2 * 8 * 4 + 2 * (2 * 3 * 2 + 4 * (2 * 2 + 4) + 2 * 16) + 2 * (8 + 16 + 8) * 32 + 12 * 8 + 2 * 8 * 5
    assert M.speller_step_flops(MODEL, 5, 8) == one
    assert speller2.speller_step_flops(MODEL, 5, 8) == one + 2 * 16 * 32 + 12 * 8


@pytest.mark.parametrize("arch", [M, speller2])
def test_a_training_step_is_three_forwards(arch):
    fwd = arch.utterance_flops(MODEL, 40, 5, 8) + 3 * arch.speller_step_flops(MODEL, 5, 8)
    assert work.train_step_flops(arch, MODEL, 40, 5, [8, 0], [3, 0]) == pytest.approx(3 * fwd)


@pytest.mark.parametrize("n,want", [(1, 1.0), (20, 19.0), (100, 95.0), (101, 96.0)])
def test_p95_is_the_nearest_rank(n, want):
    assert p95([float(i) for i in range(n, 0, -1)]) == want
