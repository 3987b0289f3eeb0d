"""On the card, at a cell's own size: the program's compared numbers inside
their limits, and each control outside at least one of them: for training
the float8 reference in the program's place and each planted fault; for
decoding the TF32 reference in the program's place, a token altered where
it is produced, and a search that prunes its best extension."""

import time

import pytest
import torch

from asr_bench import cells, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [("flagship.train.clean100", 1.0), ("flagship.decode.lm", 3.0)])
def test_the_program_passes_and_each_control_fails(workload, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    mix = spec.load_mix(cell["traffic"])
    recipe = spec.config(bench, cell["config"])["recipe"]
    runner = {"train": cells.run_train, "decode": cells.run_decode}[mix["kind"]]
    run = runner(recipe, mix, 2 ** 31 + 99, seconds, False, "cuda", time.time(), control=True)
    lim = spec.limits(workload)
    assert not run.problems
    assert all(run.numbers[k] <= lim[k] for k in lim), run.numbers
    must_fail = {"train": ("fp8", "half_batch", "state_unchanged"),
                 "decode": ("tf32", "token_altered", "skip_best")}[mix["kind"]]
    for name in must_fail:
        nums = run.control[name]
        assert any(nums[k] > lim[k] for k in nums), (name, nums)
