"""Readings behind the limits of ``asr_bench/limits/``: the program's compared
numbers over many seeds (the lower readings) and, with ``--control``, the
controls' (the upper readings), all in one process.

    python3 -m asr_bench.control --workload <cell> --seeds 1 2 3 [--control N] [--seconds 2]

Training cells' controls: the reference computed with float8 (e4m3) products
in the program's place (``fp8``; the recipe states bf16), the reference with
half of each batch left out (``half_batch``) and a state left unchanged
(``state_unchanged``). Decode cells' controls: the reference at TF32 in the
program's place (``tf32``; decoding is float32), rescoring the program's
hypotheses and searching again; a hypothesis with one token altered where it
is produced (``token_altered``); the reference's search with every step's
best live extension pruned (``skip_best``). ``--control N`` reads them on
the first N seeds. Each seed prints one JSON line; the last line gives, for
each number, the largest program reading and the smallest reading of each
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0, help="read the controls on the first N seeds")
    args = ap.parse_args(argv)

    from asr_bench import cells, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    conf = spec.config(bench, cell["config"])
    mix = spec.load_mix(cell["traffic"])
    runner = {"train": cells.run_train, "decode": cells.run_decode}[mix["kind"]]
    from asr_bench.reference import model as M

    probe = {}
    for mode in ("fp32", "tf32"):  # evidence that the TF32 control runs at TF32
        with M.Precision(mode).active():
            probe[mode] = M.matmul_error("cuda")
    print(json.dumps({"matmul_relative_error": probe}), flush=True)
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        run = runner(conf, mix, seed, args.seconds, False, "cuda", t0, control=i < args.control)
        print(json.dumps({"seed": seed, "numbers": run.numbers, "control": run.control, "problems": run.problems,
                          "checked": run.checked, "detail": run.detail, "setup_s": run.setup_s,
                          "seconds": time.time() - t0}), flush=True)
        for k, v in run.numbers.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for name, nums in run.control.items():
            for k, v in nums.items():
                upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
