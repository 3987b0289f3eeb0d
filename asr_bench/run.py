"""Run one cell of the benchmark once and print its result line.

    python3 -m asr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
(``BENCHMARK.json``) names its configuration and traffic; ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
(a profiled slice after the window). Every run checks what the timed path
produced against the plain reference and prints each compared number beside
its limit, on standard error and, last, in the result line.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "e2e_asr_tpu")  # top-level module names, compared whole


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(name: str, run) -> float:
    if name == "setup_s":
        return run.setup_s
    if name == "train_audio_s_per_s" and run.kind == "train":
        return run.audio_s / run.wall_s
    if name == "decode_audio_s_per_s" and run.kind == "decode":
        return run.audio_s / run.wall_s
    if name == "decode_batch_p95_ms" and run.kind == "decode":
        return 1e3 * p95(run.latencies_s)
    raise ValueError(f"a {run.kind} cell cannot report {name}")


def breakdown(tr: dict) -> Dict[str, list]:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from asr_bench import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    conf = spec.config(bench, cell["config"])
    mix = spec.load_mix(cell["traffic"])
    limits = spec.limits(args.workload)

    import torch

    found = forbidden_modules()
    if found:
        print(f"asr_bench: loaded at start-up: {', '.join(found)}", file=sys.stderr)
        return 5
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"asr_bench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    from asr_bench import cells

    runner = {"train": cells.run_train, "decode": cells.run_decode}[mix["kind"]]
    run = runner(conf["recipe"], mix, args.seed, args.seconds, bool(args.trace), "cuda", T_START)

    found = forbidden_modules()
    if found:
        print(f"asr_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 5
    reported = [m["name"] for m in bench["end_to_end"]
                if args.workload in m.get("workloads", [args.workload])]
    metrics: Dict[str, dict] = {}
    if args.trace:
        ctx = {"run": run, "recipe": run.recipe, "mix": mix, "kernel_names": spec.kernel_names}
        for m in spec.per_layer(bench, args.workload, reported):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name in reported:
            metrics[name] = {"value": end_to_end(name, run), "unit": units[name]}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in run.numbers.items()}
    correct = (not run.problems and set(checks) == set(limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"], device["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        line["breakdown"] = breakdown(run.trace)
    for p in run.problems:
        print(f"asr_bench: not correct: {p}", file=sys.stderr)
    if run.checked:
        print("asr_bench: checked " + ", ".join(f"{v} {k}" for k, v in run.checked.items()), file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line["checks"] = checks
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
