"""What a run reads by name: ``BENCHMARK.json``'s cell, its configuration
and traffic files, its limits, the per-layer metrics' readers and the
operations' kernel-name lists.

Layout under ``asr_bench/`` (a later change adds files, never edits one):

- ``configs/<config>.json``: ``recipe`` (the whole recipe the program runs,
  every default written out) beside ``source``, ``reduced`` and ``assumed``,
  and optionally ``architecture`` (``architecture`` below) and
  ``vocabulary`` (``asr_bench/vocab.py``);
- ``reference/<module>.py``: an architecture module a configuration names;
- ``traffic/<traffic>.json``: a mix for ``traffic.py``;
- ``limits/<workload>.json``: each compared number's limit;
- ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None``;
- ``kernels/<operation>/*.txt``: kernel names (one substring a line) that do
  an operation's work; every file in the folder counts.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def architecture(conf: dict) -> ModuleType:
    """The architecture module a configuration names: ``"architecture":
    "<module>"`` is ``asr_bench/reference/<module>.py`` (a dotted name is
    imported whole, as a test's own module); without the key,
    ``asr_bench/reference/model.py``."""
    name = conf.get("architecture", "model")
    return importlib.import_module(name if "." in name else "asr_bench.reference." + name)


def limits(workload: str) -> Dict[str, float]:
    return _json(os.path.join(HERE, "limits", workload + ".json"))


def metric_reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location("asr_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def kernel_names(operation: str) -> List[str]:
    names: List[str] = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", operation, "*.txt"))):
        with open(path) as f:
            names += [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    return names


def per_layer(bench: dict, workload: str, reported: List[str]) -> List[dict]:
    """The per-layer metrics a cell's traced run reads: those that list it,
    and those without a list that move an end-to-end metric it reports."""
    out = []
    for m in bench["per_layer"]:
        if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported):
            out.append(m)
    return out


def load_mix(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", name + ".json"))
