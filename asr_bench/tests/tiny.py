"""A tiny recipe and mix of the flagship's shape, for the CPU tests: every
layer of the cell at widths the CPU runs in seconds; and tiny configurations
over it: ``default`` (the default architecture, characters) and
``speller2.units300`` (the two-layer speller of ``tests/speller2.py``, 300
synthetic units)."""

from __future__ import annotations

import copy
from typing import Optional

from asr_bench import spec


def recipe(dtype: str = "float32") -> dict:
    r = copy.deepcopy(spec.config(spec.benchmark(), "flagship")["recipe"])
    r["data"]["corpus"].update(batch_size=4, buckets=[208, 416], token_buckets=[40, 80])
    enc = r["model"]["encoder"]
    enc["dim"] = [16, 16]
    for k in ("dropout", "layer_norm", "proj", "sample_rate"):
        enc[k] = enc[k][:2]
    r["model"]["attention"].update(dim=8, loc_kernel_size=3, loc_kernel_num=2)
    r["model"]["decoder"]["dim"] = 16
    r["lm"].update(emb_dim=16, dim=16)
    r["hparas"]["dtype"] = dtype
    r["decode"]["beam_size"] = 4
    return r


CONFIGS = ["default", "speller2.units300"]


def config(name: str = "default") -> dict:
    """A configuration file's object over ``recipe()``."""
    if name == "default":
        return {"recipe": recipe()}
    if name == "speller2.units300":
        r = recipe()
        r["model"]["decoder"]["layer"] = 2
        return {"recipe": r, "architecture": "asr_bench.tests.speller2", "vocabulary": {"kind": "units", "size": 300}}
    raise KeyError(name)


def mix(kind: str, conf: Optional[dict] = None) -> dict:
    """A tiny mix, its transcripts' rate for ``conf``'s vocabulary."""
    rate = {"tokens_per_s": [3.0, 5.0]} if (conf or {}).get("vocabulary") else {"chars_per_s": [13.0, 17.0]}
    return {"kind": kind, "utterances": 40, "duration_s": {"bins": [[1.4, 2.0, 0.5], [2.1, 4.0, 0.5]]}, **rate,
            "loader_threads": 0, "trace_steps": 2, "trace_batches": 2, "decode": {}}
