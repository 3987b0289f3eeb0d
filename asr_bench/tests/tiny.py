"""A tiny recipe and mix of the flagship's shape, for the CPU tests: every
layer of the cell at widths the CPU runs in seconds."""

from __future__ import annotations

import copy

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


def mix(kind: str) -> dict:
    return {"kind": kind, "utterances": 40, "duration_s": {"bins": [[1.4, 2.0, 0.5], [2.1, 4.0, 0.5]]},
            "chars_per_s": [13.0, 17.0], "loader_threads": 0, "trace_steps": 2, "trace_batches": 2, "decode": {}}
