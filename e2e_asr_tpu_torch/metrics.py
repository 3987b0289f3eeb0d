"""Error rates (WER/CER) on the host, as ``e2e_asr_tpu/utils/metrics.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (insert, delete, substitute: cost 1 each)."""
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


def cal_er(
    tokenizer,
    pred_ids: np.ndarray,
    truth_ids: np.ndarray,
    mode: str = "wer",
    ctc: bool = False,
    pred_len: Optional[np.ndarray] = None,
) -> tuple:
    """(errors, reference length) over a batch. ``ctc`` collapses repeats
    before blanks are dropped; rows with an empty reference are skipped."""
    total_err, total_len = 0, 0
    for i in range(len(pred_ids)):
        p = pred_ids[i][: None if pred_len is None else int(pred_len[i])]
        hyp = tokenizer.decode(p, ignore_repeat=ctc)
        ref = tokenizer.decode(truth_ids[i])
        if not ref:
            continue
        h, r = (hyp.split(), ref.split()) if mode == "wer" else (list(hyp), list(ref))
        total_err += edit_distance(h, r)
        total_len += len(r)
    return total_err, total_len
