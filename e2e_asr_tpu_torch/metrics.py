"""Error rates (WER/CER) on the host, as ``e2e_asr_tpu/utils/metrics.py``.

The distances come from the native Levenshtein (``native.py``): ``cal_er``
makes one ``levenshtein_batch`` call a batch. ``edit_distance_plain`` is the
same distance as a Python loop, the plain version the tests hold the native
one against; no scoring path calls it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from e2e_asr_tpu_torch import native


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (insert, delete, substitute: cost 1 each)."""
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance through the native library."""
    return native.levenshtein(a, b)


def cal_er(
    tokenizer,
    pred_ids: np.ndarray,
    truth_ids: np.ndarray,
    mode: str = "wer",
    ctc: bool = False,
    pred_len: Optional[np.ndarray] = None,
) -> tuple:
    """(errors, reference length) over a batch. ``ctc`` collapses repeats
    before blanks are dropped; rows with an empty reference are skipped.
    The batch's distances come from one native call."""
    pairs = []
    for i in range(len(pred_ids)):
        p = pred_ids[i][: None if pred_len is None else int(pred_len[i])]
        hyp = tokenizer.decode(p, ignore_repeat=ctc)
        ref = tokenizer.decode(truth_ids[i])
        if not ref:
            continue
        pairs.append((hyp.split(), ref.split()) if mode == "wer" else (list(hyp), list(ref)))
    return int(native.levenshtein_batch(pairs).sum()), sum(len(r) for _, r in pairs)
