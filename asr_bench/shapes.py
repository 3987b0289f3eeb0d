"""Shapes of a recorded batch as the recipe sees them: feature frames,
encoder frames, the beam's steps and each utterance's active steps."""

from __future__ import annotations

from typing import List, Tuple

from asr_bench.traffic import ALPHABET

RESERVED = ["<sos>", "<eos>", "<unk>"]  # ids 0 (also padding and the CTC blank), 1, 2
VOCAB = len(RESERVED) + len(ALPHABET)  # the benchmark's character vocabulary


def frame_params(recipe: dict) -> Tuple[int, int]:
    a = recipe["data"]["audio"]
    return int(a["sample_rate"] * a["frame_length"] / 1000), int(a["sample_rate"] * a["frame_shift"] / 1000)


def feat_lens(recipe: dict, batch: dict) -> List[int]:
    win, shift = frame_params(recipe)
    return [max(0, 1 + (int(n) - win) // shift) for n in batch["wav_len"]]


def enc_frames(recipe: dict, batch: dict) -> int:
    """The bucket's encoder frames (two 2x2 pools after the features)."""
    win, shift = frame_params(recipe)
    return (1 + (batch["n"] - win) // shift) // 4


def enc_lens(recipe: dict, batch: dict) -> List[int]:
    """Each row's encoder frames, at least 1 (an empty row's too)."""
    return [max(1, f // 4) for f in feat_lens(recipe, batch)]


def max_step(recipe: dict, n_samples: int) -> int:
    """The beam's steps for a bucket of ``n_samples``: the window's ratio of
    the bucket's encoder frames (the decode recipe's max_len_ratio)."""
    _, shift = frame_params(recipe)
    return max(4, int(recipe["decode"]["max_len_ratio"] * (n_samples // shift // 4 + 1)))


def active_steps(recipe: dict, batch: dict) -> List[int]:
    """Each real utterance's beam steps inside its token window."""
    ms, ratio = max_step(recipe, batch["n"]), recipe["decode"]["max_len_ratio"]
    return [min(int(ratio * e), ms) for e, u in zip(enc_lens(recipe, batch), batch["uids"]) if u]


def k_cand(recipe: dict) -> int:
    d = recipe["decode"]
    return min(VOCAB, max(d["beam_size"], int(d["beam_size"] * d["ctc_beam_ratio"])))
