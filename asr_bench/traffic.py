"""The one generator of the benchmark's traffic: utterances from a mix file.

A mix (``asr_bench/traffic/<name>.json``) gives the corpus's size, the
duration law of the LibriSpeech split it approximates (bins of seconds with
their shares, uniform inside a bin), the characters a second of audio, and
how the cell drives the program (``kind``: ``train`` or ``decode``, with
their settings). Durations and transcript lengths are the same set for every
seed, spread over the bins by stratified quantiles; the seed changes only
which utterance gets which, the characters, the waves and, through the
loader, the order. So every seed asks for the same work in another order.

Waves are int16 slices of one buffer of Gaussian noise (what they hold does
not matter to a model with random weights; their lengths do): utterance i is
``noise[off_i : off_i + n_i]`` of a buffer tiled long enough, ``load()``
returns it as float32 / 32768, so the loader's int16 round trip is exact.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

ALPHABET = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ '")
NOISE_S = 37.0  # seconds of noise the waves are cut from
NOISE_GAIN = 0.1  # the noise's standard deviation, as a share of full scale


@dataclass
class Utt:
    uid: str
    load: Callable[[], np.ndarray]
    text: str
    n_samples: int
    wav_path: Optional[str] = None


def load_mix(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", name + ".json")) as f:
        return json.load(f)


def durations(mix: dict) -> np.ndarray:
    """The corpus's durations in seconds: quantiles (i + 0.5) / n of the mix's
    piecewise-uniform law, ascending."""
    n = mix["utterances"]
    bins = np.asarray(mix["duration_s"]["bins"], np.float64)  # [lo, hi, share]
    cdf = np.concatenate([[0.0], np.cumsum(bins[:, 2] / bins[:, 2].sum())])
    q = (np.arange(n) + 0.5) / n
    k = np.clip(np.searchsorted(cdf, q, side="right") - 1, 0, len(bins) - 1)
    frac = (q - cdf[k]) / np.maximum(cdf[k + 1] - cdf[k], 1e-12)
    return bins[k, 0] + frac * (bins[k, 1] - bins[k, 0])


def char_rates(mix: dict) -> np.ndarray:
    """Characters a second of each utterance: stratified over the mix's range,
    paired with the durations by a fixed permutation (the same for every seed)."""
    n = mix["utterances"]
    lo, hi = mix["chars_per_s"]
    rates = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return rates[np.random.RandomState(12345).permutation(n)]


def make(mix: dict, seed: int, sample_rate: int) -> List[Utt]:
    """The mix's utterances for ``seed`` (a ``BucketedLoader`` manifest)."""
    rng = np.random.default_rng([seed, 0x5A5])
    dur = durations(mix)
    n_samples = np.round(dur * sample_rate).astype(np.int64)
    n_chars = np.maximum(1, np.round(dur * char_rates(mix)).astype(np.int64))
    n_noise = int(NOISE_S * sample_rate)
    noise = np.clip(rng.standard_normal(n_noise) * NOISE_GAIN * 32768.0, -32768, 32767).astype(np.int16)
    tiled = np.concatenate([noise, noise[: int(n_samples.max())]])
    order = rng.permutation(len(dur))  # which utterance gets which duration
    offs = rng.integers(0, n_noise, len(dur))
    letters = np.asarray(ALPHABET)
    p = np.full(len(ALPHABET), 0.8 / (len(ALPHABET) - 1))
    p[ALPHABET.index(" ")] = 0.2
    utts = []
    for i, j in enumerate(order):
        n, off = int(n_samples[j]), int(offs[i])
        text = "".join(letters[rng.choice(len(ALPHABET), int(n_chars[j]), p=p)])
        wave = tiled[off:off + n]
        utts.append(Utt(f"u{i:05d}", lambda w=wave: w.astype(np.float32) / 32768.0, text, n))
    return utts


def waves_i16(utts: Dict[str, Utt], uids, n: int) -> np.ndarray:
    """[len(uids), n] int16: each utterance's wave, zero past its end (an
    empty uid is an empty row)."""
    out = np.zeros((len(uids), n), np.int16)
    for r, uid in enumerate(uids):
        if uid:
            x = np.round(utts[uid].load() * 32768.0).astype(np.int16)[:n]
            out[r, : len(x)] = x
    return out
