"""A configuration's vocabulary: the symbols its traffic's transcripts are
drawn from, their ids, and how the program's loader tokenises them.

``"vocabulary"`` beside ``recipe`` in a configuration file: absent, or
``{"kind": "chars"}``, is the 28-symbol alphabet (26 letters, space,
apostrophe); ``{"kind": "units", "size": N}`` is N synthetic unit names,
standing in for a subword model of N units (nothing is downloaded). Ids: the
reserved three first (0 <sos>, also padding and the CTC blank; 1 <eos>;
2 <unk>), then the symbols in order. A character mix states
``chars_per_s``, a unit mix ``tokens_per_s``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

RESERVED = ["<sos>", "<eos>", "<unk>"]
ALPHABET = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ '")
EOS = 1


class Vocabulary:
    def __init__(self, kind: str, symbols: Sequence[str]):
        self.kind, self.symbols = kind, list(symbols)
        self.size = len(RESERVED) + len(self.symbols)
        self.rate_key = {"chars": "chars_per_s", "units": "tokens_per_s"}[kind]
        self._index = {s: len(RESERVED) + i for i, s in enumerate(self.symbols)}
        self._array = np.asarray(self.symbols)
        if kind == "chars":  # a space a fifth of the time, the other characters alike
            self._p = np.full(len(self.symbols), 0.8 / (len(self.symbols) - 1))
            self._p[self.symbols.index(" ")] = 0.2

    def ids(self, text: str) -> List[int]:
        """A transcript's <eos>-terminated ids, as the program's encoder of
        the same kind gives them."""
        return [self._index[t] for t in (text if self.kind == "chars" else text.split())] + [EOS]

    def draw(self, rng: np.random.Generator, n: int) -> str:
        """A transcript of ``n`` symbols from ``rng``: characters with a space
        a fifth of the time, or units uniform over the vocabulary."""
        if self.kind == "chars":
            return "".join(self._array[rng.choice(len(self.symbols), n, p=self._p)])
        return " ".join(self._array[rng.integers(0, len(self.symbols), n)])


CHARACTERS = Vocabulary("chars", ALPHABET)


def of(conf: dict) -> Vocabulary:
    """The vocabulary a configuration file states."""
    v = conf.get("vocabulary", {"kind": "chars"})
    if v["kind"] == "chars":
        return CHARACTERS
    if v["kind"] == "units":
        return Vocabulary("units", [f"U{i}" for i in range(int(v["size"]))])  # upper case: the word encoder's
    raise ValueError(f"unknown vocabulary kind {v['kind']!r}")
