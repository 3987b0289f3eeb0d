"""Small helpers (the JAX package's ``utils/misc.py``; ref: src/util.py
human_format)."""

from __future__ import annotations

import sys

_warned: set = set()


def warn_once(key: str, msg: str) -> None:
    """Print ``msg`` to stderr once per process per key: a recipe outside a
    kernel's envelope must not take the slow plain route silently."""
    if key in _warned:
        return
    _warned.add(key)
    print(f"[e2e_asr_tpu_torch] {msg}", file=sys.stderr, flush=True)


def human_format(num: float) -> str:
    """1234567 -> '1.23M' (three significant digits, K / M / G / T)."""
    magnitude = 0
    while abs(num) >= 1000 and magnitude < 4:
        magnitude += 1
        num /= 1000.0
    return f"{num:.3g}{['', 'K', 'M', 'G', 'T'][magnitude]}"


def rss_gb() -> float:
    """This process's resident set size in GiB, from /proc/self/statm (0.0
    where that file cannot be read)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * 4096 / (1 << 30)
    except Exception:
        return 0.0
