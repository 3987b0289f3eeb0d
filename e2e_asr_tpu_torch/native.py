"""The port's native host library: edit distance, WAV and FLAC input.

The counterpart of ``e2e_asr_tpu/native`` (its ``__init__``, ``audio_io``
and ``editdist``), built from the port's own copies of the C++,
``csrc/native.cpp`` (Levenshtein, the PCM WAV reader, the threaded
decode-and-pad of a batch) and ``csrc/flac.cpp`` (the FLAC decoder). This
is host code compiled by ``g++``, not a CUDA kernel: ``cuda_build.py``
compiles only the ``.cu`` sources it names.

The library is built at its first use in a process, never at import, into
``_build/native-<hash>.so`` (the hash covers both sources and the flags,
so a changed source gets a library of its own and a stale one is never
loaded), and loaded with ``ctypes``. Nothing here has a second route: a
failed build raises, and so does a file that cannot be read or decoded
whole, as the kernel wrappers raise rather than fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

from e2e_asr_tpu_torch.cuda_build import BUILD_DIR, CSRC_DIR

SOURCES = ("native.cpp", "flac.cpp")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
N_THREADS = 8  # the threads of one pack_batch / levenshtein_batch call

_lib = None
_lock = threading.Lock()

# arrays go in as their addresses (``ndarray.ctypes.data``, c_void_p):
# ``ctypes.data_as`` makes a reference cycle a call, garbage that only the
# collector frees
_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {  # name: (restype, argtypes)
    "levenshtein": (_I64, [_PTR, _I64, _PTR, _I64]),
    "levenshtein_batch": (None, [_PTR, _PTR, _PTR, _PTR, _I64, _PTR, ctypes.c_int]),
    "read_wav": (_I64, [ctypes.c_char_p, _PTR, _I64]),
    "wav_num_samples": (_I64, [ctypes.c_char_p]),
    "pack_wav_batch": (None, [ctypes.POINTER(ctypes.c_char_p), _I64, _PTR, _I64, _PTR, ctypes.c_int]),
    "flac_num_samples": (_I64, [ctypes.c_char_p]),
    "flac_decode": (_I64, [ctypes.c_char_p, _PTR, _I64]),
}


def lib_path() -> str:
    """``_build/native-<hash of the sources and flags>.so``."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compiles the library unless its current one exists; returns its path.
    Raises with the compiler's output when ``g++`` fails."""
    out = lib_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", *GXX_FLAGS, *(os.path.join(CSRC_DIR, s) for s in SOURCES), "-o", tmp, "-lpthread"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed (g++ exit {proc.returncode}):\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)  # atomic: a process that races this one loads a whole file
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
    return _lib


# ------------------------------------------------------------- audio input
def wav_num_samples(path: str) -> int:
    n = library().wav_num_samples(path.encode())
    if n < 0:
        raise IOError(f"cannot read wav: {path}")
    return int(n)


def read_wav(path: str) -> np.ndarray:
    """Channel 0 of a 16- or 32-bit PCM wav as float32 (int / 2^(bits-1))."""
    n = wav_num_samples(path)
    out = np.empty(n, np.float32)
    got = library().read_wav(path.encode(), out.ctypes.data, n)
    if got != n:
        raise IOError(f"cannot decode wav: {path}")
    return out


def pack_batch(paths: Sequence[str], n_samples: int, n_threads: int = N_THREADS) -> Tuple[np.ndarray, np.ndarray]:
    """Decodes ``paths`` on C++ threads (no GIL) into a zero-padded batch:
    (wav [B, n_samples] float32, wav_len [B] int64), each row cut to
    ``n_samples``. Raises when any file cannot be decoded."""
    b = len(paths)
    out = np.empty((b, n_samples), np.float32)
    lens = np.zeros(b, np.int64)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    library().pack_wav_batch(arr, b, out.ctypes.data, n_samples, lens.ctypes.data, max(1, min(n_threads, b)))
    bad = [p for p, n in zip(paths, lens) if n < 0]
    if bad:
        raise IOError(f"cannot decode wav: {', '.join(bad)}")
    return out, lens


def flac_num_samples(path: str) -> int:
    """The stream's sample count from its STREAMINFO (0 when unknown)."""
    n = library().flac_num_samples(path.encode())
    if n < 0:
        raise IOError(f"cannot parse flac: {path}")
    return int(n)


def read_flac(path: str) -> np.ndarray:
    """Channel 0 of a FLAC stream as float32 (int / 2^(bps-1)). Raises when
    a frame cannot be decoded or fewer samples than STREAMINFO's come out."""
    n = flac_num_samples(path)
    cap = n if n > 0 else 1 << 26  # STREAMINFO total unknown: a generous cap
    out = np.empty(cap, np.float32)
    got = library().flac_decode(path.encode(), out.ctypes.data, cap)
    if got < 0 or (n > 0 and got != n):
        raise IOError(f"cannot decode flac: {path} ({got} of {n} samples)")
    return out[:got]


# ------------------------------------------------------------ edit distance
def _ids(seqs: List[Sequence], vocab: dict) -> List[np.ndarray]:
    return [np.fromiter((vocab.setdefault(s, len(vocab)) for s in seq), np.int32, len(seq)) for seq in seqs]


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences of hashables (insert, delete,
    substitute: cost 1 each)."""
    aa, bb = _ids([a, b], {})
    return int(library().levenshtein(aa.ctypes.data, len(aa), bb.ctypes.data, len(bb)))


def levenshtein_batch(pairs: Sequence[Tuple[Sequence, Sequence]], n_threads: int = N_THREADS) -> np.ndarray:
    """The distances of ``[(a, b), ...]`` (int64 [n]) from one call, the
    pairs shared out over C++ threads."""
    vocab: dict = {}
    parts = [_ids([a for a, _ in pairs], vocab), _ids([b for _, b in pairs], vocab)]
    flat, offs = [], []
    for side in parts:
        off = np.zeros(len(pairs) + 1, np.int64)
        np.cumsum([len(x) for x in side], out=off[1:])
        flat.append(np.ascontiguousarray(np.concatenate(side) if side else np.empty(0, np.int32), np.int32))
        offs.append(off)
    out = np.zeros(len(pairs), np.int64)
    if pairs:
        library().levenshtein_batch(flat[0].ctypes.data, offs[0].ctypes.data, flat[1].ctypes.data,
                                    offs[1].ctypes.data, len(pairs), out.ctypes.data,
                                    max(1, min(n_threads, len(pairs))))
    return out
