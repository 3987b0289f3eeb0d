"""Build, load and launch the port's hand-written Hopper kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers: a source that includes ``torch/extension.h`` takes minutes
to compile, a plain one seconds). All sources are compiled in parallel, one
``nvcc`` process each, at the first kernel launch of the process, into
``e2e_asr_tpu_torch/_build/`` (listed in ``.gitignore``). A library is
reused while its source, the ``csrc/*.cuh`` headers it includes and its
flags are unchanged (the file name carries their hash).

A source may also be built as a variant with extra preprocessor defines
(``library(name, defines=("SCAN_PHASES",))``): its own library beside the
normal one, built only when asked for, never by ``build_all()``.

Every exported launcher returns the ``cudaError_t`` of
``cudaGetLastError()`` taken right after its launch; ``launch`` raises on
anything but ``cudaSuccess``. A build failure raises too: there is no
fallback from a CUDA tensor to a kernel's plain version.

Kernel wrappers route CPU tensors, and only those, to their plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("log_mel", "lstm_bidir", "lstm_bidir_bwd", "att_step", "ctc_prefix", "ctc_loss",
           "decoder_scan", "decoder_scan_bwd")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(defines: Sequence[str]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _source_bytes(name: str) -> bytes:
    """The text of ``csrc/<name>.cu`` followed by that of every ``csrc``
    header it includes (``#include "x.cuh"``, one level), so that an edited
    header changes the library's name too."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        src = f.read()
    out = [src]
    for header in re.findall(rb'^\s*#include\s+"([^"]+)"', src, flags=re.M):
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as f:
            out.append(f.read())
    return b"".join(out)


def _lib_path(name: str, defines: Sequence[str] = ()) -> str:
    digest = hashlib.sha1(_source_bytes(name) + " ".join(_flags(defines)).encode()).hexdigest()[:12]
    tag = "".join(f"-{d.lower()}" for d in defines)
    return os.path.join(BUILD_DIR, f"{name}{tag}-{digest}.so")


def build_all(variants: Sequence[Tuple[str, Sequence[str]]] = ()) -> Dict[str, str]:
    """Compile every kernel source that has no current library, and the
    ``variants`` (pairs of source name and defines) asked for, in parallel.

    Returns {name: compiler log} for the libraries compiled by this call
    (``-Xptxas -v`` lists each kernel's registers and shared memory)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, defines in [(n, ()) for n in SOURCES] + [(n, tuple(d)) for n, d in variants]:
        out = _lib_path(name, defines)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *_flags(defines), "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        label = name + "".join(f" -D{d}" for d in defines)
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    logs = {}
    failed: List[str] = []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` built with ``defines``
    (built on first use)."""
    key = (name, tuple(defines))
    with _lock:
        if key not in _libs:
            path = _lib_path(name, key[1])
            if not os.path.isfile(path):
                build_all([key] if key[1] else ())
            lib = ctypes.CDLL(path)
            lib.e2e_error_string.argtypes = [ctypes.c_int]
            lib.e2e_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return _libs[key]


def register(name: str, tag: str, path: str) -> None:
    """Load the library at ``path``, a variant of source ``name`` built
    from rewritten source (``bin/profile_decode.py``), as ``library(name,
    (tag,))``, so that the launchers that take ``defines`` reach it."""
    lib = ctypes.CDLL(path)
    lib.e2e_error_string.argtypes = [ctypes.c_int]
    lib.e2e_error_string.restype = ctypes.c_char_p
    with _lock:
        _libs[(name, (tag,))] = lib


def launch(name: str, fn: str, *args, defines: Sequence[str] = ()) -> None:
    """Call launcher ``fn`` of library ``name`` (built with ``defines``) on
    the current stream.

    ``args`` are tensors (passed as device pointers), Python ints (passed as
    C ``int``), floats (passed as C ``float``) or ``ctypes.c_double``; the
    stream goes last."""
    lib = library(name, defines)
    cargs = []
    for a in args:
        if isinstance(a, ctypes.c_double):
            cargs.append(a)
        elif isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        elif isinstance(a, bool) or not isinstance(a, (int, float)):
            raise TypeError(f"unsupported kernel argument {type(a)}")
        elif isinstance(a, int):
            cargs.append(ctypes.c_int(a))
        else:
            cargs.append(ctypes.c_float(a))
    stream = torch.cuda.current_stream().cuda_stream
    cargs.append(ctypes.c_void_p(stream))
    func = getattr(lib, fn)
    func.argtypes = [type(a) for a in cargs]
    func.restype = ctypes.c_int
    err = func(*cargs)
    if err != 0:
        raise RuntimeError(f"{name}.{fn} launch failed: {lib.e2e_error_string(err).decode()}")


STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # the types a kernel with a bf16 variant takes


def dtype_code(dtype: torch.dtype, name: str) -> int:
    """The storage-type argument of the kernels that have a bf16 variant: 0
    float32, 1 bfloat16; raises on any other type."""
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"{name}: no kernel variant for {dtype}")
    return int(dtype == torch.bfloat16)


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel in its ``dtype`` variant: its
    float32 variant counts in ``wrapper.launches``, its bfloat16 variant
    in ``wrapper.launches_bf16``."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def use_plain(x: torch.Tensor) -> bool:
    """True when a wrapper must run its plain version: for CPU tensors."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return False


def check_cuda(x: torch.Tensor, name: str, dtype=torch.float32) -> None:
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: kernel needs a contiguous {dtype} CUDA tensor, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
