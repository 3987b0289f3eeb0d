"""Log-mel kernel (csrc/log_mel.cu) beside its plain PyTorch version.

Replaces the TPU kernel ``e2e_asr_tpu/ops/frontend_pallas.py``
``log_mel_pallas``. Both versions compute, for ``wav`` [B, N] f32,
T = max(1, 1 + (N - win) // shift) frames (samples past N read as zero),
per frame DC removal, pre-emphasis, the window, the real DFT, power, the
mel product and the log floor -> [B, T, n_mels]. The plain version folds
DC removal and pre-emphasis into the windowed DFT bases, as the TPU kernel
does; the kernel applies them on the time side and runs a real FFT in
float64, from the tables ``kernel_tables`` builds. The source note in the
.cu file says what bounds the kernel on the H100, why it computes in
float64 and how its design answers both.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.ops import frontend as fe

N_FFT_RANGE = (256, 2048)  # the kernel's sizes: 25 ms windows at 8 to 48 kHz


def mel_ranges(fb: np.ndarray):
    """Each filter's bins as (first bin, bins, offset) [M, 3] int32 and the
    weights of all filters in one f32 array, taken from ``fb`` [F, M]
    itself: a filter's range runs from its first nonzero bin to its last.
    A filter's weights start at a multiple of 4 and are padded with zeros to
    one (the kernel reads them four at a time)."""
    rng = np.zeros((fb.shape[1], 3), np.int32)
    weights = []
    off = 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        start, stop = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        rng[m] = (start, stop - start, off)
        padded = -(-(stop - start) // 4) * 4
        weights.append(np.pad(fb[start:stop, m], (0, padded - (stop - start))))
        off += padded
    return rng, np.concatenate(weights).astype(np.float32)


def plan(n_fft: int):
    """(filters a group, warps a block) of the kernel's plan at ``n_fft``,
    asked of the kernel itself (``e2e_log_mel_plan``): what the host needs
    to build the filter groups."""
    out = torch.zeros(2, dtype=torch.int32)
    lib = cuda_build.library("log_mel")
    fn = lib.e2e_log_mel_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(n_fft, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"e2e_log_mel_plan: {lib.e2e_error_string(err).decode()}")
    return int(out[0]), int(out[1])


def mel_groups(rng: np.ndarray, size: int, warps: int) -> np.ndarray:
    """The kernel's mel work, [rounds * warps, size] int32: groups of
    ``size`` filters of about equal length (consecutive in order of length),
    a warp summing one group's filters at a time, one filter a row of lanes.
    Row i * warps + w is warp w's group of round i (-1: no filter): the
    groups, longest first, each go to the warp with the fewest bins so far
    (its groups' longest filters), so that the warps' loops are of about
    equal length."""
    order = sorted(range(len(rng)), key=lambda m: (-int(rng[m][1]), m))
    groups = [order[i:i + size] for i in range(0, len(order), size)]
    load = [0] * warps
    dealt = [[] for _ in range(warps)]
    for g in groups:  # longest first
        w = min(range(warps), key=lambda w: (load[w], w))
        dealt[w].append(g)
        load[w] += int(rng[g[0]][1])
    rounds = max(len(d) for d in dealt)
    out = np.full((rounds, warps, size), -1, np.int32)
    for w, d in enumerate(dealt):
        for i, g in enumerate(d):
            out[i, w, :len(g)] = g
    return out.reshape(rounds * warps, size)


@functools.lru_cache(maxsize=None)
def kernel_tables(win, n_fft, window, preemphasis, feat_dim, sample_rate, low, high):
    """The kernel's tables: the window [win] and the roots of unity
    e^{-2 pi i j / n_fft} [n_fft, 2] in float64 (the window's values are
    ``feature_window``'s, as the plain version's bases take them); the mel
    ranges and float32 weights (``mel_ranges``); the pre-emphasis (0 where
    the frontend applies none)."""
    rng, weights = mel_ranges(fe.mel_filterbank(feat_dim, n_fft, sample_rate, low, high))
    roots = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    return SimpleNamespace(
        window=fe.feature_window(window, win).astype(np.float64),
        roots=np.stack([roots.real, roots.imag], -1),
        mel_rng=rng, mel_w=weights, pre=float(preemphasis) if preemphasis > 0 else 0.0,
    )


@functools.lru_cache(maxsize=None)
def _constants(win, n_fft, window, preemphasis, feat_dim, sample_rate, low, high, device):
    """Per device: the plain version's folded bases and mel bank, and the
    kernel's tables (``kernel_tables``)."""
    dev = torch.device(device)
    wc, ws = fe.fused_bases(win, n_fft, window, preemphasis)
    fb = fe.mel_filterbank(feat_dim, n_fft, sample_rate, low, high)
    k = kernel_tables(win, n_fft, window, preemphasis, feat_dim, sample_rate, low, high)
    mel_w = k.mel_w if k.mel_w.size else np.zeros(1, np.float32)  # a filter bank of empty filters
    return SimpleNamespace(
        wc=fe.const(wc, dev), ws=fe.const(ws, dev), fb=fe.const(fb, dev), window=fe.const(k.window, dev),
        roots=fe.const(k.roots, dev), mel_rng=fe.const(k.mel_rng, dev), mel_w=fe.const(mel_w, dev),
        n_w=int(k.mel_w.size), pre=k.pre,
    )


@functools.lru_cache(maxsize=None)
def _groups(win, n_fft, window, preemphasis, feat_dim, sample_rate, low, high, device):
    """Per device: the kernel's filter groups (``mel_groups`` by its ``plan``)."""
    k = kernel_tables(win, n_fft, window, preemphasis, feat_dim, sample_rate, low, high)
    return fe.const(mel_groups(k.mel_rng, *plan(n_fft)), torch.device(device))


def _key(wav: torch.Tensor, cfg: AudioConfig, win: int, n_fft: int):
    return (win, n_fft, cfg.window, float(cfg.preemphasis), cfg.feat_dim, cfg.sample_rate,
            float(cfg.low_freq), float(cfg.high_freq), str(wav.device))


def _bases(wav: torch.Tensor, cfg: AudioConfig, win: int, n_fft: int):
    return _constants(*_key(wav, cfg, win, n_fft))


def n_log_mel_frames(n: int, win: int, shift: int) -> int:
    return max(1, 1 + (n - win) // shift)


def log_mel_plain(wav: torch.Tensor, cfg: AudioConfig, win: int, shift: int, n_fft: int) -> torch.Tensor:
    """Plain version: the folded-DFT product of the TPU kernel, in PyTorch."""
    b, n = wav.shape
    t = n_log_mel_frames(n, win, shift)
    need = (t - 1) * shift + win
    x = F.pad(wav, (0, need - n)) if need > n else wav[:, :need]
    frames = x.unfold(-1, win, shift)  # [B, T, win]
    c = _bases(wav, cfg, win, n_fft)
    re = frames @ c.wc
    im = frames @ c.ws
    mel = (re * re + im * im) @ c.fb
    return torch.log(torch.clamp(mel, min=fe.LOG_FLOOR))


def log_mel(wav: torch.Tensor, cfg: AudioConfig, win: int, shift: int, n_fft: int) -> torch.Tensor:
    """[B, N] f32 audio -> [B, T, n_mels] log-mel. Plain version on CPU
    tensors; the CUDA kernel on CUDA tensors (n_fft a power of two in
    ``N_FFT_RANGE``, win <= n_fft)."""
    if cuda_build.use_plain(wav):
        return log_mel_plain(wav, cfg, win, shift, n_fft)
    lo, hi = N_FFT_RANGE
    if n_fft & (n_fft - 1) or not lo <= n_fft <= hi:
        raise ValueError(f"log_mel kernel: n_fft {n_fft} is not a power of two in [{lo}, {hi}] "
                         "(25 ms windows at 8 to 48 kHz)")
    if not 1 <= win <= n_fft or shift < 1:
        raise ValueError(f"log_mel kernel: needs 1 <= win <= n_fft and shift >= 1, got win {win}, "
                         f"shift {shift}, n_fft {n_fft}")
    wav = wav.contiguous()
    cuda_build.check_cuda(wav, "log_mel wav")
    out = _launch((), wav, cfg, win, shift, n_fft)
    if wav.shape[0]:
        log_mel.launches += 1
    return out


def _launch(defines, wav: torch.Tensor, cfg: AudioConfig, win: int, shift: int, n_fft: int) -> torch.Tensor:
    """One launch of the kernel's library built with ``defines`` (a source
    variant, ``bin/profile_decode.py``) on a checked wave; no count."""
    b, n = wav.shape
    c = _bases(wav, cfg, win, n_fft)
    out = torch.empty((b, n_log_mel_frames(n, win, shift), c.fb.shape[1]), dtype=torch.float32, device=wav.device)
    if b == 0:
        return out
    grp = _groups(*_key(wav, cfg, win, n_fft))
    if n == 0:
        wav = wav.new_zeros((b, 4))  # the one frame is all zeros either way
    if wav.data_ptr() % 16:
        wav = wav.clone()  # the kernel stages rows with 16-byte copies
    cuda_build.launch(
        "log_mel", "e2e_log_mel", wav, c.window, c.roots, c.mel_w, c.mel_rng, grp, out,
        b, n, out.shape[1], win, shift, n_fft, c.fb.shape[1], c.n_w, *grp.shape, ctypes.c_double(c.pre),
        defines=defines,
    )
    return out


log_mel.launches = 0
