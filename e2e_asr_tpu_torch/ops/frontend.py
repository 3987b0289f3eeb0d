"""Waveform -> log-mel-fbank / MFCC features, on the device.

Counterpart of ``e2e_asr_tpu/ops/frontend.py``. This module holds the plain
PyTorch path (framing by ``unfold``, DFT as a product with precomputed
cosine/sine bases) and rebuilds the numpy constants (mel bank, window, DFT
bases, DCT, delta kernels) itself. ``ops/frontend_cuda.py`` holds the
hand-written log-mel kernel that ``compute_features`` uses when
``cfg.use_pallas`` is set, as the JAX package uses its Pallas kernel.

Semantics follow Kaldi fbank/MFCC conventions (snip_edges framing, per-frame
DC removal, pre-emphasis inside the frame, povey window, power spectrum,
triangular mel bank on the mel scale).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.parallel import dist

LOG_FLOOR = 1.1921e-7  # float32 eps, kaldi-style floor


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def hz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    num_bins: int, n_fft: int, sample_rate: int, low_freq: float, high_freq: float
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank matrix [n_fft//2+1, num_bins]."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0 + high_freq
    n_freqs = n_fft // 2 + 1
    mel_lo, mel_hi = hz_to_mel(low_freq), hz_to_mel(high_freq)
    centers = np.linspace(mel_lo, mel_hi, num_bins + 2)
    fft_mel = hz_to_mel(np.arange(n_freqs) * sample_rate / n_fft)
    fb = np.zeros((n_freqs, num_bins), dtype=np.float32)
    for m in range(num_bins):
        left, center, right = centers[m], centers[m + 1], centers[m + 2]
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=None)
def feature_window(window: str, win_size: int) -> np.ndarray:
    n = np.arange(win_size, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win_size - 1))
    if window == "hanning":
        w = hann
    elif window == "povey":
        w = hann**0.85
    elif window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (win_size - 1))
    else:
        raise ValueError(f"unknown window '{window}'")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(win_size: int, n_fft: int, window: str) -> Tuple[np.ndarray, np.ndarray]:
    """Window-fused real-DFT bases (Wc, Ws), each [win_size, n_fft//2+1]."""
    w = feature_window(window, win_size).astype(np.float64)
    n = np.arange(win_size)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    wc = (w[:, None] * np.cos(ang)).astype(np.float32)
    ws = (w[:, None] * -np.sin(ang)).astype(np.float32)
    return wc, ws


@functools.lru_cache(maxsize=None)
def fused_bases(
    win: int, n_fft: int, window: str, preemphasis: float, remove_dc: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(Aᵀ Wc, Aᵀ Ws) with DC removal + pre-emphasis folded in, [win, F]:
    both are linear maps on a frame, A = E_preemph @ (I - J/win)."""
    wc, ws = dft_matrices(win, n_fft, window)
    a = np.eye(win, dtype=np.float64)
    if remove_dc:
        a = a - np.full((win, win), 1.0 / win)
    if preemphasis > 0:
        e = np.eye(win, dtype=np.float64)
        idx = np.arange(1, win)
        e[idx, idx - 1] = -preemphasis
        e[0, 0] = 1.0 - preemphasis
        a = e @ a
    return (a.T @ wc).astype(np.float32), (a.T @ ws).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_mels: int, n_ceps: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_mels, n_ceps] (kaldi MFCC convention)."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_ceps)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_mels)) * math.sqrt(2.0 / n_mels)
    m[:, 0] *= 1.0 / math.sqrt(2.0)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def delta_kernel(window_size: int, order: int) -> np.ndarray:
    """Kaldi delta-coefficient FIR kernels [order+1, 2*order*window_size+1]
    (row r produces the r-th derivative, row 0 is the identity)."""
    base = np.array([1.0])
    denom = 2.0 * sum(i * i for i in range(1, window_size + 1))
    d1 = np.arange(-window_size, window_size + 1) / denom
    kernels = [base]
    for _ in range(order):
        kernels.append(np.convolve(kernels[-1], d1))
    k = 2 * order * window_size + 1
    out = np.zeros((order + 1, k), dtype=np.float32)
    for r, ker in enumerate(kernels):
        pad = (k - len(ker)) // 2
        out[r, pad : pad + len(ker)] = ker
    return out


def const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def frame_signal(wav: torch.Tensor, win_size: int, shift: int) -> torch.Tensor:
    """[B, N] -> [B, T, win] frames, snip_edges (T = max(0, 1+(N-win)//shift))."""
    if wav.shape[-1] < win_size:
        return wav.new_zeros(wav.shape[:-1] + (0, win_size))
    return wav.unfold(-1, win_size, shift)


def num_frames(n_samples: torch.Tensor, win_size: int, shift: int) -> torch.Tensor:
    return torch.clamp(1 + torch.div(n_samples - win_size, shift, rounding_mode="floor"), min=0)


def _spectrogram_frames(frames: torch.Tensor, cfg: AudioConfig, n_fft: int) -> torch.Tensor:
    """[.., T, win] frames -> [.., T, n_mels] log-mel (plain path)."""
    frames = frames.float()
    frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0:
        first = frames[..., :1] - cfg.preemphasis * frames[..., :1]
        rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    wc, ws = dft_matrices(frames.shape[-1], n_fft, cfg.window)
    re = frames @ const(wc, frames.device)
    im = frames @ const(ws, frames.device)
    power = re * re + im * im
    fb = mel_filterbank(cfg.feat_dim, n_fft, cfg.sample_rate, cfg.low_freq, cfg.high_freq)
    mel = power @ const(fb, frames.device)
    return torch.log(torch.clamp(mel, min=LOG_FLOOR))


def apply_deltas(feat: torch.Tensor, order: int, window_size: int) -> torch.Tensor:
    """[B, T, D] -> [B, T, D*(order+1)] with replicate edge padding."""
    if order == 0:
        return feat
    kernels = const(delta_kernel(window_size, order), feat.device)  # [order+1, K]
    k = kernels.shape[1]
    pad = k // 2
    x = torch.cat([feat[:, :1].expand(-1, pad, -1), feat, feat[:, -1:].expand(-1, pad, -1)], 1)
    windows = x.unfold(1, k, 1)  # [B, T, D, K]
    outs = [torch.einsum("btdk,k->btd", windows, kernels[r]) for r in range(order + 1)]
    return torch.cat(outs, dim=-1)


def apply_cmvn(feat: torch.Tensor, feat_len: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean/var normalization over valid frames only."""
    mask = (torch.arange(feat.shape[1], device=feat.device)[None, :] < feat_len[:, None])[..., None]
    denom = torch.clamp(feat_len, min=1).to(feat.dtype)[:, None, None]
    mean = torch.sum(feat * mask, dim=1, keepdim=True) / denom
    var = torch.sum((feat - mean) ** 2 * mask, dim=1, keepdim=True) / denom
    return torch.where(mask, (feat - mean) * torch.rsqrt(var + 1e-10), 0.0)


def compute_features(
    wav: torch.Tensor,
    wav_len: torch.Tensor,
    cfg: AudioConfig,
    use_pallas: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched waveform -> features. [B, N], [B] -> ([B, T, D_out], [B]).

    ``use_pallas`` keeps the JAX package's config name: when set, the
    log-mel step is the hand-written kernel (ops/frontend_cuda.py; its plain
    version on CPU tensors), otherwise the plain framing path below. Dither
    is added to the waveform only when cfg.dither > 0 and a generator is
    passed (training; decode passes none).
    """
    win = int(cfg.sample_rate * cfg.frame_length / 1000.0)
    shift = int(cfg.sample_rate * cfg.frame_shift / 1000.0)
    n_fft = next_pow2(win)
    feat_len = num_frames(wav_len, win, shift)

    if cfg.feat_type == "raw":
        raise ValueError("feat_type=raw has no frontend")
    if not torch.is_floating_point(wav):
        # int16 PCM wire format -> normalized f32
        wav = wav.float() * (1.0 / 32768.0)
    if cfg.dither > 0 and generator is not None:
        # drawn at the global batch's shape, this rank's rows kept (parallel/dist.py)
        noise = dist.global_draw(torch.randn, wav.shape, generator)
        wav = wav + cfg.dither * noise.to(wav.device)

    pallas = cfg.use_pallas if use_pallas is None else use_pallas
    if pallas:
        from e2e_asr_tpu_torch.ops.frontend_cuda import log_mel

        logmel = log_mel(wav, cfg, win, shift, n_fft)
    else:
        logmel = _spectrogram_frames(frame_signal(wav, win, shift), cfg, n_fft)

    if cfg.feat_type == "mfcc":
        feat = logmel @ const(dct_matrix(cfg.feat_dim, cfg.num_ceps), logmel.device)
    else:
        feat = logmel
    feat = apply_deltas(feat, cfg.delta_order, cfg.delta_window_size)
    if cfg.apply_cmvn:
        feat = apply_cmvn(feat, feat_len)
    else:
        mask = (torch.arange(feat.shape[1], device=feat.device)[None, :] < feat_len[:, None])[..., None]
        feat = torch.where(mask, feat, 0.0)
    return feat, feat_len
