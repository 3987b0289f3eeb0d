"""Port features vs the JAX frontend: compute_features on both paths
(the Pallas kernel in interpret mode / its kernel's plain version, and the
XLA oracle / the plain framing path), the log-mel kernel module alone, and
the CUDA kernel's decomposition (time-side preprocessing, a real FFT from
its host tables, sparse mel ranges) emulated on the CPU.

Tolerance: the JAX suite's own for features, rtol 1e-3, atol 2e-3
(tests/test_frontend.py): log-mel amplifies f32 rounding near the floor.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import AudioConfig as JAudio
from e2e_asr_tpu.ops import frontend as jfe
from e2e_asr_tpu.ops.frontend_pallas import log_mel_pallas
from e2e_asr_tpu_torch.config import AudioConfig as TAudio
from e2e_asr_tpu_torch.ops import frontend as tfe
from e2e_asr_tpu_torch.ops import frontend_cuda

torch.set_num_threads(1)
RTOL, ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def wav_batch():
    rng = np.random.RandomState(42)
    n = 12000
    wav = (rng.randn(3, n) * 0.1).astype(np.float32)
    tt = np.arange(n) / 16000.0
    wav += 0.5 * np.sin(2 * np.pi * 440 * tt)[None, :].astype(np.float32)
    wav_len = np.array([n, 7000, 0], np.int32)  # last row: an all-padding row
    for i, l in enumerate(wav_len):
        wav[i, l:] = 0.0
    return wav, wav_len


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_compute_features_matches_jax(wav_batch, use_pallas, wire):
    wav, wav_len = wav_batch
    if wire == "int16":
        wav = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    kw = dict(feat_dim=40, apply_cmvn=True)
    jf, jl = jfe.compute_features(jnp.asarray(wav), jnp.asarray(wav_len), JAudio(**kw), use_pallas=use_pallas)
    tf, tl = tfe.compute_features(torch.from_numpy(wav), torch.from_numpy(wav_len), TAudio(**kw),
                                  use_pallas=use_pallas)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert tl[2] == 0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    assert np.isfinite(tf.numpy()).all()
    assert (tf.numpy()[2] == 0).all()


def test_log_mel_kernel_plain_matches_pallas(wav_batch):
    """The log-mel kernel's plain version against the Pallas kernel itself."""
    wav = wav_batch[0]
    cfg_j, cfg_t = JAudio(feat_dim=40), TAudio(feat_dim=40)
    win, shift, n_fft = 400, 160, 512
    want = log_mel_pallas(jnp.asarray(wav), cfg_j, win, shift, n_fft, interpret=True)
    got = frontend_cuda.log_mel(torch.from_numpy(wav), cfg_t, win, shift, n_fft)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_log_mel_short_wave_has_one_frame():
    """N < win: the kernel (as the Pallas one) emits one zero-padded frame."""
    cfg = TAudio(feat_dim=40)
    out = frontend_cuda.log_mel(torch.zeros((2, 100)), cfg, 400, 160, 512)
    assert out.shape == (2, 1, 40)
    np.testing.assert_allclose(out.numpy(), np.log(tfe.LOG_FLOOR), rtol=1e-6)


def test_dither_only_with_generator(wav_batch):
    wav, wav_len = wav_batch
    cfg = TAudio(feat_dim=40, dither=1e-3, use_pallas=False)
    args = (torch.from_numpy(wav), torch.from_numpy(wav_len), cfg)
    plain, _ = tfe.compute_features(*args)
    again, _ = tfe.compute_features(*args)
    assert torch.equal(plain, again)
    gen = torch.Generator().manual_seed(0)
    noisy, _ = tfe.compute_features(*args, generator=gen)
    assert not torch.equal(plain, noisy)


# ---- the CUDA kernel's decomposition, emulated on the CPU in float64 from
# the float32 samples to the power, as the kernel computes it: the frame's
# mean removed, pre-emphasis and the window on the time side; the
# n_fft-point real FFT as an n_fft / 2-point complex FFT of the even/odd
# packed frame, by Stockham passes whose twiddles come from the roots table
# as the kernel takes them (e^{-2 pi i r k / (NS R)} = root r k n_fft /
# (NS R)), then the split step on the first roots; the power rounded to
# float32 and each mel filter summed over its bin range in increasing bin
# order in float32. The kernel runs only on the card; this holds its
# tables. The passes here are radix 16 while 16 divides what is left, then
# what is left: the kernel's plan is its own and tested on the card.


def _stockham(z, roots, n_fft):
    """[..., NC] complex128 -> its DFT, pass by pass (sub-transform j = k +
    NS q of each pass, radix-R DFT, autosort store)."""
    nc = z.shape[-1]
    ns = 1
    while ns < nc:
        r = 16 if nc % (ns * 16) == 0 else nc // ns
        j = torch.arange(nc // r)[:, None]
        rr = torch.arange(r)[None, :]
        k = j % ns
        v = z[..., j + rr * (nc // r)] * roots[rr * k * (n_fft // (ns * r))]
        n = np.arange(r)
        v = v @ torch.from_numpy(np.exp(-2j * np.pi * np.outer(n, n) / r))
        out = torch.empty_like(z)
        out[..., (j // ns) * ns * r + k + rr * ns] = v
        z = out
        ns *= r
    return z


def _emulate(wav, tabs, win, shift, n_fft):
    """[B, N] f32 -> [B, T, M] as the kernel computes it."""
    b, n = wav.shape
    t = frontend_cuda.n_log_mel_frames(n, win, shift)
    x = torch.nn.functional.pad(wav, (0, max(0, (t - 1) * shift + win - n)))
    frames = x.unfold(-1, win, shift)[:, :t].double()
    d = frames - frames.sum(-1, keepdim=True) / win
    prev = torch.cat([d[..., :1], d[..., :-1]], -1)  # y0 = d0 - p d0 = (1 - p) d0
    y = (d - tabs.pre * prev) * torch.from_numpy(tabs.window)
    y = torch.nn.functional.pad(y, (0, n_fft - win))
    roots = torch.view_as_complex(torch.from_numpy(tabs.roots).contiguous())
    nc = n_fft // 2
    z = _stockham(torch.complex(y[..., 0::2], y[..., 1::2]), roots, n_fft)
    k = torch.arange(nc // 2 + 1)
    p, q = z[..., k], z[..., (nc - k) % nc]
    ye, yo = (p + q.conj()) / 2, (p - q.conj()) / 2j
    hi, lo = ye + roots[k] * yo, ye - roots[k] * yo
    power = torch.zeros(y.shape[:-1] + (nc + 1,), dtype=torch.float64)
    power[..., nc - k] = lo.abs() ** 2
    power[..., k] = hi.abs() ** 2
    want = torch.fft.rfft(y).abs() ** 2
    scale = want.amax(-1, keepdim=True).clamp_min(1e-300)
    assert float(((power - want).abs() / scale).max()) < 1e-12  # the FFT itself
    power = power.float()
    mel = torch.zeros(power.shape[:-1] + (len(tabs.mel_rng),))
    for m, (start, count, off) in enumerate(tabs.mel_rng):
        for i in range(count):
            mel[..., m] += power[..., start + i] * float(tabs.mel_w[off + i])
    return torch.log(torch.clamp(mel, min=tfe.LOG_FLOOR))


def _reference(wav, tabs, fb, win, shift, n_fft):
    """The same function wholly in float64 (the library FFT, the dense mel
    product): what the kernel's float64 transform is held to."""
    t = frontend_cuda.n_log_mel_frames(wav.shape[1], win, shift)
    x = torch.nn.functional.pad(wav, (0, max(0, (t - 1) * shift + win - wav.shape[1])))
    d = x.unfold(-1, win, shift)[:, :t].double()
    d = d - d.mean(-1, keepdim=True)
    y = torch.cat([(1 - tabs.pre) * d[..., :1], d[..., 1:] - tabs.pre * d[..., :-1]], -1)
    power = torch.fft.rfft(y * torch.from_numpy(tabs.window), n=n_fft).abs() ** 2
    return torch.log(torch.clamp(power @ torch.from_numpy(fb).double(), min=tfe.LOG_FLOOR))


def _speechlike(rng, b, n, sr):
    """Tones under noise, quantised to int16 steps, with a stretch of digital
    silence (exact zeros) longer than two frames."""
    tt = np.arange(n) / sr
    wav = 0.05 * rng.randn(b, n) + 0.4 * np.sin(2 * np.pi * 300 * tt) + 0.2 * np.sin(2 * np.pi * 1700 * tt)
    wav = np.round(wav * 32767.0) / 32768.0
    wav[:, n // 3: n // 3 + int(0.05 * sr)] = 0.0
    return wav.astype(np.float32)


def _check_ranges(tabs, fb):
    """The ranges' weights are fb's nonzeros exactly; the filter groups,
    at either group size the kernel's plans take, hold every filter once
    and are dealt to the warps about evenly."""
    dense = np.zeros_like(fb)
    for m, (start, count, off) in enumerate(tabs.mel_rng):
        dense[start:start + count, m] = tabs.mel_w[off:off + count]
    np.testing.assert_array_equal(dense, fb)
    assert np.count_nonzero(tabs.mel_w) == np.count_nonzero(fb)  # the padding is zeros
    assert (tabs.mel_rng[:, 2] % 4 == 0).all() and tabs.mel_w.size % 4 == 0
    lens = tabs.mel_rng[:, 1]
    for size, warps in ((2, 8), (4, 8)):
        groups = frontend_cuda.mel_groups(tabs.mel_rng, size, warps)
        assert groups.shape[1] == size and len(groups) % warps == 0
        assert sorted(groups[groups >= 0].tolist()) == list(range(fb.shape[1]))  # each filter once
        per_warp = [sum(int(lens[g[g >= 0]].max()) for g in groups[w::warps] if (g >= 0).any())
                    for w in range(warps)]
        longest_group = max(int(lens[g[g >= 0]].max()) for g in groups if (g >= 0).any())
        assert max(per_warp) <= sum(per_warp) / len(per_warp) + longest_group  # dealt about evenly


@pytest.mark.parametrize("sample_rate", [16000, 8000])
@pytest.mark.parametrize("feat_dim", [40, 80])
@pytest.mark.parametrize("preemphasis", [0.97, 0.0])
@pytest.mark.parametrize("window", ["povey", "hamming", "hanning"])
def test_kernel_decomposition_matches_plain_and_pallas(window, preemphasis, feat_dim, sample_rate):
    kw = dict(feat_dim=feat_dim, sample_rate=sample_rate, preemphasis=preemphasis, window=window)
    cfg_t, cfg_j = TAudio(**kw), JAudio(**kw)
    win, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    n_fft = tfe.next_pow2(win)
    tabs = frontend_cuda.kernel_tables(win, n_fft, window, preemphasis, feat_dim, sample_rate, 20.0, 0.0)
    fb = tfe.mel_filterbank(feat_dim, n_fft, sample_rate, 20.0, 0.0)
    _check_ranges(tabs, fb)
    wav = _speechlike(np.random.RandomState(feat_dim + sample_rate), 2, sample_rate // 4 + 37, sample_rate)
    got = _emulate(torch.from_numpy(wav), tabs, win, shift, n_fft)
    plain = frontend_cuda.log_mel_plain(torch.from_numpy(wav), cfg_t, win, shift, n_fft)
    pallas = log_mel_pallas(jnp.asarray(wav), cfg_j, win, shift, n_fft, interpret=True)
    assert got.shape == plain.shape == pallas.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)
    # the float64 transform leaves the float32 power's and mel sums' rounding
    ref = _reference(torch.from_numpy(wav), tabs, fb, win, shift, n_fft)
    assert float((got.double() - ref).abs().max()) < 1e-5
    first_silent = -(-(wav.shape[1] // 3) // shift)  # a frame wholly inside the silence
    floor = torch.log(torch.tensor(tfe.LOG_FLOOR, dtype=torch.float32))
    assert bool((got[:, first_silent] == floor).all()) and bool((plain[:, first_silent] == floor).all())


@pytest.mark.parametrize("sample_rate,n_fft", [(32000, 1024), (48000, 2048), (10000, 256)])
def test_kernel_decomposition_other_sizes(sample_rate, n_fft):
    """The FFT sizes the 16 and 8 kHz recipes do not reach (n_fft 1024 and
    2048), and a window (250 samples) that is not a multiple of the pack."""
    cfg = TAudio(feat_dim=80, sample_rate=sample_rate)
    win, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    assert tfe.next_pow2(win) == n_fft
    tabs = frontend_cuda.kernel_tables(win, n_fft, "povey", 0.97, 80, sample_rate, 20.0, 0.0)
    _check_ranges(tabs, tfe.mel_filterbank(80, n_fft, sample_rate, 20.0, 0.0))
    wav = torch.from_numpy(_speechlike(np.random.RandomState(n_fft), 2, win + 3 * shift + 11, sample_rate))
    np.testing.assert_allclose(_emulate(wav, tabs, win, shift, n_fft).numpy(),
                               frontend_cuda.log_mel_plain(wav, cfg, win, shift, n_fft).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_kernel_sizes_outside_its_range_raise():
    """The kernel covers n_fft 256 to 2048 (powers of two); the wrapper says so
    before any device work. Checked with a CUDA tensor stand-in: the size check
    comes before the kernel is built."""
    cfg = TAudio(feat_dim=40)
    meta = torch.empty((1, 4000), device="meta")
    with mock.patch.object(frontend_cuda.cuda_build, "use_plain", lambda x: False):
        for n_fft in (128, 4096, 500):
            with pytest.raises(ValueError, match="power of two in \\[256, 2048\\]"):
                frontend_cuda.log_mel(meta, cfg, 100, 40, n_fft)
        with pytest.raises(ValueError, match="win <= n_fft"):
            frontend_cuda.log_mel(meta, cfg, 600, 160, 512)
