"""Corpus adapters: filesystem -> utterance manifests.

A copy of ``e2e_asr_tpu/data/corpus.py`` (the port imports nothing of the
JAX package): LibriSpeech-layout walking over flac (the port's native
decoder, ``native.py``), wav and npy files, plus the deterministic
numpy-generated synthetic corpus used by tests and the chip smoke run.

An utterance is (uid, loader, transcript, n_samples); `loader()` returns the
float32 waveform lazily so manifests stay cheap.
"""

from __future__ import annotations

import itertools
import os
import wave
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from e2e_asr_tpu_torch import native


@dataclass
class Utterance:
    uid: str
    load: Callable[[], np.ndarray]  # -> float32 [n_samples]
    text: str
    n_samples: int
    wav_path: Optional[str] = None  # set when backed by a wav file: the
    # loader fills a batch of such rows with one native pack_batch


def _load_wav(path: str) -> np.ndarray:
    """Minimal PCM wav reader (no soundfile/torchaudio in the image): channel
    0, as the native reader takes it. A file shorter than its header says
    raises."""
    with wave.open(path, "rb") as f:
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        data = f.readframes(n)
    if len(data) != n * width * channels:
        raise IOError(f"wav shorter than its header: {path}")
    if width == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width {width} in {path}")
    return x[::channels]


def _wav_samples(path: str) -> int:
    with wave.open(path, "rb") as f:
        return f.getnframes()


def _load_npy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32).reshape(-1)


def librispeech(
    path: str, splits: Sequence[str], sample_rate: int = 16000
) -> List[Utterance]:
    """Walk LibriSpeech-layout split dirs (ref: corpus/librispeech.py).

    Layout: <path>/<split>/<spk>/<chap>/<uid>.{flac,wav,npy} + <spk>-<chap>.trans.txt
    (LibriSpeech as shipped, or a pre-decoded wav/npy mirror). FLAC goes
    through the port's native decoder; a wav utterance keeps its path, so
    that the loader can fill a batch of them with one native ``pack_batch``.
    """
    utts: List[Utterance] = []
    for split in splits:
        root = os.path.join(path, split)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"corpus split dir not found: {root}")
        for dirpath, _, files in sorted(os.walk(root)):
            trans: Dict[str, str] = {}
            for fn in files:
                if fn.endswith(".trans.txt"):
                    with open(os.path.join(dirpath, fn)) as f:
                        for line in f:
                            uid, _, text = line.strip().partition(" ")
                            trans[uid] = text
            for fn in sorted(files):
                base, ext = os.path.splitext(fn)
                if ext not in (".wav", ".npy", ".flac"):
                    continue
                if base not in trans:
                    continue
                full = os.path.join(dirpath, fn)
                if ext == ".wav":
                    utts.append(
                        Utterance(
                            base, lambda p=full: _load_wav(p), trans[base],
                            _wav_samples(full), wav_path=full,
                        )
                    )
                elif ext == ".flac":
                    utts.append(Utterance(base, lambda p=full: native.read_flac(p), trans[base],
                                          native.flac_num_samples(full)))
                else:
                    n = int(np.load(full, mmap_mode="r").size)
                    utts.append(Utterance(base, lambda p=full: _load_npy(p), trans[base], n))
    return utts


_SYNTH_WORDS = (
    "THE OF AND TO IN IS THAT IT WAS FOR ON ARE AS WITH HIS THEY AT BE THIS "
    "HAVE FROM OR ONE HAD BY WORD BUT NOT WHAT ALL WERE WE WHEN YOUR CAN SAID "
    "THERE USE AN EACH WHICH SHE DO HOW THEIR IF WILL UP OTHER ABOUT OUT MANY "
    "THEN THEM THESE SO SOME HER WOULD MAKE LIKE HIM INTO TIME HAS LOOK TWO "
    "MORE WRITE GO SEE NUMBER NO WAY COULD PEOPLE MY THAN FIRST WATER BEEN "
    "CALL WHO OIL ITS NOW FIND LONG DOWN DAY DID GET COME MADE MAY PART"
).split()

# Word -> unique 3-tone chord over a 12-tone geometric bank (300-6000 Hz,
# ratio 1.313/step ~ 4.7 semitones). Single tones 15 Hz apart were NOT
# separable by an 80-bin mel filterbank: at 200 Hz a mel bin spans ~28 Hz,
# so 38/95 adjacent word pairs had identical fundamental AND 2nd-harmonic
# bins -- the round-1 dev-CER plateau at ~0.77 was a task artifact, not a
# model failure. Every bank tone lands in its own mel bin, and any two
# chords differ in >=1 tone, so words are always acoustically separable.
_SYNTH_BANK = tuple(300.0 * (20.0 ** (k / 11.0)) for k in range(12))
_SYNTH_CHORDS = tuple(itertools.combinations(range(12), 3))  # 220 >= 96 words
# char coding: 2-tone chords over the same bank (66 >= 26 letters); space
# stays noise-only — a distinct "silence" signature
_SYNTH_CHAR_CHORDS = tuple(itertools.combinations(range(12), 2))

# 'formant' coding: per-char (F1, F2) center-frequency pair on a 5x6 grid.
# Round-3 diagnostics proved conv prenets optimize pathologically slowly on
# spectrally-sparse STATIONARY tones (the torch twin shows the same), so the
# VGG convergence corpus needs what real speech has: energy BANDS (narrowband
# noise, not lines) that MOVE (coarticulation-style glides between adjacent
# chars) under a temporal envelope — dense local 2-D structure for 3x3 convs.
_F1_GRID = (300.0, 450.0, 620.0, 820.0, 1050.0)
_F2_GRID = (1300.0, 1700.0, 2150.0, 2650.0, 3200.0, 3800.0)


def _char_formants(ch: str):
    c = ord(ch) - ord("A")
    return _F1_GRID[c % len(_F1_GRID)], _F2_GRID[c // len(_F1_GRID)]


def _lowpass_noise(r: np.random.RandomState, n: int, sr: int, bw_hz: float) -> np.ndarray:
    """Gaussian noise band-limited to [0, bw_hz] via FFT masking — the slow
    modulator that turns a sine into a ~2*bw-wide noise band."""
    spec = np.fft.rfft(r.randn(n))
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec[freqs > bw_hz] = 0.0
    x = np.fft.irfft(spec, n)
    s = float(np.std(x))
    return (x / s if s > 0 else x).astype(np.float32)


def _speech_wave(text: str, n: int, sr: int, seed: int) -> np.ndarray:
    """Transcript -> harmonic-rich 'speech-like' waveform.

    Why a THIRD coding (round-4): narrowband formant tracks (see
    _formant_wave) light only 1-3 mel bins — most of the spectrogram is
    noise floor, conv filters see near-zero input variance, and VGG
    optimization crawls at corpus scale (measured in BOTH this framework
    and the torch twin). Real speech is broadband: an F0 impulse train
    whose MANY harmonics are shaped by the formant envelope. Here each
    char segment is glottal-pulse excitation (per-utterance F0 with
    jitter) FFT-filtered by that char's two-formant Gaussian envelope on a
    broadband floor, with short crossfades between segments. Dense energy
    across the band + formant-peak identity + segment-edge temporal
    structure = what 3x3 convs are built for.
    """
    r = np.random.RandomState(seed)
    seg = max(1, n // max(len(text), 1))
    f0 = float(r.uniform(110.0, 210.0))
    # excitation: impulse train + aspiration noise (shared across segments
    # so segment boundaries change only the FILTER, like articulation)
    period = max(int(sr / f0), 8)
    exc = 0.12 * r.randn(n).astype(np.float32)
    exc[:: period] += 6.0
    freqs_cache: dict = {}
    out = np.zeros(n, np.float32)
    chars = text if text else " "
    fade = np.linspace(0.0, 1.0, min(80, seg), dtype=np.float32)  # 5 ms xfade
    for j, ch in enumerate(chars):
        s0, e0 = j * seg, (min(n, (j + 1) * seg) if j < len(chars) - 1 else n)
        if s0 >= n:
            break
        m = e0 - s0
        if m <= 0:
            continue
        if ch == " ":
            out[s0:e0] = 0.02 * r.randn(m)
            continue
        f1, f2 = _char_formants(ch)
        if m not in freqs_cache:
            freqs_cache[m] = np.fft.rfftfreq(m, 1.0 / sr)
        fr = freqs_cache[m]
        env = (
            np.exp(-0.5 * ((fr - f1) / 140.0) ** 2)
            + 0.8 * np.exp(-0.5 * ((fr - f2) / 180.0) ** 2)
            + 0.06
        ) * np.exp(-fr / 4500.0)  # spectral tilt
        spec = np.fft.rfft(exc[s0:e0]) * env
        out[s0:e0] = np.fft.irfft(spec, m)
    # crossfade segment boundaries (articulator-like continuity, no clicks)
    k = len(fade)
    for j in range(1, len(chars)):
        s0 = j * seg
        if s0 + k > n or s0 - k < 0:
            continue
        pre = out[s0 - k : s0].copy()
        post = out[s0 : s0 + k].copy()
        out[s0 : s0 + k] = fade * post + (1 - fade) * pre
    s = float(np.std(out))
    return (0.15 * out / s if s > 0 else out).astype(np.float32)


def _formant_wave(text: str, n: int, sr: int, seed: int) -> np.ndarray:
    """Transcript -> two formant-band trajectories -> waveform.

    Per char: both bands sit at that char's (F1, F2) for the middle of its
    segment and glide linearly to the next char's targets over the final 30%
    (space pulls both bands to a low 'silence' target and gates amplitude).
    Each band = sin(2*pi*phi(t)) * lowpass_noise (~80 Hz half-width) so the
    spectrogram shows moving ENERGY BANDS, not stationary lines.
    """
    r = np.random.RandomState(seed)
    seg = max(1, n // max(len(text), 1))
    # per-sample center-frequency trajectories + amplitude gate
    f1 = np.empty(n, np.float32)
    f2 = np.empty(n, np.float32)
    amp = np.empty(n, np.float32)
    targets = [( _char_formants(ch) + (1.0,)) if ch != " " else (200.0, 1100.0, 0.0)
               for ch in text] or [(200.0, 1100.0, 0.0)]
    for j in range(len(targets)):
        s, e = j * seg, (min(n, (j + 1) * seg) if j < len(targets) - 1 else n)
        if s >= n:
            break
        a, b, g = targets[j]
        na, nb, ng = targets[j + 1] if j + 1 < len(targets) else targets[j]
        m = e - s
        hold = int(m * 0.7)
        f1[s : s + hold], f2[s : s + hold], amp[s : s + hold] = a, b, g
        k = m - hold
        if k > 0:  # linear coarticulation glide into the next char
            t = np.linspace(0.0, 1.0, k, endpoint=False, dtype=np.float32)
            f1[s + hold : e] = a + (na - a) * t
            f2[s + hold : e] = b + (nb - b) * t
            amp[s + hold : e] = g + (ng - g) * t
    # band synthesis: instantaneous phase = cumsum(f)/sr
    x = 0.01 * r.randn(n).astype(np.float32)
    for f, gain in ((f1, 0.28), (f2, 0.22)):
        phase = 2.0 * np.pi * np.cumsum(f, dtype=np.float64) / sr
        mod = _lowpass_noise(r, n, sr, 80.0)
        x += (gain * np.sin(phase).astype(np.float32) * (0.6 + 0.4 * mod) * amp)
    return x.astype(np.float32)


def synthetic(
    n_utts: int = 64,
    sample_rate: int = 16000,
    min_sec: float = 1.0,
    max_sec: float = 8.0,
    seed: int = 0,
    audible: bool = True,
    coding: str = "word",
) -> List[Utterance]:
    """Deterministic synthetic speech-like corpus.

    Each utterance's waveform is a transcript-dependent tone+noise sequence
    so the audio actually *contains* the transcript information — overfit
    and decode tests exercise a learnable mapping, not memorization of
    noise. Two codings:

    - 'word': one 3-tone chord per word, held for the whole word segment.
      Acoustically separable, but *alignment-free within a word*: every
      frame of a segment is identical, so char targets carry no intra-word
      temporal cue. Measured consequence (round 3 diagnostics, runs/diag_*):
      CTC's gradient spreads over all alignments (loss spikes, grad-norm
      bursts to ~18) and attention learns a char LM long before acoustics —
      convergence is orders of magnitude slower than real speech, where
      phones give every label a local acoustic landmark.
    - 'char': one 2-tone chord per character (space = noise-only gap) —
      every target token has its own acoustic segment, like phones do. This
      is the faithful proxy for the reference's LibriSpeech convergence
      behavior and the default for convergence recipes.
    """
    rng = np.random.RandomState(seed)
    utts: List[Utterance] = []
    for i in range(n_utts):
        dur = float(rng.uniform(min_sec, max_sec))
        # word count scales with duration (~1.0-1.6 words/s) like real
        # speech; an independent draw produced physically impossible
        # utterances (8 words in 1 s) whose char count exceeded the CTC
        # lattice length => guaranteed-infeasible rows in every corpus
        n_words = max(1, int(round(dur * rng.uniform(1.0, 1.6))))
        words = [
            _SYNTH_WORDS[rng.randint(len(_SYNTH_WORDS))] for _ in range(n_words)
        ]
        text = " ".join(words)
        n = int(dur * sample_rate)

        def make(text=text, words=tuple(words), n=n, seed=rng.randint(1 << 30)):
            if audible and coding == "speech":
                return _speech_wave(text, n, sample_rate, seed)
            if audible and coding == "formant":
                return _formant_wave(text, n, sample_rate, seed)
            r = np.random.RandomState(seed)
            x = 0.01 * r.randn(n).astype(np.float32)
            tt = np.arange(n) / sample_rate
            if audible and coding == "char":
                seg = max(1, n // max(len(text), 1))
                for j, ch in enumerate(text):
                    if ch == " ":
                        continue
                    s, e = j * seg, min(n, (j + 1) * seg)
                    for k in _SYNTH_CHAR_CHORDS[ord(ch) - ord("A")]:
                        x[s:e] += 0.25 * np.sin(
                            2 * np.pi * _SYNTH_BANK[k] * tt[s:e]
                        ).astype(np.float32)
            elif audible:
                seg = max(1, n // max(len(words), 1))
                for j, w in enumerate(words):
                    # process-independent chord per word (index-derived, not
                    # builtin `hash`: that is salted per process => train and
                    # decode in separate processes would disagree on audio)
                    s, e = j * seg, min(n, (j + 1) * seg)
                    for k in _SYNTH_CHORDS[_SYNTH_WORDS.index(w)]:
                        x[s:e] += 0.2 * np.sin(
                            2 * np.pi * _SYNTH_BANK[k] * tt[s:e]
                        ).astype(np.float32)
            return x

        utts.append(Utterance(f"synth-{i:05d}", make, text, n))
    return utts


def load_corpus(name: str, path: str, splits: Sequence[str], **kw) -> List[Utterance]:
    """ref: src/data.py imports corpus.<name> by name."""
    if name == "librispeech":
        return librispeech(path, splits, **kw)
    if name in ("synthetic", "synthetic_char", "synthetic_formant", "synthetic_speech"):
        seed = {"train": 0, "dev": 1, "test": 2}
        if name == "synthetic_char":
            kw.setdefault("coding", "char")
        if name == "synthetic_formant":
            kw.setdefault("coding", "formant")
        if name == "synthetic_speech":
            kw.setdefault("coding", "speech")
        out: List[Utterance] = []
        for s in splits:
            base, _, n = s.partition(":")
            out.extend(synthetic(n_utts=int(n or 64), seed=seed.get(base, 3), **kw))
        return out
    raise ValueError(f"unknown corpus '{name}'")
