"""Plain layers of the recipe: features, SpecAugment, the VGG + BiLSTM
listener, the CTC head, the location-aware speller and the RNN-LM.

Weights are a flat dict of named float32 tensors (``asr_bench/weights.py``
names them). Every product goes through ``Precision``: float32 with TF32 off
(the reference), TF32, or float8 (e4m3, a scale a tensor) for the controls.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

W = Dict[str, torch.Tensor]
NEG_ATT = -1e9  # padded frames' energy before the temperature softmax
LOG_FLOOR = 1.1921e-7  # float32 eps, the log-mel floor


class Precision:
    """How the reference rounds its products: ``fp32`` (TF32 off), ``tf32``
    (cuBLAS and cuDNN at TF32) or ``fp8`` (each product's operands rounded
    to float8 e4m3 with a scale a tensor; the backward passes through)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation (a layer's output, a recurrent state): rounded
        to float8 in ``fp8`` mode, where the program stores bf16."""
        return self.q(x)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode != "fp8":
            return x
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        xq = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (xq - x).detach()

    @contextmanager
    def active(self):
        tf32 = self.mode == "tf32"
        old = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield self
        finally:
            torch.set_float32_matmul_precision(old[0])
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[1:]


def matmul_error(device) -> float:
    """Relative error of a float32 [512, 512] product under the current
    settings against float64: ~1e-7 at float32, ~1e-4 at TF32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn((512, 512), generator=gen, device=device)
    exact = a.double() @ a.double()
    return float(((a @ a).double() - exact).abs().max() / exact.abs().max())


def mm(pr: Precision, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return pr.q(x) @ pr.q(w)


# ------------------------------------------------------------------ features
def _hz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel_bank(num_bins: int, n_fft: int, sr: int, low: float, high: float) -> np.ndarray:
    """Kaldi's triangular filters on the mel scale, [n_fft // 2 + 1, num_bins]."""
    if high <= 0:
        high = sr / 2.0 + high
    centers = np.linspace(_hz_to_mel(low), _hz_to_mel(high), num_bins + 2)
    fmel = _hz_to_mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    fb = np.zeros((n_fft // 2 + 1, num_bins))
    for m in range(num_bins):
        up = (fmel - centers[m]) / (centers[m + 1] - centers[m])
        down = (centers[m + 2] - fmel) / (centers[m + 2] - centers[m + 1])
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def window(kind: str, n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    if kind == "povey":
        return hann ** 0.85
    if kind == "hanning":
        return hann
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    raise ValueError(f"unknown window {kind!r}")


def frame_params(audio: dict) -> Tuple[int, int, int]:
    sr = audio["sample_rate"]
    win = int(sr * audio["frame_length"] / 1000.0)
    shift = int(sr * audio["frame_shift"] / 1000.0)
    return win, shift, 1 << (win - 1).bit_length()


def features(wav_i16: torch.Tensor, wav_len: torch.Tensor, audio: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 waves [B, N] -> (log-mel fbank with per-utterance CMVN [B, T, D]
    float32, frames [B]): snip-edge frames, the frame's mean removed,
    pre-emphasis inside the frame, the window, the power spectrum, the mel
    filters, the floored log; computed in float64."""
    if audio["feat_type"] != "fbank" or audio["delta_order"] != 0 or audio["dither"] != 0:
        raise ValueError("the reference computes plain log-mel fbank features (no deltas, no dither)")
    win, shift, n_fft = frame_params(audio)
    dev = wav_i16.device
    x = wav_i16.double() / 32768.0
    n = x.shape[1]
    t = max(0, 1 + (n - win) // shift)
    frames = x.unfold(1, win, shift)[:, :t] if n >= win else x.new_zeros((x.shape[0], 0, win))
    frames = frames - frames.mean(-1, keepdim=True)
    pe = audio["preemphasis"]
    if pe > 0:
        frames = torch.cat([frames[..., :1] * (1 - pe), frames[..., 1:] - pe * frames[..., :-1]], -1)
    frames = frames * torch.from_numpy(window(audio["window"], win)).to(dev)
    power = torch.fft.rfft(frames, n=n_fft).abs() ** 2
    fb = torch.from_numpy(mel_bank(audio["feat_dim"], n_fft, audio["sample_rate"], audio["low_freq"],
                                   audio["high_freq"])).to(dev)
    feat = torch.log(torch.clamp(power @ fb, min=LOG_FLOOR))
    feat_len = torch.clamp(1 + torch.div(wav_len.long() - win, shift, rounding_mode="floor"), min=0)
    mask = (torch.arange(t, device=dev)[None, :] < feat_len[:, None])[..., None]
    if audio["apply_cmvn"]:
        den = torch.clamp(feat_len, min=1).double()[:, None, None]
        mean = (feat * mask).sum(1, keepdim=True) / den
        var = ((feat - mean) ** 2 * mask).sum(1, keepdim=True) / den
        feat = (feat - mean) * torch.rsqrt(var + 1e-10)
    return torch.where(mask, feat, 0.0).float(), feat_len


def specaugment(feat: torch.Tensor, feat_len: torch.Tensor, sa: dict, gen: torch.Generator) -> torch.Tensor:
    """Two frequency and two time masks an utterance from four [B, n]
    uniform draws of ``gen``, in this order: frequency widths, frequency
    starts, time widths, time starts (float32 arithmetic, truncated)."""
    b, t, d = feat.shape

    def u(n):
        return torch.rand((b, n), generator=gen, device=gen.device).to(feat.device)

    nf, nt, fwid, twid = sa["freq_mask_num"], sa["time_mask_num"], sa["freq_mask_width"], sa["time_mask_width"]
    fw = torch.floor(u(nf) * (fwid + 1)).long()
    fs = torch.floor(u(nf) * max(d - fwid, 1)).long()
    flen = feat_len.long()[:, None]
    max_w = torch.clamp((feat_len.float() * sa["time_mask_ratio"]).long()[:, None], max=twid)
    tw = (u(nt) * (max_w + 1).float()).long()
    ts = (u(nt) * torch.clamp(flen - tw, min=1).float()).long()
    fi = torch.arange(d, device=feat.device)[None, None, :]
    ti = torch.arange(t, device=feat.device)[None, None, :]
    fm = ((fi >= fs[..., None]) & (fi < (fs + fw)[..., None])).any(1)
    tm = ((ti >= ts[..., None]) & (ti < (ts + tw)[..., None])).any(1)
    return feat * (~(fm[:, None, :] | tm[:, :, None])).float()


# ------------------------------------------------------------------- encoder
def vgg_channels(feat_dim: int) -> Tuple[int, int]:
    for base in (13, 40, 80):
        if feat_dim % base == 0 and feat_dim // base in (1, 2, 3):
            return feat_dim // base, base
    raise ValueError(f"no VGG split of {feat_dim} features")


def _conv(pr: Precision, w: W, name: str, h: torch.Tensor) -> torch.Tensor:
    return torch.relu(F.conv2d(pr.q(h), pr.q(w[name + ".w"]), w[name + ".b"], padding="same"))


_LSTMS: Dict[tuple, torch.nn.LSTM] = {}


def _lstm_module(d: int, h: int, layers: int, bidir: bool, device) -> torch.nn.LSTM:
    key = (d, h, layers, bidir, str(device))
    if key not in _LSTMS:
        _LSTMS[key] = torch.nn.LSTM(d, h, num_layers=layers, bidirectional=bidir, batch_first=True).to(device)
    return _LSTMS[key]


def _bilstm_loop(pr: Precision, x: torch.Tensor, lens: torch.Tensor, fwd: Sequence[torch.Tensor],
                 bwd: Sequence[torch.Tensor]) -> torch.Tensor:
    """``bilstm`` as a loop over frames, every step's h and c stored through
    ``pr.store`` (the float8 control's recurrence)."""
    b, t, _ = x.shape
    mask = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    outs = []
    for (wx, wh, bias), order in ((fwd, range(t)), (bwd, range(t - 1, -1, -1))):
        xw = pr.store(mm(pr, x, wx) + bias)
        h = x.new_zeros((b, wh.shape[0]))
        c = torch.zeros_like(h)
        ys = [None] * t
        for s in order:
            gi, gf, gg, go = (xw[:, s] + mm(pr, h, wh)).chunk(4, -1)
            c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h2 = torch.sigmoid(go) * torch.tanh(c2)
            m = mask[:, s, None]
            h, c = torch.where(m, pr.store(h2), h), torch.where(m, pr.store(c2), c)
            ys[s] = torch.where(m, h, 0.0)
        outs.append(torch.stack(ys, 1))
    return torch.cat(outs, -1)


def bilstm(pr: Precision, x: torch.Tensor, lens: torch.Tensor, fwd: Sequence[torch.Tensor],
           bwd: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, T, D] -> [B, T, 2H], zero past ``lens``: cuDNN's LSTM over the
    packed rows, gates i, f, g, o, one bias a direction, the backward
    direction from each row's last frame."""
    if pr.mode == "fp8":
        return _bilstm_loop(pr, x, lens, fwd, bwd)
    b, t, d = x.shape
    h = fwd[1].shape[0]
    mod = _lstm_module(d, h, 1, True, x.device)
    z = torch.zeros(4 * h, device=x.device)
    t_ = lambda a: pr.q(a).T.contiguous()  # noqa: E731  (cuDNN takes [4H, D] weights)
    p = {"weight_ih_l0": t_(fwd[0]), "weight_hh_l0": t_(fwd[1]), "bias_ih_l0": fwd[2], "bias_hh_l0": z,
         "weight_ih_l0_reverse": t_(bwd[0]), "weight_hh_l0_reverse": t_(bwd[1]),
         "bias_ih_l0_reverse": bwd[2], "bias_hh_l0_reverse": z}
    packed = torch.nn.utils.rnn.pack_padded_sequence(pr.q(x), lens.clamp(min=1).cpu(), batch_first=True,
                                                     enforce_sorted=False)
    out, _ = functional_call(mod, p, (packed,))
    y, _ = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=t)
    return torch.where((torch.arange(t, device=x.device)[None, :] < lens[:, None])[..., None], y, 0.0)


def encode(w: W, model: dict, feat: torch.Tensor, feat_len: torch.Tensor, pr: Precision
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VGG (two 3x3 conv pairs, ReLU, 2x2 max pools) then the BiLSTM layers,
    each followed by tanh of a dense projection; padding stays zero."""
    enc = model["encoder"]
    if enc["prenet"] != "vgg" or enc["module"] != "LSTM" or not enc["bidirection"] or any(
            r != 1 for r in enc["sample_rate"]) or any(enc["layer_norm"]) or not all(enc["proj"]):
        raise ValueError("the reference holds the VGG + projected BiLSTM listener")
    b, t, d = feat.shape
    ch, base = vgg_channels(d)
    h = feat.reshape(b, t, ch, base).permute(0, 2, 1, 3)
    h = pr.store(_conv(pr, w, "enc.conv2", pr.store(_conv(pr, w, "enc.conv1", pr.store(h)))))
    h = F.max_pool2d(h, 2, 2)
    h = pr.store(_conv(pr, w, "enc.conv4", pr.store(_conv(pr, w, "enc.conv3", h))))
    h = F.max_pool2d(h, 2, 2)
    b2, c2, t2, f2 = h.shape
    x = h.permute(0, 2, 1, 3).reshape(b2, t2, c2 * f2)
    lens = torch.div(feat_len, 4, rounding_mode="floor")
    mask = (torch.arange(t2, device=x.device)[None, :] < lens[:, None])[..., None]
    for i in range(len(enc["dim"])):
        g = lambda k: w[f"enc.l{i}.{k}"]  # noqa: E731
        y = bilstm(pr, x, lens, (g("fwd.wx"), g("fwd.wh"), g("fwd.b")), (g("bwd.wx"), g("bwd.wh"), g("bwd.b")))
        x = torch.where(mask, pr.store(torch.tanh(mm(pr, y, g("proj.w")) + g("proj.b"))), 0.0)
    return x, torch.clamp(lens, min=1)


def ctc_log_probs(w: W, enc: torch.Tensor, pr: Precision) -> torch.Tensor:
    return torch.log_softmax(pr.store(mm(pr, enc, w["ctc.w"]) + w["ctc.b"]), -1)


# ------------------------------------------------------------------- speller
def speller_setup(w: W, model: dict, enc: torch.Tensor, enc_len: torch.Tensor, pr: Precision) -> dict:
    """What every speller step reads of the listener's output: its values
    (rounded once through ``pr``), the keys, the frame mask, the uniform
    first alignment."""
    att = model["attention"]
    if att["mode"] != "location" or att["num_head"] != 1 or att["v_proj"] or model["decoder"]["layer"] != 1:
        raise ValueError("the reference holds the one-head location-aware speller of one LSTM layer")
    mask = torch.arange(enc.shape[1], device=enc.device)[None, :] < enc_len[:, None]
    return {"enc": pr.q(enc), "k": mm(pr, enc, w["att.proj_k.w"]), "mask": mask,
            "prev": mask.float() / enc_len[:, None].float(), "temp": att["temperature"]}


def speller_step(w: W, mem: dict, tok: torch.Tensor, h: torch.Tensor, c: torch.Tensor, prev: torch.Tensor,
                 pr: Precision) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step from the previous token ``tok``, state (h, c) and alignment
    ``prev``: energies locv . tanh(k + q + (conv(prev align) + conv bias) Wlp
    + loc_b) masked past the frames, align = softmax(energy / temperature),
    ctx = align . enc, one LSTM cell on [emb, ctx]. Returns (logits, h, c,
    align), each stored through ``pr``."""
    enc, mask = mem["enc"], mem["mask"]
    taps = w["att.loc_conv.w"]  # [K, 1, P]
    pad = (taps.shape[-1] - 1) // 2
    emb = w["embed"][tok]
    q = mm(pr, h, w["att.proj_q.w"]) + w["att.proj_q.b"]
    f = F.conv1d(pr.q(prev[:, None]), pr.q(taps), w["att.loc_conv.b"], padding=pad).transpose(1, 2)
    e = torch.tanh(mem["k"] + q[:, None] + mm(pr, f, w["att.loc_proj.w"]) + w["att.loc_b"])
    energy = torch.where(mask, mm(pr, e, w["att.loc_v"][0]), NEG_ATT)
    align = torch.where(mask, torch.softmax(energy / mem["temp"], -1), 0.0)
    ctx = torch.einsum("bs,bse->be", pr.q(align), enc)
    gates = mm(pr, torch.cat([emb, ctx], -1), w["dec.wx"]) + w["dec.b"] + mm(pr, h, w["dec.wh"])
    gi, gf, gg, go = gates.chunk(4, -1)
    c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h2 = torch.sigmoid(go) * torch.tanh(c2)
    logits = pr.store(mm(pr, h2, w["dec.char.w"]) + w["dec.char.b"])
    return logits, pr.store(h2), pr.store(c2), pr.store(align)


def speller(w: W, model: dict, enc: torch.Tensor, enc_len: torch.Tensor, tokens_in: torch.Tensor,
            pr: Precision, use_teacher: Optional[List[bool]] = None,
            noise: Optional[Callable[[int, torch.Size], torch.Tensor]] = None) -> torch.Tensor:
    """Teacher-forced (or, where ``use_teacher[t]`` is False, fed back)
    location-aware speller: ``speller_step`` from h = c = 0 and the uniform
    alignment. Returns logits [B, L, V] (float32). A fed-back token is
    argmax(logits of the step before + ``noise(t - 1, shape)``)."""
    mem = speller_setup(w, model, enc, enc_len, pr)
    hd = w["dec.wh"].shape[0]
    h = enc.new_zeros((enc.shape[0], hd))
    c = enc.new_zeros((enc.shape[0], hd))
    prev = mem["prev"]
    out, pred = [], None
    for t in range(tokens_in.shape[1]):
        tok = tokens_in[:, t] if (t == 0 or use_teacher is None or use_teacher[t]) else pred
        logits, h, c, prev = speller_step(w, mem, tok, h, c, prev, pr)
        out.append(logits)
        if use_teacher is not None and noise is not None and not all(use_teacher[t + 1:]):
            pred = torch.argmax(logits.detach() + noise(t, logits.shape), -1)
    return torch.stack(out, 1)


# ------------------------------------------------------------------------ LM
def lm_log_probs(w: W, lm: dict, tokens_in: torch.Tensor, pr: Precision) -> torch.Tensor:
    """[N, L] input ids (<sos> = 0 first) -> [N, L, V] next-token log-probs of
    the RNN-LM: embedding, the LSTM layers (one bias a gate), the tied
    output (a projection back to the embedding width, then the table)."""
    if lm["module"] != "LSTM" or not lm["emb_tying"]:
        raise ValueError("the reference holds the tied LSTM LM")
    x = w["lm.embed"][tokens_in]
    n_layers, hd = lm["n_layers"], lm["dim"]
    mod = _lstm_module(x.shape[-1], hd, n_layers, False, x.device)
    z = torch.zeros(4 * hd, device=x.device)
    p = {}
    for i in range(n_layers):
        p.update({f"weight_ih_l{i}": pr.q(w[f"lm.l{i}.wx"]).T.contiguous(),
                  f"weight_hh_l{i}": pr.q(w[f"lm.l{i}.wh"]).T.contiguous(),
                  f"bias_ih_l{i}": w[f"lm.l{i}.b"], f"bias_hh_l{i}": z})
    y, _ = functional_call(mod, p, (pr.q(x),))
    e = mm(pr, y, w["lm.out_proj.w"]) + w["lm.out_proj.b"]
    return torch.log_softmax(mm(pr, e, w["lm.embed"].T), -1)


def lm_step(w: W, lm: dict, tok: torch.Tensor, state: Tuple[List[torch.Tensor], List[torch.Tensor]],
            pr: Precision) -> Tuple[torch.Tensor, Tuple[List[torch.Tensor], List[torch.Tensor]]]:
    """One token of ``lm_log_probs`` for every row: [N] ids and the layers'
    (h, c) -> ([N, V] next-token log-probs, the new state)."""
    x = w["lm.embed"][tok]
    hs, cs = [], []
    for i, (h, c) in enumerate(zip(*state)):
        gi, gf, gg, go = (mm(pr, x, w[f"lm.l{i}.wx"]) + w[f"lm.l{i}.b"] + mm(pr, h, w[f"lm.l{i}.wh"])).chunk(4, -1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        x = h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    e = mm(pr, x, w["lm.out_proj.w"]) + w["lm.out_proj.b"]
    return torch.log_softmax(mm(pr, e, w["lm.embed"].T), -1), (hs, cs)


# ------------------------------------------------------------- Philox noise
def philox_gumbel(seed: int, t: int, rows: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise of the counter-based generator that keys on (seed,
    step, row, column): Philox-4x32-10's first word of counter (t, row, col,
    0) under key (seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF), its top 24
    bits a uniform u + 1e-12, -log(-log u) in float32. [len(rows), vocab]."""
    m32 = 0xFFFFFFFF
    dev = rows.device
    c0 = torch.full((rows.numel(), vocab), t, dtype=torch.int64, device=dev)
    c1 = rows.long()[:, None].expand(-1, vocab).clone()
    c2 = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :].expand(rows.numel(), -1).clone()
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF

    def mulhilo(a: int, c: torch.Tensor):
        # a * c for 32-bit a and c, in products under 2**49 (no int64 overflow)
        lo, hi = a * (c & 0xFFFF), a * (c >> 16)
        mid = lo + ((hi & 0xFFFF) << 16)
        return ((hi >> 16) + (mid >> 32)) & m32, mid & m32

    for _ in range(10):
        hi0, lo0 = mulhilo(0xD2511F53, c0)
        hi1, lo1 = mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & m32, (k1 + 0xBB67AE85) & m32
    u = (c0 >> 8).float() * (1.0 / 16777216.0) + 1e-12
    return -torch.log(-torch.log(u))


def token_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]
