"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes the flagship run does not reach: odd batch (one row per
LSTM block), T not a multiple of the kernels' tiles, B = 1; the log-mel
kernel with a wave shorter than one window, N not a multiple of the shift,
a last tile of one frame, B = 32 and M = 80, n_fft 256, 512 and 2048, the
three windows, preemphasis 0, digital silence (exactly the floor), rows
that start off 16 bytes and the synthetic corpus's int16 waves at M = 40
and 80 (also against the function in float64), its plan; the beam attention step with W = 1 and 16, S = 1 to
1100 (k and v in several tiles), enc_len of 1, B from 1 to 5, B = 64 at
S = 764 and B = 140 (more utterances than one launch takes: launches for
groups of them), and its plan refusing K > 16 and an S at which not even one
utterance fits; the fused CTC prefix kernel with
and without an empty prefix, K = 1 and V - 1, T up to 2000 (several
tiles), enc_len of 1 and of T; both decode kernels and the log-mel
kernel repeated bitwise and run under the sync debug mode set to raise; the LSTM forward's plan (Wh resident
at the flagship and convergence layers; a shape with no layout raises), its
projection's kernel-time rows, H = 512 and 1024 (Wh read from L2) and
bitwise-equal repeats; the LSTM backward with D and 4H off
the products' tiles, H = 8, H = 512 and 1024 (its sweep's weights read
from L2), a grid that cannot be resident (raises), and bitwise-equal repeats
at the flagship's shapes; the CTC loss with rows with no alignment, with no
labels and with input_len > T, S up to 1201, T V above the shared-memory
budget, int32 and int64 labels, bitwise-equal repeats, no host
synchronisation (sync debug mode) and out-of-range labels refused by a
device-side assert (in a subprocess); the lstm_seq pair with one and two
directions, prefix and suffix masks, B = 33 and 32; the fused speller scan at Dk 8 to 300, H 8 to 320, S = 1, 7
and 764, L = 1, B = 1 and 33, in its three feedback modes, its backward
sweep and its autograd function, at flagship widths with B = 40 (more
utterances than resident clusters), with H = 8 (most blocks of the grid own
no hidden unit), at S = 3000 (the backward's working buffers in global
memory), at the convergence recipe's widths with B = 32, and twice on the
same inputs (bitwise equal); the kernels' shared-memory plan over grids of
8 to 132 blocks; the LM's one-direction layer through the lstm_seq pair at
its width (B = 32, D = H = 512, T = 256, a row of length 0) and the LM's
part of a fused beam step with no host synchronisation; the prefetcher's
batches equal the loader's (streaming, and offsets gathered by
resolve_wav), its consumer side and the gather make no host
synchronisation, and its copies come from pinned memory on a stream of
their own; the beam search through CUDA graphs (decode/beam_graph.py) at
test size, with and without an LM: replay bitwise equal to the eager loop
with the same launch counts, a graph reused for a second batch and
captured anew for a new shape or new weights, the whole beam step without
host synchronisation, a capture beside a thread making pinned copies, the
attention step captured as a cooperative kernel node in a chain of nodes,
and a capture that fails raising (in a subprocess); the train step through
CUDA graphs (training/step_graph.py) at test size under both LSTM routes
and both compute types: replay bitwise equal to the eager step (loss, grad
norm, every parameter and optimizer tensor) with the same launch counts,
through failing coins and a skipped step, a graph captured anew for a new
bucket or new weights, the eager step without host synchronisation, a
capture beside a copying thread, a failing capture raising (in a
subprocess); validation through CUDA graphs (training/eval_graph.py) under
both routes and compute types: replay bitwise equal to the eager
``eval_device`` (losses, CTC ids, greedy tokens) with the same launch
counts, beside the train graphs in one memory pool, the eager validation
without host synchronisation, a failing capture raising (in a subprocess);
the LM step through CUDA graphs (training/lm_graph.py) bitwise equal to the
eager step through dropout and a non-finite step, its evaluation too; the
host-issued launches of a replayed dev batch and LM step (at most
HOST_LAUNCH_LIMIT); the scan forward's seed in device memory; the
optimizer's device bias corrections and learning rate against the host
formulas; the encoder and speller variants (a CNN prenet with GRU layers
and a GRU speller, one-direction LSTM layers with the embedding
regularizer's loss, and with its fused decoding) through the train graphs
bitwise the eager step (the Python-loop speller captured, failing coins
and sampled feedback on the card), their float32 kernel steps against
their plain steps, and the first dev batch's validation keeping its
alignment through its own graph, bitwise the eager one; the train step's
stage programs (``utils/stages.py``) captured and replayed within their
ceilings, each launching its kernels; the device stage marks
(``utils/tracing.py``): a train step's and a decode's replays with marks
bitwise those without (the decode with and without an LM), the train
stages' sections within 3% of a replay's CUDA-event time, an interval
across a capture or a profiler's start or stop not counted, and the decode
spans enclosing their launches in a Chrome trace; the scan pair given the
steps to run (1, L/2, L at the flagship's commonest bucket and the 960 h
recipe's longest, both storage types): outputs, streams and the gradients
of a masked loss bitwise the uncut launch's, zero past the steps run, and
one captured train step replayed on batches of other longest labels
bitwise the eager step over all L steps, validation running all L.
Marked ``cuda``: they skip without a card. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.data import corpus
from e2e_asr_tpu_torch.decode import ctc_prefix
from e2e_asr_tpu_torch.decode import ctc_prefix_cuda as cpc
from e2e_asr_tpu_torch.ops import att_step_cuda as asc
from e2e_asr_tpu_torch.ops import ctc_cuda
from e2e_asr_tpu_torch.ops import frontend_cuda as fec
from e2e_asr_tpu_torch.ops import rnn_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # cuDNN convolutions default to TF32 (about three decimal digits): off, as
    # device.resolve_device sets it for the port's entry points
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


# (B, N, sample rate, M, window, preemphasis): N < win (one zero-padded
# frame), N = win, N not a multiple of shift, T = 17 (a last tile of one
# frame), the flagship decode batch's N, B = 32 and M = 80 (the convergence
# recipe), 25 ms windows at 8 kHz (n_fft 256), 16 kHz (512) and 48 kHz
# (2048), the three windows, preemphasis 0
LOG_MEL_SHAPES = [
    (3, 100, 16000, 40, "povey", 0.97), (3, 400, 16000, 40, "povey", 0.97), (3, 7000, 16000, 40, "povey", 0.97),
    (3, 24160, 16000, 40, "povey", 0.97), (2, 16 * 160 + 400 + 7, 16000, 40, "povey", 0.97),
    (16, 815 * 160 + 400, 16000, 40, "povey", 0.97), (32, 815 * 160 + 400 + 93, 16000, 80, "povey", 0.97),
    (4, 9001, 8000, 40, "hamming", 0.0), (4, 9001, 8000, 80, "hanning", 0.97), (5, 12345, 16000, 80, "hanning", 0.0),
    (2, 48000 + 77, 48000, 80, "povey", 0.97), (1, 1000, 48000, 40, "hamming", 0.0),
]


def _log_mel_cfg(sr, m, window, pre):
    cfg = AudioConfig(feat_dim=m, sample_rate=sr, window=window, preemphasis=pre)
    win, shift = sr * 25 // 1000, sr * 10 // 1000
    return cfg, win, shift, 1 << (win - 1).bit_length()


def _log_mel_check(wav, cfg, win, shift, n_fft):
    """The kernel against its plain version at rtol 1e-3 / atol 2e-3; frames
    of digital silence (all samples zero) exactly at the floor."""
    before = fec.log_mel.launches
    got = fec.log_mel(wav, cfg, win, shift, n_fft)
    assert fec.log_mel.launches == before + 1
    want = fec.log_mel_plain(wav, cfg, win, shift, n_fft)
    _close(got, want, rtol=1e-3, atol=2e-3)
    t = got.shape[1]
    x = torch.nn.functional.pad(wav, (0, max(0, (t - 1) * shift + win - wav.shape[1])))
    silent = (x.unfold(-1, win, shift)[:, :t] == 0).all(-1)
    floor = torch.log(torch.tensor(1.1921e-7, device="cuda"))
    assert bool((got[silent] == floor).all())
    return got


@pytest.mark.parametrize("b,n,sr,m,window,pre", LOG_MEL_SHAPES)
def test_log_mel_kernel(gen, b, n, sr, m, window, pre):
    cfg, win, shift, n_fft = _log_mel_cfg(sr, m, window, pre)
    wav = 0.1 * torch.randn((b, n), generator=gen, device="cuda")
    wav[0, n // 3: n // 3 + 3 * win] = 0.0  # digital silence inside a row
    if b > 2:
        wav[-1] = 0.0  # and a whole row of it
    _log_mel_check(wav, cfg, win, shift, n_fft)


def _log_mel_f64(wav, cfg, win, shift, n_fft):
    """The log-mel function wholly in float64 on the CPU (the frames' mean,
    pre-emphasis and window, the library FFT, the dense mel product)."""
    from e2e_asr_tpu_torch.ops import frontend as fe

    t = fec.n_log_mel_frames(wav.shape[1], win, shift)
    x = torch.nn.functional.pad(wav.cpu().double(), (0, max(0, (t - 1) * shift + win - wav.shape[1])))
    d = x.unfold(-1, win, shift)[:, :t]
    d = d - d.mean(-1, keepdim=True)
    p = cfg.preemphasis if cfg.preemphasis > 0 else 0.0
    y = torch.cat([(1 - p) * d[..., :1], d[..., 1:] - p * d[..., :-1]], -1)
    y = y * torch.from_numpy(fe.feature_window(cfg.window, win)).double()
    fb = torch.from_numpy(fe.mel_filterbank(cfg.feat_dim, n_fft, cfg.sample_rate, cfg.low_freq, cfg.high_freq))
    return torch.log(torch.clamp((torch.fft.rfft(y, n=n_fft).abs() ** 2) @ fb.double(), min=fe.LOG_FLOOR))


@pytest.mark.parametrize("m", [40, 80])
@pytest.mark.parametrize("coding", ["word", "char", "formant"])
def test_log_mel_kernel_synthetic_waves(gen, coding, m):
    """Waves of the synthetic corpus (narrow bands with quiet spectrum
    between them) quantised to int16 as the loader ships them, rows padded
    with zeros as a bucket pads them, at both recipes' M; the kernel's
    float64 transform is also held within 1e-5 of the function in float64
    (what is left: the float32 power's and mel sums' rounding)."""
    utts = corpus.synthetic(n_utts=5, seed=1, max_sec=3.0, coding=coding)
    n = max(u.n_samples for u in utts) + 211
    wav = np.zeros((len(utts), n), np.float32)
    for i, u in enumerate(utts):
        wav[i, :u.n_samples] = np.clip(u.load() * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
    cfg, win, shift, n_fft = _log_mel_cfg(16000, m, "povey", 0.97)
    got = _log_mel_check(torch.from_numpy(wav).cuda(), cfg, win, shift, n_fft)
    ref = _log_mel_f64(torch.from_numpy(wav), cfg, win, shift, n_fft)
    assert float((got.cpu().double() - ref).abs().max()) < 1e-5


def test_log_mel_plan():
    """The kernel's plan, as the host asks it for the filter groups: a
    group's filters fill a warp's lanes by whole frames; sizes outside the
    kernel's are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n_fft in (256, 512, 1024, 2048):
        size, warps = fec.plan(n_fft)
        assert size >= 1 and 32 % size == 0 and warps >= 1
    for n_fft in (128, 4096, 500):
        with pytest.raises(RuntimeError, match="e2e_log_mel_plan"):
            fec.plan(n_fft)


def test_log_mel_kernel_misaligned_rows(gen):
    """A wave whose rows start off 16 bytes (a view one sample in): the
    wrapper copies it for the kernel's 16-byte staging."""
    cfg, win, shift, n_fft = _log_mel_cfg(16000, 40, "povey", 0.97)
    base = 0.1 * torch.randn((3 * 5001 + 1,), generator=gen, device="cuda")
    _log_mel_check(base[1:].view(3, 5001), cfg, win, shift, n_fft)


@pytest.mark.parametrize("b,t,d,h", [(3, 11, 40, 32), (2, 17, 1280, 320), (5, 9, 24, 104), (16, 30, 640, 320)])
def test_lstm_kernel(gen, b, t, d, h):
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1.0 / math.sqrt(h)
    x = torch.randn((t, b, d), generator=gen, device="cuda")
    wx = (torch.rand((2, d, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    wh = (torch.rand((2, h, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    bias = (torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    args = (x, mask, wx, wh, bias)
    _close(rnn_cuda.lstm_bidir_fwd(*args), rnn_cuda.lstm_bidir_fwd_plain(*args), rtol=1e-4, atol=1e-4)


def _att_args(gen, b, w, s, dk, e_dim, lens, kk=10, p=2 * 50 + 1):
    q = torch.randn((b, w, dk), generator=gen, device="cuda")
    prev = torch.softmax(torch.randn((b, w, s), generator=gen, device="cuda"), -1)
    k = torch.tanh(torch.randn((b, s, dk), generator=gen, device="cuda"))
    v = torch.randn((b, s, e_dim), generator=gen, device="cuda")
    taps = torch.randn((kk, p), generator=gen, device="cuda") / math.sqrt(p)
    wlp = torch.randn((kk, dk), generator=gen, device="cuda") / math.sqrt(kk)
    locv = torch.randn((dk,), generator=gen, device="cuda") / math.sqrt(dk)
    locb = torch.randn((dk,), generator=gen, device="cuda")
    return (q, prev, k, v, torch.tensor(lens, device="cuda"), taps, wlp, locv, locb, 0.5)


# (B, W, S, Dk, E, enc_len): B from 1 to 5, W = 1 and 16, S = 7 to 1100 (k
# and v in several tiles past 48 frames a block), enc_len of 1 and of S, the
# flagship widths; B = 64 at S = 764 (the big decode config's batch: its
# units' frames do not fit one launch's shared memory) and B = 140 (more
# utterances than the grid's 132 blocks): launches for groups of utterances
ATT_SHAPES = [
    (2, 3, 7, 20, 16, [7, 2]), (2, 3, 300, 20, 64, [300, 100]), (2, 3, 1100, 20, 48, [1100, 366]),
    (3, 1, 204, 300, 640, [204, 1, 150]), (3, 16, 7, 20, 16, [1, 7, 4]), (5, 16, 204, 300, 640, [204, 1, 160, 102, 190]),
    (3, 16, 764, 300, 640, [764, 400, 1]), (2, 16, 1100, 300, 640, [1100, 551]), (1, 1, 1, 8, 8, [1]),
    (64, 16, 764, 300, 640, [764 - 11 * i for i in range(63)] + [1]),
    (140, 2, 30, 20, 16, [30 - i % 30 for i in range(140)]),
]


@pytest.mark.parametrize("b,w,s,dk,e_dim,lens", ATT_SHAPES)
def test_att_step_kernel(gen, b, w, s, dk, e_dim, lens):
    args = _att_args(gen, b, w, s, dk, e_dim, lens)
    before = asc.att_step_beam_loc.launches
    got, want = asc.att_step_beam_loc(*args), asc.att_step_beam_loc_plain(*args)
    group = asc.plan(b, w, s, dk, e_dim, 10, 2 * 50 + 1)["group"]
    assert (group < b) == (b in (64, 140))  # those two take several launches, the rest one
    assert asc.att_step_beam_loc.launches == before + -(-b // group)
    _close(got[0], want[0], rtol=1e-4, atol=1e-6)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)


def test_att_step_plan_raises_outside_its_envelope(gen):
    """More than 16 location filters (two k-steps of the energies' product),
    or an S at which one utterance's share of frames a block does not fit in
    shared memory, have no layout: the plan raises, no launch is made."""
    before = asc.att_step_beam_loc.launches
    with pytest.raises(RuntimeError, match="e2e_att_step_plan"):
        asc.att_step_beam_loc(*_att_args(gen, 2, 3, 30, 20, 16, [30, 9], kk=17))
    with pytest.raises(RuntimeError, match="no layout fits"):
        asc.att_step_beam_loc(*_att_args(gen, 1, 16, 1_000_000, 8, 8, [1_000_000], p=3))
    assert asc.att_step_beam_loc.launches == before


def _prefix_args(gen, b, w, k, t, v, lens, empty):
    """ctc_lp, enc_len (int32), parents' r_g, last_tok, cand (one candidate
    of each beam equal to its last token where the prefix is not empty)."""
    lp = torch.log_softmax(3.0 * torch.randn((b, t, v), generator=gen, device="cuda"), -1)
    lens = torch.tensor(lens, device="cuda")
    r_g = ctc_prefix.init_empty_prefix(lp, lens, w)
    last = torch.zeros((b, w), dtype=torch.long, device="cuda")
    if not empty:  # parents that emitted one token
        first = torch.randint(1, v, (b, w, 1), generator=gen, device="cuda")
        _, r_h, _ = cpc.prefix_scores_fused_plain(lp, lens, r_g, last, first, 1)
        r_g, last = r_h[:, :, 0].contiguous(), first[:, :, 0].contiguous()
    cand = torch.randint(1, v, (b, w, k), generator=gen, device="cuda")
    if not empty and k > 1:
        cand[:, :, 1] = last
    return lp, lens.to(torch.int32), r_g, last, cand, int(empty)


# (B, W, K, T, V, enc_len): K = 1 and V - 1, T = 764 (one tile of shared
# memory) and T = 1000 with 96 columns a block (several tiles), enc_len of 1
# and of T, column runs across beams, the flagship's shapes
PREFIX_SHAPES = [
    (1, 1, 3, 5, 9, [5]), (3, 4, 7, 61, 9, [61, 1, 30]), (2, 3, 1, 40, 9, [40, 17]), (2, 3, 8, 40, 9, [1, 40]),
    (16, 16, 24, 204, 26, [204 - 6 * i for i in range(16)]), (4, 16, 24, 764, 26, [764, 380, 1, 500]),
    (32, 16, 24, 1000, 26, [1000 - 29 * i for i in range(31)] + [1]), (3, 40, 30, 50, 31, [50, 25, 3]),
]


@pytest.mark.parametrize("empty", [True, False])
@pytest.mark.parametrize("b,w,k,t,v,lens", PREFIX_SHAPES)
def test_prefix_recursion_kernel(gen, b, w, k, t, v, lens, empty):
    """The fused CTC prefix kernel (psi, r_h, psi_eos in one launch) against
    its plain version (the streams, the serial recursion, the layout change
    and eos_score): cells unreachable in the plain version stay unreachable."""
    args = _prefix_args(gen, b, w, k, t, v, lens, empty)
    before = cpc.prefix_scores_fused.launches
    got, want = cpc.prefix_scores_fused(*args), cpc.prefix_scores_fused_plain(*args)
    assert cpc.prefix_scores_fused.launches == before + 1
    assert got[1].shape == (b, w, k, t, 2)
    for g, wv in zip(got, want):
        keep = wv > -1e20
        assert torch.equal(g > -1e20, keep)
        assert bool((g[~keep] <= ctc_prefix.NEG / 2).all())
        _close(g[keep], wv[keep], rtol=1e-5, atol=2e-3)


def test_decode_kernels_repeat_bitwise(gen):
    """No atomics: both decode kernels, and the log-mel kernel that feeds
    the decode, give bitwise equal outputs from run to run, at the flagship
    decode shapes."""
    att = _att_args(gen, 16, 16, 204, 300, 640, list(range(204, 101, -6))[:16], p=201)
    prefix = _prefix_args(gen, 16, 16, 24, 204, 26, list(range(204, 101, -6))[:16], False)
    mel = (0.1 * torch.randn((16, 815 * 160 + 400), generator=gen, device="cuda"), AudioConfig(feat_dim=40),
           400, 160, 512)
    for fn, args in ((asc.att_step_beam_loc, att), (cpc.prefix_scores_fused, prefix), (fec.log_mel, mel)):
        first = fn(*args)
        first = (first,) if isinstance(first, torch.Tensor) else first
        for _ in range(3):
            again = fn(*args)
            again = (again,) if isinstance(again, torch.Tensor) else again
            assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_decode_kernels_make_no_host_sync(gen):
    """Both decode wrappers and the log-mel one under PyTorch's sync debug
    mode set to raise (as a CUDA graph of the beam step needs): no
    device-to-host synchronisation, once their plans and tables are cached
    and their libraries built."""
    att = _att_args(gen, 3, 16, 204, 300, 640, [204, 150, 1], p=201)
    prefix = _prefix_args(gen, 3, 16, 24, 204, 26, [204, 150, 1], False)
    wav = 0.1 * torch.randn((3, 24160), generator=gen, device="cuda")
    cfg = AudioConfig(feat_dim=40)
    asc.att_step_beam_loc(*att)
    cpc.prefix_scores_fused(*prefix)
    fec.log_mel(wav, cfg, 400, 160, 512)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        align, ctx = asc.att_step_beam_loc(*att)
        psi, r_h, psi_eos = cpc.prefix_scores_fused(*prefix)
        mel = fec.log_mel(wav, cfg, 400, 160, 512)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(ctx).all()) and bool(torch.isfinite(psi_eos).all())
    assert bool(torch.isfinite(mel).all())


def _lstm_args(gen, b, t, d, h, full=False):
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    if full:
        lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1.0 / math.sqrt(h)
    x = torch.tanh(torch.randn((t, b, d), generator=gen, device="cuda"))
    wx = (torch.rand((2, d, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    wh = (torch.rand((2, h, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    bias = (torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound
    return x, mask, wx, wh, bias


# (B, T, D, H): D and 4H not multiples of the products' tiles (D = 37: rows
# not 16-byte aligned), H = 8
LSTM_TRAIN_SHAPES = [(1, 9, 40, 64), (3, 11, 24, 64), (3, 17, 1280, 320), (1, 33, 640, 320),
                     (2, 13, 37, 8), (5, 7, 200, 24)]


@pytest.mark.parametrize("b,t,d,h", LSTM_TRAIN_SHAPES)
def test_lstm_train_fwd_kernel(gen, b, t, d, h):
    """ys, the c carry and the gate activations of the training variant."""
    args = _lstm_args(gen, b, t, d, h)
    before = rnn_cuda.lstm_bidir_fwd_train.launches
    got = rnn_cuda.lstm_bidir_fwd_train(*args)
    assert rnn_cuda.lstm_bidir_fwd_train.launches == before + 1
    for g, w in zip(got, rnn_cuda.lstm_bidir_fwd_train_plain(*args)):
        _close(g, w, rtol=1e-4, atol=1e-4)


def _close_scaled(got, want, rtol):
    """allclose with atol = rtol * max|want|: sums over many rows whose
    terms cancel."""
    _close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("b,t,d,h", LSTM_TRAIN_SHAPES)
def test_lstm_bwd_kernel(gen, b, t, d, h):
    """dx, dWx, dWh, db of the backward kernel against the plain reverse
    sweep, and the autograd function against autograd of the plain forward
    (tolerance rtol 1e-4, atol 1e-4 of the largest entry)."""
    x, mask, wx, wh, bias = _lstm_args(gen, b, t, d, h, full=True)
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, bias)
    dy = torch.randn(ys.shape, generator=gen, device="cuda")
    before = rnn_cuda.lstm_bidir_bwd.launches
    got = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
    assert rnn_cuda.lstm_bidir_bwd.launches == before + 1
    for g, w in zip(got, rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)):
        _close_scaled(g, w, 1e-4)
    leaves = [a.clone().requires_grad_() for a in (x, wx, wh, bias)]
    want = torch.autograd.grad(
        (rnn_cuda.lstm_bidir_fwd_plain(leaves[0], mask, *leaves[1:]) * dy).sum(), leaves)
    ys_k = rnn_cuda.lstm_bidir_train(leaves[0], mask, *leaves[1:])
    got = torch.autograd.grad((ys_k * dy).sum(), leaves)
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-4)


def _ctc_args(gen, b, t, v, l, index_dtype=torch.int64):
    """log_probs, labels, input_len, label_len: row 0 without alignment, row
    1 without labels, row 2 with input_len > T, repeated labels."""
    lp = torch.log_softmax(3.0 * torch.randn((b, t, v), generator=gen, device="cuda"), -1)
    labels = torch.randint(1, v, (b, l), generator=gen, device="cuda")
    labels[:, 1:3] = labels[:, :1]  # repeated labels forbid the skip
    inlen = torch.randint(max(1, t // 2), t + 1, (b,), generator=gen, device="cuda")
    lablen = torch.randint(0, l + 1, (b,), generator=gen, device="cuda")
    lablen[0] = l
    inlen[0] = max(1, l - 1)  # too few frames: no alignment
    if b > 1:
        lablen[1] = 0
    if b > 2:
        inlen[2] = t + 5  # clamped to T
    labels = torch.where(torch.arange(l, device="cuda")[None] < lablen[:, None], labels, 0)
    return lp, labels.to(index_dtype), inlen.to(index_dtype), lablen.to(index_dtype)


# (B, T, V, L): S = 2L+1 up to 1201 (more states than a half's 512 threads);
# T V above the shared-memory budget (emission rows streamed in tiles)
CTC_SHAPES = [(1, 7, 5, 3), (4, 61, 12, 20), (3, 204, 30, 199), (3, 1300, 9, 600), (4, 300, 400, 30)]


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,t,v,l", CTC_SHAPES)
def test_ctc_lattice_kernel(gen, b, t, v, l, index_dtype):
    """nll and G = d nll / d log_probs against the plain route, with a row
    that has no alignment (+inf, zero gradient), one with no labels and one
    with input_len > T; labels and lengths as int32 or int64; CTCLossFn's
    gradient against the plain route's."""
    lp, labels, inlen, lablen = _ctc_args(gen, b, t, v, l, index_dtype)
    before = ctc_cuda.ctc_lattice.launches
    nll, grad = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)
    assert ctc_cuda.ctc_lattice.launches == before + 1
    nll_p, grad_p = ctc_cuda.ctc_lattice_grad_plain(lp, labels, inlen, lablen)
    assert float(nll[0]) > ctc_cuda.BIG and float(nll_p[0]) > ctc_cuda.BIG
    _close(nll[1:], nll_p[1:], rtol=1e-5, atol=1e-4)
    assert float(grad[0].abs().max()) == 0.0
    _close(grad, grad_p, rtol=1e-5, atol=1e-5)
    lp_k = lp.clone().requires_grad_()
    loss_k = ctc_cuda.CTCLossFn.apply(lp_k, inlen, labels, lablen)
    assert torch.isinf(loss_k[0])
    ct = torch.rand((b,), generator=gen, device="cuda") + 0.5
    (g_k,) = torch.autograd.grad(torch.where(torch.isfinite(loss_k), loss_k, 0.0), lp_k, ct)
    with mock.patch.object(cuda_build, "use_plain", lambda x: True):
        lp_p = lp.clone().requires_grad_()
        loss_p = ctc_cuda.CTCLossFn.apply(lp_p, inlen, labels, lablen)
        (g_p,) = torch.autograd.grad(torch.where(torch.isfinite(loss_p), loss_p, 0.0), lp_p, ct)
    _close(g_k, g_p, rtol=1e-5, atol=1e-5)


def test_ctc_gradient_repeats_bitwise(gen):
    """No atomics: nll and G are bitwise equal from run to run."""
    args = _ctc_args(gen, 16, 204, 32, 199)
    first = ctc_cuda.ctc_lattice(*args)
    for _ in range(3):
        again = ctc_cuda.ctc_lattice(*args)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_ctc_route_makes_no_host_sync(gen):
    """The CUDA route of the loss, forward and backward, under PyTorch's
    sync debug mode set to raise: no device-to-host synchronisation."""
    lp, labels, inlen, lablen = _ctc_args(gen, 4, 61, 12, 20)
    ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)  # plan and build outside the check
    lp = lp.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nll = ctc_cuda.CTCLossFn.apply(lp, inlen, labels, lablen)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(nll), nll, 0.0).sum(), lp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(g).all())


_BAD_LABELS = """
import sys, torch
from e2e_asr_tpu_torch.ops import ctc_cuda
bad = sys.argv[1]
lp = torch.log_softmax(torch.randn((2, 9, 6), device="cuda"), -1)
labels = torch.tensor([[1, 2, 2], [3, 1, 0]], device="cuda")
inlen, lablen = torch.tensor([9, 7], device="cuda"), torch.tensor([3, 2], device="cuda")
if bad == "label_ge_vocab":
    labels[0, 0] = 6
elif bad == "negative_label":
    labels[1, 2] = -1
else:
    lablen[0] = 4
nll, grad = ctc_cuda.ctc_lattice(lp, labels, inlen, lablen)
torch.cuda.synchronize()
print("LOSS", nll.tolist())
"""


@pytest.mark.parametrize("bad", ["label_ge_vocab", "negative_label", "label_len_gt_l"])
def test_ctc_kernel_refuses_out_of_range_labels(gen, bad):
    """The kernel checks labels and label lengths itself (the wrapper does
    not synchronise to look): a bad one stops it with a device-side assert,
    which poisons the process's CUDA context, hence a subprocess; no loss
    comes out."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _BAD_LABELS, bad], cwd=root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    out = res.stdout + res.stderr
    assert res.returncode != 0, out
    assert "LOSS" not in res.stdout
    assert "device-side assert" in out or "ctc_loss: a label" in out, out


def test_lstm_bwd_kernels_repeat_bitwise(gen):
    """No atomics in the sweep or the products (split partials summed in a
    fixed order): every output of lstm_bidir_bwd and lstm_seq_bwd is bitwise
    equal from run to run, at the flagship's shapes, where dWx (D = 640) and
    dWh are split over K."""
    b, t, h = 16, 204, 320
    for d in (1280, 640):
        x, mask, wx, wh, bias = _lstm_args(gen, b, t, d, h, full=True)
        ys, c, acts = rnn_cuda.lstm_bidir_fwd_train(x, mask, wx, wh, bias)
        dy = torch.randn(ys.shape, generator=gen, device="cuda")
        first = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
        for _ in range(2):
            again = rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy)
            assert all(torch.equal(p, q) for p, q in zip(first, again))
    m2 = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1)
    first = rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy)
    again = rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


def test_lstm_bwd_sweep_grid_raises_when_not_resident(gen):
    """The sweep is one cooperative grid: where no plan is resident (here
    4096 rows a direction at H = 1024) the wrapper raises instead of
    launching a grid that would hang."""
    with pytest.raises(ValueError, match="no resident grid"):
        rnn_cuda.sweep_grid(10, 4096, 2, 1024, torch.device("cuda", torch.cuda.current_device()))
    nt, w_smem, smem, blocks, piece = rnn_cuda.sweep_grid(204, 16, 2, 320,
                                                          torch.device("cuda", torch.cuda.current_device()))
    assert (nt, w_smem) == (1, 1) and blocks == 80 and piece == 4 * 320


def _dev():
    return torch.device("cuda", torch.cuda.current_device())


def test_lstm_fwd_plan_keeps_wh_resident_and_raises_without_layout(gen):
    """The forward sweep's plan (the kernel's own): the flagship layer (B=16,
    H=320) and the convergence recipe's first layer (B=32, H=256) keep their
    columns of Wh in shared memory, a block a (direction, 16 units, 8 rows);
    a shape with no resident grid (4096 rows a direction at H = 1024) raises
    instead of launching a grid that would hang."""
    for b, h, blocks in ((16, 320, 80), (32, 256, 128)):
        nt, w_smem, smem, nb = rnn_cuda.fwd_plan(b, 2, h, _dev())
        assert (nt, w_smem, nb) == (1, 1, blocks) and smem <= 232448
    with pytest.raises(ValueError, match="no resident grid"):
        rnn_cuda.fwd_plan(4096, 2, 1024, _dev())


def test_lstm_fwd_kernels_repeat_bitwise(gen):
    """No atomics and a fixed order of the partial sums: the forward's
    outputs (ys, c, acts of the fused layer and of lstm_seq) are bitwise
    equal from run to run at the flagship's shapes."""
    b, t, h = 16, 204, 320
    for d in (1280, 640):
        args = _lstm_args(gen, b, t, d, h)
        first = rnn_cuda.lstm_bidir_fwd_train(*args)
        for _ in range(2):
            again = rnn_cuda.lstm_bidir_fwd_train(*args)
            assert all(torch.equal(p, q) for p, q in zip(first, again))
        assert torch.equal(rnn_cuda.lstm_bidir_fwd(*args), first[0])
    xw, m2 = rnn_cuda._kernel_time_inputs(*(args[i] for i in (0, 1, 2, 4)))
    m2 = m2.float()
    first = rnn_cuda.lstm_seq_fwd(xw, m2, args[3], train=True)
    again = rnn_cuda.lstm_seq_fwd(xw, m2, args[3], train=True)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.parametrize("b,t,d,h", [(3, 11, 37, 8), (16, 204, 1280, 320), (5, 9, 640, 104)])
def test_lstm_projection_rows_in_kernel_time(gen, b, t, d, h):
    """The fused layer's input projection (the shared GEMM with a bias and a
    flipped output row map) against _kernel_time_inputs: x wx[d] + b[d],
    the backward direction's rows flipped over T (D = 37: rows not 16-byte
    aligned)."""
    x, mask, wx, _, bias = _lstm_args(gen, b, t, d, h)
    xw = torch.empty((t, 2 * b, 4 * h), device="cuda")
    rnn_cuda._projection(x, wx, bias, xw)
    _close(xw, rnn_cuda._kernel_time_inputs(x, mask, wx, bias)[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dirs,h,resident", [(2, 512, 1), (1, 1024, 0)])
def test_lstm_seq_fwd_wide_h(gen, dirs, h, resident):
    """At H = 512 the forward's columns of Wh still live in shared memory; at
    H = 1024 they do not fit and the sweep reads them from L2; both agree
    with the plain loop."""
    b, t = 5, 9
    assert rnn_cuda.fwd_plan(b, dirs, h, _dev())[1] == resident
    lens = torch.randint(1, t + 1, (dirs * b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    xw = torch.randn((t, dirs * b, 4 * h), generator=gen, device="cuda")
    wh = (torch.rand((dirs, h, 4 * h), generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)
    for g, w in zip(rnn_cuda.lstm_seq_fwd(xw, mask, wh, train=True), rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)):
        _close(g, w, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ lstm_seq pair
@pytest.mark.parametrize("dirs,b,t,h,suffix", [(2, 3, 11, 64, False), (1, 1, 9, 256, False),
                                               (2, 33, 17, 320, False), (1, 5, 13, 104, True),
                                               (2, 32, 40, 256, False)])
def test_lstm_seq_kernels(gen, dirs, b, t, h, suffix):
    """lstm_seq forward (ys, c, acts) and backward (dxw, dWh) against their
    plain versions, prefix and suffix masks, and LSTMSeqFn against autograd
    through the plain forward."""
    r = dirs * b
    lens = torch.randint(1, t + 1, (r,), generator=gen, device="cuda")
    lens[0] = t
    pos = torch.arange(t, device="cuda")[:, None]
    mask = ((pos >= t - lens[None, :]) if suffix else (pos < lens[None, :])).float()
    xw = torch.randn((t, r, 4 * h), generator=gen, device="cuda")
    wh = (torch.rand((dirs, h, 4 * h), generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)
    before = rnn_cuda.lstm_seq_fwd.launches
    got = rnn_cuda.lstm_seq_fwd(xw, mask, wh, train=True)
    assert rnn_cuda.lstm_seq_fwd.launches == before + 1
    want = rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-4)
    _close(rnn_cuda.lstm_seq_fwd(xw, mask, wh), want[0], rtol=1e-4, atol=1e-4)
    ys, c, acts = want
    dy = torch.randn(ys.shape, generator=gen, device="cuda")
    before = rnn_cuda.lstm_seq_bwd.launches
    got = rnn_cuda.lstm_seq_bwd(mask, wh, ys, c, acts, dy)
    assert rnn_cuda.lstm_seq_bwd.launches == before + 1
    for g, w in zip(got, rnn_cuda.lstm_seq_bwd_plain(mask, wh, ys, c, acts, dy)):
        _close_scaled(g, w, 1e-4)
    leaves = [a.clone().requires_grad_() for a in (xw, wh)]
    want = torch.autograd.grad((rnn_cuda.lstm_seq_fwd_plain(leaves[0], mask, leaves[1])[0] * dy).sum(),
                               leaves)
    got = torch.autograd.grad((rnn_cuda.lstm_seq(leaves[0], mask, leaves[1]) * dy).sum(), leaves)
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-4)


@pytest.mark.parametrize("h,resident", [(512, 1), (1024, 0)])
def test_lstm_seq_bwd_wide_h(gen, h, resident):
    """At H = 512 (the 960 h recipe's width) a block's 16 rows of Wh still
    live in shared memory beside the step's dgates; at H = 1024 they do not fit and the sweep reads them from L2;
    both agree with the plain reverse sweep."""
    dirs, b, t = 2, 5, 9
    dev = torch.device("cuda", torch.cuda.current_device())
    assert rnn_cuda.sweep_grid(t, b, dirs, h, dev)[1] == resident
    lens = torch.randint(1, t + 1, (dirs * b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    xw = torch.randn((t, dirs * b, 4 * h), generator=gen, device="cuda")
    wh = (torch.rand((dirs, h, 4 * h), generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)
    ys, c, acts = rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)
    dy = torch.randn(ys.shape, generator=gen, device="cuda")
    for g, w in zip(rnn_cuda.lstm_seq_bwd(mask, wh, ys, c, acts, dy),
                    rnn_cuda.lstm_seq_bwd_plain(mask, wh, ys, c, acts, dy)):
        _close_scaled(g, w, 1e-4)


def _lstm_seq_bwd_args(gen, dirs, b, t, h):
    lens = torch.randint(1, t + 1, (dirs * b,), generator=gen, device="cuda")
    lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    xw = torch.randn((t, dirs * b, 4 * h), generator=gen, device="cuda")
    wh = (torch.rand((dirs, h, 4 * h), generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)
    ys, c, acts = rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)
    return mask, wh, ys, c, acts, torch.randn(ys.shape, generator=gen, device="cuda")


@pytest.mark.parametrize("b", [10, 20])
def test_lstm_seq_bwd_stages_the_dgates_at_h1024(gen, b):
    """At H = 1024 with B 10 or 20 a direction (the ESPnet recipe's BLSTM
    layers) no grid holding a step's dgates of a block's rows whole is
    resident: the plan stages them in pieces (a piece of whole product
    rounds of 256 columns, a smaller shared memory than the unstaged
    layout's), and the backward agrees with the plain reverse sweep."""
    dirs, t, h = 2, 9, 1024
    nt, w_smem, smem, blocks, piece = rnn_cuda.sweep_grid(t, b, dirs, h, _dev())
    whole = 4 * ((16 * (4 * h + 16) if w_smem else 0) + 8 * nt * (4 * h + 16) + 8 * nt * 16 * 8)
    assert smem < whole and piece < 4 * h and piece % 256 == 0
    args = _lstm_seq_bwd_args(gen, dirs, b, t, h)
    for g, w in zip(rnn_cuda.lstm_seq_bwd(*args), rnn_cuda.lstm_seq_bwd_plain(*args)):
        _close_scaled(g, w, 1e-4)


def test_lstm_seq_bwd_in_pieces_is_bitwise_the_unstaged_sweep(gen, monkeypatch):
    """Staging a step's dgates in two pieces (a plan naming a piece of 2H
    columns, with its shared memory) leaves every warp's sum in its order:
    the outputs are the unstaged sweep's bits (H = 512, B = 16, float32)."""
    dirs, b, t, h = 2, 16, 13, 512
    args = _lstm_seq_bwd_args(gen, dirs, b, t, h)
    nt, w_smem, smem, blocks, piece = rnn_cuda.sweep_grid(t, b, dirs, h, _dev())
    assert piece == 4 * h
    whole = rnn_cuda.lstm_seq_bwd(*args)
    wh_floats = 16 * (4 * h + 16) if w_smem else 0
    staged = 4 * (wh_floats + 8 * nt * (2 * h + 16) + 8 * nt * 16 * 8)  # pieces of 2H columns
    assert staged < smem
    key = next(k for k in rnn_cuda._sweep_grids if k[:4] == (t, b, dirs, h))
    monkeypatch.setitem(rnn_cuda._sweep_grids, key, (nt, w_smem, staged, blocks, 2 * h))
    for g, w in zip(rnn_cuda.lstm_seq_bwd(*args), whole):
        assert torch.equal(g, w)


# ------------------------------------------------------- fused speller scan
def _scan_args(gen, b, s, dk, e_dim, kk, p, h, emb, v, l, lens=None):
    """(k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout,
    bout, teacher [L, B]) with ragged lengths."""
    dev = "cuda"
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    uni = lambda bound, *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound
    enc_len = torch.randint(1, s + 1, (b,), generator=gen, device=dev) if lens is None else \
        torch.tensor(lens, device=dev)
    enc_len[0] = s
    return (torch.tanh(rnd(b, s, dk)), torch.tanh(rnd(b, s, e_dim)), enc_len,
            uni(1 / math.sqrt(p), kk, p), uni(1 / math.sqrt(h), h, dk), uni(0.1, dk),
            uni(1 / math.sqrt(kk), kk, dk), uni(1 / math.sqrt(dk), dk), uni(0.1, dk),
            rnd(v, emb) / math.sqrt(emb), uni(1 / math.sqrt(h), emb + e_dim, 4 * h),
            uni(1 / math.sqrt(h), h, 4 * h), uni(1 / math.sqrt(h), 4 * h),
            uni(1 / math.sqrt(h), h, v), uni(0.1, v),
            torch.randint(0, v, (l, b), generator=gen, device=dev, dtype=torch.int32))


# (B, S, Dk, E, K, P, H, Emb, V, L)
SCAN_SHAPES = [
    (1, 1, 8, 16, 2, 3, 8, 8, 5, 1),
    (3, 7, 20, 24, 3, 11, 64, 16, 9, 4),
    (2, 61, 300, 96, 10, 201, 320, 40, 31, 6),
    (33, 30, 128, 64, 8, 65, 256, 32, 70, 3),
    (2, 764, 300, 64, 10, 201, 320, 32, 31, 2),
    (40, 61, 300, 640, 10, 201, 320, 320, 26, 3),  # flagship widths, B above the resident clusters
    (5, 13, 24, 32, 3, 7, 8, 16, 11, 5),  # H = 8: most blocks of the grid own no hidden unit
    (2, 3000, 256, 64, 4, 31, 64, 16, 9, 2),  # the backward's working buffers in global memory
    (2, 20, 64, 3000, 4, 15, 512, 16, 9, 2),  # the cell's weights too wide to stay in shared memory
    (32, 204, 128, 512, 8, 65, 256, 256, 32, 6),  # the convergence recipe's widths, B above the resident clusters
]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("mode", ["teacher", "argmax", "sample"])
def test_decoder_scan_fwd_kernel(gen, shape, mode):
    """logits, align, hidden and the residuals against the plain version:
    teacher-forced, argmax feedback, and sampled feedback fed the kernel's
    own noise (the fed tokens must be equal; the seeded inputs have no
    near-tie within the 1e-4 tolerance of the logits)."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    b, s, dk, e_dim, kk, p, h, emb, v, l = shape
    args = _scan_args(gen, *shape)
    use = torch.ones(l, dtype=torch.bool) if mode == "teacher" else torch.zeros(l, dtype=torch.bool)
    sample, seed = mode == "sample", 1234567891011
    noise = dc.gumbel_noise(seed, l, b, v, "cuda") if sample else None
    before = dc.decoder_scan_fwd.launches
    got = dc.decoder_scan_fwd(*args, use, 0.5, sample, seed)
    assert dc.decoder_scan_fwd.launches == before + 1
    want = dc.decoder_scan_fwd_plain(*args, use, 0.5, sample, noise)
    assert torch.equal(got[3][1], want[3][1])  # tokens fed
    if mode != "teacher":
        assert int(got[3][1].max()) < v and bool((got[3][1][0] == 0).all())
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, rtol=1e-4, atol=1e-4)
    for g, w in zip((got[3][0], *got[3][2:]), (want[3][0], *want[3][2:])):
        _close(g, w, rtol=1e-4, atol=1e-4)
    past = torch.arange(s, device="cuda")[None, None, :] >= args[2][None, :, None]
    assert float(got[1][past.expand_as(got[1])].abs().max() if past.any() else 0.0) == 0.0


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_decoder_scan_bwd_kernel(gen, shape):
    """The backward sweep against its plain version, and DecoderScanFn on
    the card against autograd through the plain forward loop (atol = 1e-4
    of the largest entry: sums over L*B*S terms in other orders)."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    b, s, dk, e_dim, kk, p, h, emb, v, l = shape
    args = _scan_args(gen, *shape)
    use = torch.ones(l, dtype=torch.bool)
    logits, align, hidden, (cseq, tokens, acts, qs, ctxs) = dc.decoder_scan_fwd_plain(*args, use, 0.5)
    k, vv, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout, teacher = args
    cots = [torch.randn(o.shape, generator=gen, device="cuda") for o in (logits, align, hidden)]
    bargs = (k, vv, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
             ctxs, *cots, 0.5)
    before = dc.decoder_scan_bwd.launches
    got = dc.decoder_scan_bwd(*bargs)
    assert dc.decoder_scan_bwd.launches == before + 1
    for g, w in zip(got, dc.decoder_scan_bwd_plain(*bargs)):
        _close_scaled(g, w, 1e-4)

    idx = [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]  # every float input
    def grads(fn):
        leaves = [a.clone().requires_grad_() if i in idx else a for i, a in enumerate(args)]
        outs = fn(*leaves, use, 0.5)[:3]
        return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)),
                                   [leaves[i] for i in idx])
    want = grads(dc.decoder_scan_fwd_plain)
    got = grads(dc.decoder_scan)
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-4)


def test_decoder_scan_kernels_repeat_bitwise(gen):
    """Two launches of each scan kernel on the same inputs give bitwise-equal
    outputs: no atomics, every sum in a fixed order."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    shape = (16, 61, 300, 640, 10, 201, 320, 320, 26, 6)
    args = _scan_args(gen, *shape)
    use = torch.zeros(shape[-1], dtype=torch.bool)
    first, second = (dc.decoder_scan_fwd(*args, use, 0.5, True, 7) for _ in range(2))
    for g, w in zip((*first[:3], *first[3]), (*second[:3], *second[3])):
        assert torch.equal(g, w)
    logits, align, hidden, (cseq, tokens, acts, qs, ctxs) = first
    k, vv, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout, teacher = args
    cots = [torch.randn(o.shape, generator=gen, device="cuda") for o in (logits, align, hidden)]
    bargs = (k, vv, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
             ctxs, *cots, 0.5)
    for g, w in zip(dc.decoder_scan_bwd(*bargs), dc.decoder_scan_bwd(*bargs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("h_dim", [8, 64, 256, 320, 512])
@pytest.mark.parametrize("nblocks", [8, 64, 128, 132])
def test_scan_plan_fits_the_grid(gen, h_dim, nblocks):
    """The kernels' own shared-memory plan (csrc e2e_decoder_scan_*_plan) at
    the flagship widths on a grid of ``nblocks`` blocks in clusters of 4:
    a block stays within the H100's 227 KB (B 16, and B 40 on grids of 64
    blocks or more), and a grid of 128 or more blocks holds its slice of the
    cell in shared memory."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    for b in (16, 40) if nblocks >= 64 else (16,):
        for which in ("fwd", "bwd"):
            smem, flags, _ = dc.plan(which, nblocks // 4, 4, b, 204, 300, 640, 10, 201, h_dim, 26)
            assert 0 < smem <= dc.SMEM_MAX
            if nblocks >= 128:
                assert flags["w_smem" if which == "fwd" else "wr_smem"]


def test_flagship_plan_keeps_the_cell_resident(gen):
    """At the flagship training shapes on 15 clusters of 8 both kernels hold
    their slice of the cell in shared memory; at S = 764 the plan still fits,
    with k and v left in L2; at S = 4000 the backward's working buffers move
    to global memory (its scratch) and it still fits (S has no limit)."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    smem, flags, _ = dc.plan("fwd", 15, 8, 16, 204, 300, 640, 10, 201, 320, 26)
    assert flags["w_smem"] and smem <= dc.SMEM_MAX
    smem, flags, scratch = dc.plan("bwd", 15, 8, 16, 204, 300, 640, 10, 201, 320, 26)
    assert flags["wr_smem"] and flags["dk_smem"] and smem <= dc.SMEM_MAX and scratch == 0
    smem, flags, _ = dc.plan("fwd", 15, 8, 16, 764, 300, 640, 10, 201, 320, 26)
    assert flags["w_smem"] and not flags["k_smem"] and not flags["v_smem"] and smem <= dc.SMEM_MAX
    smem, flags, scratch = dc.plan("bwd", 15, 8, 16, 4000, 512, 640, 10, 201, 320, 26)
    assert not flags["es_smem"] and "dfa_smem" not in flags and smem <= dc.SMEM_MAX
    assert scratch == 500 * 512  # the energies alone: dfpre's window around a block's frames stays resident


def test_bwd_plan_keeps_the_rows_resident_on_the_dealt_grid(gen):
    """The backward's own grid at the training cells' long buckets (66
    clusters of 2 on a 132-SM H100): fewer frames a block leave room for the
    cell's rows (Wx[Emb:], Wh) beside the energies, at the flagship's (8,
    408) with dk, k and v too, and at asr960h's B 16 buckets in bf16."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    bf = torch.bfloat16
    smem, flags, scratch = dc.plan("bwd", 66, 2, 8, 408, 300, 640, 10, 201, 320, 26, bf)
    assert all(flags.values()) and smem <= dc.SMEM_MAX and scratch == 0
    for s in (408, 764):
        smem, flags, scratch = dc.plan("bwd", 66, 2, 16, s, 300, 1024, 10, 201, 512, 30, bf)
        assert flags["es_smem"] and flags["wr_smem"] and smem <= dc.SMEM_MAX and scratch == 0


# ------------------------- the backward's deal of frames over every block
DEAL_WIDTHS = {"flagship": (300, 640, 10, 201, 320, 320, 26), "asr960h": (300, 1024, 10, 201, 512, 512, 30)}
DEAL_L = 24
# (widths, B, S, lengths: None for ragged in [S/2, S] with one of S)
DEAL_CASES = [("flagship", 8, 408, None), ("asr960h", 16, 764, None), ("flagship", 1, 408, None),
              ("flagship", 40, 204, None), ("flagship", 8, 408, [408, 0, 390, 300, 250, 408, 1, 204])]


def _deal_bwd_args(gen, widths, b, s, dt, lens=None):
    """The backward's arguments at recipe ``widths`` (``DEAL_WIDTHS``), B, S,
    L = DEAL_L, storage type ``dt``: the plain forward's residuals (at bf16
    the context rebuilt from the stored alignment, as DecoderScanFn does) and
    cotangents of chip_smoke.py's scale (1 / sqrt of the last dim)."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    dk, e_dim, kk, p, h, emb, v = DEAL_WIDTHS[widths]
    if lens is None:
        lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device="cuda").tolist()
    args = tuple(a.to(dt) if a.is_floating_point() else a
                 for a in _scan_args(gen, b, s, dk, e_dim, kk, p, h, emb, v, DEAL_L, lens))
    use = torch.ones(DEAL_L, dtype=torch.bool)
    logits, align, hidden, (cseq, _, acts, qs, ctxs) = dc.decoder_scan_fwd_plain(*args, use, 0.5)
    k, vv, enc_len, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args
    cots = [(torch.randn(o.shape, generator=gen, device="cuda") / math.sqrt(o.shape[-1])).to(dt)
            for o in (logits, align, hidden)]
    if dt == torch.bfloat16:
        ctxs = torch.einsum("lbs,bse->lbe", align.float(), vv.float())
    return (k, vv, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctxs, *cots, 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DEAL_CASES)
def test_decoder_scan_bwd_on_the_dealt_grid(gen, case, dtype):
    """The backward on its own grid against its plain version: the training
    cells' long buckets (flagship B 8, S 408; asr960h B 16, S 764), where
    every block of the grid (every SM) holds frames, one utterance over all
    the clusters (B 1), B 40 and a batch with an empty utterance and one of
    one frame. float32 within the table's max error 9.5e-6 and scaled rtol
    1e-4; bf16 by ``_bf16_carried``. A launch adds its grid's frame blocks
    and the card's SMs to the tracer's counters."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc
    from e2e_asr_tpu_torch.utils import tracing

    widths, b, s, lens = case
    dt = getattr(torch, dtype)
    dk, e_dim, kk, p, h, _, v = DEAL_WIDTHS[widths]
    grid = dc.bwd_grid(b, s, dk, e_dim, kk, p, h, v, dtype=dt)
    sms = torch.cuda.get_device_properties(_dev()).multi_processor_count
    if b in (8, 16):
        assert grid["frame_blocks"] == grid["blocks"] == sms and grid["slots"] == 1
    bargs = _deal_bwd_args(gen, widths, b, s, dt, lens)
    counts = lambda: [tracing.counted(n) for n in ("scan.bwd_frame_blocks", "scan.bwd_sms")]
    before, launches = counts(), dc.decoder_scan_bwd.launches + dc.decoder_scan_bwd.launches_bf16
    got = dc.decoder_scan_bwd(*bargs)
    assert dc.decoder_scan_bwd.launches + dc.decoder_scan_bwd.launches_bf16 == launches + 1
    assert [a - c for a, c in zip(counts(), before)] == [grid["frame_blocks"], sms]
    want = dc.decoder_scan_bwd_plain(*bargs)
    for g, w in zip(got, want):
        if dt == torch.float32:
            assert float((g - w).abs().max()) <= 9.5e-6
            _close_scaled(g, w, 1e-4)
        else:
            _bf16_carried(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_scan_bwd_on_the_dealt_grid_repeats_bitwise(gen, dtype):
    """Two launches at the flagship's (8, 408), 16 or 18 blocks an
    utterance over 9 clusters: dq's parts, the shares of the softmax term
    and the per-block partials are summed in a fixed order, no atomics."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    bargs = _deal_bwd_args(gen, "flagship", 8, 408, getattr(torch, dtype))
    for g, w in zip(dc.decoder_scan_bwd(*bargs), dc.decoder_scan_bwd(*bargs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b", [32, 40])
def test_bwd_grid_past_the_clusters_is_no_slower_than_a_cluster_a_slot(gen, b):
    """At B 32 and 40 (more utterances than clusters of 6) the backward's
    own grid (the plan's pick, frames dealt over every block) against the
    grid of one cluster of 6 an utterance slot, the parent's mapping, on
    the flagship's bf16 widths at S 204: the least of 5 device times, in
    turns, within 5%; both agree with each other as with the plain version."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    s, bf = 204, torch.bfloat16
    dk, e_dim, kk, p, h, _, v = DEAL_WIDTHS["flagship"]
    slot = dc.bwd_grid(b, s, dk, e_dim, kk, p, h, v, cluster_size=6, dtype=bf)
    assert slot["slots"] == -(-b // slot["clusters"]) > 1
    bargs = _deal_bwd_args(gen, "flagship", b, s, bf)
    runs = {cl: (lambda cl=cl: dc._bwd_launch((), *bargs, cluster_size=cl)) for cl in (None, 6)}
    outs = {cl: fn() for cl, fn in runs.items()}
    for g, w in zip(outs[None], outs[6]):
        _bf16_carried(g, w)
    best = {cl: float("inf") for cl in runs}
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        for cl, fn in runs.items():
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            best[cl] = min(best[cl], t0.elapsed_time(t1))
    assert best[None] <= 1.05 * best[6], best


# ------------------------------------------------------------------ the RNN-LM
@pytest.mark.parametrize("t", [256, 9])
def test_lm_lstm_through_lstm_seq(gen, t):
    """ops/rnn.py lstm, one direction through the lstm_seq kernel pair, at the
    LM's width (B = 32, D = H = 512) over a bucket of T = 256 tokens (and a
    short one), ragged lengths with one row of length 0 (a padded row of the
    text loader) and one of T: the outputs and the gradients of x, Wx, Wh and
    b against the plain versions; one launch of each kernel."""
    from e2e_asr_tpu_torch.ops import rnn as rnn_ops

    b, d, h = 32, 512, 512
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[1] = t, 0
    x = torch.tanh(torch.randn((b, t, d), generator=gen, device="cuda"))
    w = {k: (torch.rand(s, generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)
         for k, s in (("wx", (d, 4 * h)), ("wh", (h, 4 * h)), ("b", (4 * h,)))}
    dy = torch.randn((b, t, h), generator=gen, device="cuda")

    def run():
        leaves = [x.clone().requires_grad_()] + [v.clone().requires_grad_() for v in w.values()]
        ys = rnn_ops.lstm(leaves[0], lens, dict(zip(w, leaves[1:])))
        return [ys.detach()] + list(torch.autograd.grad((ys * dy).sum(), leaves))

    before = (rnn_cuda.lstm_seq_fwd.launches, rnn_cuda.lstm_seq_bwd.launches)
    got = run()
    assert (rnn_cuda.lstm_seq_fwd.launches, rnn_cuda.lstm_seq_bwd.launches) == (before[0] + 1, before[1] + 1)
    with mock.patch.object(cuda_build, "use_plain", lambda a: True):
        want = run()
    _close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert not bool(got[0][1].any())  # the row of length 0
    for g, wv in zip(got[1:], want[1:]):
        _close_scaled(g, wv, 1e-4)


def test_fused_lm_step_makes_no_host_sync(gen):
    """The LM's part of a fused beam step at the flagship decode's rows (B =
    16, W = 16) with configs/libri/lm_example.yaml's LM (512 / 2 x 512,
    tied): models/lm.py step, the fusion term added to the speller's
    log-probs, the state following its parents and freezing with its
    utterance (decode/beam.py follow_parents), three steps under PyTorch's
    sync debug mode set to raise, as a CUDA graph of the beam step needs."""
    from e2e_asr_tpu_torch.config import LMConfig
    from e2e_asr_tpu_torch.decode.beam import follow_parents
    from e2e_asr_tpu_torch.models import lm as lm_mod

    b, w, vocab = 16, 16, 26
    cfg = LMConfig(emb_tying=True, emb_dim=512, dim=512, n_layers=2)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(0)
    params = lm_mod.lm_init(cpu_gen, vocab, cfg, _dev())
    state = lm_mod.init_state(b * w, cfg, _dev())
    tok = torch.randint(0, vocab, (b * w,), generator=gen, device="cuda")
    step_lp = torch.log_softmax(torch.randn((b, w, vocab), generator=gen, device="cuda"), -1)
    parent = torch.randint(0, w, (b, w), generator=gen, device="cuda")
    flat_parent = (parent + torch.arange(b, device="cuda")[:, None] * w).reshape(-1)
    act_bw = (torch.arange(b, device="cuda") < 12).repeat_interleave(w)

    def lm_part(state):
        lm_lp, new = lm_mod.step(params, cfg, tok, state)
        nxt = follow_parents(new, tuple(x.clone() for x in state), flat_parent, act_bw)  # (in place)
        return step_lp + 0.3 * lm_lp.reshape(b, w, vocab), nxt

    lm_part(state)  # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states = [state]
        for _ in range(3):
            fused, nxt = lm_part(states[-1])
            states.append(nxt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(fused).all())
    frozen = ~act_bw
    for s in states[1:]:
        assert all(torch.equal(x[:, frozen], y[:, frozen]) for x, y in zip(s, state))
        assert bool((s[0][:, act_bw] != 0).any())


# ------------------------------------------------------------ the input path
def _card_loader(workers=2):
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.data.dataset import BucketedLoader, build_tokenizer

    utts = corpus.load_corpus("synthetic", "", ["train:24"])
    tok = build_tokenizer(Config.from_dict({"data": {"text": {"mode": "character"}}}).data, utts)
    return BucketedLoader(utts, tok, 4, buckets_frames=[100, 208, 416], token_buckets=[24, 32, 48],
                          win=400, shift=160, shuffle=True, num_workers=workers)


def _card_put(corpus_buf=None):
    from e2e_asr_tpu_torch.data.prefetch import to_device

    def put(b):
        keys = ("wav_len", "text", "text_len") + (("wav",) if b.wav is not None else ("wav_off",))
        out = {k: to_device(getattr(b, k), _dev()) for k in keys}
        if b.wav is None:
            out.update(corpus=corpus_buf, n_samples=b.n_samples)
        return out
    return put


def test_prefetched_batches_equal_host_batches(gen):
    """Streaming and offsets batches through the prefetcher's stream: the
    device batch (after resolve_wav) equals the host batch, bitwise, in the
    loader's order over two epochs."""
    from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
    from e2e_asr_tpu_torch.training.step import resolve_wav

    loader = _card_loader()
    stream = [b for e in (0, 1) for b in loader.epoch(e)]
    pf = DevicePrefetcher(loader.forever(), _card_put(), depth=2, device=_dev())
    try:
        for want in stream:
            hb, db = next(pf)
            assert hb.uids == want.uids and db["wav"].is_cuda
            for k in ("wav", "wav_len", "text", "text_len"):
                assert np.array_equal(db[k].cpu().numpy(), getattr(want, k)), k
    finally:
        pf.close()
    flat, _ = loader.flat_corpus()
    pf = DevicePrefetcher(loader.forever(), _card_put(to_device(flat, _dev())), depth=2, device=_dev())
    try:
        for want in stream:
            hb, db = next(pf)
            assert hb.wav is None and hb.uids == want.uids
            wav, _ = resolve_wav(db)
            assert np.array_equal(wav.cpu().numpy(), want.wav)
    finally:
        pf.close()


def test_prefetch_next_and_resolve_wav_make_no_host_sync(gen):
    """The consumer's next() (its stream waits on the copy's event) and the
    offsets batch's gather run under the sync debug mode set to raise, the
    prefetch thread's pinned copies with them."""
    from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
    from e2e_asr_tpu_torch.training.step import resolve_wav

    loader = _card_loader()
    want = list(loader.epoch(0))
    flat, _ = loader.flat_corpus()
    pf = DevicePrefetcher(loader.epoch(0), _card_put(to_device(flat, _dev())), depth=2, device=_dev())
    try:
        _, db = next(pf)
        resolve_wav(db)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [resolve_wav(db)[0] for _, db in [next(pf) for _ in range(len(want) - 1)]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        pf.close()
    for g, w in zip(got, want[1:], strict=True):
        assert np.array_equal(g.cpu().numpy(), w.wav)


def test_prefetch_copies_come_from_pinned_memory(gen):
    """Every host-to-device copy of a prefetched batch is from pinned host
    memory (the profiler's memcpy kind), issued on the prefetcher's own
    stream."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher

    loader = _card_loader()
    x = torch.zeros(1 << 16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pf = DevicePrefetcher(loader.epoch(0), _card_put(), depth=2, device=_dev())
        try:
            n = 0
            for _ in pf:
                x.add_(1.0)  # a kernel on the consumer's stream
                n += 1
        finally:
            pf.close()
        torch.cuda.synchronize()
    assert n == len(loader) and float(x[0]) == n
    cuda_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    htod = [e for e in cuda_events if "HtoD" in e.name]
    kernels = [e for e in cuda_events if "Memcpy" not in e.name and "Memset" not in e.name]
    assert len(htod) >= 4 * n, [e.name for e in htod][:8]
    assert all("Pinned" in e.name for e in htod), sorted({e.name for e in htod})
    assert kernels and not ({e.device_resource_id for e in htod} & {e.device_resource_id for e in kernels})


# ------------------------------------------- the beam search as CUDA graphs
def _small_decode(lm: bool, seed: int = 0):
    """(params, model cfg, decode cfg, lm params, lm cfg) of the flagship's
    structure at test size (VGG prenet, two 32-wide BiLSTM layers, location
    attention 16 / 3 filters / 11 taps, one 32-wide speller layer, CTC
    head), beam 4, ctc_weight 0.3, an <eos> bias so that hypotheses finish
    inside the length window; with ``lm`` a 2 x 16 LSTM LM fused at 0.4."""
    from e2e_asr_tpu_torch.config import Config, LMConfig
    from e2e_asr_tpu_torch.data.text import EOS_ID
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.models import lm as lm_mod

    cfg = Config.from_dict({
        "model": {
            "ctc_weight": 0.5,
            "encoder": {"prenet": "vgg", "dim": [32, 32], "dropout": [0.0, 0.0], "layer_norm": [False, False],
                        "proj": [True, True], "sample_rate": [1, 1], "sample_style": "drop"},
            "attention": {"mode": "location", "dim": 16, "num_head": 1, "loc_kernel_size": 5, "loc_kernel_num": 3},
            "decoder": {"dim": 32, "layer": 1},
        },
        "decode": {"beam_size": 4, "ctc_weight": 0.3, "lm_weight": 0.4 if lm else 0.0, "max_len_ratio": 0.8,
                   "min_len_ratio": 0.2},
    })
    params, _ = asr_mod.asr_init(seed, 40, 12, cfg.model, _dev())
    params["decoder"]["char"]["b"][EOS_ID] += 2.5
    lm_params = lm_cfg = None
    if lm:
        lm_cfg = LMConfig(emb_tying=False, emb_dim=8, dim=16, n_layers=2, dropout=0.0)
        g = torch.Generator()
        g.manual_seed(seed + 5)
        lm_params = lm_mod.lm_init(g, 12, lm_cfg, _dev())
    return params, cfg.model, cfg.decode, lm_params, lm_cfg


def _small_feats(gen, b=3, t=64):
    feat = torch.randn((b, t, 40), generator=gen, device="cuda")
    feat_len = torch.tensor([t, 45, 30, 64, 50][:b], device="cuda", dtype=torch.int32)
    return torch.where(torch.arange(t, device="cuda")[None, :, None] < feat_len[:, None, None], feat, 0.0), feat_len


def _decode(setup, feat, feat_len, max_step=12, **kw):
    from e2e_asr_tpu_torch.decode.beam import beam_search

    params, cfg, dcfg, lm_params, lm_cfg = setup
    return beam_search(params, cfg, dcfg, feat, feat_len, max_step, lm_params=lm_params, lm_cfg=lm_cfg, **kw)


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree


def _launch_counts():
    return (asc.att_step_beam_loc.launches, cpc.prefix_scores_fused.launches)


def _zero_counts():
    asc.att_step_beam_loc.launches = cpc.prefix_scores_fused.launches = 0


@pytest.mark.parametrize("lm", [False, True], ids=["no-lm", "lm"])
def test_graph_replay_equals_eager_loop_bitwise(gen, lm):
    """Two batches of one shape decoded through one graph cache (the first
    captures, the second replays) and through the eager loop: tokens,
    lengths and scores bitwise equal; one capture; the decode kernels'
    counts of a replayed decode, and of the capturing one, equal the eager
    loop's (one a step)."""
    from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs

    setup = _small_decode(lm)
    cache = BeamGraphs()
    for i in range(2):
        feat, feat_len = _small_feats(gen)
        _zero_counts()
        got = _decode(setup, feat, feat_len, graph_cache=cache)
        counts = _launch_counts()
        _zero_counts()
        want = _decode(setup, feat, feat_len, graphs=False)
        assert _launch_counts() == counts == (12, 12), (i, counts)
        for name, x, y in zip(("tokens", "lengths", "scores"), got, want):
            assert torch.equal(x, y), (i, name)
        assert len(cache.graphs) == len(cache.captures) == 1


@pytest.mark.parametrize("lm", [False, True], ids=["no-lm", "lm"])
def test_beam_step_makes_no_host_sync(gen, lm):
    """The whole beam step (the speller, the attention and CTC prefix
    kernels, the fused LM, top-k, the finished set, pruning, the in-place
    state update) under PyTorch's sync debug mode set to raise, once the
    libraries are built and the plans cached: no host synchronisation, as
    the capture needs."""
    from e2e_asr_tpu_torch.decode import beam

    setup = _small_decode(lm)
    feat, feat_len = _small_feats(gen)
    _decode(setup, feat, feat_len, graphs=False)  # warm-up
    params, cfg, dcfg, lm_params, lm_cfg = setup
    with torch.inference_mode():
        spec, inp = beam.prepare(params, cfg, dcfg, feat, feat_len, 12, lm_params, lm_cfg)
        st = beam.init_state(spec, inp)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(3):
                beam.beam_step(spec, inp, st, first=i == 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(st.t) == 3 and bool(torch.isfinite(st.scores).all())


def test_graphs_are_captured_anew_for_a_new_shape_or_new_weights(gen):
    """A second batch of one shape replays its graph; another batch size,
    another max_step or the same weights at other addresses capture anew,
    and each decode equals the eager loop's."""
    from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs

    setup = _small_decode(False)
    clone = (_clone_tree(setup[0]),) + setup[1:]
    cache = BeamGraphs()
    runs = [(setup, 3, 12), (setup, 3, 12), (setup, 2, 12), (setup, 3, 14), (clone, 3, 12), (clone, 3, 12)]
    for n, (s, b, max_step) in enumerate(runs):
        feat, feat_len = _small_feats(gen, b=b)
        got = _decode(s, feat, feat_len, max_step=max_step, graph_cache=cache)
        want = _decode(s, feat, feat_len, max_step=max_step, graphs=False)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), n
    assert len(cache.graphs) == len(cache.captures) == 4


def test_capture_beside_a_copying_thread(gen):
    """Capture (``capture_error_mode="thread_local"``) while another thread
    does what the decode's prefetcher does: pinned copies on a stream of
    its own, events, synchronising on them. The capture goes through, the
    thread's copies arrive intact, and the decode equals the eager loop."""
    import threading

    import numpy as np

    from e2e_asr_tpu_torch.data.prefetch import to_device
    from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs

    setup = _small_decode(True)
    feat, feat_len = _small_feats(gen)
    stop, errors, copies = threading.Event(), [], [0]

    def copier():
        try:
            side = torch.cuda.Stream()
            host = np.arange(1 << 18, dtype=np.int16)
            while not stop.is_set():
                with torch.cuda.stream(side):
                    x = to_device(host, _dev())
                    ev = torch.cuda.Event()
                    ev.record(side)
                ev.synchronize()
                assert int(x[-1]) == int(host[-1])
                copies[0] += 1
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    th = threading.Thread(target=copier, daemon=True)
    th.start()
    try:
        got = _decode(setup, feat, feat_len, graph_cache=BeamGraphs())
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors, errors
    assert copies[0] > 0
    want = _decode(setup, feat, feat_len, graphs=False)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_attention_step_is_a_cooperative_kernel_node(gen, tmp_path):
    """A later beam step captured as decode/beam_graph.py captures it (after
    an eager step on the side stream), with the graph's debug mode on: the
    DOT dump shows the attention step as a kernel node whose cooperative
    attribute is set (the runtime keeps cudaLaunchAttributeCooperative under
    stream capture), and the nodes form one chain in stream order, so no
    node starts while the cooperative grid still runs (none can reuse its
    scratch early)."""
    import re

    from e2e_asr_tpu_torch.decode import beam

    params, cfg, dcfg, lm_params, lm_cfg = _small_decode(False)
    feat, feat_len = _small_feats(gen)
    with torch.inference_mode():
        spec, inp = beam.prepare(params, cfg, dcfg, feat, feat_len, 12, lm_params, lm_cfg)
        st = beam.init_state(spec, inp)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            beam.beam_step(spec, inp, st, first=True)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)  # keeps the cudaGraph_t for the dump
        g.enable_debug_mode()
        before = _launch_counts()
        with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
            beam.beam_step(spec, inp, st, first=False)
    path = tmp_path / "beam_step.dot"
    g.debug_dump(str(path))
    dot = path.read_text()
    # a node: "graph_i_node_j"[... label="{KERNEL | ... | {cooperative | 1} ...}"]; an edge: "a" -> "b" [...]
    nodes = dict(re.findall(r'^"(graph_\d+_node_\d+)"\[(.*?)\];', dot, flags=re.S | re.M))
    edges = re.findall(r'^"(graph_\d+_node_\d+)"\s*->\s*"(graph_\d+_node_\d+)"', dot, flags=re.M)
    att = [label for label in nodes.values() if "att_step_kernel" in label]
    assert len(att) == 1 == _launch_counts()[0] - before[0], (len(att), dot[:3000])
    assert "{cooperative | 1}" in att[0], att[0]
    assert len(nodes) > 50 and len(edges) == len(nodes) - 1, (len(nodes), len(edges))
    assert len({b for _, b in edges}) == len(edges) and len({a for a, _ in edges}) == len(edges)


_SYNC_IN_CAPTURE = """
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("card_tests", "tests/test_torch_cuda.py")
card = importlib.util.module_from_spec(spec)
spec.loader.exec_module(card)
from e2e_asr_tpu_torch.decode import beam
from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs
step = beam.beam_step
def syncing_step(spec, inp, st, first):
    step(spec, inp, st, first)
    float(st.scores.sum())  # a host synchronisation: illegal while capturing
beam.beam_step = syncing_step
g = torch.Generator(device="cuda")
g.manual_seed(0)
feat, feat_len = card._small_feats(g)
try:
    card._decode(card._small_decode(False), feat, feat_len, graph_cache=BeamGraphs())
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:200])
    sys.exit(0)
print("NO ERROR")
"""


def test_a_failing_capture_raises(gen):
    """A step that synchronises with the host cannot be captured: the decode
    raises (it does not fall back to the eager loop). In a subprocess, since
    a failed capture may leave the CUDA context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SYNC_IN_CAPTURE], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and "RAISED" in res.stdout, res.stdout + res.stderr[-3000:]


# --------------------------------------------------------- bfloat16 variants
def _bf16_close(got, want):
    """A bf16 output the kernel and its plain version round alike:
    chip_smoke's criterion (at most BF16_ULPS ulp of the tensor's scale
    apart, on at most BF16_SHARE of its elements)."""
    from chip_smoke import BF16_SHARE, BF16_ULPS

    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(max(float(w.abs().max()), 2.0 ** -126))) - 7)
    assert float((g - w).abs().max()) <= BF16_ULPS * ulp
    assert float((g != w).float().mean()) <= BF16_SHARE


@pytest.mark.parametrize("dirs,b,t,h", [(2, 3, 11, 64), (1, 5, 13, 104), (2, 33, 17, 320)])
def test_bf16_lstm_seq_kernels(gen, dirs, b, t, h):
    """The bf16 variants of the lstm_seq pair against their bf16 plain
    versions: ys, c, dxw and dWh bf16 (``_bf16_close``), acts float32
    (scaled rtol 1e-3); the launches count as bf16 ones; LSTMSeqFn gives
    bf16 gradients of bf16 inputs."""
    bf = torch.bfloat16
    r = dirs * b
    lens = torch.randint(1, t + 1, (r,), generator=gen, device="cuda")
    lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    xw = torch.randn((t, r, 4 * h), generator=gen, device="cuda").to(bf)
    wh = ((torch.rand((dirs, h, 4 * h), generator=gen, device="cuda") * 2 - 1) / math.sqrt(h)).to(bf)
    before, before32 = rnn_cuda.lstm_seq_fwd.launches_bf16, rnn_cuda.lstm_seq_fwd.launches
    got = rnn_cuda.lstm_seq_fwd(xw, mask, wh, train=True)
    assert (rnn_cuda.lstm_seq_fwd.launches_bf16, rnn_cuda.lstm_seq_fwd.launches) == (before + 1, before32)
    want = rnn_cuda.lstm_seq_fwd_plain(xw, mask, wh)
    assert got[2].dtype == want[2].dtype == torch.float32
    for g, w in zip(got[:2], want[:2]):
        _bf16_close(g, w)
    _close_scaled(got[2], want[2], 1e-3)
    ys, c, acts = want
    dy = torch.randn(ys.shape, generator=gen, device="cuda").to(bf)
    for g, w in zip(rnn_cuda.lstm_seq_bwd(mask, wh, ys, c, acts, dy),
                    rnn_cuda.lstm_seq_bwd_plain(mask, wh, ys, c, acts, dy)):
        _bf16_close(g, w)
    leaves = [a.clone().requires_grad_() for a in (xw, wh)]
    grads = torch.autograd.grad((rnn_cuda.lstm_seq(leaves[0], mask, leaves[1]).float() * dy.float()).sum(), leaves)
    assert all(g.dtype == bf for g in grads)


@pytest.mark.parametrize("b,t,d,h", [(3, 11, 24, 64), (16, 30, 1280, 320), (5, 9, 80, 256)])
def test_bf16_lstm_bidir_kernels(gen, b, t, d, h):
    """The bf16 variants of the fused layer's pair against their bf16 plain
    versions: ys, c, acts (the training forward), ys (the inference
    forward), dx, dWx, dWh and db, all bf16 (``_bf16_close``)."""
    bf = torch.bfloat16
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1 / math.sqrt(h)
    x = torch.tanh(torch.randn((t, b, d), generator=gen, device="cuda")).to(bf)
    wx, wh = ((torch.rand(s, generator=gen, device="cuda") * 2 - 1).mul(bound).to(bf)
              for s in ((2, d, 4 * h), (2, h, 4 * h)))
    bias = ((torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound).to(bf)
    got = rnn_cuda.lstm_bidir_fwd_train(x, mask, wx, wh, bias)
    want = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, bias)
    for g, w in zip(got, want):
        _bf16_close(g, w)
    _bf16_close(rnn_cuda.lstm_bidir_fwd(x, mask, wx, wh, bias), want[0])
    ys, c, acts = want
    dy = torch.randn(ys.shape, generator=gen, device="cuda").to(bf)
    for g, w in zip(rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy),
                    rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)):
        _bf16_close(g, w)


@pytest.mark.parametrize("shape", [SCAN_SHAPES[1], SCAN_SHAPES[4], SCAN_SHAPES[8], SCAN_SHAPES[9]])
def test_bf16_decoder_scan_kernels(gen, shape):
    """The bf16 variants of the scan pair against their bf16 plain versions,
    teacher-forced: logits, align, hidden and c bf16 (``_bf16_close``), the
    float32 residuals and every output of the backward at scaled rtol 1e-3;
    S = 764 and weights too wide for shared memory among the shapes."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a for a in _scan_args(gen, *shape))
    l = shape[-1]
    use = torch.ones(l, dtype=torch.bool)
    got = dc.decoder_scan_fwd(*args, use, 0.5)
    want = dc.decoder_scan_fwd_plain(*args, use, 0.5)
    for g, w in zip(list(got[:3]) + [got[3][0]], list(want[:3]) + [want[3][0]]):
        _bf16_close(g, w)
    for g, w in zip(got[3][2:], want[3][2:]):
        _close_scaled(g, w, 1e-3)
    logits, align, hidden, (cseq, _, acts, qs, _) = want
    k, v, lens, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args
    ctx_r = torch.einsum("lbs,bse->lbe", align.float(), v.float())
    cots = [torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16) for o in (logits, align, hidden)]
    bargs = (k, v, lens, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctx_r, *cots, 0.5)
    for g, w in zip(dc.decoder_scan_bwd(*bargs), dc.decoder_scan_bwd_plain(*bargs)):
        assert g.dtype == torch.float32
        _close_scaled(g, w, 1e-3)


def test_bf16_reaches_no_kernel_without_a_variant(gen):
    """A bf16 tensor that reaches a kernel with no bf16 variant raises (the
    CTC loss, the log-mel frontend), and so do a type no kernel takes
    (float16) and storage types mixed within one call (lstm_seq, the scan);
    nothing is cast to reach a kernel."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    bf = torch.bfloat16
    lp, labels, inlen, lablen = _ctc_args(gen, 2, 20, 9, 5)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_lattice(lp.to(bf), labels, inlen, lablen)
    cfg, win, shift, n_fft = _log_mel_cfg(16000, 40, "povey", 0.97)
    with pytest.raises(ValueError):
        fec.log_mel(torch.randn((2, 4000), generator=gen, device="cuda").to(bf), cfg, win, shift, n_fft)
    t, r, h = 5, 4, 16
    mask = torch.ones((t, r), device="cuda")
    xw = torch.randn((t, r, 4 * h), generator=gen, device="cuda")
    wh = torch.randn((2, h, 4 * h), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        rnn_cuda.lstm_seq_fwd(xw.to(bf), mask, wh)  # wh float32
    with pytest.raises(ValueError):
        rnn_cuda.lstm_seq_fwd(xw.half(), mask, wh.half())
    args = list(_scan_args(gen, *SCAN_SHAPES[1]))
    args[0] = args[0].to(bf)
    with pytest.raises(ValueError):
        dc.decoder_scan_fwd(*args, torch.ones(SCAN_SHAPES[1][-1], dtype=torch.bool), 0.5)


def test_bf16_plans_reckon_in_bf16_bytes(gen):
    """The plans count the residents in the storage type: the bf16 forward
    sweep keeps Wh in shared memory at H = 1024 and the backward sweep at
    H = 768, where float32 cannot (the backward's staged gate gradients
    stay float32), and the scan's bf16 plans take fewer bytes at the
    flagship's shapes."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    dev = torch.device("cuda", torch.cuda.current_device())
    bf = torch.bfloat16
    assert rnn_cuda.fwd_plan(5, 2, 1024, dev)[1] == 0 and rnn_cuda.fwd_plan(5, 2, 1024, dev, bf)[1] == 1
    assert rnn_cuda.sweep_grid(9, 5, 2, 768, dev)[1] == 0 and rnn_cuda.sweep_grid(9, 5, 2, 768, dev, bf)[1] == 1
    shape = (16, 204, 300, 640, 10, 201, 320, 26)
    for which in ("fwd", "bwd"):
        s32, _, _ = dc.plan(which, 15, 8, *shape)
        s16, _, _ = dc.plan(which, 15, 8, *shape, dtype=bf)
        assert s16 < s32


# ------------------------------------------- the train step as CUDA graphs
def _small_train(dtype="float32", rnn_impl="auto", **hparas):
    """(Trainer, TrainState) of the flagship's structure at test size (VGG
    prenet on 40-dim fbank through the log-mel kernel, two 32-wide BiLSTM
    layers by ``rnn_impl``, location attention 16 / 3 filters / 11 taps, a
    32-wide speller through the fused scan, CTC head, ctc_weight 0.5), Adam
    with the warmup schedule and clip 5, dither, SpecAugment and encoder
    dropout on, the teacher-forcing rate 1.0 -> 0.5 over 2 steps, compute
    type ``dtype``."""
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import Trainer

    resolve_device("cuda")  # as the solver: TF32 off, cuDNN on deterministic algorithms
    h = dict(dtype=dtype, optimizer="Adam", lr=1e-3, eps=1e-8, grad_clip=5.0, lr_scheduler="warmup", warmup_step=3,
             tf_start=1.0, tf_end=0.5, tf_step=2, ctc_infeasible="skip")
    h.update(hparas)
    cfg = Config.from_dict({
        "data": {"audio": {"feat_dim": 40, "use_pallas": True, "dither": 1e-5}},
        "model": {
            "ctc_weight": 0.5,
            "encoder": {"prenet": "vgg", "dim": [32, 32], "dropout": [0.1, 0.0], "layer_norm": [False, False],
                        "proj": [True, True], "sample_rate": [1, 1], "sample_style": "drop", "rnn_impl": rnn_impl},
            "attention": {"mode": "location", "dim": 16, "num_head": 1, "loc_kernel_size": 5, "loc_kernel_num": 3},
            "decoder": {"dim": 32, "layer": 1},
            "specaugment": {"enable": True, "freq_mask_width": 5, "time_mask_width": 10},
        },
        "hparas": h,
    })
    params, _ = asr_mod.asr_init(0, 40, 12, cfg.model, _dev())
    trainer = Trainer(cfg)
    return trainer, trainer.init_state(params)


def _train_batch(seed, frames=(64, 52, 24), text_len=(8, 6, 5), l_pad=10):
    """A streaming batch on the card: numpy waves of ``frames`` 10 ms frames
    and targets without repeats (every row fits its CTC lattice unless a
    text is made longer than its encoder frames)."""
    rng = np.random.RandomState(seed)
    n = (max(frames) - 1) * 160 + 400
    wav_len = np.array([(f - 1) * 160 + 400 for f in frames], np.int32)
    wav = (0.1 * rng.randn(len(frames), n)).astype(np.float32)
    text = (1 + np.cumsum(rng.randint(1, 10, size=(len(frames), l_pad)), axis=1) % 11).astype(np.int32)
    for i, (m, t) in enumerate(zip(wav_len, text_len)):
        wav[i, m:] = 0.0
        text[i, t:] = 0
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("wav", wav), ("wav_len", wav_len), ("text", text), ("text_len", np.asarray(text_len, np.int32)))}


def _train_counts():
    from e2e_asr_tpu_torch.training.step_graph import COUNTED, COUNTERS

    return {f"{fn.__name__}.{a}": getattr(fn, a, 0) for fn in COUNTED for a in COUNTERS}


def _leaf_clone(tree):
    """A parameter tree at other addresses, its tensors leaves that need grad."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _leaf_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_clone(v) for v in tree]
    return tree


def _gen_of(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _state_tensors(state):
    from e2e_asr_tpu_torch.training.step import param_leaves

    return [p.detach() for p in param_leaves(state.params)] + [
        t for k in sorted(state.opt_state) for t in param_leaves(state.opt_state[k])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rnn_impl", ["auto", "pallas"])
def test_train_graph_replay_equals_eager_step_bitwise(gen, dtype, rnn_impl):
    """Six steps of one bucket shape through TrainGraphs (the first runs
    eagerly and captures, the rest replay) and through the eager step from
    the same weights, batches and seeds: loss, grad norm, step_skipped,
    every parameter and optimizer tensor bitwise equal after each step, and
    the same launch counts. The rate falls below 1 from the second step on
    (coins fail: sampled feedback in the scan) and the fifth has a row with
    no CTC alignment (loss +inf: the skip by select)."""
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    tg, sg = _small_train(dtype, rnn_impl)
    te, se = _small_train(dtype, rnn_impl)
    graphs = TrainGraphs()
    for i in range(6):
        batch = _train_batch(i, text_len=(8, 6, 9) if i == 4 else (8, 6, 5))
        counts0 = _train_counts()
        mg = tg.train_step(sg, batch, _gen_of(100 + i), graphs=graphs)
        got = [mg[k].clone() for k in ("loss", "grad_norm", "step_skipped", "tf_rate")]
        counts1 = _train_counts()
        me = te.train_step(se, batch, _gen_of(100 + i))
        counts2 = _train_counts()
        want = [me[k] for k in ("loss", "grad_norm", "step_skipped", "tf_rate")]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (i, got, want)
        assert float(want[2]) == float(i == 4) and (float(want[3]) < 1.0) == (i >= 1)
        assert all(torch.equal(a, b) for a, b in zip(_state_tensors(sg), _state_tensors(se))), i
        dg = {k: counts1[k] - counts0[k] for k in counts0}
        de = {k: counts2[k] - counts1[k] for k in counts0}
        assert dg == de and sum(de.values()) >= 6, (i, dg, de)
    assert len(graphs.graphs) == len(graphs.captures) == 1
    assert int(sg.opt_state["count"]) == 5 and sg.step == 6


def test_eager_train_step_makes_no_host_sync(gen):
    """One eager train step (tf 0.5: failing coins, the scan's seed drawn on
    the card) under PyTorch's sync debug mode set to raise, once the
    libraries are built and the plans cached: the step reads nothing back,
    as its capture needs."""
    trainer, state = _small_train(tf_start=0.5, tf_end=0.5)
    batch = _train_batch(0)
    trainer.train_step(state, batch, _gen_of(1))  # warm-up
    gens = [_gen_of(2 + i) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in gens:
            m = trainer.train_step(state, batch, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(m["step_skipped"]) == 0.0 and bool(torch.isfinite(m["loss"]))


def test_train_graphs_are_captured_anew_for_a_new_bucket_or_new_weights(gen):
    """A second batch of one bucket replays its graph; a longer bucket, a
    longer token bucket, or the same model and state at other addresses
    capture anew; each step equals the eager one's loss."""
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    trainer, state = _small_train()
    graphs = TrainGraphs()
    shapes = [((64, 52, 24), 10), ((64, 52, 24), 10), ((80, 52, 24), 10), ((64, 52, 24), 12)]
    for i, (frames, l_pad) in enumerate(shapes):
        trainer.train_step(state, _train_batch(i, frames=frames, l_pad=l_pad), _gen_of(i), graphs=graphs)
    assert len(graphs.graphs) == len(graphs.captures) == 3
    moved = type(state)(_leaf_clone(state.params), _clone_tree(state.opt_state), state.step)
    for p in _state_tensors(moved)[:1]:
        assert p.data_ptr() != _state_tensors(state)[0].data_ptr()
    before = [t.clone() for t in _state_tensors(moved)]
    trainer.train_step(moved, _train_batch(9), _gen_of(9), graphs=graphs)
    assert len(graphs.graphs) == 4
    assert any(not torch.equal(a, b) for a, b in zip(_state_tensors(moved), before))


def test_train_capture_beside_a_copying_thread(gen):
    """Capture (``capture_error_mode="thread_local"``) of the train step
    while another thread does what the prefetcher does: pinned copies on a
    stream of its own, events, synchronising on them. The capture goes
    through, the copies arrive intact, and the next step replays equal to
    the eager step."""
    import threading

    from e2e_asr_tpu_torch.data.prefetch import to_device
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    tg, sg = _small_train()
    te, se = _small_train()
    stop, errors, copies = threading.Event(), [], [0]

    def copier():
        try:
            side = torch.cuda.Stream()
            host = np.arange(1 << 18, dtype=np.int16)
            while not stop.is_set():
                with torch.cuda.stream(side):
                    x = to_device(host, _dev())
                    ev = torch.cuda.Event()
                    ev.record(side)
                ev.synchronize()
                assert int(x[-1]) == int(host[-1])
                copies[0] += 1
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    graphs = TrainGraphs()
    th = threading.Thread(target=copier, daemon=True)
    th.start()
    try:
        tg.train_step(sg, _train_batch(0), _gen_of(0), graphs=graphs)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors, errors
    assert copies[0] > 0 and len(graphs.captures) == 1
    te.train_step(se, _train_batch(0), _gen_of(0))
    mg = tg.train_step(sg, _train_batch(1), _gen_of(1), graphs=graphs)
    me = te.train_step(se, _train_batch(1), _gen_of(1))
    assert torch.equal(mg["loss"], me["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(sg), _state_tensors(se)))


_SYNC_IN_TRAIN_CAPTURE = """
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("card_tests", "tests/test_torch_cuda.py")
card = importlib.util.module_from_spec(spec)
spec.loader.exec_module(card)
from e2e_asr_tpu_torch.training.step import Trainer
from e2e_asr_tpu_torch.training.step_graph import TrainGraphs
step = Trainer.device_step
def syncing_step(self, *args, **kw):
    m = step(self, *args, **kw)
    float(m["loss"])  # a host synchronisation: illegal while capturing
    return m
Trainer.device_step = syncing_step
trainer, state = card._small_train()
try:
    trainer.train_step(state, card._train_batch(0), card._gen_of(0), graphs=TrainGraphs())
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:200])
    sys.exit(0)
print("NO ERROR")
"""


def test_a_failing_train_capture_raises(gen):
    """A train step that synchronises with the host cannot be captured: the
    step raises (it does not fall back to the eager step). In a subprocess,
    since a failed capture may leave the CUDA context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SYNC_IN_TRAIN_CAPTURE], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and "RAISED" in res.stdout, res.stdout + res.stderr[-3000:]


# ------------------------------------- validation and the LM as CUDA graphs
EVAL_MAX_STEP = 12
HOST_LAUNCH_LIMIT = 10  # host-issued launches of a replayed dev batch or LM step


def _eval_outputs(out):
    return {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rnn_impl", ["auto", "pallas"])
def test_eval_graph_replay_equals_eager_validation_bitwise(gen, dtype, rnn_impl):
    """Three dev batches of one shape through EvalGraphs (the first runs
    eagerly and captures, the rest replay) and through the eager
    ``eval_device``: losses, CTC ids, encoder lengths and greedy tokens
    bitwise, the same launch counts; a new max_step captures anew."""
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs

    trainer, state = _small_train(dtype, rnn_impl)
    graphs = EvalGraphs()
    for i in range(3):
        batch = _train_batch(10 + i)
        counts0 = _train_counts()
        got = _eval_outputs(trainer.validate_batch(state.params, batch, EVAL_MAX_STEP, graphs=graphs))
        counts1 = _train_counts()
        want = trainer.eval_device(state.params, batch, EVAL_MAX_STEP)
        counts2 = _train_counts()
        assert set(got) == set(want) == {"scalars", "sums", "ctc_preds", "enc_len", "tokens"}
        assert got["tokens"].shape == (3, EVAL_MAX_STEP) and got["scalars"].dtype == torch.float32
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        dg = {k: counts1[k] - counts0[k] for k in counts0}
        de = {k: counts2[k] - counts1[k] for k in counts0}
        assert dg == de and sum(de.values()) >= 4, (i, dg, de)
    assert len(graphs.graphs) == len(graphs.captures) == 1
    out = trainer.validate_batch(state.params, _train_batch(20), EVAL_MAX_STEP + 3, graphs=graphs)
    assert len(graphs.captures) == 2 and out["tokens"].shape == (3, EVAL_MAX_STEP + 3)


def test_eval_graphs_beside_train_graphs_in_one_pool(gen):
    """Train steps and validations in turns, the validation graphs sharing
    the train graphs' memory pool and capture stream, against the eager
    step and ``eval_device`` on a second copy of the model: every step and
    every validation bitwise, so that neither kind of graph overwrites what
    the other still reads."""
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    tg, sg = _small_train()
    te, se = _small_train()
    train = TrainGraphs()
    evals = EvalGraphs(share=train)
    for i in range(4):
        batch = _train_batch(i)
        mg = tg.train_step(sg, batch, _gen_of(30 + i), graphs=train)
        assert torch.equal(mg["loss"].clone(), te.train_step(se, batch, _gen_of(30 + i))["loss"])
        got = _eval_outputs(tg.validate_batch(sg.params, _train_batch(40 + i), EVAL_MAX_STEP, graphs=evals))
        want = te.eval_device(se.params, _train_batch(40 + i), EVAL_MAX_STEP)
        assert all(torch.equal(got[k], want[k]) for k in want), i
        assert all(torch.equal(a, b) for a, b in zip(_state_tensors(sg), _state_tensors(se))), i
    assert evals.pool == train.pool is not None and evals.stream is train.stream
    assert len(train.captures) == len(evals.captures) == 1


def test_eager_validation_makes_no_host_sync(gen):
    """``eval_device`` (losses, CTC argmax, the greedy loop) under PyTorch's
    sync debug mode set to raise, once the plans are cached: it reads
    nothing back, as its capture needs."""
    trainer, state = _small_train()
    batch = _train_batch(0)
    trainer.eval_device(state.params, batch, EVAL_MAX_STEP)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = trainer.eval_device(state.params, batch, EVAL_MAX_STEP)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out["scalars"]).all())


def _small_lm(dropout=0.2):
    """(LM config, Optimizer, TrainState) of a two-layer 16-wide LM (its
    layers through the lstm_seq pair), Adam with clip 5, on the card."""
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.models import lm as lm_mod
    from e2e_asr_tpu_torch.optim import Optimizer
    from e2e_asr_tpu_torch.training.step import TrainState, param_leaves

    cfg = Config.from_dict({"hparas": {"optimizer": "Adam", "lr": 1e-2, "grad_clip": 5.0},
                            "lm": {"emb_dim": 8, "dim": 16, "n_layers": 2, "dropout": dropout, "emb_tying": True}})
    g = torch.Generator()
    g.manual_seed(0)
    params = lm_mod.lm_init(g, 12, cfg.lm, _dev())
    for p in param_leaves(params):
        p.requires_grad_(True)
    opt = Optimizer(cfg.hparas)
    return cfg.lm, opt, TrainState(params, opt.init(param_leaves(params)), 0)


def _lm_batch(seed, b=4, length=9):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 12, size=(b, length)).astype(np.int32)
    lens = np.array([length, length - 2, 3, 0][:b] + [length] * max(b - 4, 0), np.int32)
    for i, n in enumerate(lens):
        text[i, n:] = 0
    return {"text": torch.from_numpy(text).cuda(), "text_len": torch.from_numpy(lens).cuda()}


def _same_bits(a, b):
    """Bitwise equality that holds for NaNs too (``torch.equal`` is False on them)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.detach().reshape(-1).contiguous().view(torch.uint8), b.detach().reshape(-1).contiguous().view(torch.uint8))


def test_lm_graph_replay_equals_eager_lm_step_bitwise(gen):
    """Five LM steps of one shape through LMGraphs and eagerly, dropout 0.2
    from each step's seed, the third made non-finite (a NaN bias in both
    models, restored after it): loss, grad norm, step_skipped and every
    parameter and optimizer tensor bitwise after each step, the same launch
    counts; the skipped step leaves both models as they were."""
    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.training.lm_graph import LMGraphs

    cfg, og, sg = _small_lm()
    _, oe, se = _small_lm()
    graphs = LMGraphs()
    for i in range(5):
        batch = _lm_batch(i)
        if i == 2:
            saved = sg.params["cells"][0]["b"].detach().clone()
            for st in (sg, se):
                st.params["cells"][0]["b"].data.fill_(float("nan"))
            before = [t.clone() for t in _state_tensors(sg)]
        counts0 = _train_counts()
        mg = train_lm.train_step(sg, og, cfg, batch, _gen_of(50 + i), graphs=graphs)
        got = {k: mg[k].clone() for k in train_lm.SCALARS}
        counts1 = _train_counts()
        me = train_lm.train_step(se, oe, cfg, batch, _gen_of(50 + i))
        counts2 = _train_counts()
        assert all(_same_bits(got[k], me[k]) for k in train_lm.SCALARS), (i, got, me)
        assert _same_bits(mg["scalars"], me["scalars"])
        assert float(got["step_skipped"]) == float(i == 2)
        assert all(_same_bits(a, b) for a, b in zip(_state_tensors(sg), _state_tensors(se))), i
        if i == 2:
            assert all(_same_bits(a, b) for a, b in zip(_state_tensors(sg), before))
            for st in (sg, se):
                st.params["cells"][0]["b"].data.copy_(saved)
        dg = {k: counts1[k] - counts0[k] for k in counts0}
        de = {k: counts2[k] - counts1[k] for k in counts0}
        assert dg == de and de["lstm_seq_fwd.launches"] == de["lstm_seq_bwd.launches"] == 2, (i, dg)
    assert len(graphs.captures) == 1 and sg.step == se.step == 5 and int(sg.opt_state["count"]) == 4


def test_lm_eval_graph_equals_eager(gen):
    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.training.lm_graph import LMEvalGraphs

    cfg, _, state = _small_lm()
    graphs = LMEvalGraphs()

    def ev(b, _=None):
        with torch.no_grad():
            return train_lm.lm_loss(state.params, cfg, b["text"], b["text_len"], None, False)[1]

    for i in range(3):
        batch = _lm_batch(60 + i)
        got = {k: v.clone() for k, v in graphs.eval(cfg, state.params, batch, ev).items()}
        want = ev(batch)
        assert all(torch.equal(got[k], want[k]) for k in ("loss", "n_tokens")), i
    assert len(graphs.captures) == 1


def test_host_launches_of_a_replayed_dev_batch_and_lm_step(gen):
    """The launches the host issues for one dev batch through EvalGraphs
    (its copies into the static buffers and one replay) and for one LM step
    through LMGraphs (the same and the ring's copy), by the profiler: each
    at most HOST_LAUNCH_LIMIT, where the eager ones issue hundreds."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch.bin import train_lm
    from e2e_asr_tpu_torch.bin.profile_decode import host_launches
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
    from e2e_asr_tpu_torch.training.lm_graph import LMGraphs

    trainer, state = _small_train()
    evals = EvalGraphs()
    cfg, opt, lm_state = _small_lm()
    lm_graphs = LMGraphs()
    ring = torch.empty((4, len(train_lm.SCALARS)), device="cuda")

    def dev_batch(eager=False):
        return trainer.validate_batch(state.params, _train_batch(1), EVAL_MAX_STEP, graphs=None if eager else evals)

    def lm_step(eager=False):
        m = train_lm.train_step(lm_state, opt, cfg, _lm_batch(1), _gen_of(1), graphs=None if eager else lm_graphs)
        ring[0].copy_(m["scalars"])

    counted = {}
    for name, fn in (("dev batch", dev_batch), ("LM step", lm_step)):
        fn()  # captures
        for eager in (False, True):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(eager)
                torch.cuda.synchronize()
            counted[name, eager] = host_launches(prof)
    print(counted)
    for name in ("dev batch", "LM step"):
        assert 1 <= counted[name, False] <= HOST_LAUNCH_LIMIT < counted[name, True], counted


_SYNC_IN_EVAL_CAPTURE = """
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("card_tests", "tests/test_torch_cuda.py")
card = importlib.util.module_from_spec(spec)
spec.loader.exec_module(card)
from e2e_asr_tpu_torch.training.step import Trainer
from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
run = Trainer.eval_device
def syncing(self, *args, **kw):
    out = run(self, *args, **kw)
    out["scalars"].tolist()  # a host synchronisation: illegal while capturing
    return out
Trainer.eval_device = syncing
trainer, state = card._small_train()
try:
    trainer.validate_batch(state.params, card._train_batch(0), 5, graphs=EvalGraphs())
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:200])
    sys.exit(0)
print("NO ERROR")
"""


def test_a_failing_eval_capture_raises(gen):
    """A validation that synchronises with the host cannot be captured: it
    raises (it does not fall back to the eager validation). In a
    subprocess, since a failed capture may leave the CUDA context
    unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SYNC_IN_EVAL_CAPTURE], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and "RAISED" in res.stdout, res.stdout + res.stderr[-3000:]


@pytest.mark.parametrize("mode", ["teacher", "argmax", "sample"])
def test_scan_seed_in_device_memory(gen, mode):
    """The scan forward with its seed in device memory: a seed given as an
    int (written into a device tensor by the wrapper) and the same seed
    drawn into a tensor give bitwise-equal outputs in each feedback mode;
    where every step uses the teacher, sampling on and off are bitwise
    equal (the noise acts only where a coin failed); sampled feedback feeds
    the tokens the plain version feeds on ``gumbel_noise`` of that seed."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    shape = (16, 61, 300, 640, 10, 201, 320, 320, 26, 6)
    b, s, dk, e_dim, kk, p, h, emb, v, l = shape
    args = _scan_args(gen, *shape)
    use = torch.ones(l, dtype=torch.bool, device="cuda") if mode == "teacher" else \
        torch.zeros(l, dtype=torch.bool, device="cuda")
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda"))
    sample = mode != "argmax"
    as_int = dc.decoder_scan_fwd(*args, use, 0.5, sample, seed)
    as_tensor = dc.decoder_scan_fwd(*args, use, 0.5, sample,
                                    torch.full((1,), seed, dtype=torch.int64, device="cuda"))
    for g, w in zip((*as_int[:3], *as_int[3]), (*as_tensor[:3], *as_tensor[3])):
        assert torch.equal(g, w)
    if mode == "teacher":
        off = dc.decoder_scan_fwd(*args, use, 0.5, False, 0)
        for g, w in zip((*as_int[:3], *as_int[3]), (*off[:3], *off[3])):
            assert torch.equal(g, w)
    if mode == "sample":
        want = dc.decoder_scan_fwd_plain(*args, use.cpu(), 0.5, True, dc.gumbel_noise(seed, l, b, v, "cuda"))
        assert torch.equal(as_int[3][1], want[3][1])
    with pytest.raises(ValueError, match="seed"):
        dc.decoder_scan_fwd(*args, use, 0.5, True, torch.zeros(2, dtype=torch.int64, device="cuda"))


def test_device_bias_corrections_and_lr_on_the_card(gen):
    """The optimizer's device formulas on the card against the host
    formulas over counts 1..10^5: bitwise."""
    from e2e_asr_tpu_torch.config import HparasConfig
    from e2e_asr_tpu_torch.optim import _bias_correction, bias_correction, build_schedule, device_lr

    counts = torch.arange(1, 100_001, dtype=torch.int32, device="cuda")
    for decay in (0.9, 0.999):
        got = bias_correction(decay, counts).cpu().numpy()
        want = np.array([_bias_correction(decay, c) for c in range(1, 100_001)], np.float32)
        assert np.array_equal(got, want), (decay, np.nonzero(got != want)[0][:5] + 1)
    h = HparasConfig(lr_scheduler="warmup", lr=1.0, warmup_step=25000)
    sched = build_schedule(h)
    got = device_lr(h, counts).cpu().numpy()
    want = np.array([sched(c) for c in range(1, 100_001)], np.float32)
    assert np.array_equal(got, want), np.nonzero(got != want)[0][:5] + 1


# ------------------------------------------------------------ data parallelism
def _ddp_train_yaml(tmp_path, dropout=0.0):
    """A small training recipe on the synthetic corpus for the data-parallel
    checks (parallel/mp_worker.py): the flagship's structure at test size,
    the fused scan (speller dropout 0), SpecAugment, encoder dropout
    ``dropout``, 3 steps of 4 rows, validations at 2 and 3."""
    from e2e_asr_tpu_torch.config import Config

    cfg = Config.from_dict({
        "data": {"corpus": {"name": "synthetic", "train_split": ["train:8"], "dev_split": ["dev:4"], "test_split": [],
                            "batch_size": 4, "buckets": [416], "token_buckets": [48], "half_batch_len": 1000,
                            "num_workers": 0},
                 "audio": {"feat_dim": 40, "use_pallas": True}, "text": {"mode": "character"}},
        "hparas": {"max_step": 3, "valid_step": 2, "log_step": 1, "optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                   "grad_clip": 5.0, "curriculum": 0, "tf_start": 1.0, "tf_end": 0.5, "tf_step": 2},
        "model": {
            "ctc_weight": 0.5,
            "encoder": {"prenet": "vgg", "dim": [32, 32], "dropout": [dropout, dropout], "layer_norm": [False, False],
                        "proj": [True, True], "sample_rate": [1, 1], "sample_style": "drop"},
            "attention": {"mode": "location", "dim": 16, "num_head": 1, "loc_kernel_size": 5, "loc_kernel_num": 3},
            "decoder": {"dim": 32, "layer": 1},
            "specaugment": {"enable": True, "freq_mask_width": 5, "time_mask_width": 10},
        },
        "decode": {"beam_size": 2, "batch_size": 2, "ctc_weight": 0.3, "max_len_ratio": 0.3},
    })
    path = tmp_path / "ddp_train.yaml"
    cfg.save(path)
    return str(path), cfg


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_world1_nccl_group_step_validation_decode_and_lm_are_bitwise(gen, tmp_path):
    """In an NCCL group of one (the collectives captured in the step graphs,
    the validation's sums all-reduced, the LM step's flat buffer) training
    with its validations at float32 and bf16, the decode and the LM trainer
    give the bits of the same runs without a group."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.data.dataset import load_dataset
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.parallel import mp_worker

    path, cfg = _ddp_train_yaml(tmp_path)
    _, _, feat_dim, vocab, _, _ = load_dataset(cfg.data, num_workers=0)
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, asr_mod.asr_init(0, feat_dim, vocab, cfg.model, torch.device("cpu"))[0], vocab,
                            feat_dim)
    spec = {"config": path, "ckpt": ckpt, "dir": str(tmp_path / "runs"), "device": "cuda",
            "modes": ["train", "decode"], "dtypes": ["float32", "bfloat16"], "out": str(tmp_path / "w1.pt")}
    mp_worker.run("world1", spec, 1, str(tmp_path / "w1"), 600, cwd=_root())
    res = torch.load(spec["out"], weights_only=False)
    assert set(res) == {"train_float32", "train_bfloat16", "decode"}
    for run, r in res.items():
        assert all(r["same"].values()), (run, r["same"])
    assert res["train_float32"]["with"]["train_graphs"] and res["train_bfloat16"]["with"]["train_graphs"]
    lm = Config.from_dict({"data": {"corpus": {"name": "synthetic", "train_split": ["train:16"], "dev_split": ["dev:4"]},
                                    "text": {"mode": "character"}},
                           "hparas": {"max_step": 4, "valid_step": 2, "log_step": 1, "optimizer": "Adam", "lr": 1e-3},
                           "lm": {"emb_dim": 16, "dim": 24, "n_layers": 2, "batch_size": 4, "dropout": 0.2}})
    lm.save(tmp_path / "lm.yaml")
    spec = {"config": str(tmp_path / "lm.yaml"), "dir": str(tmp_path / "lmruns"), "device": "cuda", "modes": ["lm"],
            "out": str(tmp_path / "w1lm.pt")}
    mp_worker.run("world1", spec, 1, str(tmp_path / "w1lm"), 600, cwd=_root())
    r = torch.load(spec["out"], weights_only=False)["lm"]
    assert all(r["same"].values()) and r["with"]["graphs"], r["same"]


def test_two_gloo_ranks_on_one_card_give_the_global_step(gen, tmp_path):
    """Two gloo ranks sharing the card (the step eager: gloo cannot be
    captured) take one step with dropout and SpecAugment on their row
    blocks: the one-rank step on the global batch within the
    kernel-versus-plain tolerances, the ranks' parameters bitwise equal."""
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.parallel import mp_worker
    from e2e_asr_tpu_torch.training.step import Trainer

    path, cfg = _ddp_train_yaml(tmp_path, dropout=0.2)
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, asr_mod.asr_init(0, 40, 12, cfg.model, torch.device("cpu"))[0], 12, 40)
    batch = {k: v.cpu().numpy() for k, v in _train_batch(3, frames=(64, 52, 24, 40), text_len=(8, 6, 5, 2)).items()}
    np.savez(tmp_path / "batch.npz", **batch)
    spec = {"config": path, "params": ckpt, "batch": str(tmp_path / "batch.npz"), "seed": 3, "device": "cuda",
            "backend": "gloo", "dtypes": ["float32", "bfloat16"], "out": str(tmp_path / "step")}
    mp_worker.run("step", spec, 2, str(tmp_path / "step_log"), 600, local_rank_zero=True, cwd=_root())
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    dbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for dtype, p_tol in (("float32", 1e-5), ("bfloat16", 1e-4)):
        cfg.hparas.dtype = dtype
        trainer = Trainer(cfg)
        one = mp_worker.step_result(trainer, trainer.init_state(convert.load_checkpoint(ckpt, torch.device("cuda"))
                                                                ["params"]), dbatch, 3, torch.device("cuda"))
        got = ranks[0][dtype]
        assert all(torch.equal(a, b) for a, b in zip(got["params"], ranks[1][dtype]["params"]))
        assert abs(float(got["loss"]) - float(one["loss"])) <= 1e-4 * abs(float(one["loss"]))
        assert abs(float(got["grad_norm"]) - float(one["grad_norm"])) <= 1e-3 * abs(float(one["grad_norm"]))
        assert max(float((a - b).abs().max()) for a, b in zip(got["params"], one["params"])) <= p_tol


def test_two_card_nccl_gradients_are_the_global_batch_gradients(gen, tmp_path):
    """On two cards (NCCL), the loss and gradients of the global batch
    summed over the ranks equal one card's on the whole batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from e2e_asr_tpu_torch import convert
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.parallel import mp_worker
    from e2e_asr_tpu_torch.training.step import compute_loss, param_leaves

    path, cfg = _ddp_train_yaml(tmp_path)
    params, _ = asr_mod.asr_init(0, 40, 12, cfg.model, torch.device("cuda"))
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, params, 12, 40)
    batch = {k: v.cpu().numpy() for k, v in _train_batch(5, frames=(64, 52, 24, 40), text_len=(8, 6, 5, 2)).items()}
    np.savez(tmp_path / "batch.npz", **batch)
    spec = {"config": path, "params": ckpt, "batch": str(tmp_path / "batch.npz"), "device": "cuda",
            "out": str(tmp_path / "grads.npz")}
    mp_worker.run("grads", spec, 2, str(tmp_path / "grads_log"), 600, cwd=_root())
    got = np.load(tmp_path / "grads.npz")
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    loss, _ = compute_loss(params, cfg, b["wav"], b["wav_len"], b["text"], b["text_len"], 1.0, None, train=False)
    want = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, leaves)]).cpu().numpy()
    np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(got["grads"], want, rtol=1e-4, atol=1e-6)


def test_scan_gumbel_noise_at_a_row_offset(gen):
    """A rank's rows draw the global batch's Gumbel noise: ``gumbel_noise``
    at ``row0`` is rows row0.. of the full batch's bit for bit, and the scan
    forward with sampled feedback on rows 8-15 at ``row0`` 8 feeds back the
    tokens the plain version feeds on that noise."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    seed = 123456789
    full = dc.gumbel_noise(seed, 6, 16, 26, "cuda")
    assert torch.equal(dc.gumbel_noise(seed, 6, 8, 26, "cuda", row0=8), full[:, 8:])
    assert not torch.equal(dc.gumbel_noise(seed, 6, 8, 26, "cuda"), full[:, 8:])
    shape = (8, 61, 300, 640, 10, 201, 320, 320, 26, 6)
    args = _scan_args(gen, *shape)
    use = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
    got = dc.decoder_scan_fwd(*args, use, 0.5, True, seed, row0=8)
    want = dc.decoder_scan_fwd_plain(*args, use.cpu(), 0.5, True, full[:, 8:])
    assert torch.equal(got[3][1], want[3][1])


# ----------------------------------------------- configs/libri/asr_960h.yaml
# The recipe's speller at its widths (Dk 300, E = 2 x 512, 10 x 201 taps,
# H 512 = the scan kernels' MAX_H, a 512-wide embedding, the character
# vocabulary): (B, S, Dk, E, K, P, H, Emb, V, L) of its 416-frame bucket at
# B = 32 and of its 3056-frame bucket at the half-batch rule's B = 16, the
# scan's longest S (764) and L (520).
SCAN_960H = {"416": (32, 104, 300, 1024, 10, 201, 512, 512, 30, 160),
             "3056": (16, 764, 300, 1024, 10, 201, 512, 512, 30, 520)}


def _bf16_carried(got, want):
    """A float32 output computed from a bf16 recurrence's state (the scan's
    residuals and gradients over 160 or 520 steps): within the flagship
    tests' scaled rtol 1e-3 but on at most BF16_SHARE of its elements, and
    within BF16_ULPS bf16 ulp of the tensor's scale on all of them. A
    rounding of the bf16 state that the two versions take apart carries
    into every later step's float32 products by about an ulp of the state;
    over the flagship tests' 6 steps no element goes past 1e-3, over a
    recipe's L a few do."""
    from chip_smoke import BF16_SHARE, BF16_ULPS

    assert got.dtype == want.dtype == torch.float32
    scale = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -126))) - 7)
    diff = (got - want).abs()
    assert float(diff.max()) <= BF16_ULPS * ulp
    assert float((diff > 1e-3 * (scale + want.abs())).float().mean()) <= BF16_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bucket", ["416", "3056"])
def test_recipe_960h_scan_kernels(gen, bucket, dtype):
    """The scan pair at asr_960h.yaml's shapes: a grid of clusters fits
    (``scan_grid`` raises where none does) and each kernel holds against its
    plain version, teacher-forced: float32 at rtol 1e-4 (scaled for the
    backward), as at the flagship's widths; bf16 outputs by ``_bf16_close``,
    the float32 residuals and gradients of the bf16 variants by
    ``_bf16_carried``."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    shape = SCAN_960H[bucket]
    b, s, dk, e_dim, kk, p, h, emb, v, l = shape
    dt = getattr(torch, dtype)
    for which in ("fwd", "bwd"):
        grid = dc.scan_grid(which, b, s, dk, e_dim, kk, p, h, v, dtype=dt)
        assert grid["smem"] <= dc.SMEM_MAX and grid["clusters"] >= 1
    args = tuple(a.to(dt) if a.is_floating_point() else a for a in _scan_args(gen, *shape))
    use = torch.ones(l, dtype=torch.bool)
    got = dc.decoder_scan_fwd(*args, use, 0.5)
    want = dc.decoder_scan_fwd_plain(*args, use, 0.5)
    if dt == torch.float32:
        for g, w in zip((*got[:3], got[3][0], *got[3][2:]), (*want[:3], want[3][0], *want[3][2:])):
            _close(g, w, rtol=1e-4, atol=1e-4)
    else:
        for g, w in zip(list(got[:3]) + [got[3][0]], list(want[:3]) + [want[3][0]]):
            _bf16_close(g, w)
        for g, w in zip(got[3][2:], want[3][2:]):
            _bf16_carried(g, w)
    logits, align, hidden, (cseq, _, acts, qs, ctxs) = want
    k, vv, lens, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = args
    cots = [torch.randn(o.shape, generator=gen, device="cuda").to(dt) for o in (logits, align, hidden)]
    if dt == torch.bfloat16:
        ctxs = torch.einsum("lbs,bse->lbe", align.float(), vv.float())
    bargs = (k, vv, lens, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctxs, *cots, 0.5)
    for g, w in zip(dc.decoder_scan_bwd(*bargs), dc.decoder_scan_bwd_plain(*bargs)):
        if dt == torch.float32:
            _close_scaled(g, w, 1e-4)
        else:
            _bf16_carried(g, w)


@pytest.mark.parametrize("s,lens", [(104, [104, 1, 80] + [104 - 3 * i for i in range(13)]),
                                    (764, [764, 400, 1] + [764 - 50 * i for i in range(13)])])
def test_recipe_960h_att_step_kernel(gen, s, lens):
    """The beam attention step at asr_960h.yaml's decode (B 16, beam 16, Dk
    300, E = 1024, 10 x 201 taps) over its 416-frame bucket's 104 encoder
    frames and the longest bucket's 764: a layout fits and the kernel holds
    against its plain version (the flagship's tolerances)."""
    args = _att_args(gen, 16, 16, s, 300, 1024, lens, kk=10, p=201)
    p = asc.plan(16, 16, s, 300, 1024, 10, 201)
    assert p["blocks"] >= 1 and p["group"] >= 1
    before = asc.att_step_beam_loc.launches
    got, want = asc.att_step_beam_loc(*args), asc.att_step_beam_loc_plain(*args)
    assert asc.att_step_beam_loc.launches == before + -(-16 // p["group"])
    _close(got[0], want[0], rtol=1e-4, atol=1e-6)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,lens", [(16, 104, [104, 1, 80] + [104 - 3 * i for i in range(13)]),
                                      (16, 764, [764, 400, 1] + [764 - 50 * i for i in range(13)]),
                                      (1, 764, [764])])
def test_espnet_att_step_kernel(gen, b, s, lens):
    """The beam attention step at the ESPnet recipe's widths (beam 16, Dk =
    E = 1024, 10 x 201 taps): a k tile of 48 frames x Dk beside 16 rows of q
    does not fit, so the layout takes fewer frames a tile, and the kernel
    holds against its plain version (the flagship's tolerances)."""
    args = _att_args(gen, b, 16, s, 1024, 1024, lens, kk=10, p=201)
    p = asc.plan(b, 16, s, 1024, 1024, 10, 201)
    assert p["blocks"] >= 1 and p["group"] >= 1
    before = asc.att_step_beam_loc.launches
    got, want = asc.att_step_beam_loc(*args), asc.att_step_beam_loc_plain(*args)
    assert asc.att_step_beam_loc.launches == before + -(-b // p["group"])
    _close(got[0], want[0], rtol=1e-4, atol=1e-6)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [1280, 1024])
def test_recipe_960h_bf16_lstm_layer(gen, d):
    """A BiLSTM layer of asr_960h.yaml (H = 512; D 1280 after the VGG prenet,
    1024 after a layer) by either kernel pair in bf16, the recipe's dtype,
    against the plain versions; the backward's sweep holds Wh at H = 512."""
    bf = torch.bfloat16
    b, t, h = 8, 40, 512
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lens[0] = t
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    bound = 1 / math.sqrt(h)
    x = torch.tanh(torch.randn((t, b, d), generator=gen, device="cuda")).to(bf)
    wx, wh = ((torch.rand(sh, generator=gen, device="cuda") * 2 - 1).mul(bound).to(bf)
              for sh in ((2, d, 4 * h), (2, h, 4 * h)))
    bias = ((torch.rand((2, 4 * h), generator=gen, device="cuda") * 2 - 1) * bound).to(bf)
    want = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, bias)
    for g, w in zip(rnn_cuda.lstm_bidir_fwd_train(x, mask, wx, wh, bias), want):
        _bf16_close(g, w)
    ys, c, acts = want
    dy = torch.randn(ys.shape, generator=gen, device="cuda").to(bf)
    for g, w in zip(rnn_cuda.lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy),
                    rnn_cuda.lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)):
        _bf16_close(g, w)
    xw = (x.float().transpose(0, 1) @ wx[0].float()).transpose(0, 1).to(bf).repeat(1, 2, 1).contiguous()
    m2 = mask.repeat(1, 2)
    got = rnn_cuda.lstm_seq_fwd(xw, m2, wh, train=True)
    want = rnn_cuda.lstm_seq_fwd_plain(xw, m2, wh)
    for g, w in zip(got[:2], want[:2]):
        _bf16_close(g, w)
    ys, c, acts = want
    dy = torch.randn(ys.shape, generator=gen, device="cuda").to(bf)
    for g, w in zip(rnn_cuda.lstm_seq_bwd(m2, wh, ys, c, acts, dy), rnn_cuda.lstm_seq_bwd_plain(m2, wh, ys, c, acts, dy)):
        _bf16_close(g, w)


_DEAD_GRAPH_CAPTURE = """
import gc, sys, torch
from e2e_asr_tpu_torch.device import graph_capture

def dead():  # a captured graph and its pool's tensor in a cycle: only the collector frees them
    x = torch.zeros(1 << 20, device="cuda")
    g = torch.cuda.CUDAGraph()
    with graph_capture(g):
        z = x * 2
    d = {"graph": g, "x": x, "z": z}
    d["self"] = d

gc.disable()  # no automatic collection: the cycle lives until one is asked for
dead()
y = torch.zeros(8, device="cuda")
g = torch.cuda.CUDAGraph()
bare = sys.argv[1] == "bare"
with (torch.cuda.graph(g, capture_error_mode="thread_local") if bare else graph_capture(g)):
    y.add_(1)
    assert bare or not gc.isenabled()
    gc.collect()  # a collection inside the capture: the dead graph's, if it still lives
    y.add_(1)
g.replay()
torch.cuda.synchronize()
print("value", float(y[0]))
"""


@pytest.mark.parametrize("how", ["graph_capture", "bare"])
def test_dead_graphs_are_collected_before_a_capture_not_in_it(gen, how, tmp_path):
    """A cycle that holds a captured graph (an old solver's cache) and dies
    before a new capture, and a collection inside that capture (the
    collector runs wherever allocations take it): ``device.graph_capture``
    (every capture site of the port goes through it) freed the cycle before
    the capture and holds the automatic collector off inside it, so the
    capture replays; under a bare ``torch.cuda.graph`` the collection frees
    the dead graph inside the capture, whose reset invalidates it (run in
    a subprocess)."""
    import os
    import subprocess
    import sys

    script = tmp_path / "capture.py"
    script.write_text(_DEAD_GRAPH_CAPTURE)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script), how], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": root})
    if how == "graph_capture":
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "value 2.0" in proc.stdout
    else:
        assert proc.returncode != 0 and "capture" in proc.stderr, proc.stdout + proc.stderr[-2000:]


# ------------------------------ encoder and speller variants, the plugin
VARIANT_OVERRIDES = {
    # CNN prenet, bidirectional GRU layers, GRU speller (the Python loop)
    "V1": {"encoder": {"prenet": "cnn", "module": "GRU"}, "decoder": {"module": "GRU"}},
    # VGG prenet, one-direction LSTM layers (lstm_seq with one direction), the
    # fused scan with the embedding regularizer's loss
    "V2": {"encoder": {"bidirection": False}, "emb_reg": {"enable": True, "weight": 0.5, "fuse": 0.0}},
    # V2 with fused decoding: the speller takes the loop
    "V2-fuse": {"encoder": {"bidirection": False}, "emb_reg": {"enable": True, "weight": 0.5, "fuse": 0.3}},
}


def _variant_train(name, dtype="float32", **hparas):
    """``_small_train``'s model and recipe with a variant's overrides."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import Trainer

    trainer, _ = _small_train(dtype, **hparas)
    cfg = trainer.cfg
    for section, fields in VARIANT_OVERRIDES[name].items():
        for k, v in fields.items():
            setattr(getattr(cfg.model, section), k, v)
    params, _ = asr_mod.asr_init(0, 40, 12, cfg.model, _dev())
    trainer = Trainer(cfg)
    return trainer, trainer.init_state(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["V1", "V2", "V2-fuse"])
def test_variant_train_graph_replay_equals_eager_step_bitwise(gen, name, dtype):
    """Four steps of a variant through TrainGraphs and eagerly from the same
    weights, batches and seeds, the rate falling below 1 from the second
    step on (V1 and V2-fuse: the Python-loop speller captured, its coins and
    sampled feedback on the card): metrics, every parameter and optimizer
    tensor bitwise, the same launch counts (V2: the lstm_seq and scan pairs
    launched; V1 and V2-fuse: no scan launch)."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    tg, sg = _variant_train(name, dtype)
    te, se = _variant_train(name, dtype)
    route = asr_mod.speller_route(sg.params, tg.cfg.model, True, _dev())
    assert route == ("fused" if name == "V2" else "loop")
    graphs = TrainGraphs()
    for i in range(4):
        batch = _train_batch(i)
        counts0 = _train_counts()
        mg = tg.train_step(sg, batch, _gen_of(200 + i), graphs=graphs)
        got = {k: mg[k].clone() for k in ("loss", "grad_norm", "step_skipped", "tf_rate")}
        counts1 = _train_counts()
        me = te.train_step(se, batch, _gen_of(200 + i))
        counts2 = _train_counts()
        assert all(torch.equal(got[k], me[k]) for k in got), (i, got, me)
        assert float(got["step_skipped"]) == 0.0 and bool(torch.isfinite(got["loss"]))
        assert all(torch.equal(a, b) for a, b in zip(_state_tensors(sg), _state_tensors(se))), i
        dg = {k: counts1[k] - counts0[k] for k in counts0 if counts1[k] - counts0[k]}
        de = {k: counts2[k] - counts1[k] for k in counts0 if counts2[k] - counts1[k]}
        assert dg == de, (i, dg, de)
        scan = [k for k in dg if k.startswith("decoder_scan")]
        assert bool(scan) == (name == "V2"), dg
        if name == "V2":
            assert any(k.startswith("lstm_seq_bwd") for k in dg), dg
    assert len(graphs.captures) == 1


@pytest.mark.parametrize("name", ["V1", "V2"])
def test_variant_kernel_step_matches_plain_step(gen, name):
    """One float32 train step of a variant with the kernels against one with
    the plain versions (``cuda_build.use_plain``) from the same weights,
    batch and seed: loss rtol 1e-5, grad norm rtol 1e-4, every updated
    parameter within 1e-5. Adadelta, as the flagship recipe: Adam's first
    step moves every parameter by +-lr, its sign the gradient's rounding
    where the gradient is near zero."""
    from contextlib import nullcontext

    from e2e_asr_tpu_torch.training.step import param_leaves

    res = {}
    for mode in ("kernel", "plain"):
        trainer, state = _variant_train(name, optimizer="Adadelta", lr=1.0, lr_scheduler="fixed")
        ctx = mock.patch.object(cuda_build, "use_plain", lambda x: True) if mode == "plain" else nullcontext()
        with ctx:
            m = trainer.train_step(state, _train_batch(3), _gen_of(7))
        res[mode] = (float(m["loss"]), float(m["grad_norm"]), [p.detach().clone() for p in param_leaves(state.params)])
    (lk, gk, pk), (lp, gp, pp) = res["kernel"], res["plain"]
    np.testing.assert_allclose(lk, lp, rtol=1e-5)
    np.testing.assert_allclose(gk, gp, rtol=1e-4)
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-5


@pytest.mark.parametrize("name", ["flagship", "V1"])
def test_eval_graph_replay_keeps_the_alignment_bitwise(gen, name):
    """The first dev batch's validation (``keep_align``): capture and replay
    against the eager ``eval_device``, every output bitwise, the alignment
    [B, max_step, heads, S] among them; its graph is keyed apart from the
    other batches' (V1: the Python-loop speller in the graph)."""
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs

    trainer, state = _small_train() if name == "flagship" else _variant_train(name)
    graphs = EvalGraphs()
    for i in range(2):
        batch = _train_batch(10 + i)
        got = _eval_outputs(trainer.validate_batch(state.params, batch, EVAL_MAX_STEP, graphs=graphs,
                                                   keep_align=True))
        want = trainer.eval_device(state.params, batch, EVAL_MAX_STEP, keep_align=True)
        assert set(got) == set(want) and "align" in want and want["align"].shape[:2] == (3, EVAL_MAX_STEP)
        assert all(torch.equal(got[k], want[k]) for k in want), i
    trainer.validate_batch(state.params, _train_batch(12), EVAL_MAX_STEP, graphs=graphs)
    assert len(graphs.captures) == 2  # with and without the alignment


# ------------------------------------------------------- the stage programs
STAGE_SHAPE = (4, 208, 32, 26)  # B, bucket frames, tokens, vocabulary: the flagship's widths, small


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_measure_stages_on_the_card_within_their_ceilings(gen, dtype):
    """``measure_stages`` at the flagship's widths and a small bucket (B 4,
    208 frames, L 32): every stage program captured and its replays timed,
    each time finite and positive and at or above its ceiling (sol at most
    1.05: a ceiling above the measured time is a wrong count), and each
    program's replay launches its kernels in the compute type's variant
    (log_mel and ctc_loss float32 at either)."""
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.utils import stages

    cfg = Config.load("configs/libri/asr_example.yaml")
    launches = {}
    got = stages.measure_stages(cfg, *STAGE_SHAPE, iters=2, dtype=dtype, launches=launches)
    ceil = stages.stage_ceilings(cfg, *STAGE_SHAPE, dtype)
    assert set(got) == set(stages.MEASURED)
    for k, s in got.items():
        assert math.isfinite(s) and s > 0, (k, s)
        assert ceil[k]["ceiling_ms"] / (s * 1e3) <= 1.05, (k, ceil[k], s)
    sfx = "_bf16" if dtype == "bfloat16" else ""
    want = {"frontend_fwd": ["log_mel"], "encoder_fb": ["lstm_seq_fwd" + sfx, "lstm_seq_bwd" + sfx],
            "ctc_fb": ["ctc_lattice"], "decoder_fb": ["decoder_scan_fwd" + sfx, "decoder_scan_bwd" + sfx],
            "optimizer": []}
    for k, names in want.items():
        assert all(launches[k].get(n, 0) > 0 for n in names), (k, launches[k])


def test_stage_programs_on_the_card_launch_their_kernels(gen):
    """Each stage program captured as ``measure_stages`` captures it and
    replayed launches its kernels, counted by the wrappers' launch counters
    (the features: log_mel; the encoder under rnn_impl auto: the lstm_seq
    pair; the CTC objective: ctc_loss; the speller: the scan pair), and a
    replay's value is the eager run's."""
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc
    from e2e_asr_tpu_torch.training.step_graph import Captured
    from e2e_asr_tpu_torch.utils import stages

    dev = torch.device("cuda")
    cfg = Config.load("configs/libri/asr_example.yaml")
    b, frames, l_tok, vocab = STAGE_SHAPE
    params, _ = asr_mod.asr_init(0, 40, vocab, cfg.model, dev)
    programs = stages.stage_programs(cfg, params, stages.stage_inputs(cfg, b, frames, l_tok, vocab), "float32", dev)
    expect = {"frontend_fwd": [fec.log_mel], "encoder_fb": [rnn_cuda.lstm_seq_fwd, rnn_cuda.lstm_seq_bwd],
              "ctc_fb": [ctc_cuda.ctc_lattice], "decoder_fb": [dc.decoder_scan_fwd, dc.decoder_scan_bwd]}
    stream = torch.cuda.Stream()
    for name, fns in expect.items():
        fn, batch = programs[name]
        eager_gen = torch.Generator(device=dev)
        eager_gen.manual_seed(0)
        want = float(fn(batch, eager_gen))
        g = Captured(batch, list(batch), stream)
        g.capture(fn, 0)
        before = [f.launches for f in fns]
        got = float(g.replay(0))
        assert all(f.launches > n for f, n in zip(fns, before)), (name, before)
        assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-5), (name, got, want)


# ---------------------------------------------------------------- stage marks (utils/tracing.py)
def _sections(bank="untraced"):
    from e2e_asr_tpu_torch.utils import tracing

    return {k: (v["n"], v["total_ms"]) for k, v in tracing.snapshot(bank)["sections"].items()}


def _added(before, after, prefix):
    """{section: intervals added} of the sections starting with ``prefix``."""
    return {k: n - before.get(k, (0, 0.0))[0] for k, (n, _) in after.items()
            if k.startswith(prefix) and n > before.get(k, (0, 0.0))[0]}


def test_stage_marks_leave_the_train_replay_bitwise(gen):
    """Four steps of one bucket through TrainGraphs captured with the stage
    marks and through TrainGraphs captured without (``set_marks(False)``),
    from the same weights, batches and seeds: loss, grad norm and every
    parameter and optimizer tensor bitwise equal after each step. The
    marked replays add one interval a replay to each stage and one to the
    gap between steps from the second replay on; the unmarked ones add
    none."""
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs
    from e2e_asr_tpu_torch.utils import tracing

    tm, sm = _small_train()
    tu, su = _small_train()
    marked, unmarked = TrainGraphs(), TrainGraphs()
    s0 = _sections()
    for i in range(4):
        batch = _train_batch(i)
        mm = tm.train_step(sm, batch, _gen_of(100 + i), graphs=marked)
        got = [mm[k].clone() for k in ("loss", "grad_norm")]
        s1 = _sections()
        tracing.set_marks(False)
        try:
            mu = tu.train_step(su, batch, _gen_of(100 + i), graphs=unmarked)
        finally:
            tracing.set_marks(True)
        assert _sections() == s1, i
        assert all(torch.equal(a, mu[k]) for a, k in zip(got, ("loss", "grad_norm"))), i
        assert all(torch.equal(a, b) for a, b in zip(_state_tensors(sm), _state_tensors(su))), i
    stages = ("features", "encoder", "heads", "backward", "optimizer")
    assert _added(s0, _sections(), "train.") == {**{f"train.{k}": 3 for k in stages}, "train.between_steps": 2}


@pytest.mark.parametrize("lm", [False, True], ids=["no-lm", "lm"])
def test_stage_marks_leave_the_decode_bitwise(gen, lm):
    """Two batches of one shape decoded through a BeamGraphs cache captured
    with the beam step's marks and one captured without: tokens, lengths
    and scores bitwise equal. The marked decode adds a speller and search
    interval a replayed step, two LM intervals (its step, its state's
    writes) only with an LM, one gap
    between batches (the second batch's step 0) and the gaps between the
    steps that follow a replayed step."""
    from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs
    from e2e_asr_tpu_torch.utils import tracing

    setup = _small_decode(lm)
    marked, unmarked = BeamGraphs(), BeamGraphs()
    s0 = _sections()
    for i in range(2):
        feat, feat_len = _small_feats(gen)
        got = _decode(setup, feat, feat_len, graph_cache=marked)
        tracing.set_marks(False)
        try:
            want = _decode(setup, feat, feat_len, graph_cache=unmarked)
        finally:
            tracing.set_marks(True)
        for name, x, y in zip(("tokens", "lengths", "scores"), got, want):
            assert torch.equal(x, y), (i, name)
    replays = 11 + 12  # the capturing batch replays steps 1-11, the second all 12
    want = {"beam.speller": replays, "beam.search": replays, "beam.between_batches": 1,
            "beam.between_steps": replays - 2}
    if lm:
        want["beam.lm"] = 2 * replays
    assert _added(s0, _sections(), "beam.") == want


def test_train_sections_sum_to_the_replays_device_time(gen):
    """Ten replays of a captured train step queued behind a spin of the
    card, each between CUDA events: the stages' device time (the marked
    sections but the gap between steps) is within 3% of the events'."""
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs
    from e2e_asr_tpu_torch.utils import profiling

    trainer, state = _small_train()
    graphs = TrainGraphs()
    batch = _train_batch(0, frames=(400, 320, 240), text_len=(40, 30, 20), l_pad=48)
    for i in range(2):
        trainer.train_step(state, batch, _gen_of(i), graphs=graphs)
    (g,) = graphs.graphs.values()
    torch.cuda.synchronize()
    s0 = _sections()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(10)]
    torch.cuda._sleep(profiling.SPIN_CYCLES_PER_CALL * 40)
    for a, b in ev:
        a.record()
        g.replay(7)
        b.record()
    torch.cuda.synchronize()
    events_ms = sum(a.elapsed_time(b) for a, b in ev)
    s1 = _sections()
    stages_ms = sum(ms - s0.get(k, (0, 0.0))[1] for k, (n, ms) in s1.items()
                    if k.startswith("train.") and k != "train.between_steps")
    assert abs(stages_ms - events_ms) <= 0.03 * events_ms, (stages_ms, events_ms)
    assert _added(s0, s1, "train.")["train.optimizer"] == 10


def test_an_interval_across_a_capture_or_a_profiler_is_dropped(gen):
    """Two buckets, each captured (its eager step, then the capture) and
    replayed twice: the interval from the first bucket's last replay across
    the second's capture is not counted (two gaps between steps, not
    three). Two replays under torch.profiler count in the traced bank, the
    interval into the recording dropped; after it the untraced bank counts
    again, the interval out of it dropped."""
    from torch.profiler import ProfilerActivity, profile

    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs
    from e2e_asr_tpu_torch.utils import tracing

    trainer, state = _small_train()
    graphs = TrainGraphs()
    u0, t0 = _sections(), _sections("traced")
    captures = tracing.counted("graph.captures")
    for frames in ((64, 52, 24), (80, 52, 24)):
        for i in range(3):
            trainer.train_step(state, _train_batch(i, frames=frames), _gen_of(i), graphs=graphs)
    assert tracing.counted("graph.captures") == captures + 2
    u1 = _sections()
    assert _added(u0, u1, "train.")["train.features"] == 4
    assert _added(u0, u1, "train.")["train.between_steps"] == 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(2):
            trainer.train_step(state, _train_batch(i, frames=(80, 52, 24)), _gen_of(i), graphs=graphs)
        torch.cuda.synchronize()
    t1 = _sections("traced")
    assert _sections() == u1
    assert _added(t0, t1, "train.")["train.features"] == 2 and _added(t0, t1, "train.")["train.between_steps"] == 1
    for i in range(2):
        trainer.train_step(state, _train_batch(i, frames=(80, 52, 24)), _gen_of(i), graphs=graphs)
    u2 = _sections()
    assert _sections("traced") == t1
    assert _added(u1, u2, "train.")["train.features"] == 2 and _added(u1, u2, "train.")["train.between_steps"] == 1


_DECODE_TRACE = """
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("card_tests", "tests/test_torch_cuda.py")
card = importlib.util.module_from_spec(spec)
spec.loader.exec_module(card)
from e2e_asr_tpu_torch.bin import test_asr
from e2e_asr_tpu_torch.config import Config
from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs
from e2e_asr_tpu_torch.utils import profiling
params, cfg_model, dcfg, _, _ = card._small_decode(False)
solver = test_asr.Solver.__new__(test_asr.Solver)
solver.config = Config.from_dict({"data": {"audio": {"feat_dim": 40}}})
solver.config.model, solver.config.decode = cfg_model, dcfg
solver.device, solver.params, solver.lm_params, solver.lm_cfg = torch.device("cuda"), params, None, None
solver.beam_graphs = BeamGraphs()
g = torch.Generator(device="cuda")
g.manual_seed(0)
wav = 0.1 * torch.randn((3, 8000), generator=g, device="cuda")
wav_len = torch.tensor([8000, 6400, 4000], device="cuda")
solver.decode_batch(wav, wav_len)  # captures
torch.cuda.synchronize()
with profiling.trace(sys.argv[1], "decode"):
    for _ in range(2):
        solver.decode_batch(wav, wav_len).tokens.cpu()
print("STEPS", solver.max_step_for(8000))
"""


def test_decode_spans_enclose_their_launches_in_a_chrome_trace(gen, tmp_path):
    """``utils/profiling.trace`` around two replayed decode batches through
    ``bin/test_asr``'s ``Solver.decode_batch`` (in a subprocess: a profiler
    session of its own): each batch's ``asr.decode.features``,
    ``.encoder``, ``.steps`` and ``.rank`` lie inside its
    ``asr.decode.batch`` and each encloses CUDA launches (the steps: a graph
    launch a beam step) whose kernels ran after them on the trace's one
    timeline."""
    import json
    import os
    import subprocess
    import sys

    root = _root()
    res = subprocess.run([sys.executable, "-c", _DECODE_TRACE, str(tmp_path)], cwd=root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and "STEPS" in res.stdout, res.stdout + res.stderr[-3000:]
    steps = int(res.stdout.split("STEPS")[1].split()[0])
    events = [e for e in json.load(open(tmp_path / "decode.json"))["traceEvents"] if e.get("ph") == "X"]

    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    spans = [(e["name"][4:], iv(e)) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("asr.decode.")]
    launches = [(e["name"], iv(e)[0], e.get("args", {}).get("correlation")) for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")]
    kernel_ts = {e.get("args", {}).get("correlation"): iv(e)[0] for e in events if e.get("cat") == "kernel"}
    batches = [b for n, b in spans if n == "decode.batch"]
    assert len(batches) == 2
    for a, b in batches:
        for part in ("decode.features", "decode.encoder", "decode.steps", "decode.rank"):
            (s, e), = [v for n, v in spans if n == part and a <= v[0] and v[1] <= b]
            inside = [(name, t, c) for name, t, c in launches if s <= t <= e]
            assert inside, part
            if part == "decode.steps":
                assert sum(name == "cudaGraphLaunch" for name, _, _ in inside) == steps
            assert any(c in kernel_ts and kernel_ts[c] >= t for _, t, c in inside), (
                part, inside[:5], [(c, kernel_ts.get(c)) for _, _, c in inside[:5]])


# ------------------- the scan stops at a training batch's longest label
# (B, S, Dk, E, K, P, H, Emb, V, L): the cells' commonest bucket (1632 frames,
# 360 tokens) at the flagship's widths, the 960 h recipe's longest (3056 / 520)
SCAN_CUT = {"flagship": (8, 408, 300, 640, 10, 201, 320, 320, 26, 360),
            "960h": (16, 764, 300, 1024, 10, 201, 512, 512, 30, 520)}


def _dirty_cache():
    """The caching allocator's free blocks filled with NaN, so that an
    output the kernels leave unwritten shows."""
    torch.empty(1 << 28, device="cuda").fill_(float("nan"))


def _scan_counts():
    from e2e_asr_tpu_torch.utils import tracing

    c = tracing.snapshot("all")["counts"]
    return c.get("scan.steps_run", 0), c.get("scan.bucket_steps", 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", list(SCAN_CUT))
@pytest.mark.parametrize("part", ["one", "half", "all"])
def test_scan_kernels_stop_at_the_steps_run(gen, cell, dtype, part):
    """Both kernels given ``steps`` = n (1, L/2, L), with sampled feedback at
    tf 0.5: every output and residual of the forward, and the backward's
    streams, bitwise the uncut launch's on steps < n and zero past them
    (written over NaN), and through the autograd function the gradients of
    a loss masked past each utterance's label (the longest n) bitwise the
    uncut ones; the device counter adds n, the host counter L."""
    from e2e_asr_tpu_torch.ops import decoder_cuda as dc

    shape = SCAN_CUT[cell]
    b, s, dk, e_dim, kk, p, h, emb, v, l = shape
    n = {"one": 1, "half": l // 2, "all": l}[part]
    dt = getattr(torch, dtype)
    args = _scan_args(gen, *shape)
    stored = tuple(a.to(dt) if a.is_floating_point() else a for a in args)
    use = torch.rand(l, generator=gen, device="cuda") < 0.5
    steps = torch.tensor([n], dtype=torch.int32, device="cuda")
    seed = 20261018
    flat = lambda out: [*out[:3], *out[3]]
    full = flat(dc.decoder_scan_fwd(*stored, use, 0.5, True, seed))
    _dirty_cache()
    c0 = _scan_counts()
    cut = flat(dc.decoder_scan_fwd(*stored, use, 0.5, True, seed, steps=steps))
    assert [a - z for a, z in zip(_scan_counts(), c0)] == [n, l]
    for i, (c, f) in enumerate(zip(cut, full)):
        assert torch.equal(c[:n], f[:n]), i
        assert not c[n:].any(), i

    text_len = torch.randint(0, n + 1, (b,), generator=gen, device="cuda")
    text_len[b // 2] = n
    mask = (torch.arange(l, device="cuda")[:, None] < text_len[None, :]).float()[..., None]
    logits, align, hidden, cseq, _, acts, qs, ctxs = full
    cots = [(torch.randn(o.shape, generator=gen, device="cuda") * mask).to(dt) for o in (logits, align, hidden)]
    k, vv, lens, taps, wq, _, wlp, locv, locb, _, wx, wh, _, wout, _, _ = stored
    if dt == torch.bfloat16:  # as DecoderScanFn passes it
        ctxs = torch.einsum("lbs,bse->lbe", align.float(), vv.float())
    bargs = (k, vv, lens, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctxs, *cots, 0.5)
    bfull = dc.decoder_scan_bwd(*bargs)
    _dirty_cache()
    bcut = dc.decoder_scan_bwd(*bargs, steps=steps)
    for i, (c, f) in enumerate(zip(bcut, bfull)):
        assert torch.equal(c, f), i
    for c in bcut[:3]:
        assert not c[n:].any()

    idx = [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]  # every float input

    def grads(st):
        leaves = [(a.to(dt) if i < 2 else a).clone().requires_grad_() if i in idx else a for i, a in enumerate(args)]
        outs = dc.decoder_scan(*leaves, use, 0.5, True, seed, steps=st)
        return torch.autograd.grad(sum((o.float() * c.float()).sum() for o, c in zip(outs, cots)),
                                   [leaves[i] for i in idx])

    want = grads(None)
    _dirty_cache()
    got = grads(steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), idx[i]


def test_train_graph_replays_each_batchs_longest_label_bitwise(gen):
    """One captured train step (tf 0.5: sampled feedback) replayed on
    batches whose longest labels differ (10, 4, 7 of a 10-token bucket):
    loss, grad norm, every parameter and optimizer tensor bitwise those of
    the eager step that runs all L steps, no new capture, and the device
    counter adds each batch's longest label while the host counter adds L;
    the validation graph's replay runs all L steps."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.eval_graph import EvalGraphs
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    tg, sg = _small_train(tf_start=0.5, tf_end=0.5)
    te, se = _small_train(tf_start=0.5, tf_end=0.5)
    graphs = TrainGraphs()
    real_heads = asr_mod.heads
    for i, text_len in enumerate([(10, 6, 5), (4, 3, 4), (2, 7, 5), (4, 4, 1)]):
        batch = _train_batch(30 + i, text_len=text_len)
        c0 = _scan_counts()
        mg = tg.train_step(sg, batch, _gen_of(200 + i), graphs=graphs)
        got = [mg[k].clone() for k in ("loss", "grad_norm", "step_skipped")]
        assert [a - z for a, z in zip(_scan_counts(), c0)] == [max(text_len), 10], i
        with mock.patch.object(asr_mod, "heads", lambda *a, **kw: real_heads(*a, **{**kw, "steps": None})):
            me = te.train_step(se, batch, _gen_of(200 + i))
        want = [me[k] for k in ("loss", "grad_norm", "step_skipped")]
        assert all(torch.equal(a, w) for a, w in zip(got, want)), (i, got, want)
        assert float(want[2]) == 0.0
        assert all(torch.equal(a, w) for a, w in zip(_state_tensors(sg), _state_tensors(se))), i
    assert len(graphs.graphs) == len(graphs.captures) == 1
    evals = EvalGraphs(share=graphs)
    for i in range(2):
        batch = _train_batch(40 + i, text_len=(3, 2, 2))
        c0 = _scan_counts()
        trainer_out = tg.validate_batch(sg.params, batch, EVAL_MAX_STEP, graphs=evals)
        assert [a - z for a, z in zip(_scan_counts(), c0)] == [10, 10], i
        want = tg.eval_device(sg.params, batch, EVAL_MAX_STEP)
        assert torch.equal(trainer_out["scalars"], want["scalars"]), i
