"""Fused speller scan kernels (csrc/decoder_scan.cu, csrc/decoder_scan_bwd.cu)
beside their plain PyTorch versions, the autograd function that joins
them, and ``run_decode_scan``, the drop-in for the Python loop of
``models/asr.py`` ``forward``.

Replaces the TPU kernel pair ``e2e_asr_tpu/ops/decoder_pallas.py``
``decoder_scan_fused`` (forward and backward). One launch runs all L
teacher-forced / scheduled-sampling speller steps: per step and utterance

    token  = teacher token where the step uses the teacher, else the fed-back
             prediction of the step before (<sos> = 0 before the first)
    emb    = embed[token]
    q      = h Wq + bq
    f      = SAME cross-correlation of the previous alignment with the taps
    energy = locv . tanh(k + q + f Wlp + locb), -1e9 past enc_len
    align  = softmax(energy / temp), exactly 0 past enc_len
    ctx    = align @ v
    h', c' = LSTM cell on [emb, ctx] (i, f, g, o)
    logits = h' Wout + bout
    prediction = argmax(logits [+ Gumbel noise when sampling])

from h = c = 0 and the uniform alignment over the valid frames. locb is
``loc_b + loc_conv.b @ Wlp``, folded by the caller. Unlike the TPU kernel
there is no Toeplitz bank (the taps [K, P] are read directly), no one-hot
product (token ids are gathered) and no padding of V, S or L.

All versions work in time-major layouts: teacher [L, B] int32, logits
[L, B, V], align [L, B, S], hidden [L, B, H]. Besides the three outputs the
forward returns its residuals for the backward: the c sequence, the token
fed at each step, the gate activations [L, B, 4H], q [L, B, Dk] and ctx
[L, B, E] (16 + 4 + 8 MB at the flagship's B=16, L=200; storing them spares
the backward the recompute of the gate product, which the TPU kernel
redoes from (align, hidden, c, token) alone). The tanh energies [S, Dk] per
step are too large to store and are rebuilt in the backward.

Sampled feedback: the kernel draws Gumbel noise from a counter-based
generator (Philox-4x32-10) keyed by (seed, step, utterance, vocabulary
column), the seed an int64 in device memory that the kernel reads at each
step (``run_decode_scan`` draws it on the card from the step's
``torch.Generator`` at every training step; a Python int is written into
such a tensor by the wrapper), so that no launch argument changes from
step to step and a captured step replays with the generator's new draw.
The noise matters only at steps whose coin failed, so a launch in which
every step uses the teacher gives the same outputs with sampling on or off.
``gumbel_noise`` fills a [L, B, V] buffer with exactly that noise so that
the plain version can be fed the same numbers; given no buffer the plain
version draws its noise from the generator itself. Neither reproduces
``jax.random`` nor the Python loop's ``torch.multinomial`` stream: the
distribution is the same (Gumbel-max), the numbers are not. Teacher-forced
and argmax feedback are comparable value for value.

Storage types: k, v, the weights and the outputs logits, align, hidden
and c are float32 or bfloat16, one type a call (each kernel has a variant
of each); the residuals acts, q and ctx and every gradient the backward
kernel returns are float32. At bfloat16 the rounding points are the TPU
kernel's: every product and the cell run in float32 from the widened
inputs; h, c and the alignment are carried rounded to bfloat16 (h' and the
logits from the unrounded c' and h'; q from the rounded h; the context from
the unrounded alignment; the location features in float32), the initial
alignment too; the backward's carries stay float32 and it reads the rounded
stored c, alignment and h. ``DecoderScanFn`` takes the float32 parameters,
casts them to k's type for the kernels (as the TPU kernel's wrapper casts
them) and returns their gradients in float32, from the per-step streams
rounded to bfloat16 where the TPU kernel stores them so (dgates, dq,
dfpre); dk and dv come back in bfloat16. As the TPU kernel's backward, it
rebuilds the context from the stored (rounded) alignment, for the softmax
term and dWx, and the gate activations from that context and the stored h
(products outside the sweep, in float32), in place of the forward's.

The kernels take H a multiple of 8 up to 512, Dk up to 512, any L, V, E,
Emb, K, odd P and S up to what their per-frame buffers leave of a block's
shared memory (``scan_grid`` raises past it: about 6,000 frames at the
flagship widths). Each runs as a persistent grid of G co-resident clusters
of CL blocks (a cooperative launch; ``scan_grid`` picks CL from 4 to 8 and G
from cudaOccupancyMaxActiveClusters, e.g. 17 clusters of 6 on a 132-SM H100
for B = 16): the cell's weights are split by hidden unit over all G CL
blocks and held in shared memory for the whole launch, and each cluster
walks ceil(B / G) utterances for the attention part. What else fits in a
block's shared memory the kernels' own layout decides (``plan``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.cuda_build import dtype_code
from e2e_asr_tpu_torch.ops.att_step_cuda import NEG, location_features

CL = 8  # blocks per cluster, at most (the portable cluster size)
CLUSTER_SIZES = (8, 7, 6, 5, 4)  # the sizes scan_grid weighs
SLOT_COST = 10  # an utterance slot's fixed cost, in frames a block, for that choice
MAX_H = 512
MAX_DK = 512
SMEM_MAX = 227 * 1024  # shared memory a block may use on the H100
# the residents' flags of the kernels' plans (csrc e2e_decoder_scan_fwd_plan / _bwd_plan out[1:])
FWD_RESIDENTS = ("w_smem", "v_smem", "wq_smem", "wo_smem", "k_smem")
BWD_RESIDENTS = ("es_smem", "dfa_smem", "wr_smem", "dk_smem", "k_smem", "v_smem")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(which: str, g: int, cl: int, b: int, s: int, dk: int, e_dim: int, kk: int, p: int,
         h_dim: int, vocab: int, dtype: torch.dtype = torch.float32):
    """Shared memory of kernel ``which`` ("fwd" or "bwd") on ``g`` clusters
    of ``cl`` blocks for storage type ``dtype`` (the residents, k, v and the
    weights, held in it), from the kernel's own layout (csrc
    ``e2e_decoder_scan_{fwd,bwd}_plan``): (bytes a block, {resident: 0/1},
    floats of global scratch a block). Residents are taken in order of
    priority while a block stays within 227 KB; raises ValueError when its
    working buffers alone exceed that. Needs the built library, not the card."""
    out = torch.zeros(8, dtype=torch.int32)
    dims = (b, s, dk, e_dim, kk, p, h_dim) + ((vocab,) if which == "fwd" else ())
    cuda_build.launch(_library(which), f"e2e_decoder_scan_{which}_plan", *dims, g, cl,
                      dtype_code(dtype, f"decoder_scan_{which}"), out)
    o = out.tolist()
    if o[0] < 0:
        raise ValueError(f"decoder_scan_{which}: S = {s} leaves a block's working buffers above "
                         f"{SMEM_MAX} bytes of shared memory")
    names = FWD_RESIDENTS if which == "fwd" else BWD_RESIDENTS
    return o[0], dict(zip(names, o[1:])), (o[7] if which == "bwd" else 0)


def _library(which: str) -> str:
    """The name of kernel ``which``'s library, built (or the build's error
    raised) before the card is asked anything."""
    name = "decoder_scan" if which == "fwd" else "decoder_scan_bwd"
    cuda_build.library(name)
    return name


_clusters = {}


def resident_clusters(which: str, cl: int = CL, smem: int = SMEM_MAX,
                      dtype: torch.dtype = torch.float32) -> int:
    """How many clusters of ``cl`` blocks of kernel ``which`` ("fwd" or
    "bwd", its ``dtype`` variant) can be resident at once with ``smem``
    bytes of shared memory a block (cudaOccupancyMaxActiveClusters; card
    only)."""
    name = _library(which)
    key = (which, cl, smem, dtype, torch.cuda.current_device())
    if key not in _clusters:
        out = torch.zeros(1, dtype=torch.int32)
        cuda_build.launch(name, f"e2e_decoder_scan_{which}_clusters", cl, smem,
                          dtype_code(dtype, f"decoder_scan_{which}"), out)
        _clusters[key] = int(out[0])
    return _clusters[key]


def pick_cluster_size(b: int, s: int, resident) -> int:
    """The cluster size for B utterances of S frames, given ``resident(cl)``
    = the clusters of that size that fit: the smallest slots x (frames a
    block + SLOT_COST), larger clusters first on a tie. On an H100 at one block an
    SM (15, 15, 17, 22, 30 clusters of 8, 7, 6, 5, 4) that is 6 for B = 16,
    where 8 would leave one cluster two utterances."""
    def cost(cl):
        g = resident(cl)
        return float("inf") if g < 1 else _cdiv(b, g) * (_cdiv(s, cl) + SLOT_COST)
    return min(CLUSTER_SIZES, key=lambda cl: (cost(cl), -cl))


_grids = {}


def scan_grid(which: str, b: int, s: int, dk: int, e_dim: int, kk: int, p: int, h_dim: int,
              vocab: int, cluster_size: Optional[int] = None, dtype: torch.dtype = torch.float32):
    """The grid a launch of kernel ``which`` (its ``dtype`` variant) uses at
    these shapes: G clusters of CL blocks (all that can be resident, CL from
    ``pick_cluster_size``), the shared memory a block, the residents and the
    global scratch a block (``cluster_size`` overrides the pick). Raises
    when the planned grid cannot be resident: a cooperative grid that does
    not fit would not run."""
    _library(which)
    key = (which, b, s, dk, e_dim, kk, p, h_dim, vocab, cluster_size, dtype, torch.cuda.current_device())
    if key in _grids:
        return dict(_grids[key])
    shapes = (b, s, dk, e_dim, kk, p, h_dim, vocab, dtype)

    def fits_plan(cl):
        g = resident_clusters(which, cl, dtype=dtype)
        if g < 1:
            return False
        try:
            plan(which, g, cl, *shapes)
        except ValueError:
            return False
        return True

    cl = cluster_size or pick_cluster_size(
        b, s, lambda c: resident_clusters(which, c, dtype=dtype) if fits_plan(c) else 0)
    g = resident_clusters(which, cl, dtype=dtype)
    if g < 1 or not fits_plan(cl):
        raise RuntimeError(f"decoder_scan_{which}: no grid of clusters fits on this card at these shapes")
    smem, flags, scratch = plan(which, g, cl, *shapes)
    if resident_clusters(which, cl, smem, dtype) < g:
        raise RuntimeError(f"decoder_scan_{which}: {g} clusters with {smem} bytes of shared memory a "
                           "block cannot be resident at once")
    _grids[key] = dict(clusters=g, cluster_size=cl, blocks=g * cl, slots=_cdiv(b, g), smem=smem,
                       scratch=scratch, **flags)
    return dict(_grids[key])


def supported(cfg, train: bool) -> bool:
    """The fused scan's envelope (as ``decoder_pallas.supported``): location
    attention, one head, no value projection, 1-layer LSTM speller, no
    decoder dropout in training."""
    a, d = cfg.attention, cfg.decoder
    return (
        a.mode == "location"
        and a.num_head == 1
        and not a.v_proj
        and d.module.upper() == "LSTM"
        and d.layer == 1
        and (d.dropout == 0.0 or not train)
    )


def fits(h_dim: int, dk: int) -> bool:
    """The kernels' design limits on the speller width and attention dim."""
    return h_dim % CL == 0 and h_dim <= MAX_H and dk <= MAX_DK


def _init_align(enc_len: torch.Tensor, s: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The uniform alignment over the valid frames, computed in float32 and
    stored in ``dtype``."""
    mask = torch.arange(s, device=enc_len.device)[None, :] < enc_len[:, None]
    return (mask.float() / torch.clamp(enc_len, min=1)[:, None].float()).to(dtype)


def _attend(k, v, mask, prev_att, q, taps, wlp, locv, locb, temp):
    """(align [B, S], ctx [B, E], e [B, S, Dk], f [B, S, K]) of one step."""
    f = location_features(prev_att[:, None], taps[:, None, :])  # [B, S, K]
    e = torch.tanh(k + q[:, None, :] + f @ wlp + locb)
    energy = torch.where(mask, e @ locv, NEG)
    align = torch.where(mask, torch.softmax(energy / temp, dim=-1), 0.0)
    ctx = torch.einsum("bs,bse->be", align, v)
    return align, ctx, e, f


def decoder_scan_fwd_plain(
    k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
    teacher, use_teacher, temp: float, sample: bool = False,
    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
):
    """Plain version: the scan as a loop over L. ``use_teacher`` [L] bool;
    where it is false the prediction of the step before is fed (argmax of
    the logits, plus ``noise`` [L, B, V] when ``sample``; without a buffer
    the noise is Gumbel noise drawn from ``generator``). Returns (logits,
    align, hidden, residuals = (cseq, tokens, acts, q, ctx)): the first
    four in k's type (the inputs' storage type), the rest float32."""
    b, s, _ = k.shape
    l = teacher.shape[0]
    h_dim = wh.shape[0]
    dt = k.dtype
    k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout = (
        a.float() for a in (k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout))
    mask = torch.arange(s, device=k.device)[None, :] < enc_len[:, None]
    att = _init_align(enc_len, s, dt)
    h = k.new_zeros((b, h_dim), dtype=dt)
    c = k.new_zeros((b, h_dim), dtype=dt)
    pred = torch.zeros((b,), dtype=torch.long, device=k.device)  # <sos>
    use = use_teacher.tolist()
    outs = [[] for _ in range(8)]
    for t in range(l):
        tok = teacher[t].long() if use[t] else pred
        q = h.float() @ wq + bq
        align, ctx, _, _ = _attend(k, v, mask, att.float(), q, taps, wlp, locv, locb, temp)
        gates = torch.cat([embed[tok], ctx], -1) @ wx + h.float() @ wh + bl
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        c2 = f * c.float() + i * g
        h2 = o * torch.tanh(c2)
        logits = h2 @ wout + bout
        scores = logits
        if sample:
            if noise is not None:
                scores = logits + noise[t]
            else:
                u = torch.rand(logits.shape, generator=generator,
                               device=generator.device if generator is not None else None)
                scores = logits - torch.log(-torch.log(u.to(logits.device) + 1e-12))
        pred = torch.argmax(scores, -1)
        att, h, c = align.to(dt), h2.to(dt), c2.to(dt)
        for lst, val in zip(outs, (logits.to(dt), att, h, c, tok.int(), torch.cat([i, f, g, o], -1), q,
                                   ctx)):
            lst.append(val)
    logits, align, hidden, cseq, tokens, acts, qs, ctxs = (torch.stack(o) for o in outs)
    return logits, align, hidden, (cseq, tokens, acts, qs, ctxs)


def _check(name, tensors, ints=(), dtype=torch.float32, wide=()):
    """``tensors`` in the storage type ``dtype``, ``wide`` in float32, ``ints``
    in int32."""
    dtype_code(dtype, name)
    for a, an in tensors:
        cuda_build.check_cuda(a, f"{name} {an}", dtype)
    for a, an in wide:
        cuda_build.check_cuda(a, f"{name} {an}")
    for a, an in ints:
        cuda_build.check_cuda(a, f"{name} {an}", torch.int32)


def _dims(name, k, v, taps, wq, wlp, embed, wx, wh, wout, teacher):
    b, s, dk = k.shape
    e_dim = v.shape[2]
    kk, p = taps.shape
    h_dim = wh.shape[0]
    vocab, emb = embed.shape
    l = teacher.shape[0]
    if (v.shape[:2] != (b, s) or wq.shape != (h_dim, dk) or wlp.shape != (kk, dk) or p % 2 != 1
            or wx.shape != (emb + e_dim, 4 * h_dim) or wh.shape != (h_dim, 4 * h_dim)
            or wout.shape != (h_dim, vocab) or teacher.shape != (l, b) or l < 1 or s < 1):
        raise ValueError(
            f"{name}: shapes k {tuple(k.shape)} v {tuple(v.shape)} taps {tuple(taps.shape)} "
            f"wq {tuple(wq.shape)} wlp {tuple(wlp.shape)} embed {tuple(embed.shape)} "
            f"wx {tuple(wx.shape)} wh {tuple(wh.shape)} wout {tuple(wout.shape)} "
            f"teacher {tuple(teacher.shape)}")
    if not fits(h_dim, dk):
        raise ValueError(f"{name}: the kernel takes H a multiple of {CL} up to {MAX_H} and Dk up "
                         f"to {MAX_DK}, got H {h_dim}, Dk {dk}")
    return b, s, dk, e_dim, kk, p, h_dim, vocab, emb, l


def decoder_scan_fwd(
    k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
    teacher, use_teacher, temp: float, sample: bool = False, seed: int = 0,
    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
):
    """Plain version on CPU tensors; the CUDA kernel on CUDA tensors (its
    sampled feedback draws the noise of ``gumbel_noise(seed, ...)`` in the
    kernel, ``seed`` an int or an int64 tensor of one element on k's device
    that the kernel reads; ``noise`` and ``generator`` are the plain
    version's)."""
    if cuda_build.use_plain(k):
        return decoder_scan_fwd_plain(k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh,
                                      bl, wout, bout, teacher, use_teacher, temp, sample, noise,
                                      generator)
    out = _fwd_launch((), k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
                      teacher, use_teacher, temp, sample, seed)
    cuda_build.count_launch(decoder_scan_fwd, k.dtype)
    return out


def _fwd_launch(defines, k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout,
                bout, teacher, use_teacher, temp, sample, seed, cluster_size=None):
    """Checks, allocates and launches the forward kernel of the library
    built with ``defines``."""
    fl = [a.contiguous() for a in (k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout)]
    k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout = fl
    enc_len = enc_len.to(torch.int32).contiguous()
    teacher = teacher.to(torch.int32).contiguous()
    use_i = use_teacher.to(device=k.device, dtype=torch.int32).contiguous()
    names = "k v taps wq bq wlp locv locb embed wx wh bl wout bout".split()
    dt = k.dtype
    _check("decoder_scan_fwd", zip(fl, names),
           ((enc_len, "enc_len"), (teacher, "teacher"), (use_i, "use_teacher")), dt)
    b, s, dk, e_dim, kk, p, h_dim, vocab, emb, l = _dims(
        "decoder_scan_fwd", k, v, taps, wq, wlp, embed, wx, wh, wout, teacher)
    grid = scan_grid("fwd", b, s, dk, e_dim, kk, p, h_dim, vocab, cluster_size, dt)
    dev = k.device
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    logits, align = new(l, b, vocab, dtype=dt), new(l, b, s, dtype=dt)
    hidden, cseq = new(l, b, h_dim, dtype=dt), new(l, b, h_dim, dtype=dt)
    acts, qs, ctxs = new(l, b, 4 * h_dim), new(l, b, dk), new(l, b, e_dim)
    tokens = torch.empty((l, b), dtype=torch.int32, device=dev)
    ew = new(vocab, 4 * h_dim)  # scratch: embed Wx[:Emb] + bl
    hs = new(b, h_dim) if dt != torch.float32 else hidden  # scratch: h' of the step, unrounded
    seed_t = None  # the kernel reads no seed without sampling
    if sample:
        seed_t = seed if isinstance(seed, torch.Tensor) else torch.full((1,), int(seed), dtype=torch.int64,
                                                                        device=dev)
        if seed_t.dtype != torch.int64 or seed_t.numel() != 1 or seed_t.device != dev:
            raise ValueError(f"decoder_scan_fwd: the seed must be one int64 on {dev}, got {seed_t.dtype} "
                             f"{tuple(seed_t.shape)} on {seed_t.device}")
    cuda_build.launch(
        "decoder_scan", "e2e_decoder_scan_fwd", k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed,
        wx, wh, bl, wout, bout, teacher, use_i, logits, align, hidden, cseq, tokens, acts, qs, ctxs, ew,
        hs, b, s, dk, e_dim, kk, p, h_dim, emb, vocab, l, 1.0 / float(temp), int(bool(sample)),
        seed_t, grid["clusters"], grid["cluster_size"],
        grid["w_smem"], grid["wq_smem"], grid["wo_smem"], grid["k_smem"], grid["v_smem"],
        dtype_code(dt, "decoder_scan_fwd"), defines=defines,
    )
    return logits, align, hidden, (cseq, tokens, acts, qs, ctxs)


decoder_scan_fwd.launches = 0
decoder_scan_fwd.launches_bf16 = 0


def gumbel_noise(seed: int, l: int, b: int, vocab: int, device) -> torch.Tensor:
    """The [L, B, V] Gumbel noise the kernel adds to the logits of step t,
    utterance b, column v under ``seed`` (the same device function fills
    it, so the numbers are the kernel's bit for bit). Card only."""
    out = torch.empty((l, b, vocab), dtype=torch.float32, device=device)
    if cuda_build.use_plain(out):
        raise RuntimeError("gumbel_noise: the kernel's noise exists on the card only")
    seed = int(seed)
    cuda_build.launch("decoder_scan", "e2e_decoder_scan_noise", out, l, b, vocab,
                      seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF)
    return out


def _taps_grad(att_prev: torch.Tensor, dfpre: torch.Tensor, p: int) -> torch.Tensor:
    """dtaps[kk, p] = sum over (n, s) of att_prev[n, s + p - half] dfpre[n, s, kk]
    for att_prev [N, S], dfpre [N, S, K]: one product over the N = L*B
    sequences, m[j, s, kk] = sum_n att_prev[n, j] dfpre[n, s, kk] (the
    gradient of the JAX package's Toeplitz bank), then the sums along its
    diagonals j - s = p - half, read through a strided view."""
    n, s, kk = dfpre.shape
    half = (p - 1) // 2
    m = (att_prev.T @ dfpre.reshape(n, s * kk)).view(s, s, kk)
    m = F.pad(m, (0, 0, 0, 0, half, half))  # [S + 2 half, S, K]: m[j + half, s, kk]
    diag = m.as_strided((p, s, kk), (s * kk, s * kk + kk, 1))  # diag[p, s, kk] = m[s + p, s, kk]
    return diag.sum(dim=1).T


def _shift(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The sequence delayed by one step, ``first`` [B, ...] at step 0."""
    return torch.cat([first[None], x[:-1]], dim=0)


def decoder_scan_bwd_plain(k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout,
                           align, hidden, cseq, acts, qs, ctxs, dlogits, dalign, dhidden,
                           temp: float):
    """Plain version of the backward kernel: the reverse sweep written out
    step by step (not autograd). Returns what the kernel returns: the
    per-step dgates [L, B, 4H], dq [L, B, Dk] and the location-feature
    cotangent dfpre [L, B, S, K], then dk [B, S, Dk], dwlp [K, Dk] and
    dlocv [Dk] summed over steps and utterances, all float32 (the inputs in
    their storage type are widened)."""
    l, b, s = align.shape
    h_dim = wh.shape[0]
    e_dim = v.shape[2]
    init = _init_align(enc_len, s, align.dtype).float()
    (k, v, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, dlogits, dalign,
     dhidden) = (a.float() for a in (k, v, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden,
                                      cseq, dlogits, dalign, dhidden))
    wx_ctx = wx[wx.shape[0] - e_dim:]
    mask = torch.arange(s, device=k.device)[None, :] < enc_len[:, None]
    att_prev_all = _shift(align, init)
    c_prev_all = _shift(cseq, torch.zeros_like(cseq[0]))
    p = taps.shape[1]
    dh_c = k.new_zeros((b, h_dim))
    dc_c = k.new_zeros((b, h_dim))
    datt_c = k.new_zeros((b, s))
    dk = torch.zeros_like(k)
    dwlp = torch.zeros_like(wlp)
    dlocv = torch.zeros_like(locv)
    dg_all, dq_all, dfp_all = [], [], []
    for t in range(l - 1, -1, -1):
        i, f, g, o = acts[t].chunk(4, dim=-1)
        tc = torch.tanh(cseq[t])
        dh = dlogits[t] @ wout.T + dhidden[t] + dh_c
        dc = dc_c + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev_all[t] * f * (1.0 - f),
                            dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        dc_c = dc * f
        dctx = dgates @ wx_ctx.T
        dh_lstm = dgates @ wh.T
        att_t = align[t]
        dal = torch.einsum("be,bse->bs", dctx, v) + dalign[t] + datt_c
        sdot = torch.sum(dal * att_t, dim=-1, keepdim=True)
        den = torch.where(mask, att_t * (dal - sdot) / temp, 0.0)
        # the tanh energies of step t, rebuilt from the alignment of step t-1
        fpre = location_features(att_prev_all[t][:, None], taps[:, None, :])  # [B, S, K]
        e = torch.tanh(k + qs[t][:, None, :] + fpre @ wlp + locb)
        de = den[..., None] * locv * (1.0 - e * e)  # [B, S, Dk]
        dq = de.sum(dim=1)
        dk += de
        dlocv += torch.einsum("bsd,bs->d", e, den)
        dwlp += torch.einsum("bsk,bsd->kd", fpre, de)
        dfp = de @ wlp.T  # [B, S, K]
        # transpose of the SAME cross-correlation: datt[j] = sum_s dfp[s] taps[j - s + half]
        datt_c = F.conv_transpose1d(dfp.transpose(1, 2), taps[:, None, :], padding=(p - 1) // 2)[:, 0]
        dh_c = dh_lstm + dq @ wq.T
        dg_all.append(dgates)
        dq_all.append(dq)
        dfp_all.append(dfp)
    rev = lambda xs: torch.stack(xs[::-1])
    return rev(dg_all), rev(dq_all), rev(dfp_all), dk, dwlp, dlocv


def decoder_scan_bwd(k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout,
                     align, hidden, cseq, acts, qs, ctxs, dlogits, dalign, dhidden, temp: float):
    """Backward sweep: plain version on CPU tensors; the CUDA kernel on CUDA
    tensors. dwlp and dlocv leave the kernel as one partial per block, summed
    here in a fixed order (no atomics: the result does not change from run
    to run)."""
    args = (k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs,
            ctxs, dlogits, dalign, dhidden)
    if cuda_build.use_plain(k):
        return decoder_scan_bwd_plain(*args, temp)
    out = _bwd_launch((), *args, temp)
    cuda_build.count_launch(decoder_scan_bwd, k.dtype)
    return out


def _bwd_launch(defines, k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden,
                cseq, acts, qs, ctxs, dlogits, dalign, dhidden, temp, cluster_size=None):
    """Checks, allocates and launches the backward kernel of the library
    built with ``defines``; sums the per-block partials."""
    fl = [a.contiguous() for a in (k, v, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden,
                                   cseq, acts, qs, ctxs, dlogits, dalign, dhidden)]
    (k, v, taps, wq, wlp, locv, locb, wx, wh, wout, align, hidden, cseq, acts, qs, ctxs, dlogits,
     dalign, dhidden) = fl
    enc_len = enc_len.to(torch.int32).contiguous()
    names = ("k v taps wq wlp locv locb wx wh wout align hidden cseq acts q ctx dlogits dalign "
             "dhidden").split()
    dt = k.dtype
    wide = {"acts", "q", "ctx"}
    _check("decoder_scan_bwd", [(a, n) for a, n in zip(fl, names) if n not in wide],
           ((enc_len, "enc_len"),), dt, [(a, n) for a, n in zip(fl, names) if n in wide])
    b, s, dk_dim = k.shape
    e_dim = v.shape[2]
    kk, p = taps.shape
    h_dim, vocab = wout.shape
    l = align.shape[0]
    emb = wx.shape[0] - e_dim
    if not fits(h_dim, dk_dim):
        raise ValueError(f"decoder_scan_bwd: the kernel takes H a multiple of {CL} up to {MAX_H} "
                         f"and Dk up to {MAX_DK}, got H {h_dim}, Dk {dk_dim}")
    for a, an, shape in ((align, "align", (l, b, s)), (hidden, "hidden", (l, b, h_dim)),
                         (cseq, "cseq", (l, b, h_dim)), (acts, "acts", (l, b, 4 * h_dim)),
                         (qs, "q", (l, b, dk_dim)), (ctxs, "ctx", (l, b, e_dim)),
                         (dlogits, "dlogits", (l, b, vocab)), (dalign, "dalign", (l, b, s)),
                         (dhidden, "dhidden", (l, b, h_dim))):
        if a.shape != shape:
            raise ValueError(f"decoder_scan_bwd: {an} {tuple(a.shape)} != {shape}")
    grid = scan_grid("bwd", b, s, dk_dim, e_dim, kk, p, h_dim, vocab, cluster_size, dt)
    dev = k.device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dgates, dq, dfpre = new(l, b, 4 * h_dim), new(l, b, dk_dim), new(l, b, s, kk)
    dk = new(b, s, dk_dim)
    nb = grid["blocks"]
    dwlp_part, dlocv_part = new(nb, kk, dk_dim), new(nb, dk_dim)
    dctx = new(b, e_dim)  # scratch: dctx of the step
    scratch = new(max(1, nb * grid["scratch"]))
    cuda_build.launch(
        "decoder_scan_bwd", "e2e_decoder_scan_bwd", k, v, enc_len, taps, wq, wlp, locv, locb, wx, wh,
        wout, align, cseq, acts, qs, ctxs, dlogits, dalign, dhidden, dgates, dq, dfpre, dk,
        dwlp_part, dlocv_part, dctx, scratch, b, s, dk_dim, e_dim, kk, p, h_dim, emb, vocab, l,
        1.0 / float(temp), grid["clusters"], grid["cluster_size"], grid["es_smem"], grid["dfa_smem"],
        grid["wr_smem"], grid["dk_smem"], grid["k_smem"],
        grid["v_smem"], dtype_code(dt, "decoder_scan_bwd"), defines=defines,
    )
    return dgates, dq, dfpre, dk, dwlp_part.sum(dim=0), dlocv_part.sum(dim=0)


decoder_scan_bwd.launches = 0
decoder_scan_bwd.launches_bf16 = 0


PHASE_BUILD = ("SCAN_PHASES",)  # the define of the kernels' timing build (bin/profile_decode.py)


class DecoderScanFn(torch.autograd.Function):
    """(logits, align, hidden) = the scan's forward, with the backward sweep
    above and, outside it, one contraction over L*B for every gradient that
    is a sum of per-step outer products (dv, dWx, dWh, db, dWq, dbq, dlocb,
    d_embed, dWout, dbout) and one more product for the taps' gradient (the
    counterpart of ``decoder_scan_fused.defvjp``; d_embed as the product of
    the fed tokens' one-hot, a fixed order of sums). k and v set the storage
    type; the float32 parameters are cast to it for the kernels, and their
    gradients come back in float32, summed in float32 from the per-step
    streams as stored in that type (dgates, dq, dfpre) and the float32
    parameters, as the TPU kernel's VJP sums them."""

    @staticmethod
    def forward(ctx, k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
                enc_len, teacher, use_teacher, temp, sample, seed, noise, generator):
        dt = k.dtype
        w = [a.to(dt) for a in (taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout)]
        logits, align, hidden, res = decoder_scan_fwd(
            k, v, enc_len, *w, teacher, use_teacher, temp, sample, seed, noise, generator)
        cseq, tokens, acts, qs, ctxs = res
        taps_s, wq_s, _, wlp_s, locv_s, locb_s, embed_s, wx_s, wh_s, bl_s, wout_s, _ = w
        ctx.save_for_backward(k, v, enc_len, taps_s, wq_s, wlp_s, locv_s, locb_s, wx_s, wh_s, wout_s,
                              embed, wx, embed_s, bl_s, align, hidden, cseq, tokens, acts, qs, ctxs)
        ctx.temp = temp
        return logits, align, hidden

    @staticmethod
    def backward(ctx, dlogits, dalign, dhidden):
        (k, v, enc_len, taps, wq, wlp, locv, locb, wx_s, wh, wout, embed, wx, embed_s, bl_s,
         align, hidden, cseq, tokens, acts, qs, ctxs) = ctx.saved_tensors
        dt = k.dtype
        l, b, s = align.shape
        dlogits, dalign, dhidden = (
            align.new_zeros(shape) if d is None else d.contiguous()
            for d, shape in ((dlogits, (l, b, wout.shape[1])), (dalign, align.shape),
                             (dhidden, hidden.shape)))
        al, hid = align.float(), hidden.float()
        h_prev = _shift(hid, torch.zeros_like(hid[0]))
        toks = tokens.reshape(-1).long()
        if dt != torch.float32:
            # below float32 the TPU kernel's backward rebuilds the context from
            # the alignment as stored (the softmax term and dWx read it) and the
            # gate activations from it and the stored h; at float32 both equal
            # the forward's
            ctxs = torch.einsum("lbs,bse->lbe", al, v.float())
            xin_s = torch.cat([embed_s[toks].float().reshape(l, b, -1), ctxs], dim=-1)
            gates = xin_s @ wx_s.float() + h_prev @ wh.float() + bl_s.float()
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            acts = torch.cat([torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)], dim=-1)
        dgates, dq, dfpre, dk, dwlp, dlocv = decoder_scan_bwd(
            k, v, enc_len, taps, wq, wlp, locv, locb, wx_s, wh, wout, align, hidden, cseq, acts, qs,
            ctxs, dlogits, dalign, dhidden, ctx.temp)
        dlocb = dq.sum(dim=(0, 1))
        # the streams as the TPU kernel stores them (no-ops at float32)
        dgates, dq, dfpre = (a.to(dt).float() for a in (dgates, dq, dfpre))
        emb_dim = embed.shape[1]
        flat = lambda x: x.reshape(l * b, -1)
        dlog = dlogits.float()
        att_prev = _shift(al, _init_align(enc_len, s, dt).float())
        din = dgates @ wx.T  # [L, B, Emb + E]
        xin = torch.cat([embed[toks].reshape(l, b, emb_dim), ctxs], dim=-1)
        dwx = flat(xin).T @ flat(dgates)
        dwh = flat(h_prev).T @ flat(dgates)
        dbl = dgates.sum(dim=(0, 1))
        # the rows of each token summed by one product with the tokens'
        # one-hot, in a fixed order (index_add_ adds atomically on the card, so
        # two runs of one step would differ; index_put_'s sorted accumulate
        # takes 1.4 ms at the flagship)
        onehot = (toks[:, None] == torch.arange(embed.shape[0], device=toks.device)).to(din.dtype)
        dembed = onehot.T @ flat(din[..., :emb_dim])
        dwq = flat(h_prev).T @ flat(dq)
        dbq = dq.sum(dim=(0, 1))
        dv = torch.einsum("lbs,lbe->bse", al, din[..., emb_dim:]).to(dt)
        dwout = flat(hid).T @ flat(dlog)
        dbout = dlog.sum(dim=(0, 1))
        dtaps = _taps_grad(att_prev.reshape(l * b, s), dfpre.reshape(l * b, s, -1), taps.shape[1])
        return (dk.to(dt), dv, dtaps, dwq, dbq, dwlp, dlocv, dlocb, dembed, dwx, dwh, dbl, dwout,
                dbout, None, None, None, None, None, None, None, None)


def decoder_scan(k, v, enc_len, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
                 teacher, use_teacher, temp, sample=False, seed=0, noise=None, generator=None):
    """Differentiable (logits [L, B, V], align [L, B, S], hidden [L, B, H]),
    in k's type."""
    return DecoderScanFn.apply(k, v, taps, wq, bq, wlp, locv, locb, embed, wx, wh, bl, wout, bout,
                               enc_len, teacher, use_teacher, temp, sample, seed, noise, generator)


def run_decode_scan(
    params, cfg, enc: torch.Tensor, enc_len: torch.Tensor, teacher_in: torch.Tensor,
    coins: torch.Tensor, generator: Optional[torch.Generator] = None, train: bool = False,
    sample_decoding: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop-in for the loop of ``models/asr.py`` ``forward`` inside the
    envelope of ``supported``. teacher_in [B, L]: the right-shifted targets;
    coins [L] bool: the steps that use the teacher (all do outside
    training), on enc's device for the kernel. Sampled feedback needs a
    generator; without one the prediction fed back is the argmax, as in the
    loop.

    Returns (att_logits [B, L, V], align [B, L, 1, S], att_hidden [B, L, H])."""
    ap, dp = params["attention"], params["decoder"]
    cell = dp["cells"][0]
    k = enc @ ap["proj_k"]["w"].to(enc.dtype)
    wlp = ap["loc_proj"]["w"]
    locb = ap["loc_b"] + ap["loc_conv"]["b"] @ wlp
    use_teacher = coins if train else torch.ones(teacher_in.shape[1], dtype=torch.bool, device=enc.device)
    # a static choice: whether a coin failed is known only on the device; the
    # seed is drawn at every training step, the step's last draw (on the
    # CPU the plain version draws its noise from the generator instead)
    sample = bool(train and sample_decoding and generator is not None)
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device) if sample else 0
    logits, align, hidden = decoder_scan(
        k, enc, enc_len, ap["loc_conv"]["w"][:, 0], ap["proj_q"]["w"], ap["proj_q"]["b"], wlp,
        ap["loc_v"][0], locb, params["embed"]["table"], cell["wx"], cell["wh"], cell["b"],
        dp["char"]["w"], dp["char"]["b"], teacher_in.T.int(), use_teacher,
        float(cfg.attention.temperature), sample, seed, None, generator,
    )
    return logits.transpose(0, 1), align.transpose(0, 1)[:, :, None, :], hidden.transpose(0, 1)
