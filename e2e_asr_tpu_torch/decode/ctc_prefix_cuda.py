"""The fused CTC prefix-score kernel (csrc/ctc_prefix.cu) beside its plain
PyTorch version.

Replaces the TPU kernel ``e2e_asr_tpu/decode/ctc_prefix_pallas.py``
``prefix_recursion`` together with what ``e2e_asr_tpu/decode/ctc_prefix.py``
builds around it (``prefix_scores``: candidate emissions, phi(t-1), the
masks) and ``eos_score``. ``prefix_scores_fused`` takes ctc_lp, enc_len, the
parents' r_g, last_tok, cand and prefix_is_empty and returns (psi, r_h in
[B, W, K, T, 2], psi_eos). Its plain version composes the building blocks
below: ``recursion_inputs`` (the [T, N] streams, N = batch x beam x
candidate columns), ``prefix_recursion_plain`` (the serial recursion of
``prefix_scores_scan``, frozen where valid = 0), the layout change and
``eos_score``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from e2e_asr_tpu_torch import cuda_build

NEG = -1.0e30


def lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) with the NEG floor of decode/ctc_prefix.py _lse."""
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m > NEG / 2, out, NEG)


def prefix_recursion_plain(lp_c, phi, lp_b, valid) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the serial recursion as a loop over T."""
    t_len, n = lp_c.shape
    rn = lp_c.new_full((n,), NEG)
    rb = lp_c.new_full((n,), NEG)
    psi = lp_c.new_full((n,), NEG)
    r_n = lp_c.new_empty((t_len, n))
    r_b = lp_c.new_empty((t_len, n))
    for t in range(t_len):
        v = valid[t] > 0
        rn_t = lse(rn, phi[t]) + lp_c[t]
        rb_t = lse(rb, rn) + lp_b[t]
        psi = torch.where(v, lse(psi, phi[t] + lp_c[t]), psi)
        rn = torch.where(v, rn_t, rn)
        rb = torch.where(v, rb_t, rb)
        r_n[t] = rn
        r_b[t] = rb
    return r_n, r_b, psi


def _candidate_emissions(ctc_lp: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Per-time candidate emission log-probs [T, B, W, K], a gather (the JAX
    package's one-hot product was a TPU workaround for slow gathers)."""
    b, w, k = cand.shape
    t = ctc_lp.shape[1]
    idx = cand.reshape(b, 1, w * k).expand(b, t, w * k).long()
    lp_c = torch.gather(ctc_lp, 2, idx).reshape(b, t, w, k)
    return lp_c.permute(1, 0, 2, 3)


def _phi_prev(r_g_t, match, prefix_is_empty: bool):
    """phi(t-1) for every t: the score of prefix g ending at frame t-1 such
    that candidate c may start at frame t. phi(-1) = 0 for the empty prefix,
    NEG otherwise. r_g_t [T, B, W, 2], match [B, W, K] -> [T, B, W, K]."""
    t, b, w, _ = r_g_t.shape
    k = match.shape[-1]
    r_n_g = r_g_t[..., 0:1]
    r_b_g = r_g_t[..., 1:2]
    phi = lse(r_b_g.expand(t, b, w, k), torch.where(match[None], NEG, r_n_g))
    init = r_g_t.new_full((1, b, w, k), 0.0 if prefix_is_empty else NEG)
    return torch.cat([init, phi[:-1]], dim=0)


def recursion_inputs(ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty: bool):
    """The [T, N] streams of ``prefix_recursion_plain`` (N = B*W*K):
    candidate emissions and phi(t-1), masked to 0 / NEG past enc_len, blank
    log-probs masked to 0, and the 1/0 validity stream."""
    b, w, k = cand.shape
    t_len = ctc_lp.shape[1]
    lp_c = _candidate_emissions(ctc_lp, cand)  # [T, B, W, K]
    match = cand == last_tok[:, :, None]
    r_g_t = r_g.permute(2, 0, 1, 3)  # [T, B, W, 2]
    valid = torch.arange(t_len, device=ctc_lp.device)[:, None] < enc_len[None, :]  # [T, B]
    v4 = valid[:, :, None, None]
    phi_prev = torch.where(v4, _phi_prev(r_g_t, match, prefix_is_empty), NEG)
    lp_c_eff = torch.where(v4, lp_c, 0.0)
    lp_b = torch.where(valid, ctc_lp[:, :, 0].transpose(0, 1), 0.0)[:, :, None, None]
    shape = (t_len, b, w, k)
    n = b * w * k
    return (
        lp_c_eff.reshape(t_len, n),
        phi_prev.reshape(t_len, n),
        lp_b.expand(shape).reshape(t_len, n),
        v4.float().expand(shape).reshape(t_len, n),
    )


def eos_score(r_g: torch.Tensor, enc_len: torch.Tensor) -> torch.Tensor:
    """psi(g+eos) = full-prefix probability at the last valid frame.
    r_g: [B, W, T, 2] -> [B, W]."""
    b, w = r_g.shape[:2]
    idx = torch.clamp(enc_len - 1, min=0).long()[:, None, None, None].expand(b, w, 1, 2)
    r_end = torch.gather(r_g, 2, idx)
    return lse(r_end[:, :, 0, 0], r_end[:, :, 0, 1])


def prefix_scores_fused_plain(ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty):
    """Plain version: the composition the kernel replaces, the streams of
    ``recursion_inputs``, the serial recursion, the [B, W, K, T, 2] layout
    and ``eos_score``."""
    b, w, k = cand.shape
    shape = (ctc_lp.shape[1], b, w, k)
    r_n, r_b, psi = prefix_recursion_plain(
        *recursion_inputs(ctc_lp, enc_len, r_g, last_tok, cand, bool(prefix_is_empty))
    )
    r_h = torch.stack([r_n.reshape(shape), r_b.reshape(shape)], dim=-1)  # [T, B, W, K, 2]
    return psi.reshape(b, w, k), r_h.permute(1, 2, 3, 0, 4), eos_score(r_g, enc_len)


BLOCKS = 128  # blocks the kernel aims at: about one a streaming multiprocessor of the H100
MAX_COLUMNS = 96  # csrc 32 RWMAX: columns a block, at most


def columns_per_block(b: int, w: int, k: int) -> Tuple[int, int]:
    """(columns a block, blocks an utterance): an utterance's W*K columns in
    runs of equal length, enough blocks for about BLOCKS in all."""
    n = w * k
    nbu = min(n, max(1, -(-BLOCKS // b), -(-n // MAX_COLUMNS)))
    cpb = -(-n // nbu)
    return cpb, -(-n // cpb)


@functools.lru_cache(maxsize=None)
def plan(t: int, cpb: int, k: int) -> Tuple[int, int]:
    """(steps a tile, shared-memory bytes a block), from the kernel's own
    layout code (``e2e_prefix_scores_plan``)."""
    out = torch.zeros(2, dtype=torch.int32)
    lib = cuda_build.library("ctc_prefix")
    fn = lib.e2e_prefix_scores_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(t, cpb, k, out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"e2e_prefix_scores_plan: {lib.e2e_error_string(err).decode()}")
    return int(out[0]), int(out[1])


PHASE_BUILD = ("PREFIX_PHASES",)  # the define of the kernel's timing build (bin/profile_decode.py)
PHASES = ("set-up", "staging and recursion")  # what the timing build times (csrc MARK)


def prefix_scores_fused(ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty):
    """Score K candidate extensions of every live hypothesis, and its eos.

    ctc_lp [B, T, V] CTC log-softmax; enc_len [B]; r_g [B, W, T, 2] forward
    variables of the current prefixes; last_tok [B, W] last emitted token
    (ignored where prefix_is_empty); cand [B, W, K] candidate ids;
    prefix_is_empty a bool or an int (a kernel argument). Returns (psi [B,
    W, K], r_h [B, W, K, T, 2], psi_eos [B, W]). Plain version on CPU
    tensors; the CUDA kernel, one launch, on CUDA tensors: no host
    synchronisation, so a CUDA graph can capture it."""
    if cuda_build.use_plain(ctc_lp):
        return prefix_scores_fused_plain(ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty)
    out = _launch((), ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty)
    prefix_scores_fused.launches += 1
    return out


def _launch(defines, ctc_lp, enc_len, r_g, last_tok, cand, prefix_is_empty):
    ctc_lp, r_g = ctc_lp.contiguous(), r_g.contiguous()
    enc_len = enc_len if enc_len.dtype == torch.int32 else enc_len.to(torch.int32)
    last_tok = last_tok if last_tok.dtype == torch.int64 else last_tok.to(torch.int64)
    cand = cand if cand.dtype == torch.int64 else cand.to(torch.int64)
    enc_len, last_tok, cand = enc_len.contiguous(), last_tok.contiguous(), cand.contiguous()
    cuda_build.check_cuda(ctc_lp, "prefix_scores_fused ctc_lp")
    cuda_build.check_cuda(r_g, "prefix_scores_fused r_g")
    cuda_build.check_cuda(enc_len, "prefix_scores_fused enc_len", torch.int32)
    cuda_build.check_cuda(last_tok, "prefix_scores_fused last_tok", torch.int64)
    cuda_build.check_cuda(cand, "prefix_scores_fused cand", torch.int64)
    b, t, v = ctc_lp.shape
    _, w, k = cand.shape
    if cand.shape[0] != b or r_g.shape != (b, w, t, 2) or last_tok.shape != (b, w) or enc_len.shape != (b,):
        raise ValueError(
            f"prefix_scores_fused: shapes ctc_lp {tuple(ctc_lp.shape)} enc_len {tuple(enc_len.shape)} "
            f"r_g {tuple(r_g.shape)} last_tok {tuple(last_tok.shape)} cand {tuple(cand.shape)}"
        )
    cpb, nbu = columns_per_block(b, w, k)
    tt, _ = plan(t, cpb, k)
    psi = torch.empty((b, w, k), dtype=torch.float32, device=ctc_lp.device)
    r_h = torch.empty((b, w, k, t, 2), dtype=torch.float32, device=ctc_lp.device)
    psi_eos = torch.empty((b, w), dtype=torch.float32, device=ctc_lp.device)
    cuda_build.launch(
        "ctc_prefix", "e2e_prefix_scores", ctc_lp, enc_len, r_g, last_tok, cand, psi, r_h, psi_eos,
        b, t, v, w, k, int(bool(prefix_is_empty)), cpb, nbu, tt, defines=defines,
    )
    return psi, r_h, psi_eos


prefix_scores_fused.launches = 0
