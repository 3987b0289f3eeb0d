"""Beam attention-step kernel (csrc/att_step.cu) beside its plain PyTorch
version.

Replaces the TPU kernel ``e2e_asr_tpu/ops/att_step_pallas.py``
``att_step_beam_loc``. Both versions take q [B, W, Dk] (after proj_q),
prev_att [B, W, S], k [B, S, Dk], v [B, S, E], enc_len [B], the location
conv taps [K, P] (P = 2*loc_kernel_size + 1, head squeezed), wlp [K, Dk]
(loc_proj), locv [Dk] and locb [Dk] = loc_b + loc_conv.b @ wlp, and return
(align [B, W, S], ctx [B, W, E]). The location features are a SAME
cross-correlation of prev_att with the taps; there is no Toeplitz bank. The
kernel is one cooperative grid of every SM's resident blocks that splits
the utterances' valid frames evenly over them, an utterance's share to a
block. A launch takes at most as many utterances as blocks (132 on an
H100), and fewer where their shares would not fit in shared memory (long S
with many utterances); the wrapper then launches it for groups of
utterances in turn, B split evenly into the fewest groups that fit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from e2e_asr_tpu_torch import cuda_build

NEG = -1.0e9


def supported(cfg, params) -> bool:
    """The kernel's envelope (as att_step_pallas.supported): location mode,
    one head, no value projection, no merge."""
    return (
        cfg.mode == "location"
        and cfg.num_head == 1
        and "proj_v" not in params
        and "merge" not in params
    )


def location_features(prev_att: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """[N, H, S] alignments, taps [K, H, P] -> [N, S, K] SAME conv features."""
    p = taps.shape[-1]
    return F.conv1d(prev_att, taps, padding=(p - 1) // 2).transpose(1, 2)


def att_step_beam_loc_plain(q, prev_att, k, v, enc_len, taps, wlp, locv, locb, temp: float):
    """Plain version: the kernel's arithmetic as PyTorch products."""
    b, w, s = prev_att.shape
    f = location_features(prev_att.reshape(b * w, 1, s), taps[:, None, :]).reshape(b, w, s, -1)
    e = torch.tanh(q[:, :, None, :] + k[:, None] + f @ wlp + locb)
    energy = e @ locv  # [B, W, S]
    mask = (torch.arange(s, device=q.device)[None, :] < enc_len[:, None])[:, None, :]
    energy = torch.where(mask, energy, NEG)
    align = torch.softmax(energy / temp, dim=-1)
    align = torch.where(mask, align, 0.0)
    ctx = torch.einsum("bws,bse->bwe", align, v)
    return align, ctx


PHASE_BUILD = ("ATT_PHASES",)  # the define of the kernel's timing build (bin/profile_decode.py)
# the phases the timing build times (csrc PH_*, in order)
PHASES = ("staging", "conv", "energies", "softmax", "context", "grid barrier", "align", "reduce")


@functools.lru_cache(maxsize=None)
def plan(b: int, w: int, s: int, dk: int, e_dim: int, kk: int, p: int) -> dict:
    """The kernel's launch plan from its own layout code and the card's
    occupancy (``e2e_att_step_plan``, asked once a shape): blocks of the
    cooperative grid (all resident), shared memory a block, floats of
    scratch a launch, utterances a launch (``group``). Raises where not even
    one utterance fits."""
    out = torch.zeros(4, dtype=torch.int32)
    lib = cuda_build.library("att_step")
    fn = lib.e2e_att_step_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(b, w, s, dk, e_dim, kk, p, out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"e2e_att_step_plan: {lib.e2e_error_string(err).decode()}")
    if int(out[0]) < 1:
        raise RuntimeError(f"att_step_beam_loc: no layout fits B={b} W={w} S={s} Dk={dk} E={e_dim}")
    return {"blocks": int(out[0]), "smem": int(out[1]), "scratch": int(out[2]), "group": int(out[3])}


def _launch(defines, q, prev_att, k, v, enc_len, taps, wlp, locv, locb, temp):
    """(align, ctx) from the kernel built with ``defines``, and its launches:
    one a group of the plan's utterances, in turn on one scratch."""
    q, prev_att, k, v, taps, wlp, locv, locb = (
        a.contiguous() for a in (q, prev_att, k, v, taps, wlp, locv, locb)
    )
    enc_len = (enc_len if enc_len.dtype == torch.int32 else enc_len.to(torch.int32)).contiguous()
    for a, name in ((q, "q"), (prev_att, "prev_att"), (k, "k"), (v, "v"), (taps, "taps"),
                    (wlp, "wlp"), (locv, "locv"), (locb, "locb")):
        cuda_build.check_cuda(a, f"att_step_beam_loc {name}")
    cuda_build.check_cuda(enc_len, "att_step_beam_loc enc_len", torch.int32)
    b, w, dk = q.shape
    s = prev_att.shape[2]
    e_dim = v.shape[2]
    kk, p = taps.shape
    if k.shape != (b, s, dk) or v.shape[:2] != (b, s) or wlp.shape != (kk, dk) or p % 2 != 1:
        raise ValueError(
            f"att_step_beam_loc: shapes q {tuple(q.shape)} prev_att {tuple(prev_att.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} taps {tuple(taps.shape)} wlp {tuple(wlp.shape)}"
        )
    pl = plan(b, w, s, dk, e_dim, kk, p)
    align = torch.empty((b, w, s), dtype=torch.float32, device=q.device)
    ctx = torch.empty((b, w, e_dim), dtype=torch.float32, device=q.device)
    scratch = torch.empty((pl["scratch"],), dtype=torch.float32, device=q.device)
    groups = range(0, b, pl["group"])
    for b0 in groups:
        g = slice(b0, min(b, b0 + pl["group"]))
        cuda_build.launch(
            "att_step", "e2e_att_step_beam_loc", q[g], prev_att[g], k[g], v[g], enc_len[g], taps, wlp, locv,
            locb, align[g], ctx[g], scratch, g.stop - b0, w, s, dk, e_dim, kk, p, 1.0 / float(temp),
            pl["blocks"], defines=defines,
        )
    return (align, ctx), len(groups)


def att_step_beam_loc(
    q, prev_att, k, v, enc_len, taps, wlp, locv, locb, temp: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if cuda_build.use_plain(q):
        return att_step_beam_loc_plain(q, prev_att, k, v, enc_len, taps, wlp, locv, locb, temp)
    out, n = _launch((), q, prev_att, k, v, enc_len, taps, wlp, locv, locb, temp)
    att_step_beam_loc.launches += n
    return out


att_step_beam_loc.launches = 0
