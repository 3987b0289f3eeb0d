"""Location-aware and scaled-dot attention, multi-head.

Counterpart of ``e2e_asr_tpu/models/attention.py`` (``attention_init``,
``prepare``, ``init_align``, ``step``, ``step_beam``). ``step`` (one query
per utterance: teacher-forced training and greedy decoding) is plain and
differentiable. ``prepare`` caches the key
projection once per utterance batch; it builds no Toeplitz bank: the
location conv reads its taps directly (ops/att_step_cuda.py). Inside the
kernel's envelope (location mode, one head, no value projection, no merge)
``step_beam`` is ``att_step_beam_loc`` (the hand-written kernel on CUDA
tensors); outside it, the plain path below, which mirrors the JAX XLA
branch. NEG = -1e9 masks padded frames before the temperature softmax, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from e2e_asr_tpu_torch.config import AttentionConfig
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params
from e2e_asr_tpu_torch.ops import att_step_cuda
from e2e_asr_tpu_torch.ops.att_step_cuda import NEG, location_features


def attention_init(
    gen: torch.Generator, enc_dim: int, dec_dim: int, cfg: AttentionConfig
) -> Tuple[Params, int]:
    """Returns (params, context_dim); context_dim == enc_dim always."""
    h, d = cfg.num_head, cfg.dim
    p: Params = {
        "proj_q": L.dense_init(gen, dec_dim, h * d),
        "proj_k": L.dense_init(gen, enc_dim, h * d, bias=False),
    }
    v_dim = d if cfg.v_proj else enc_dim
    if cfg.v_proj:
        p["proj_v"] = L.dense_init(gen, enc_dim, h * v_dim, bias=False)
    if h > 1 or cfg.v_proj:
        p["merge"] = L.dense_init(gen, h * v_dim, enc_dim)
    if cfg.mode == "location":
        p["loc_conv"] = L.conv1d_init(gen, cfg.loc_kernel_size * 2 + 1, h, cfg.loc_kernel_num)
        p["loc_proj"] = L.dense_init(gen, cfg.loc_kernel_num, d, bias=False)
        p["loc_v"] = L.uniform(gen, (h, d), 1.0 / math.sqrt(d))
        p["loc_b"] = torch.zeros((d,), device=gen.device)
    return p, enc_dim


def prepare(params: Params, cfg: AttentionConfig, enc: torch.Tensor, enc_len: torch.Tensor) -> Dict:
    """Cache per-utterance projections, k [B, H, S, d] and v [B, H, S, E],
    and what the beam step would otherwise recompute every step: enc_len as
    int32 and, in location mode, the folded bias locb = loc_b + loc_conv.b
    @ loc_proj."""
    b, s, e = enc.shape
    h, d = cfg.num_head, cfg.dim
    k = L.dense(params["proj_k"], enc).reshape(b, s, h, d).transpose(1, 2)
    if "proj_v" in params:
        v = L.dense(params["proj_v"], enc).reshape(b, s, h, d).transpose(1, 2)
    else:
        v = enc[:, None].expand(b, h, s, e)
    mask = torch.arange(s, device=enc.device)[None, :] < enc_len[:, None]  # [B, S]
    mem = {"k": k, "v": v, "mask": mask, "enc_len": enc_len, "enc_len32": enc_len.to(torch.int32)}
    if cfg.mode == "location":
        mem["locb"] = params["loc_b"] + params["loc_conv"]["b"] @ params["loc_proj"]["w"]
    return mem


def init_align(cfg: AttentionConfig, mem: Dict) -> torch.Tensor:
    """Uniform alignment over valid frames, [B, H, S]."""
    mask = mem["mask"]
    b, s = mask.shape
    uni = mask.float() / torch.clamp(mem["enc_len"], min=1)[:, None]
    return uni[:, None].expand(b, cfg.num_head, s)


def step(
    params: Params, cfg: AttentionConfig, query: torch.Tensor, mem: Dict, prev_att: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention step, one query per utterance.

    query: [B, dec_dim]; prev_att: [B, H, S].
    Returns (align [B, H, S], ctx [B, enc_dim])."""
    b = query.shape[0]
    h, d = cfg.num_head, cfg.dim
    k, v, mask = mem["k"], mem["v"], mem["mask"]
    s = k.shape[2]
    q = L.dense(params["proj_q"], query).reshape(b, h, d)
    if cfg.mode == "dot":
        energy = torch.einsum("bhd,bhsd->bhs", q, k) / math.sqrt(d)
    elif cfg.mode == "location":
        dt = q.dtype
        f = location_features(prev_att, params["loc_conv"]["w"].to(dt)) + params["loc_conv"]["b"].to(dt)
        f = L.dense(params["loc_proj"], f)  # [B, S, d]
        e = torch.tanh(q[:, :, None, :] + k + f[:, None] + params["loc_b"].to(dt))
        energy = torch.einsum("bhsd,hd->bhs", e, params["loc_v"].to(dt))
    else:
        raise ValueError(f"unknown attention mode {cfg.mode}")
    m = mask[:, None]
    energy = torch.where(m, energy, NEG)
    align = L.softmax(energy / cfg.temperature, dim=-1)
    align = torch.where(m, align, 0.0)
    ctx = torch.einsum("bhs,bhse->bhe", align, v).reshape(b, -1)
    if "merge" in params:
        ctx = torch.tanh(L.dense(params["merge"], ctx))
    return align, ctx


def step_beam(
    params: Params, cfg: AttentionConfig, query: torch.Tensor, mem: Dict, prev_att: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention step for W beams per utterance, memory untiled.

    query: [B, W, dec_dim]; prev_att: [B, W, H, S].
    Returns (align [B, W, H, S], ctx [B, W, enc_dim])."""
    b, w, _ = query.shape
    h, d = cfg.num_head, cfg.dim
    k, v, mask = mem["k"], mem["v"], mem["mask"]
    s = k.shape[2]
    q = L.dense(params["proj_q"], query).reshape(b, w, h, d)

    if att_step_cuda.supported(cfg, params):
        align, ctx = att_step_cuda.att_step_beam_loc(
            q[:, :, 0], prev_att[:, :, 0], k[:, 0], v[:, 0], mem["enc_len32"],
            params["loc_conv"]["w"][:, 0], params["loc_proj"]["w"], params["loc_v"][0], mem["locb"],
            temp=float(cfg.temperature),
        )
        return align[:, :, None], ctx

    if cfg.mode == "dot":
        energy = torch.einsum("bwhd,bhsd->bwhs", q, k) / math.sqrt(d)
    elif cfg.mode == "location":
        f = location_features(prev_att.reshape(b * w, h, s), params["loc_conv"]["w"])
        f = f + params["loc_conv"]["b"]
        f = L.dense(params["loc_proj"], f).reshape(b, w, s, d)
        e = torch.tanh(q[:, :, :, None, :] + k[:, None] + f[:, :, None] + params["loc_b"])
        energy = torch.einsum("bwhsd,hd->bwhs", e, params["loc_v"])
    else:
        raise ValueError(f"unknown attention mode {cfg.mode}")
    m = mask[:, None, None]
    energy = torch.where(m, energy, NEG)
    align = torch.softmax(energy / cfg.temperature, dim=-1)
    align = torch.where(m, align, 0.0)
    ctx = torch.einsum("bwhs,bhse->bwhe", align, v).reshape(b, w, -1)
    if "merge" in params:
        ctx = torch.tanh(L.dense(params["merge"], ctx))
    return align, ctx
