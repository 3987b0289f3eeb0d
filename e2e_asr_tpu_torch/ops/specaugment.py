"""SpecAugment: frequency and time masks on the features.

Counterpart of ``e2e_asr_tpu/ops/specaugment.py``, split in two so that a
test can hand both packages the same masks: ``draw_masks`` draws the widths
and starts from a ``torch.Generator`` with the JAX package's ranges,
``apply_masks`` zeroes the masked bins (0 is the per-utterance mean after
CMVN). Per utterance and mask:

- frequency: width uniform in [0, freq_mask_width], start uniform in
  [0, max(D - freq_mask_width, 1));
- time: max_w = min(time_mask_width, int(feat_len * time_mask_ratio)),
  width = int(u * (max_w + 1)), start = int(u' * max(feat_len - width, 1))
  with u, u' uniform in [0, 1), so time masks stay inside the utterance.

The uniforms are drawn at the global batch's shape and each rank keeps its
rows (``parallel/dist.py`` ``global_draw``): an utterance's masks do not
depend on the world size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.config import SpecAugmentConfig
from e2e_asr_tpu_torch.parallel import dist


class Masks(NamedTuple):
    freq_start: torch.Tensor  # [B, freq_mask_num] long
    freq_width: torch.Tensor
    time_start: torch.Tensor  # [B, time_mask_num] long
    time_width: torch.Tensor


def draw_masks(
    feat_len: torch.Tensor, feat_dim: int, cfg: SpecAugmentConfig, generator: torch.Generator
) -> Masks:
    b = feat_len.shape[0]

    def uniform(n):
        return dist.global_draw(torch.rand, (b, n), generator).to(feat_len.device)

    nf, nt = cfg.freq_mask_num, cfg.time_mask_num
    fw = torch.floor(uniform(nf) * (cfg.freq_mask_width + 1)).long()
    fs = torch.floor(uniform(nf) * max(feat_dim - cfg.freq_mask_width, 1)).long()
    flen = feat_len.long()[:, None]
    max_w = torch.clamp((feat_len.float() * cfg.time_mask_ratio).long()[:, None], max=cfg.time_mask_width)
    tw = (uniform(nt) * (max_w + 1).float()).long()
    ts = (uniform(nt) * torch.clamp(flen - tw, min=1).float()).long()
    return Masks(fs, fw, ts, tw)


def apply_masks(feat: torch.Tensor, masks: Masks) -> torch.Tensor:
    """[B, T, D] -> features with every masked bin set to 0."""
    _, t, d = feat.shape
    fidx = torch.arange(d, device=feat.device)[None, None, :]
    tidx = torch.arange(t, device=feat.device)[None, None, :]
    fm = ((fidx >= masks.freq_start[..., None]) & (fidx < (masks.freq_start + masks.freq_width)[..., None])).any(1)
    tm = ((tidx >= masks.time_start[..., None]) & (tidx < (masks.time_start + masks.time_width)[..., None])).any(1)
    keep = ~(fm[:, None, :] | tm[:, :, None])
    return feat * keep.to(feat.dtype)


def specaugment(
    feat: torch.Tensor, feat_len: torch.Tensor, cfg: SpecAugmentConfig, generator: torch.Generator
) -> torch.Tensor:
    if not cfg.enable:
        return feat
    return apply_masks(feat, draw_masks(feat_len, feat.shape[2], cfg, generator))
