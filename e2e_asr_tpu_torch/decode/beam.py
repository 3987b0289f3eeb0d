"""Batched hybrid CTC/attention beam search with a fixed-shape masked beam.

Counterpart of ``e2e_asr_tpu/decode/beam.py`` ``beam_search`` as a Python
loop over ``max_step`` (the JAX package scans it). Every step advances all
(batch x beam) hypotheses at once: the beam-aware attention step
(models/attention.py ``step_beam``), the speller, top-k candidates, CTC
prefix rescoring (decode/ctc_prefix.py), finished-set routing of <eos>
candidates inside the length window, pruning to W live hypotheses, and the
per-utterance freeze once an utterance's window has closed.

Score semantics: per-step candidate score is the attention log-prob; with
ctc_weight w the top ``int(beam * ctc_beam_ratio)`` candidates are
prefix-rescored and the running total is (1-w)*att + w*psi_ctc (kept
additive through per-step psi deltas); finished hypotheses are ranked by
length-normalized score. RNN-LM shallow fusion comes with a later slice.

Behaviours copied from the JAX package on purpose (not faults):

- ``top_k`` tie order. ``jax.lax.top_k`` returns equal values lowest index
  first; ``torch.topk`` promises no order for ties. At t = 0 every beam but
  the first scores NEG, so ties are everywhere; ``top_k`` below is a stable
  descending sort, which keeps the JAX order.
- The NEG constants. Beam scores and CTC prefix variables use -1e30
  (decode/ctc_prefix.py); the attention mask uses -1e9 before its
  temperature softmax (models/attention.py). They are kept as they are.
- Frozen-step length normalisation. An utterance whose window closed
  (t >= max_len) freezes, so a live leftover has emitted exactly
  min(max_len, max_step) tokens, and the final ranking divides its score by
  that count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.config import DecodeConfig, ModelConfig
from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.decode import ctc_prefix
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.models import attention as att_mod
from e2e_asr_tpu_torch.models import decoder as dec_mod
from e2e_asr_tpu_torch.models import layers as L

NEG = -1.0e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, W, L] (eos-terminated, 0-padded)
    lengths: torch.Tensor  # [B, W] (incl. eos)
    scores: torch.Tensor  # [B, W] length-normalized, sorted desc


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, W, ...], idx: [B, W'] beam indices -> [B, W', ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def beam_search(
    params, cfg: ModelConfig, dcfg: DecodeConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    max_step: int,
) -> BeamResult:
    if dcfg.lm_weight > 0:
        raise NotImplementedError("RNN-LM shallow fusion: later slice")
    if cfg.emb_reg.enable and cfg.emb_reg.fuse > 0:
        raise NotImplementedError("embedding-regularizer fused decoding: later slice")
    w = dcfg.beam_size
    use_ctc = dcfg.ctc_weight > 0 and "ctc" in params
    dev = feat.device

    enc, enc_len = asr_mod.encode(params, cfg, feat, feat_len)
    b, s, _ = enc.shape
    mem = att_mod.prepare(params["attention"], cfg.attention, enc, enc_len)
    n_heads = cfg.attention.num_head
    vocab = params["decoder"]["char"]["w"].shape[1]

    ctc_lp = asr_mod.ctc_log_probs(params, enc) if use_ctc else None
    k_cand = min(vocab, max(w, int(w * dcfg.ctc_beam_ratio))) if use_ctc else vocab

    min_len = (dcfg.min_len_ratio * enc_len).to(torch.int32)  # [B]
    max_len = torch.clamp((dcfg.max_len_ratio * enc_len).to(torch.int32), max=max_step)

    init_att = att_mod.init_align(cfg.attention, mem)  # [B, H, S]
    prev_att = init_att[:, None].expand(b, w, n_heads, s).reshape(b * w, n_heads, s)
    tokens = torch.zeros((b, w, max_step), dtype=torch.long, device=dev)
    scores = torch.where(torch.arange(w, device=dev)[None, :] == 0, 0.0, NEG).expand(b, w).float()
    dec_state = dec_mod.init_state(b * w, cfg.decoder, dev)
    prev_tok = torch.zeros((b, w), dtype=torch.long, device=dev)
    r_g = (
        ctc_prefix.init_empty_prefix(ctc_lp, enc_len, w)
        if use_ctc
        else torch.zeros((b, w, 1, 2), device=dev)
    )
    psi_g = torch.zeros((b, w), device=dev)
    fin_tokens = torch.zeros((b, w, max_step), dtype=torch.long, device=dev)
    fin_scores = torch.full((b, w), NEG, device=dev)
    fin_len = torch.ones((b, w), dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None]

    for t in range(max_step):
        # ---- one decoder/attention step for all B*W hypotheses
        tok_flat = prev_tok.reshape(-1)
        emb = L.embed(params["embed"], tok_flat)
        query = dec_mod.query_of(dec_state)  # [B*W, H_dec]
        align_bw, ctx_bw = att_mod.step_beam(
            params["attention"], cfg.attention, query.reshape(b, w, -1), mem,
            prev_att.reshape(b, w, n_heads, s),
        )
        align = align_bw.reshape(b * w, n_heads, s)
        ctx = ctx_bw.reshape(b * w, -1)
        logits, _, new_dec_state = dec_mod.step(
            params["decoder"], cfg.decoder, dec_state, torch.cat([emb, ctx], -1)
        )
        step_lp = torch.log_softmax(logits, -1).reshape(b, w, vocab)

        # ---- candidate set + mixed scores
        if use_ctc:
            attlm_k, cand = top_k(step_lp, k_cand)  # [B, W, K]
            # candidates' prefix scores, their forward variables and each
            # beam's eos score: one kernel launch on the card
            psi_h, r_h, psi_eos = ctc_prefix.prefix_scores_fused(
                ctc_lp, mem["enc_len32"], r_g, prev_tok, cand, t == 0
            )
            is_eos = cand == EOS_ID
            ctc_term = torch.where(is_eos, psi_eos[:, :, None], psi_h)
            step_score = (1.0 - dcfg.ctc_weight) * attlm_k + dcfg.ctc_weight * (
                ctc_term - psi_g[:, :, None]
            )
        else:
            cand = torch.arange(vocab, device=dev)[None, None].expand(b, w, vocab)
            step_score = step_lp
            is_eos = cand == EOS_ID
            psi_h = None
        total = scores[:, :, None] + step_score  # [B, W, K]
        new_len = t + 1

        # ---- route eos candidates to the finished set (length-normalized)
        in_window = (new_len >= min_len) & (new_len <= max_len)  # [B]
        eos_avg = torch.where(is_eos & in_window[:, None, None], total / new_len, NEG)
        all_fin_scores = torch.cat([fin_scores, eos_avg.reshape(b, w * k_cand)], dim=1)
        top_fin, fin_idx = top_k(all_fin_scores, w)
        from_old = fin_idx < w
        old_idx = torch.clamp(fin_idx, 0, w - 1)
        par_idx = torch.clamp(torch.div(fin_idx - w, k_cand, rounding_mode="floor"), 0, w - 1)
        old_toks = _gather_beams(fin_tokens, old_idx)
        par_toks = _gather_beams(tokens, par_idx)
        par_toks[:, :, t] = EOS_ID
        new_fin_tokens = torch.where(from_old[:, :, None], old_toks, par_toks)
        new_fin_len = torch.where(from_old, _gather_beams(fin_len, old_idx), new_len)

        # ---- live expansion: non-eos candidates, prune to W
        live_total = torch.where(is_eos, NEG, total).reshape(b, w * k_cand)
        top_live, live_idx = top_k(live_total, w)
        parent = torch.div(live_idx, k_cand, rounding_mode="floor")  # [B, W]
        tok = torch.gather(cand.reshape(b, w * k_cand), 1, live_idx)
        new_tokens = _gather_beams(tokens, parent)
        new_tokens[:, :, t] = tok

        flat_parent = (parent + rows * w).reshape(-1)
        h, c = new_dec_state
        new_dec = (h[:, flat_parent], c[:, flat_parent])
        new_prev_att = align[flat_parent]
        if use_ctc:
            new_r_g = r_h[rows, parent, live_idx % k_cand]  # [B, W, T, 2]
            new_psi = torch.gather(
                torch.where(is_eos, NEG, psi_h).reshape(b, w * k_cand), 1, live_idx
            )
        else:
            new_r_g, new_psi = r_g, psi_g

        # ---- per-utterance termination: utterances whose window closed
        # (t >= max_len) freeze; no further score or token changes
        active = t < max_len  # [B]
        a1 = active[:, None]
        a2 = active[:, None, None]
        act_bw = active.repeat_interleave(w)  # [B*W]
        tokens = torch.where(a2, new_tokens, tokens)
        scores = torch.where(a1, top_live, scores)
        dec_state = tuple(
            torch.where(act_bw[None, :, None], n, o) for n, o in zip(new_dec, dec_state)
        )
        prev_att = torch.where(act_bw[:, None, None], new_prev_att, prev_att)
        prev_tok = torch.where(a1, tok, prev_tok)
        r_g = torch.where(active[:, None, None, None], new_r_g, r_g)
        psi_g = torch.where(a1, new_psi, psi_g)
        fin_tokens = torch.where(a2, new_fin_tokens, fin_tokens)
        fin_scores = torch.where(a1, top_fin, fin_scores)
        fin_len = torch.where(a1, new_fin_len, fin_len)

    # ---- final ranking: finished beams + length-normalized live leftovers
    live_len = torch.clamp(torch.clamp(max_len, max=max_step), min=1).long()  # [B]
    live_avg = scores / live_len[:, None]
    all_scores = torch.cat([fin_scores, live_avg], dim=1)  # [B, 2W]
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    all_len = torch.cat([fin_len, live_len[:, None].expand(b, w)], dim=1)
    top, idx = top_k(all_scores, w)
    out_tokens = _gather_beams(all_tokens, idx)
    lengths = torch.gather(all_len, 1, idx)
    pos = torch.arange(max_step, device=dev)[None, None, :]
    out_tokens = torch.where(pos < lengths[:, :, None], out_tokens, 0)
    return BeamResult(tokens=out_tokens, lengths=lengths, scores=top)
