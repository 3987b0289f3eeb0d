"""The reference's beam search: the search's semantics in plain PyTorch, its
scores in float64.

Per step, every live hypothesis of every utterance is extended at once: the
speller's log-probabilities (and the LM's, weighted by m) give each beam its
``k = min(V, max(W, int(W * ctc_beam_ratio)))`` best candidates (ties to the
lower id); with CTC weight w a candidate scores

    total = s + (1 - w) (att + m lm) + w (psi(prefix + c) - psi(prefix)),

psi(prefix + <eos>) being the CTC probability of the whole prefix. <eos>
candidates inside the utterance's token window [min_len_ratio, max_len_ratio]
x encoder frames join the finished set at total / length; the others compete
for the W live places (ties to the lower beam, then the lower candidate). An
utterance whose window has closed keeps its state. At the end the finished
set and the live hypotheses (over their window's length) are ranked together
and the best W returned. Beam 0 starts alone at score 0; the others at NEG.

The CTC prefix probabilities follow the recursion of ``decode.prefix_f32``
in closed form over frames (cumulative sums and log-cumulative-sum-exps), in
float64. ``skip_best`` plants a fault for the check's tests: every step's
best live candidate is pruned.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from asr_bench.reference import model as M
from asr_bench.reference.decode import EOS, NEG


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, W, ...] at beam indices idx [B, W'] -> [B, W', ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _shift(x: torch.Tensor, first: float) -> torch.Tensor:
    """x[..., t - 1] along the last axis, ``first`` at t = 0."""
    return torch.cat([torch.full_like(x[..., :1], first), x[..., :-1]], -1)


def empty_prefix64(lp: torch.Tensor, t_len: torch.Tensor) -> torch.Tensor:
    """(r^n, r^b) [B, T, 2] of the empty prefix under float64 frame
    log-probs [B, T, V]."""
    valid = torch.arange(lp.shape[1], device=lp.device)[None, :] < t_len[:, None]
    r_b = torch.cumsum(torch.where(valid, lp[:, :, 0], 0.0), 1)
    return torch.stack([torch.full_like(r_b, NEG), r_b], -1)


def prefix_scores(lp: torch.Tensor, t_len: torch.Tensor, r_g: torch.Tensor, last: torch.Tensor,
                  cand: torch.Tensor, first: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(psi [B, W, K], the candidates' (r^n, r^b) [B, W, K, T, 2], each
    beam's <eos> score [B, W]) of every candidate ``cand`` [B, W, K] after
    its beam's prefix, whose variables are ``r_g`` [B, W, T, 2] and last
    token ``last`` [B, W]; ``lp`` [B, T, V] float64. Frames past ``t_len``
    are not read (their variables are not the held ones)."""
    b, w, k = cand.shape
    t = lp.shape[1]
    valid = (torch.arange(t, device=lp.device)[None, :] < t_len[:, None])[:, None, None, :]  # [B, 1, 1, T]
    lpc = lp.gather(2, cand.reshape(b, 1, w * k).expand(b, t, w * k)).reshape(b, t, w, k).permute(0, 2, 3, 1)
    lpc = torch.where(valid, lpc, 0.0)
    lpb = torch.where(valid[:, :, 0], lp[:, None, :, 0], 0.0)  # [B, 1, T]
    r_n, r_b = r_g[..., 0][:, :, None], r_g[..., 1][:, :, None]  # [B, W, 1, T]
    match = (cand == last[:, :, None])[..., None]
    phi = torch.logaddexp(r_b, torch.where(match, NEG, r_n))
    phi_prev = torch.where(valid, _shift(phi, 0.0 if first else NEG), NEG)
    psi = torch.logsumexp(torch.where(valid, phi_prev + lpc, NEG), -1)
    a = torch.cumsum(lpc, -1)
    rn = a + torch.logcumsumexp(phi_prev - _shift(a, 0.0), -1)
    bc = torch.cumsum(lpb, -1)[:, :, None]  # [B, 1, 1, T]
    rb = bc + torch.logcumsumexp(_shift(rn, NEG) - _shift(bc, 0.0), -1)
    end = (t_len - 1).clamp(min=0).long()[:, None, None].expand(b, w, 1)
    eos = torch.logaddexp(r_g[..., 0].gather(2, end)[..., 0], r_g[..., 1].gather(2, end)[..., 0])
    return psi, torch.stack([rn, rb], -1), eos


@torch.no_grad()
def search(arch, w: M.W, cfg: dict, wav: torch.Tensor, wav_len: torch.Tensor, dcfg: dict, max_step: int,
           pr: M.Precision, skip_best: bool = False, stop: int = 0) -> Dict[str, torch.Tensor]:
    """The n-best of one batch of int16 waves under architecture module
    ``arch``: ``tokens`` [B, W, max_step] (<eos>-terminated, 0-padded),
    ``lengths`` [B, W] (<eos> included), ``scores`` [B, W] (float64, best
    first). With ``stop`` > 0, only the live
    hypotheses after that many steps: ``live`` [B, W, stop]."""
    model = cfg["model"]
    nw, lm_w, cw = dcfg["beam_size"], dcfg["lm_weight"], dcfg["ctc_weight"]
    with pr.active():
        feat, feat_len = M.features(wav, wav_len, cfg["data"]["audio"])
        enc, enc_len = arch.encode(w, model, feat, feat_len, pr)
        b, s, _ = enc.shape
        dev = enc.device
        n = b * nw
        rows = torch.arange(b, device=dev).repeat_interleave(nw)
        mem = arch.speller_setup(w, model, enc[rows], enc_len[rows], pr)
        vocab = w["ctc.w"].shape[1]
        k = min(vocab, max(nw, int(nw * dcfg["ctc_beam_ratio"]))) if cw > 0 else vocab
        min_len = (dcfg["min_len_ratio"] * enc_len).to(torch.int32)
        max_len = torch.clamp((dcfg["max_len_ratio"] * enc_len).to(torch.int32), max=max_step)
        state = arch.speller_state(w, mem)
        if lm_w > 0:
            lm_layers, lm_d = cfg["lm"]["n_layers"], cfg["lm"]["dim"]
            lm_state = ([enc.new_zeros((n, lm_d)) for _ in range(lm_layers)],
                        [enc.new_zeros((n, lm_d)) for _ in range(lm_layers)])
        lp = arch.ctc_log_probs(w, enc, pr).double() if cw > 0 else None
        r_g = empty_prefix64(lp, enc_len)[:, None].expand(b, nw, s, 2).clone() if cw > 0 else None
        f64 = dict(dtype=torch.float64, device=dev)
        scores = torch.where(torch.arange(nw, device=dev)[None, :] == 0, 0.0, NEG).to(**f64).expand(b, nw).clone()
        psi_g = torch.zeros((b, nw), **f64)
        tokens = torch.zeros((b, nw, max_step), dtype=torch.long, device=dev)
        prev_tok = torch.zeros((b, nw), dtype=torch.long, device=dev)
        fin_tokens = torch.zeros_like(tokens)
        fin_scores = torch.full((b, nw), NEG, **f64)
        fin_len = torch.ones((b, nw), dtype=torch.long, device=dev)
        for t in range(stop or max_step):
            tok_flat = prev_tok.reshape(-1)
            logits, new_state = arch.speller_step(w, mem, tok_flat, state, pr)
            step_lp = torch.log_softmax(logits, -1).double().reshape(b, nw, vocab)
            if lm_w > 0:
                lm_lp, lm_new = M.lm_step(w, cfg["lm"], tok_flat, lm_state, pr)
                step_lp = step_lp + lm_w * lm_lp.double().reshape(b, nw, vocab)
            if cw > 0:
                attlm, cand = top_k(step_lp, k)
                psi_h, r_h, psi_eos = prefix_scores(lp, enc_len, r_g, prev_tok, cand, t == 0)
                is_eos = cand == EOS
                step_score = (1.0 - cw) * attlm + cw * (torch.where(is_eos, psi_eos[:, :, None], psi_h)
                                                        - psi_g[:, :, None])
            else:
                cand = torch.arange(vocab, device=dev)[None, None].expand(b, nw, vocab)
                step_score, is_eos = step_lp, cand == EOS
            total = scores[:, :, None] + step_score
            new_len = t + 1
            at_t = torch.arange(max_step, device=dev) == t
            in_window = (new_len >= min_len) & (new_len <= max_len)
            eos_avg = torch.where(is_eos & in_window[:, None, None], total / new_len, NEG)
            top_fin, fin_idx = top_k(torch.cat([fin_scores, eos_avg.reshape(b, nw * k)], 1), nw)
            from_old = fin_idx < nw
            old_idx = fin_idx.clamp(0, nw - 1)
            par_idx = torch.div(fin_idx - nw, k, rounding_mode="floor").clamp(0, nw - 1)
            new_fin_tokens = torch.where(from_old[:, :, None], _gather(fin_tokens, old_idx),
                                         torch.where(at_t, EOS, _gather(tokens, par_idx)))
            new_fin_len = torch.where(from_old, _gather(fin_len, old_idx), new_len)
            live = torch.where(is_eos, NEG, total).reshape(b, nw * k)
            if skip_best:
                top_live, live_idx = top_k(live, nw + 1)
                top_live, live_idx = top_live[:, 1:], live_idx[:, 1:]
            else:
                top_live, live_idx = top_k(live, nw)
            parent = torch.div(live_idx, k, rounding_mode="floor")
            tok = torch.gather(cand.reshape(b, nw * k), 1, live_idx)
            flat_parent = (parent + torch.arange(b, device=dev)[:, None] * nw).reshape(-1)
            active = t < max_len
            a1, a2 = active[:, None], active[:, None, None]
            act = a1.expand(b, nw).reshape(-1)[:, None]
            tokens = torch.where(a2, torch.where(at_t, tok[:, :, None], _gather(tokens, parent)), tokens)
            scores = torch.where(a1, top_live, scores)
            state = tuple(torch.where(act.view((-1,) + (1,) * (o.dim() - 1)), x[flat_parent], o)
                          for x, o in zip(new_state, state))
            if lm_w > 0:
                lm_state = tuple([torch.where(act, x[flat_parent], o) for x, o in zip(new, old)]
                                 for new, old in zip(lm_new, lm_state))
            prev_tok = torch.where(a1, tok, prev_tok)
            if cw > 0:
                r_g = torch.where(active[:, None, None, None], _gather(r_h.reshape(b, nw * k, s, 2), live_idx), r_g)
                psi_g = torch.where(a1, torch.gather(torch.where(is_eos, NEG, psi_h).reshape(b, nw * k), 1,
                                                     live_idx), psi_g)
            fin_tokens = torch.where(a2, new_fin_tokens, fin_tokens)
            fin_scores = torch.where(a1, top_fin, fin_scores)
            fin_len = torch.where(a1, new_fin_len, fin_len)
        if stop:
            return {"live": tokens[:, :, :stop]}
        live_len = max_len.clamp(min=1).long()
        top, idx = top_k(torch.cat([fin_scores, scores / live_len[:, None]], 1), nw)
        lengths = torch.gather(torch.cat([fin_len, live_len[:, None].expand(b, nw)], 1), 1, idx)
        out = _gather(torch.cat([fin_tokens, tokens], 1), idx)
        out = torch.where(torch.arange(max_step, device=dev)[None, None, :] < lengths[:, :, None], out, 0)
    return {"tokens": out, "lengths": lengths, "scores": top}
