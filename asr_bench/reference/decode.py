"""The reference's rescoring of returned beam-search hypotheses, in the
search's own float32 arithmetic.

A hypothesis y_1..y_n scores the running total of its steps,

    s_i = s_(i-1) + [(1 - w) (att_i + m lm_i) + w (psi_i - psi_(i-1))],

over its length: n + 1 where it ends in <eos> (finished; its last step's
psi is the CTC probability of the whole of y_1..y_n), n where it does not
(still live when its utterance's window closed). att_i and lm_i are the
speller's and the LM's log-probabilities of token i after <sos>
y_1..y_(i-1), w the CTC weight, m the LM weight, psi_i the CTC prefix
probability of y_1..y_i (Watanabe et al.'s prefix recursion over the
utterance's valid frames, psi_0 = 0). Every sum is taken in float32 in the
order in which a float32 search forms it: the prefix recursion serially over
frames, the total step by step. A float32 search's scores then carry the same
roundings as these, and a gap between the two reads the model's and the
search's faults, not float32's rounding of totals near a thousand. Nothing
here depends on how the search found the hypothesis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from asr_bench.reference import model as M

EOS = 1
NEG = -1.0e30


def lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) with a NEG floor."""
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m > NEG / 2, out, NEG)


def empty_prefix(lp: torch.Tensor, t_len: torch.Tensor) -> torch.Tensor:
    """r^b of the empty prefix [N, T]: the cumulative blank log-probability,
    held at its last valid frame."""
    t = lp.shape[1]
    valid = torch.arange(t, device=lp.device)[None, :] < t_len[:, None]
    r_b = torch.cumsum(torch.where(valid, lp[:, :, 0], 0.0), dim=1)
    last = torch.gather(r_b, 1, torch.clamp(t_len - 1, min=0)[:, None].long())
    return torch.where(valid, r_b, last)


def prefix_f32(lp: torch.Tensor, t_len: torch.Tensor, tokens: torch.Tensor, n_tok: torch.Tensor,
               rb0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(psi [N, L] after each of a row's tokens, the CTC probability of the
    whole of its first ``n_tok`` tokens [N]) under float32 frame log-probs
    ``lp`` [N, T, V]. Frame by frame, every token of every row at once:
    token i's variables at frame t need only its own and token i - 1's at
    frame t - 1, so a loop over frames takes each token's serial recursion
    in its own order:

        phi    = r^b_(i-1)(t-1) (+ r^n_(i-1)(t-1) unless y_i = y_(i-1))
        r^n(t) = lse(r^n(t-1), phi) + p_t(y_i)
        r^b(t) = lse(r^b(t-1), r^n(t-1)) + p_t(blank)
        psi    = lse(psi, phi + p_t(y_i))

    with phi = 0 at t = 0 for the first token and NEG for the others, the
    variables held past ``t_len``; ``rb0`` [N, T] is the empty prefix's r^b
    (``empty_prefix``)."""
    n, t, _ = lp.shape
    big_l = tokens.shape[1]
    dev = lp.device
    toks = tokens.long().clamp(min=0)
    prev_tok = torch.cat([toks.new_zeros((n, 1)), toks[:, :-1]], 1)
    match = toks == prev_tok
    lpc = lp.gather(2, toks[:, None, :].expand(n, t, big_l))  # [N, T, L]
    neg = lp.new_full((n, big_l), NEG)
    rn, rb, psi = neg.clone(), neg.clone(), neg.clone()
    first = torch.arange(big_l, device=dev)[None, :] == 0
    for s in range(t):
        v = (s < t_len)[:, None]
        if s == 0:
            phi = torch.where(first, 0.0, NEG).expand(n, big_l)
        else:  # token i - 1's variables at frame s - 1 (the empty prefix's for token 0)
            g_n = torch.cat([lp.new_full((n, 1), NEG), rn[:, :-1]], 1)
            g_b = torch.cat([rb0[:, s - 1:s], rb[:, :-1]], 1)
            phi = lse(g_b, torch.where(match, NEG, g_n))
        phi = torch.where(v, phi, NEG)
        c = torch.where(v, lpc[:, s], 0.0)
        b = torch.where(v, lp[:, s, 0:1], 0.0)
        rn_s = lse(rn, phi) + c
        rb_s = lse(rb, rn) + b
        psi = torch.where(v, lse(psi, phi + c), psi)
        rn = torch.where(v, rn_s, rn)
        rb = torch.where(v, rb_s, rb)
    last = (n_tok - 1).clamp(min=0)[:, None]
    end_n = torch.where(n_tok > 0, rn.gather(1, last)[:, 0], NEG)
    end_b = torch.where(n_tok > 0, rb.gather(1, last)[:, 0],
                        rb0.gather(1, (t_len - 1).clamp(min=0)[:, None].long())[:, 0])
    return psi, lse(end_n, end_b)


@torch.no_grad()
def rescore(w: M.W, cfg: dict, wav: torch.Tensor, wav_len: torch.Tensor, tokens: torch.Tensor,
            lengths: torch.Tensor, dcfg: dict, pr: M.Precision) -> Dict[str, torch.Tensor]:
    """Reference scores [B, W] (float32) of the hypotheses ``tokens`` [B, W,
    L] of ``lengths`` [B, W] (<eos> included where there is one) of one batch
    of int16 waves, and what a valid result must satisfy: ``finished`` [B,
    W], ``max_len`` [B] (the utterance's token window)."""
    model = cfg["model"]
    with pr.active():
        feat, feat_len = M.features(wav, wav_len, cfg["data"]["audio"])
        enc, enc_len = M.encode(w, model, feat, feat_len, pr)
        b, nw, big_l = tokens.shape
        n = b * nw
        toks = tokens.reshape(n, big_l).long()
        lens = lengths.reshape(n).long().clamp(min=1)
        idx = (lens - 1).clamp(max=big_l - 1)
        finished = toks.gather(1, idx[:, None])[:, 0] == EOS
        rows = torch.arange(b, device=enc.device).repeat_interleave(nw)
        enc_n, enc_len_n = enc[rows], enc_len[rows]
        tokens_in = torch.cat([toks.new_zeros((n, 1)), toks[:, :-1]], 1)
        logits = M.speller(w, model, enc_n, enc_len_n, tokens_in, pr)
        step = torch.log_softmax(logits, -1).gather(2, toks[..., None])[..., 0]  # [N, L] float32
        lm_w, cw = dcfg["lm_weight"], dcfg["ctc_weight"]
        if lm_w > 0:
            step = step + lm_w * M.lm_log_probs(w, cfg["lm"], tokens_in, pr).gather(2, toks[..., None])[..., 0]
        if cw > 0:
            lp_b = M.ctc_log_probs(w, enc, pr)
            n_tok = torch.where(finished, lens - 1, lens)
            psi, full = prefix_f32(lp_b[rows], enc_len_n, toks, n_tok, empty_prefix(lp_b, enc_len)[rows])
            pos = torch.arange(big_l, device=enc.device)[None, :]
            term = torch.where(finished[:, None] & (pos == lens[:, None] - 1), full[:, None], psi)
            prev = torch.cat([psi.new_zeros((n, 1)), psi[:, :-1]], 1)
            step = (1.0 - cw) * step + cw * (term - prev)
        total = torch.zeros(n, dtype=torch.float32, device=enc.device)
        for i in range(big_l):
            total = torch.where(i < lens, total + step[:, i], total)
        score = total / lens.float()
        max_len = torch.clamp((dcfg["max_len_ratio"] * enc_len.float()).long(), max=big_l)  # float32, as the search
    return {"score": score.reshape(b, nw), "finished": finished.reshape(b, nw),
            "max_len": max_len, "enc_len": enc_len}


def check(tokens: torch.Tensor, lengths: torch.Tensor, scores: torch.Tensor, ref: Dict[str, torch.Tensor],
          vocab: int, max_step: int) -> Optional[str]:
    """What is wrong with a batch's returned hypotheses beside their scores,
    or None: lengths inside [1, max_step], ids inside the vocabulary, <eos>
    only at a finished hypothesis's end and inside the utterance's window,
    a live one exactly as long as that window, scores in descending order,
    no hypothesis twice in an utterance's list (a search keeps each path
    once)."""
    b, nw, big_l = tokens.shape
    if bool((lengths < 1).any()) or bool((lengths > max_step).any()):
        return "a length outside [1, max_step]"
    if bool((tokens < 0).any()) or bool((tokens >= vocab).any()):
        return "a token outside the vocabulary"
    pos = torch.arange(big_l, device=tokens.device)[None, None, :]
    inside = pos < lengths[..., None]
    eos_in = ((tokens == EOS) & inside & (pos < lengths[..., None] - 1)).any(-1)
    if bool(eos_in.any()):
        return "<eos> inside a hypothesis"
    win = ref["max_len"][:, None].expand(b, nw)
    fin = ref["finished"]
    if bool((fin & (lengths > win)).any()):
        return "a finished hypothesis past its utterance's window"
    if bool((~fin & (lengths != win.clamp(min=1))).any()):
        return "a live hypothesis shorter or longer than its utterance's window"
    if bool((scores[:, 1:] > scores[:, :-1]).any()):
        return "the n-best list out of order"
    real = scores > NEG / 2  # an utterance with fewer than W paths pads its list at NEG
    same = ((tokens[:, :, None] == tokens[:, None, :]).all(-1) & (lengths[:, :, None] == lengths[:, None, :])
            & real[:, :, None] & real[:, None, :])
    if bool((same & ~torch.eye(nw, dtype=torch.bool, device=tokens.device)).any()):
        return "a hypothesis twice in an n-best list"
    return None


def prefix_miss(tokens: torch.Tensor, lengths: torch.Tensor, live: torch.Tensor) -> Tuple[int, int]:
    """(how many, of how many) hypotheses ``tokens`` [B, W, L] of ``lengths``
    [B, W] with at least M = ``live.shape[2]`` tokens before <eos> do not
    begin with one of their utterance's live hypotheses after M steps of a
    search, ``live`` [B, W, M]: every hypothesis that a search returns grew
    from one it kept at each step."""
    m = live.shape[2]
    big_l = tokens.shape[2]
    last = tokens.gather(2, (lengths.long() - 1).clamp(0, big_l - 1)[..., None])[..., 0]
    n_tok = lengths.long() - (last == EOS).long()
    considered = n_tok >= m
    if m > big_l:
        return 0, 0
    kept = (tokens[:, :, None, :m] == live[:, None, :, :]).all(-1).any(-1)
    return int((considered & ~kept).sum()), int(considered.sum())
