"""Batched hybrid CTC/attention/LM beam search with a fixed-shape masked beam.

Counterpart of ``e2e_asr_tpu/decode/beam.py`` ``beam_search``, whose one
``lax.scan`` over ``max_step`` the JAX package compiles once a bucket shape.
Here the search is three parts: ``init_state`` fills the search's state as
contiguous buffers, ``beam_step`` advances it by one step in place (the
step index ``t`` is a 0-d device tensor inside the state, which the step
advances itself), and ``rank`` turns the final state into the result. On
CPU tensors, and on the card with ``graphs=False``, ``beam_search`` runs
``beam_step`` in a Python loop; on the card it replays the step as CUDA
graphs captured once a bucket shape and set of weights
(decode/beam_graph.py). Both run the same ``beam_step``. As in the JAX
scan, every batch runs all ``max_step`` steps; there is no early exit.

Every step advances all (batch x beam) hypotheses at once: the beam-aware
attention step (models/attention.py ``step_beam``), the speller (its
log-probs mixed with the embedding regularizer's at ``emb_reg.fuse`` > 0,
models/plugin.py), with
``lm_weight`` > 0 and an LM the RNN-LM's step (models/lm.py ``step``),
top-k candidates, CTC prefix rescoring (decode/ctc_prefix.py),
finished-set routing of <eos> candidates inside the length window, pruning
to W live hypotheses, and the per-utterance freeze once an utterance's
window has closed. The step makes no host synchronisation: it reads ``t``
on the device, writes the token of step ``t`` through a position mask and
follows parents with gathers.

Score semantics: per-step candidate score is att_log_prob + lm_weight *
lm_log_prob (shallow fusion, added before the top-k); with ctc_weight w the
top ``int(beam * ctc_beam_ratio)`` candidates are prefix-rescored and the
running total is (1-w)*(att+lm) + w*psi_ctc (kept additive through per-step
psi deltas); finished hypotheses are ranked by length-normalized score. The
LM's state follows its hypothesis through the pruning and freezes with the
utterance, as the speller's does.

Tracing (``utils/tracing.py``): ``beam_search`` spans ``prepare`` as
``decode.encoder``, the steps as ``decode.steps`` and ``rank`` as
``decode.rank``. A captured ``beam_step`` holds device stage marks before
the speller (``beam.speller``: embedding, attention, speller,
log-softmax), the LM (``beam.lm``: its step and the fused add), the
search (``beam.search``: top-k, CTC prefix scores, routing, pruning, the
state's writes) and, with an LM, the LM state's writes (``beam.lm`` again,
so that a step has two ``beam.lm`` intervals), and one at its end; the
time from a step's end to the next step's first mark is
``beam.between_steps``, or ``beam.between_batches`` before a batch's
step 0.

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

from typing import NamedTuple, Optional

import torch

from e2e_asr_tpu_torch.config import DecodeConfig, LMConfig, ModelConfig
from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.decode import ctc_prefix
from e2e_asr_tpu_torch.models import asr as asr_mod
from e2e_asr_tpu_torch.models import attention as att_mod
from e2e_asr_tpu_torch.models import decoder as dec_mod
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models import lm as lm_mod
from e2e_asr_tpu_torch.models import plugin as plugin_mod
from e2e_asr_tpu_torch.utils import tracing

NEG = -1.0e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, W, L] (eos-terminated, 0-padded)
    lengths: torch.Tensor  # [B, W] (incl. eos)
    scores: torch.Tensor  # [B, W] length-normalized, sorted desc


class BeamSpec(NamedTuple):
    """What a beam step holds fixed: the weights, the configs, the shapes."""
    params: dict
    cfg: ModelConfig
    dcfg: DecodeConfig
    lm_params: Optional[dict]
    lm_cfg: Optional[LMConfig]
    b: int
    w: int
    s: int  # encoder frames (the CTC head's T too)
    n_heads: int
    vocab: int
    k_cand: int  # candidates a beam
    max_step: int
    use_lm: bool
    use_ctc: bool


class StepInputs(NamedTuple):
    """What a beam step reads of one batch and never changes."""
    mem: dict  # models/attention.py ``prepare``
    ctc_lp: Optional[torch.Tensor]  # [B, T, V]
    min_len: torch.Tensor  # [B] int32
    max_len: torch.Tensor  # [B] int32, at most max_step


class BeamState(NamedTuple):
    """The search's state, contiguous buffers that ``beam_step`` updates in
    place (the LM's fields are None without an LM)."""
    t: torch.Tensor  # 0-d int64: the step about to run
    tokens: torch.Tensor  # [B, W, max_step] live hypotheses
    scores: torch.Tensor  # [B, W]
    dec_h: torch.Tensor  # [layers, B*W, H]
    dec_c: torch.Tensor
    lm_h: Optional[torch.Tensor]  # [layers, B*W, H_lm]
    lm_c: Optional[torch.Tensor]
    prev_att: torch.Tensor  # [B*W, heads, S]
    prev_tok: torch.Tensor  # [B, W]
    r_g: torch.Tensor  # [B, W, T, 2] CTC forward variables ([B, W, 1, 2] without CTC)
    psi_g: torch.Tensor  # [B, W]
    fin_tokens: torch.Tensor  # [B, W, max_step] finished hypotheses
    fin_scores: torch.Tensor  # [B, W]
    fin_len: torch.Tensor  # [B, W]


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, W, ...], idx: [B, W'] beam indices -> [B, W', ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def follow_parents(new, old, flat_parent: torch.Tensor, act_bw: torch.Tensor):
    """A recurrent (h, c) state [layers, B*W, H] after pruning, written into
    ``old`` (returned): each surviving hypothesis takes its parent's new
    state (``flat_parent`` [B*W]), and rows of a frozen utterance (``act_bw``
    False) keep their old one."""
    return tuple(torch.where(act_bw[None, :, None], n.index_select(1, flat_parent), o, out=o)
                 for n, o in zip(new, old))


def _own(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def prepare(
    params, cfg: ModelConfig, dcfg: DecodeConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    max_step: int, lm_params=None, lm_cfg: Optional[LMConfig] = None,
):
    """Encode one batch: (BeamSpec, StepInputs)."""
    w = dcfg.beam_size
    use_lm = dcfg.lm_weight > 0 and lm_params is not None
    use_ctc = dcfg.ctc_weight > 0 and "ctc" in params

    enc, enc_len = asr_mod.encode(params, cfg, feat, feat_len)
    b, s, _ = enc.shape
    mem = att_mod.prepare(params["attention"], cfg.attention, enc, enc_len)
    vocab = params["decoder"]["char"]["w"].shape[1]
    ctc_lp = asr_mod.ctc_log_probs(params, enc) if use_ctc else None
    k_cand = min(vocab, max(w, int(w * dcfg.ctc_beam_ratio))) if use_ctc else vocab
    min_len = (dcfg.min_len_ratio * enc_len).to(torch.int32)  # [B]
    max_len = torch.clamp((dcfg.max_len_ratio * enc_len).to(torch.int32), max=max_step)
    spec = BeamSpec(params, cfg, dcfg, lm_params if use_lm else None, lm_cfg if use_lm else None,
                    b, w, s, cfg.attention.num_head, vocab, k_cand, max_step, use_lm, use_ctc)
    return spec, StepInputs(mem, ctc_lp, min_len, max_len)


def init_state(spec: BeamSpec, inp: StepInputs) -> BeamState:
    """The state before step 0, every field a buffer of its own."""
    b, w, m = spec.b, spec.w, spec.max_step
    dev = inp.min_len.device
    init_att = att_mod.init_align(spec.cfg.attention, inp.mem)  # [B, H, S]
    dec = dec_mod.init_state(b * w, spec.cfg.decoder, dev)
    lm = lm_mod.init_state(b * w, spec.lm_cfg, dev) if spec.use_lm else (None, None)
    r_g = (ctc_prefix.init_empty_prefix(inp.ctc_lp, inp.mem["enc_len"], w)
           if spec.use_ctc else torch.zeros((b, w, 1, 2), device=dev))
    return BeamState(
        t=torch.zeros((), dtype=torch.long, device=dev),
        tokens=torch.zeros((b, w, m), dtype=torch.long, device=dev),
        scores=_own(torch.where(torch.arange(w, device=dev)[None, :] == 0, 0.0, NEG).expand(b, w).float()),
        dec_h=_own(dec[0]), dec_c=_own(dec[1]),
        lm_h=None if lm[0] is None else _own(lm[0]), lm_c=None if lm[1] is None else _own(lm[1]),
        prev_att=_own(init_att[:, None].expand(b, w, spec.n_heads, spec.s).reshape(b * w, spec.n_heads, spec.s)),
        prev_tok=torch.zeros((b, w), dtype=torch.long, device=dev),
        r_g=_own(r_g),
        psi_g=torch.zeros((b, w), device=dev),
        fin_tokens=torch.zeros((b, w, m), dtype=torch.long, device=dev),
        fin_scores=torch.full((b, w), NEG, device=dev),
        fin_len=torch.ones((b, w), dtype=torch.long, device=dev),
    )


def beam_step(spec: BeamSpec, inp: StepInputs, st: BeamState, first: bool) -> None:
    """Step ``st.t`` of the search, written into ``st`` in place; advances
    ``st.t``. ``first`` says that ``st.t`` is 0 (the CTC prefix kernel's
    ``prefix_is_empty`` argument). No host synchronisation."""
    params, cfg, dcfg = spec.params, spec.cfg, spec.dcfg
    b, w, s, n_heads, vocab, k_cand = spec.b, spec.w, spec.s, spec.n_heads, spec.vocab, spec.k_cand
    t = st.t

    # ---- one decoder/attention step for all B*W hypotheses
    tracing.mark("beam.speller", gap="beam.between_batches" if first else "beam.between_steps")
    tok_flat = st.prev_tok.reshape(-1)
    emb = L.embed(params["embed"], tok_flat)
    dec_state = (st.dec_h, st.dec_c)
    query = dec_mod.query_of(dec_state)  # [B*W, H_dec]
    align_bw, ctx_bw = att_mod.step_beam(
        params["attention"], cfg.attention, query.reshape(b, w, -1), inp.mem,
        st.prev_att.reshape(b, w, n_heads, s),
    )
    ctx = ctx_bw.reshape(b * w, -1)
    logits, hidden, new_dec_state = dec_mod.step(params["decoder"], cfg.decoder, dec_state, torch.cat([emb, ctx], -1))
    if "emb_reg" in params and cfg.emb_reg.fuse > 0:
        logits = plugin_mod.fused_log_probs(params["emb_reg"], cfg.emb_reg, logits, hidden)
    step_lp = torch.log_softmax(logits, -1).reshape(b, w, vocab)
    if spec.use_lm:
        tracing.mark("beam.lm")
        lm_lp, new_lm_state = lm_mod.step(spec.lm_params, spec.lm_cfg, tok_flat, (st.lm_h, st.lm_c))
        step_lp = step_lp + dcfg.lm_weight * lm_lp.reshape(b, w, vocab)

    # ---- candidate set + mixed scores
    tracing.mark("beam.search")
    if spec.use_ctc:
        attlm_k, cand = top_k(step_lp, k_cand)  # [B, W, K]
        # candidates' prefix scores, their forward variables and each
        # beam's eos score: one kernel launch on the card
        psi_h, r_h, psi_eos = ctc_prefix.prefix_scores_fused(
            inp.ctc_lp, inp.mem["enc_len32"], st.r_g, st.prev_tok, cand, first
        )
        is_eos = cand == EOS_ID
        ctc_term = torch.where(is_eos, psi_eos[:, :, None], psi_h)
        step_score = (1.0 - dcfg.ctc_weight) * attlm_k + dcfg.ctc_weight * (ctc_term - st.psi_g[:, :, None])
    else:
        cand = torch.arange(vocab, device=t.device)[None, None].expand(b, w, vocab)
        step_score = step_lp
        is_eos = cand == EOS_ID
    total = st.scores[:, :, None] + step_score  # [B, W, K]
    new_len = t + 1
    at_t = torch.arange(spec.max_step, device=t.device) == t  # [max_step]: the token of this step

    # ---- route eos candidates to the finished set (length-normalized)
    in_window = (new_len >= inp.min_len) & (new_len <= inp.max_len)  # [B]
    eos_avg = torch.where(is_eos & in_window[:, None, None], total / new_len, NEG)
    all_fin_scores = torch.cat([st.fin_scores, eos_avg.reshape(b, w * k_cand)], dim=1)
    top_fin, fin_idx = top_k(all_fin_scores, w)
    from_old = fin_idx < w
    old_idx = torch.clamp(fin_idx, 0, w - 1)
    par_idx = torch.clamp(torch.div(fin_idx - w, k_cand, rounding_mode="floor"), 0, w - 1)
    old_toks = _gather_beams(st.fin_tokens, old_idx)
    par_toks = torch.where(at_t, EOS_ID, _gather_beams(st.tokens, par_idx))
    new_fin_tokens = torch.where(from_old[:, :, None], old_toks, par_toks)
    new_fin_len = torch.where(from_old, _gather_beams(st.fin_len, old_idx), new_len)

    # ---- live expansion: non-eos candidates, prune to W
    live_total = torch.where(is_eos, NEG, total).reshape(b, w * k_cand)
    top_live, live_idx = top_k(live_total, w)
    parent = torch.div(live_idx, k_cand, rounding_mode="floor")  # [B, W]
    tok = torch.gather(cand.reshape(b, w * k_cand), 1, live_idx)
    new_tokens = torch.where(at_t, tok[:, :, None], _gather_beams(st.tokens, parent))

    flat_parent = (parent + torch.arange(b, device=t.device)[:, None] * w).reshape(-1)
    new_prev_att = align_bw.reshape(b * w, n_heads, s).index_select(0, flat_parent)
    if spec.use_ctc:
        new_r_g = _gather_beams(r_h.reshape(b, w * k_cand, s, 2), live_idx)  # [B, W, T, 2]
        new_psi = torch.gather(torch.where(is_eos, NEG, psi_h).reshape(b, w * k_cand), 1, live_idx)

    # ---- per-utterance termination: utterances whose window closed
    # (t >= max_len) freeze; no further score or token changes. Every
    # field is written in place, after all of the step's reads.
    active = t < inp.max_len  # [B]
    a1 = active[:, None]
    a2 = active[:, None, None]
    act_bw = a1.expand(b, w).reshape(-1)  # [B*W]
    torch.where(a2, new_tokens, st.tokens, out=st.tokens)
    torch.where(a1, top_live, st.scores, out=st.scores)
    follow_parents(new_dec_state, dec_state, flat_parent, act_bw)
    torch.where(act_bw[:, None, None], new_prev_att, st.prev_att, out=st.prev_att)
    torch.where(a1, tok, st.prev_tok, out=st.prev_tok)
    if spec.use_ctc:
        torch.where(active[:, None, None, None], new_r_g, st.r_g, out=st.r_g)
        torch.where(a1, new_psi, st.psi_g, out=st.psi_g)
    torch.where(a2, new_fin_tokens, st.fin_tokens, out=st.fin_tokens)
    torch.where(a1, top_fin, st.fin_scores, out=st.fin_scores)
    torch.where(a1, new_fin_len, st.fin_len, out=st.fin_len)
    t.add_(1)
    if spec.use_lm:
        # the LM's state follows its hypotheses: the LM's work, marked as
        # such (nothing above reads or writes the LM's state)
        tracing.mark("beam.lm")
        follow_parents(new_lm_state, (st.lm_h, st.lm_c), flat_parent, act_bw)
    tracing.mark(None)


def rank(spec: BeamSpec, inp: StepInputs, st: BeamState) -> BeamResult:
    """Final ranking: finished beams + length-normalized live leftovers."""
    b, w, max_step = spec.b, spec.w, spec.max_step
    live_len = torch.clamp(torch.clamp(inp.max_len, max=max_step), min=1).long()  # [B]
    live_avg = st.scores / live_len[:, None]
    all_scores = torch.cat([st.fin_scores, live_avg], dim=1)  # [B, 2W]
    all_tokens = torch.cat([st.fin_tokens, st.tokens], dim=1)
    all_len = torch.cat([st.fin_len, live_len[:, None].expand(b, w)], dim=1)
    top, idx = top_k(all_scores, w)
    out_tokens = _gather_beams(all_tokens, idx)
    lengths = torch.gather(all_len, 1, idx)
    pos = torch.arange(max_step, device=out_tokens.device)[None, None, :]
    out_tokens = torch.where(pos < lengths[:, :, None], out_tokens, 0)
    return BeamResult(tokens=out_tokens, lengths=lengths, scores=top)


@torch.inference_mode()
def beam_search(
    params, cfg: ModelConfig, dcfg: DecodeConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    max_step: int, lm_params=None, lm_cfg: Optional[LMConfig] = None, *, graphs: bool = True,
    graph_cache=None,
) -> BeamResult:
    """Decode one batch. On the card (``graphs`` True, the default) the
    steps replay CUDA graphs from ``graph_cache`` (a
    ``decode.beam_graph.BeamGraphs``; without one, graphs captured for this
    call alone); ``graphs=False`` runs the eager loop there, for
    comparison. CPU tensors always take the eager loop."""
    with tracing.span("decode.encoder"):
        spec, inp = prepare(params, cfg, dcfg, feat, feat_len, max_step, lm_params, lm_cfg)
    with tracing.span("decode.steps"):
        if feat.device.type == "cuda" and graphs:
            from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs

            st = (graph_cache if graph_cache is not None else BeamGraphs()).run(spec, inp)
        else:
            st = init_state(spec, inp)
            for i in range(max_step):
                beam_step(spec, inp, st, first=i == 0)
    with tracing.span("decode.rank"):
        return rank(spec, inp, st)
