"""The joint CTC/attention ASR model (Listen-Attend-Spell + CTC head).

Counterpart of ``e2e_asr_tpu/models/asr.py``: ``asr_init`` builds the
same parameter tree from a seeded ``torch.Generator`` (the numbers differ
from ``jax.random``; ``convert.py`` carries JAX weights over), ``encode``
runs the encoder, ``ctc_log_probs`` the CTC head, ``attend_and_step`` one
speller step and ``forward`` the teacher-forced training/eval forward.

The JAX forward is a ``lax.scan`` over target positions (or the fused
Pallas decoder scan where the TPU picks it); here it is a Python loop over
the steps, recorded by autograd. Random draws (dropout, the per-step
teacher-forcing coins, sampled feedback) come from one explicit
``torch.Generator`` and cannot reproduce ``jax.random``'s numbers.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import ModelConfig
from e2e_asr_tpu_torch.models import attention as att_mod
from e2e_asr_tpu_torch.models import decoder as dec_mod
from e2e_asr_tpu_torch.models import encoder as enc_mod
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params


class ASRShapes(NamedTuple):
    enc_dim: int
    ctx_dim: int
    emb_dim: int
    vocab: int


def asr_init(
    seed: int, feat_dim: int, vocab: int, cfg: ModelConfig, device: torch.device
) -> Tuple[Params, ASRShapes]:
    if cfg.emb_reg.enable:
        raise NotImplementedError("embedding-regularizer plugin: later slice")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Params = {}
    p["encoder"], enc_dim = enc_mod.encoder_init(gen, feat_dim, cfg.encoder)
    ctx_dim = enc_dim
    emb_dim = cfg.decoder.dim
    if cfg.ctc_weight > 0:
        p["ctc"] = L.dense_init(gen, enc_dim, vocab)
    if cfg.ctc_weight < 1:
        p["embed"] = L.embedding_init(gen, vocab, emb_dim)
        p["attention"], ctx_dim = att_mod.attention_init(gen, enc_dim, cfg.decoder.dim, cfg.attention)
        p["decoder"] = dec_mod.decoder_init(gen, ctx_dim + emb_dim, vocab, cfg.decoder)
    return p, ASRShapes(enc_dim, ctx_dim, emb_dim, vocab)


def encode(
    params: Params, cfg: ModelConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
):
    return enc_mod.encoder_apply(params["encoder"], cfg.encoder, feat, feat_len, generator, train)


def ctc_log_probs(params: Params, enc: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(L.dense(params["ctc"], enc), dim=-1)


class DecodeCarry(NamedTuple):
    dec_state: dec_mod.State
    prev_att: torch.Tensor  # [B, H, S]
    prev_tok: torch.Tensor  # [B] long


def init_carry(params: Params, cfg: ModelConfig, enc: torch.Tensor, enc_len: torch.Tensor):
    """(attention memory, the speller's carry before <sos>)."""
    mem = att_mod.prepare(params["attention"], cfg.attention, enc, enc_len)
    b = enc.shape[0]
    carry = DecodeCarry(
        dec_mod.init_state(b, cfg.decoder, enc.device),
        att_mod.init_align(cfg.attention, mem),
        torch.zeros((b,), dtype=torch.long, device=enc.device),  # <sos>
    )
    return mem, carry


def attend_and_step(
    params: Params, cfg: ModelConfig, mem: Dict, carry: DecodeCarry, tok: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
):
    """Embed ``tok``, attend with the current decoder state as query
    (attention before the RNN step), then advance the speller. Returns
    (logits, align, hidden, new_carry)."""
    emb = L.embed(params["embed"], tok)
    query = dec_mod.query_of(carry.dec_state)
    align, ctx = att_mod.step(params["attention"], cfg.attention, query, mem, carry.prev_att)
    logits, hidden, new_state = dec_mod.step(
        params["decoder"], cfg.decoder, carry.dec_state, torch.cat([emb, ctx], -1),
        generator=generator, train=train,
    )
    return logits, align, hidden, DecodeCarry(new_state, align, tok)


def forward(
    params: Params,
    cfg: ModelConfig,
    feat: torch.Tensor,
    feat_len: torch.Tensor,
    decode_step: int,
    tf_rate: float = 1.0,
    teacher: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    sample_decoding: bool = True,
) -> Dict[str, torch.Tensor]:
    """Training/eval forward.

    teacher: [B, L] target ids (with <eos>, 0-padded). The speller's inputs
    are the right-shifted targets starting from <sos> = 0. One coin per step
    for the whole batch, drawn up front (``uniform < tf_rate``); where a
    training step's coin fails, the previous prediction is fed back instead,
    sampled from the output distribution when ``sample_decoding``, its
    argmax otherwise (drawn only for the steps that feed it back). Outside
    training the teacher is always used.

    Returns ctc_log_probs [B, S, V] (with a CTC head), enc_len [B], enc, and
    with an attention head att_logits [B, L, V], align [B, L, H, S],
    att_hidden [B, L, H_dec]."""
    enc, enc_len = encode(params, cfg, feat, feat_len, generator, train)
    out: Dict[str, torch.Tensor] = {"enc_len": enc_len, "enc": enc}
    if "ctc" in params:
        out["ctc_log_probs"] = ctc_log_probs(params, enc)
    if "decoder" not in params:
        return out
    if teacher is None:
        raise ValueError("the attention head needs teacher tokens")

    b = feat.shape[0]
    teacher = teacher.long()
    teacher_in = torch.cat([teacher.new_zeros((b, 1)), teacher[:, : decode_step - 1]], dim=1)
    dev = enc.device
    if generator is not None:
        coins = torch.rand((decode_step,), generator=generator, device=generator.device) < tf_rate
        coins = coins.cpu().tolist()
    else:
        coins = [True] * decode_step
    use_teacher = [c or not train for c in coins]
    mem, carry = init_carry(params, cfg, enc, enc_len)
    logits_all, aligns, hiddens = [], [], []
    for t in range(decode_step):
        tok = teacher_in[:, t] if use_teacher[t] else carry.prev_tok
        logits, align, hidden, carry = attend_and_step(
            params, cfg, mem, carry, tok, generator=generator, train=train
        )
        if t + 1 < decode_step and not use_teacher[t + 1]:
            # the next step feeds this prediction back (its teacher coin failed)
            with torch.no_grad():
                if sample_decoding and generator is not None:
                    probs = torch.softmax(logits.float(), -1)
                    pred = torch.multinomial(probs, 1, generator=generator)[:, 0].to(dev)
                else:
                    pred = torch.argmax(logits, -1)
            carry = carry._replace(prev_tok=pred)
        logits_all.append(logits)
        aligns.append(align)
        hiddens.append(hidden)
    out["att_logits"] = torch.stack(logits_all, 1)
    out["align"] = torch.stack(aligns, 1)
    out["att_hidden"] = torch.stack(hiddens, 1)
    return out
