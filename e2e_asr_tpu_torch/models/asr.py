"""The joint CTC/attention ASR model (Listen-Attend-Spell + CTC head).

Counterpart of ``e2e_asr_tpu/models/asr.py``: ``asr_init`` builds the
same parameter tree from a seeded ``torch.Generator`` (the numbers differ
from ``jax.random``; ``convert.py`` carries JAX weights over), ``encode``
runs the encoder, ``ctc_log_probs`` the CTC head, ``attend_and_step`` one
speller step and ``forward`` the teacher-forced training/eval forward.

The JAX forward is a ``lax.scan`` over target positions or the fused
Pallas decoder scan; here it is a Python loop over the steps, recorded by
autograd, or the fused scan of ``ops/decoder_cuda.py`` (one kernel forward,
one backward), chosen by ``decoder.fused_scan`` as ``_use_fused_scan``
says. Both read nothing on the host, so either is captured in the train
step's and validation's CUDA graphs. With the embedding regularizer
(``models/plugin.py``) the params hold ``emb_reg``. Random draws (dropout, the per-step
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
from e2e_asr_tpu_torch.models import plugin as plugin_mod
from e2e_asr_tpu_torch.models.layers import Params
from e2e_asr_tpu_torch.ops import decoder_cuda
from e2e_asr_tpu_torch.parallel import dist
from e2e_asr_tpu_torch.utils.misc import warn_once


class ASRShapes(NamedTuple):
    enc_dim: int
    ctx_dim: int
    emb_dim: int
    vocab: int


def asr_init(
    seed: int, feat_dim: int, vocab: int, cfg: ModelConfig, device: torch.device
) -> Tuple[Params, ASRShapes]:
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
        if cfg.emb_reg.enable:
            p["emb_reg"] = plugin_mod.emb_reg_init(gen, cfg.decoder.dim, vocab, cfg.emb_reg)
    return p, ASRShapes(enc_dim, ctx_dim, emb_dim, vocab)


def encode(
    params: Params, cfg: ModelConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
):
    return enc_mod.encoder_apply(params["encoder"], cfg.encoder, feat, feat_len, generator, train)


def ctc_log_probs(params: Params, enc: torch.Tensor) -> torch.Tensor:
    return L.log_softmax(L.dense(params["ctc"], enc), dim=-1)


class DecodeCarry(NamedTuple):
    dec_state: dec_mod.State
    prev_att: torch.Tensor  # [B, H, S]
    prev_tok: torch.Tensor  # [B] long


def init_carry(params: Params, cfg: ModelConfig, enc: torch.Tensor, enc_len: torch.Tensor):
    """(attention memory, the speller's carry before <sos>)."""
    mem = att_mod.prepare(params["attention"], cfg.attention, enc, enc_len)
    b = enc.shape[0]
    carry = DecodeCarry(
        dec_mod.init_state(b, cfg.decoder, enc.device, enc.dtype),
        att_mod.init_align(cfg.attention, mem).to(enc.dtype),
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
    emb = L.embed(params["embed"], tok, mem["k"].dtype)
    query = dec_mod.query_of(carry.dec_state)
    align, ctx = att_mod.step(params["attention"], cfg.attention, query, mem, carry.prev_att)
    logits, hidden, new_state = dec_mod.step(
        params["decoder"], cfg.decoder, carry.dec_state, torch.cat([emb, ctx], -1),
        generator=generator, train=train,
    )
    return logits, align, hidden, DecodeCarry(new_state, align, tok)


def speller_route(params: Params, cfg: ModelConfig, train: bool, device: torch.device) -> str:
    """The speller's route for tensors on ``device``: ``none`` (no attention
    head), ``fused`` (the fused scan, ``_use_fused_scan``) or ``loop``."""
    if "decoder" not in params:
        return "none"
    return "fused" if _use_fused_scan(params, cfg, train, device) else "loop"


def _use_fused_scan(params: Params, cfg: ModelConfig, train: bool, device: torch.device) -> bool:
    """The route of the speller scan under ``decoder.fused_scan`` (the JAX
    package's value names): ``scan`` is the Python loop; ``pallas`` forces
    the fused scan (``ops/decoder_cuda.py``: the hand-written kernels on CUDA
    tensors, their plain versions on CPU tensors) and raises outside its
    envelope; ``auto`` takes the fused scan for CUDA tensors inside the
    envelope and the loop otherwise (CPU tensors, or a configuration or
    width the kernels do not take)."""
    fs = cfg.decoder.fused_scan
    if fs == "scan":
        return False
    if fs not in ("auto", "pallas"):
        raise ValueError(f"decoder.fused_scan must be auto, pallas or scan, got '{fs}'")
    ok = decoder_cuda.supported(cfg, train)
    dk = params["attention"]["proj_k"]["w"].shape[1]
    fits = ok and decoder_cuda.fits(cfg.decoder.dim, dk)
    if fs == "pallas":
        if not ok:
            raise ValueError(
                "decoder.fused_scan='pallas': the configuration is outside the fused scan's "
                f"envelope (attention mode={cfg.attention.mode}, num_head={cfg.attention.num_head}, "
                f"v_proj={cfg.attention.v_proj}, decoder {cfg.decoder.module}/layer="
                f"{cfg.decoder.layer}/dropout={cfg.decoder.dropout}, emb_reg enable="
                f"{cfg.emb_reg.enable}/fuse={cfg.emb_reg.fuse})")
        if device.type == "cuda" and not fits:
            raise ValueError(
                f"decoder.fused_scan='pallas': the kernels take a speller width that is a multiple "
                f"of {decoder_cuda.CL} up to {decoder_cuda.MAX_H} and an attention dim up to "
                f"{decoder_cuda.MAX_DK}, got {cfg.decoder.dim} and {dk}")
        return True
    if device.type != "cuda":
        return False
    if ok and not fits:
        warn_once(f"fused_scan:{cfg.decoder.dim}:{dk}",
                  f"decoder.fused_scan=auto: speller width {cfg.decoder.dim} / attention dim {dk} "
                  "exceed the fused scan kernels' limits -> Python loop")
    return fits


def _exponential(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.empty(shape, device=device).exponential_(1.0, generator=generator)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token a row drawn from softmax(logits) [B, V], by ``generator``:
    argmax(p / q) with q ~ Exp(1), which is how ``torch.multinomial`` draws
    one sample, without its check of the probabilities on the host. The
    noise q is drawn at the global batch's shape (``dist.global_draw``), so
    that a rank's rows get the tokens a world of one samples for them."""
    probs = torch.softmax(logits.float(), -1)
    q = dist.global_draw(_exponential, probs.shape, generator).to(probs.device)
    return torch.argmax(probs / q, -1)


def forward(
    params: Params,
    cfg: ModelConfig,
    feat: torch.Tensor,
    feat_len: torch.Tensor,
    decode_step: int,
    tf_rate=1.0,
    teacher: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    sample_decoding: bool = True,
) -> Dict[str, torch.Tensor]:
    """Training/eval forward.

    teacher: [B, L] target ids (with <eos>, 0-padded). The speller's inputs
    are the right-shifted targets starting from <sos> = 0. One coin per step
    for the whole batch, drawn up front on the generator's device
    (``uniform < tf_rate``, the rate a float or a 0-dim tensor); where a
    training step's coin fails, the previous prediction is fed back instead,
    sampled from the output distribution when ``sample_decoding``
    (``sample_tokens``), its argmax otherwise. The Python loop computes that
    prediction at every training step and selects on the device, so that it
    reads no coin on the host. Outside training the teacher is always used.

    Returns ctc_log_probs [B, S, V] (with a CTC head), enc_len [B], enc, and
    with an attention head att_logits [B, L, V], align [B, L, H, S],
    att_hidden [B, L, H_dec]."""
    enc, enc_len = encode(params, cfg, feat, feat_len, generator, train)
    return heads(params, cfg, enc, enc_len, decode_step, tf_rate, teacher, generator, train, sample_decoding)


def heads(
    params: Params,
    cfg: ModelConfig,
    enc: torch.Tensor,
    enc_len: torch.Tensor,
    decode_step: int,
    tf_rate=1.0,
    teacher: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    sample_decoding: bool = True,
) -> Dict[str, torch.Tensor]:
    """The heads half of ``forward`` over the encoder's output: its outputs
    from the CTC head and the speller (``spell``)."""
    out: Dict[str, torch.Tensor] = {"enc_len": enc_len, "enc": enc}
    if "ctc" in params:
        out["ctc_log_probs"] = ctc_log_probs(params, enc)
    if "decoder" not in params:
        return out
    out.update(spell(params, cfg, enc, enc_len, decode_step, tf_rate, teacher, generator, train,
                     sample_decoding))
    return out


def spell(
    params: Params,
    cfg: ModelConfig,
    enc: torch.Tensor,
    enc_len: torch.Tensor,
    decode_step: int,
    tf_rate=1.0,
    teacher: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    sample_decoding: bool = True,
) -> Dict[str, torch.Tensor]:
    """The speller half of ``forward`` over the encoder's output: att_logits
    [B, L, V], align [B, L, H, S], att_hidden [B, L, H_dec] by the fused
    scan or the Python loop (``_use_fused_scan``)."""
    if teacher is None:
        raise ValueError("the attention head needs teacher tokens")

    b = enc.shape[0]
    teacher = teacher.long()
    teacher_in = torch.cat([teacher.new_zeros((b, 1)), teacher[:, : decode_step - 1]], dim=1)
    dev = enc.device
    if generator is not None:
        # on the generator's device: the fused scan reads them there, and a
        # captured step may not copy them to the host
        coins = torch.rand((decode_step,), generator=generator, device=generator.device) < tf_rate
    else:
        coins = torch.ones((decode_step,), dtype=torch.bool)

    out: Dict[str, torch.Tensor] = {}
    if _use_fused_scan(params, cfg, train, enc.device):
        out["att_logits"], out["align"], out["att_hidden"] = decoder_cuda.run_decode_scan(
            params, cfg, enc, enc_len, teacher_in, coins, generator=generator, train=train,
            sample_decoding=sample_decoding,
        )
        return out

    # the Python loop: no host read and no branch on a coin, so that a
    # training step through it is captured like one through the fused scan
    # (the coins are the generator's, on the card there; outside training
    # none is read)
    if train:
        coins = coins.to(dev)
    mem, carry = init_carry(params, cfg, enc, enc_len)
    logits_all, aligns, hiddens = [], [], []
    for t in range(decode_step):
        tok = torch.where(coins[t], teacher_in[:, t], carry.prev_tok) if train and t else teacher_in[:, t]
        logits, align, hidden, carry = attend_and_step(
            params, cfg, mem, carry, tok, generator=generator, train=train
        )
        if train and t + 1 < decode_step:
            # the token the next step takes where its coin fails
            with torch.no_grad():
                if sample_decoding and generator is not None:
                    pred = sample_tokens(logits, generator)
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
