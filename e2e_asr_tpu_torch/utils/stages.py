"""The train step's stages, each timed as its own program and held against
its own ceiling: the port's counterpart of ``e2e_asr_tpu/utils/stages.py``.

Stages: ``frontend_fwd`` (the features' forward), ``encoder_fb`` (the
encoder's value and gradient; its ceiling is ``vgg_fb`` + ``recurrence_fb``,
the prenet and the recurrent layers with their projections),
``ctc_fb`` (the CTC objective's value and gradient over the encoder's
output), ``decoder_fb`` (the teacher-forced speller's value and gradient)
and ``optimizer`` (the clip and update of every parameter from constant
gradients).

Each stage's ceiling (``stage_ceilings``) is max(bytes / HBM, operations /
peak) on the card's peaks (``utils/profiling.py``) at the compute type:
- operations: the JAX package's counts for the VGG prenet, the recurrence
  and its projections (``_lstm_layer_flops``, ``_vgg_flops``; f + b = 3x
  forward for the prenet and projections) and the speller's per-step work
  (location features, energies, context, cell, logits; 3 x the forward),
  scaled to the model's direction and gate counts (a GRU has three gates);
  the CNN prenet's two strided convolutions;
- bytes: the hand kernels' least bytes where a kernel runs the stage (the
  LSTM pair of the layer's route, the scan pair), none elsewhere, so that a
  stage without a kernel (a GRU layer, the prenet) is held against its
  operations alone;
- the frontend and CTC rows: the ``log_mel`` and ``ctc_loss`` kernels'
  least work (``log_mel_work``, ``ctc_work``) at float32;
- the optimizer: 7 float32 words a parameter (read p, g and two slots;
  write p and two slots) over HBM, from the model's own parameter count.
Every row is at the bucket's full lengths.

Stage programs (``stage_programs``) are built from seed-0 weights at a
bucket shape, with dropout off; on the card each is captured once as a
CUDA graph (``training/step_graph.Captured``: one eager run on a side
stream, then the capture through ``device.graph_capture``, as the JAX
package jits each stage) and replayed under ``time_fn``; on the CPU it
runs eagerly under the host clock. Each program runs the port's normal
routes (on the card: ``log_mel``, the LSTM kernel pair of
``encoder.rnn_impl``, ``ctc_loss`` and the ``decoder_scan`` pair, each
launching its kernel or raising; never its plain version). Stages timed
alone do not overlap, so their sum may exceed a whole train step's time.
``sol`` = ceiling / measured: a ceiling above the measured time means a
wrong count.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from e2e_asr_tpu_torch.utils import profiling as prof

MEASURED = ("frontend_fwd", "encoder_fb", "ctc_fb", "decoder_fb", "optimizer")


def _lstm_layer_flops(b: int, t: int, d_in: int, h: int) -> Tuple[float, float]:
    """(fwd, bwd) FLOPs of one fused biLSTM layer (v3 backward: no remat).

    fwd per step: block-batched input proj (both dirs) + hidden matmul.
    bwd per step: dh propagate + dWh accumulate + block-batched dx + dWx.
    """
    gh = 4 * h
    xproj = 2 * 2 * b * d_in * gh  # both directions
    hidden = 2 * 2 * b * h * gh
    fwd = t * (xproj + hidden)
    bwd = t * (2 * xproj + 2 * hidden)  # dx+dWx = 2*xproj; dh+dWh = 2*hidden
    return fwd, bwd


def _vgg_flops(b: int, t: int, mel: int) -> float:
    """Forward FLOPs of the reference VGG extractor (two 3x3 conv pairs,
    64 then 128 channels, 2x2 pools; ref: src/module.py VGGExtractor)."""
    pos1 = b * t * mel
    fl = pos1 * 1 * 64 * 9 * 2 + pos1 * 64 * 64 * 9 * 2
    pos2 = b * (t // 2) * (mel // 2)
    fl += pos2 * 64 * 128 * 9 * 2 + pos2 * 128 * 128 * 9 * 2
    return fl


def _cnn_flops(b: int, t: int, d_in: int, dim: int) -> float:
    """Forward FLOPs of the CNN prenet: two 3-tap convolutions of stride 2,
    d_in -> dim -> dim channels."""
    t1 = (t + 1) // 2
    return 2 * b * t1 * 3 * d_in * dim + 2 * b * ((t1 + 1) // 2) * 3 * dim * dim


def param_count(cfg, vocab: int) -> int:
    """The ASR model's parameter count at ``cfg``'s widths and ``vocab``
    (built once on the CPU)."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step import param_leaves

    with torch.no_grad():
        params, _ = asr_mod.asr_init(0, cfg.data.audio.output_dim, vocab, cfg.model, torch.device("cpu"))
    return sum(p.numel() for p in param_leaves(params))


def _row(n_bytes: float, n_flops: float, dtype) -> dict:
    ms, by = prof.bound_ms(n_bytes, n_flops, dtype)
    return {"ceiling_ms": ms, "bound": by, "bytes": float(n_bytes), "flops": float(n_flops)}


def stage_ceilings(cfg, b: int, frames: int, l_tok: int, vocab: int, dtype="float32",
                   n_params: int = 0) -> Dict[str, dict]:
    """{stage: {ceiling_ms, bound ("bytes" | "operations"), bytes, flops}}
    at a bucket (B utterances of ``frames`` feature frames, ``l_tok``
    tokens) at the compute type ``dtype``; ``n_params`` 0 counts the
    model's parameters (``param_count``)."""
    dtype = prof.as_dtype(dtype)
    a, m = cfg.data.audio, cfg.model
    win = int(a.sample_rate * a.frame_length / 1000)
    shift = int(a.sample_rate * a.frame_shift / 1000)
    n_fft = 1 << (win - 1).bit_length()
    mel = a.feat_dim
    out: Dict[str, dict] = {}

    # ---- frontend: the log_mel kernel's least work, float32
    out["frontend_fwd"] = _row(*prof.log_mel_work(a, b, (frames - 1) * shift + win, win, n_fft), torch.float32)

    # ---- encoder = prenet f+b + recurrence f+b + inter-layer projections
    enc = m.encoder
    layers, s, e_dim = prof.encoder_layers(cfg, frames)
    pre = 0.0
    if enc.prenet == "vgg":
        pre = 3.0 * _vgg_flops(b, frames, mel)
    elif enc.prenet == "cnn":
        pre = 3.0 * _cnn_flops(b, frames, a.output_dim, enc.dim[0])
    rec_flops = rec_bytes = 0.0
    for i, (tl, d_in, h, dirs, cell) in enumerate(layers):
        f_fwd, f_bwd = _lstm_layer_flops(b, tl, d_in, h)
        rec_flops += (f_fwd + f_bwd) * dirs / 2 * (4 if cell == "lstm" else 3) / 4
        d_out = dirs * h
        if enc.sample_rate[i] > 1 and enc.sample_style == "concat":
            d_out *= enc.sample_rate[i]
        if enc.proj[i]:
            rec_flops += 3.0 * (2 * b * tl * d_out * d_out)
        if cell != "lstm":
            continue  # no kernel: held against its operations
        valid = tl * b
        if dirs == 2 and enc.rnn_impl == "pallas":
            works = (prof.lstm_bidir_fwd_work(tl, b, d_in, h, valid, True, dtype),
                     prof.lstm_bidir_bwd_work(tl, b, d_in, h, valid, dtype))
        else:
            works = (prof.lstm_seq_fwd_work(tl, b, h, valid, dirs, dtype),
                     prof.lstm_seq_bwd_work(tl, b, h, valid, dirs, dtype))
        rec_bytes += sum(w[0] for w in works)
    out["vgg_fb"] = _row(0.0, pre, dtype)
    out["recurrence_fb"] = _row(rec_bytes, rec_flops, dtype)
    out["encoder_fb"] = _row(rec_bytes, pre + rec_flops, dtype)

    # ---- decoder: per-step attention + cell + logits math, f+b = 3x
    att, dec = m.attention, m.decoder
    k_feats = att.loc_kernel_num if att.mode == "location" else 0
    gates = 4 if dec.module.upper() == "LSTM" else 3
    per_step = 0.0
    if att.mode == "location":
        per_step += 2 * b * s * s * k_feats  # Toeplitz location features
        per_step += 2 * b * s * k_feats * att.dim
    per_step += 2 * b * s * att.dim  # energies (q.k or tanh reduction)
    per_step += 2 * b * s * e_dim  # context
    dec_in = dec.dim + e_dim
    per_step += 2 * b * dec_in * gates * dec.dim + 2 * b * dec.dim * gates * dec.dim
    per_step += 2 * b * dec.dim * vocab
    dec_bytes = 0.0
    if att.mode == "location" and gates == 4:
        dims = (b, s, att.dim, e_dim, k_feats, 2 * att.loc_kernel_size + 1, dec.dim, dec.dim, vocab, l_tok,
                [s] * b)
        dec_bytes = (prof.decoder_scan_fwd_work(*dims, dtype)[0] + prof.decoder_scan_bwd_work(*dims, dtype)[0])
    out["decoder_fb"] = _row(dec_bytes, 3.0 * l_tok * per_step, dtype)

    # ---- CTC: the ctc_loss kernel's least work, float32
    full = lambda v: torch.full((b,), v, dtype=torch.int64)
    out["ctc_fb"] = _row(*prof.ctc_work(torch.empty((b, s, vocab), device="meta"),
                                        torch.empty((b, l_tok - 1), dtype=torch.int64, device="meta"),
                                        full(s), full(l_tok - 1)), torch.float32)

    # ---- optimizer: HBM roofline (read p, g, 2 slots; write p, 2 slots)
    n_par = n_params or param_count(cfg, vocab)
    out["optimizer"] = _row(7 * n_par * 4, 0.0, torch.float32)
    return out


# --------------------------------------------------------------- the programs
def stage_inputs(cfg, b: int, frames: int, l_tok: int, vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's stage inputs (``measure_stages``): B waves of the
    bucket's samples, randn x 0.1 from ``RandomState(seed)``, every row at
    full length; teacher ids in [3, vocab) ending in <eos> = 1."""
    a = cfg.data.audio
    win = int(a.sample_rate * a.frame_length / 1000)
    shift = int(a.sample_rate * a.frame_shift / 1000)
    n = (frames - 1) * shift + win
    rng = np.random.RandomState(seed)
    wav = (rng.randn(b, n) * 0.1).astype(np.float32)
    text = np.zeros((b, l_tok), np.int32)
    text[:, : l_tok - 1] = rng.randint(3, vocab, (b, l_tok - 1))
    text[:, l_tok - 1] = 1
    return {"wav": wav, "wav_len": np.full(b, n, np.int32), "text": text, "text_len": np.full(b, l_tok, np.int32)}


def _stage_config(cfg):
    """``cfg`` with every dropout off (the stage programs' model)."""
    cfg = copy.deepcopy(cfg)
    cfg.model.encoder.dropout = [0.0] * len(cfg.model.encoder.dropout)
    cfg.model.decoder.dropout = 0.0
    return cfg


Program = Tuple[Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]], torch.Tensor], Dict[str, torch.Tensor]]


def stage_programs(cfg, params, inputs: Dict[str, np.ndarray], dtype=None,
                   device=None) -> Dict[str, Program]:
    """{stage: (fn, batch)}: ``fn(batch, generator)`` runs the stage over the
    tensors of ``batch`` and returns a 0-dim value, as the JAX package's
    programs do (a stage with a gradient: value + the sum of every
    gradient's elements). ``params``: the model's tree on ``device`` (the
    default: the card), ``inputs``: ``stage_inputs``; ``dtype`` the compute
    type (default ``hparas.dtype``); the parameters are set to require
    gradients. The encoder's output for the CTC and
    speller programs and the features for the encoder's are computed once
    here, as the JAX package computes them outside its programs. The
    speller's program wants a generator on the card (its coins, all
    teacher-forced, are drawn there); on the CPU it may be None."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.ops.ctc import ctc_loss
    from e2e_asr_tpu_torch.ops.frontend import compute_features
    from e2e_asr_tpu_torch.optim import Optimizer, global_norm
    from e2e_asr_tpu_torch.training.step import compute_dtype, param_leaves

    cfg = _stage_config(cfg)
    m, a = cfg.model, cfg.data.audio
    dev = torch.device(device or "cuda")
    dt = prof.as_dtype(dtype) if dtype is not None else compute_dtype(cfg)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    b, l_tok = t["text"].shape
    for p in param_leaves(params):
        p.requires_grad_(True)

    def vg(fn, leaves):
        with torch.enable_grad():
            v = fn()
            grads = torch.autograd.grad(v, leaves, allow_unused=True)
        return v.detach() + sum(g.float().sum() for g in grads if g is not None)

    def frontend(batch, gen):
        return compute_features(batch["wav"], batch["wav_len"], a)[0].float().sum()

    with torch.no_grad():
        feat, feat_len = compute_features(t["wav"], t["wav_len"], a)
        enc, enc_len = asr_mod.encode(params, m, feat.to(dt), feat_len)

    def encoder(batch, gen):
        return vg(lambda: asr_mod.encode(params, m, batch["feat"], batch["feat_len"])[0].float().sum(),
                  param_leaves(params["encoder"]))

    out: Dict[str, Program] = {
        "frontend_fwd": (frontend, {"wav": t["wav"], "wav_len": t["wav_len"]}),
        "encoder_fb": (encoder, {"feat": feat.to(dt), "feat_len": feat_len}),
    }
    text, tl = t["text"].long(), t["text_len"].long()

    if "ctc" in params:
        def ctc(batch, gen):
            def obj():
                lp = asr_mod.ctc_log_probs(params, batch["enc"]).float()
                lab_len = torch.clamp(tl - 1, min=0)
                pos = torch.arange(l_tok, device=dev)[None, :]
                labels = torch.where(pos < lab_len[:, None], text, 0)
                nll = ctc_loss(lp, batch["enc_len"], labels, lab_len)
                return torch.sum(nll / torch.clamp(lab_len, min=1)) / b
            return vg(obj, param_leaves(params["ctc"]))

        out["ctc_fb"] = (ctc, {"enc": enc, "enc_len": enc_len})

    if "decoder" in params:
        spell_leaves = param_leaves({k: params[k] for k in ("attention", "embed", "decoder")})

        def decoder(batch, gen):
            e = batch["enc"].detach().requires_grad_()

            def obj():
                logits = asr_mod.spell(params, m, e, batch["enc_len"], l_tok, 1.0, text, gen, train=True,
                                       sample_decoding=False)["att_logits"]
                logp = torch.log_softmax(logits.float(), -1)
                return -torch.mean(logp.gather(2, text[..., None]))
            return vg(obj, spell_leaves + [e])

        out["decoder_fb"] = (decoder, {"enc": enc, "enc_len": enc_len})

    opt = Optimizer(cfg.hparas)
    p_opt = [p.detach().clone() for p in param_leaves(params)]
    state = opt.init(p_opt)
    sizes = [p.numel() for p in p_opt]

    def optimizer(batch, gen):
        grads = [g.view(p.shape) for g, p in zip(batch["grads"].split(sizes), p_opt)]
        g_norm = global_norm(grads)
        opt.update(p_opt, grads, state, g_norm, torch.isfinite(g_norm))
        return p_opt[0].sum()

    out["optimizer"] = (optimizer, {"grads": torch.full((sum(sizes),), 1e-4, device=dev)})
    return out


def measure_stages(cfg, b: int, frames: int, l_tok: int, vocab: int, iters: int = 5, dtype=None,
                   device=None, seed: int = 0, launches: Optional[Dict[str, Dict[str, int]]] = None
                   ) -> Dict[str, float]:
    """Seconds a call of each stage program (``MEASURED``; those the model
    has), from seed-``seed`` weights at the bucket. On the card (the
    default ``device``) each program is captured once as a CUDA graph and
    its replays timed (``time_fn``: CUDA events, median of three rounds of
    ``iters``); the kernels' launch counters count the replays, and
    ``launches``, where given, gets each program's launches a replay,
    ``{stage: {wrapper: n}}`` (a bf16 variant's wrapper name ends in
    ``_bf16``; the kernels it does not launch left out). On the CPU each
    runs eagerly under the host clock."""
    from e2e_asr_tpu_torch.models import asr as asr_mod
    from e2e_asr_tpu_torch.training.step_graph import COUNTED, COUNTERS, Captured

    dev = torch.device(device or "cuda")
    params, _ = asr_mod.asr_init(seed, cfg.data.audio.output_dim, vocab, cfg.model, dev)
    programs = stage_programs(cfg, params, stage_inputs(cfg, b, frames, l_tok, vocab, seed), dtype, dev)
    out: Dict[str, float] = {}
    stream = torch.cuda.Stream() if dev.type == "cuda" else None
    for name, (fn, batch) in programs.items():
        if dev.type == "cuda":
            g = Captured(batch, list(batch), stream)
            g.capture(fn, seed)
            if launches is not None:
                labels = [f.__name__ + ("_bf16" if c == "launches_bf16" else "") for f in COUNTED for c in COUNTERS]
                launches[name] = {k: n for k, n in zip(labels, g.deltas) if n}
            out[name] = prof.time_fn(lambda: g.replay(seed), iters=iters, warmup=1, device=dev)
            del g
        else:
            out[name] = prof.time_fn(fn, batch, None, iters=iters, warmup=1, device=dev)
    return out


def stage_report(cfg, b, frames, l_tok, vocab, measured: Dict[str, float], n_params: int = 0,
                 dtype="float32") -> Dict[str, dict]:
    """Join measured stage seconds with the ceilings -> {stage: {ms,
    ceiling_ms, sol, bound}}, rounded as the JAX package's (ms and
    ceiling_ms to 0.1, sol to 0.001; sol from the unrounded numbers)."""
    ceil = stage_ceilings(cfg, b, frames, l_tok, vocab, dtype, n_params)
    rep = {}
    for k, sec in measured.items():
        ms = sec * 1e3
        c = ceil.get(k, {}).get("ceiling_ms", 0.0)
        rep[k] = {
            "ms": round(ms, 1),
            "ceiling_ms": round(c, 1),
            "sol": round(c / ms, 3) if ms else 0.0,
            "bound": ceil.get(k, {}).get("bound", ""),
        }
    return rep
