"""Listener encoder: VGG / CNN prenet + pyramidal (Bi)LSTM / GRU stack.

Counterpart of ``e2e_asr_tpu/models/encoder.py``: prenet ``vgg``, ``cnn``
(two 3-tap 1-D convolutions of stride 2, SAME-padded as JAX pads them) or
none; LSTM or GRU layers, with one direction or two; optional layer norm /
tanh projection; pyramid ``drop`` or ``concat``. Two pieces of ESPnet's RNN
listener (``vggblstm``) that the JAX package lacks: the prenet ``vgg2l``
(ESPnet's ``VGG2L``: one input channel over all the features, ceil-mode
pools, lengths ceil(ceil(T / 2) / 2)) and ``out_proj``, one tanh projection
of the stack's output to a width of its own (ESPnet's ``RNN.l_last``).

Routes of a layer's recurrence (``ops/rnn.py``): a bidirectional LSTM layer
takes the kernel pair that ``encoder.rnn_impl`` names (``bidir``); a
one-direction LSTM layer runs ``lstm``, the ``lstm_seq`` kernel pair with
one direction, under every ``rnn_impl``, since the fused-projection kernels
take exactly two directions (``ops/rnn_cuda.py``, wx [2, D, 4H]) and the
JAX package sends a one-direction layer to its scan whatever the impl; a
GRU layer, of either direction count, runs its plain recurrence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from e2e_asr_tpu_torch.config import EncoderConfig
from e2e_asr_tpu_torch.models import layers as L
from e2e_asr_tpu_torch.models.layers import Params
from e2e_asr_tpu_torch.ops import rnn as rnn_ops


# ---------------------------------------------------------------- VGG prenet
def infer_vgg_channels(feat_dim: int) -> Tuple[int, int]:
    """feat_dim -> (channels, base_dim). ref: VGGExtractor.check_dim."""
    for base in (13, 40, 80):
        if feat_dim % base == 0 and feat_dim // base in (1, 2, 3):
            return feat_dim // base, base
    raise ValueError(f"cannot infer VGG channels from feat_dim={feat_dim}")


def vgg_init(gen: torch.Generator, feat_dim: int) -> Tuple[Params, int]:
    ch, base = infer_vgg_channels(feat_dim)
    p = {
        "conv1": L.conv2d_init(gen, 3, 3, ch, 64),
        "conv2": L.conv2d_init(gen, 3, 3, 64, 64),
        "conv3": L.conv2d_init(gen, 3, 3, 64, 128),
        "conv4": L.conv2d_init(gen, 3, 3, 128, 128),
    }
    return p, 128 * ((base // 2) // 2)


def vgg_apply(p: Params, x: torch.Tensor, x_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, D] -> [B, T//4, 128*(base//4)], len//4.

    The feature axis splits as [ch, base] (channel-major, as the JAX reshape
    does); the conv image is [B, ch, T, base]; the output flattens as
    [channel, freq] per frame, which is the JAX ``transpose(0,1,3,2)`` of
    its NHWC result."""
    b, t, d = x.shape
    ch, base = infer_vgg_channels(d)
    h = x.reshape(b, t, ch, base).permute(0, 2, 1, 3)  # [B, ch, T, base]
    h = torch.relu(L.conv2d(p["conv1"], h))
    h = torch.relu(L.conv2d(p["conv2"], h))
    h = L.maxpool2d(h)
    h = torch.relu(L.conv2d(p["conv3"], h))
    h = torch.relu(L.conv2d(p["conv4"], h))
    h = L.maxpool2d(h)
    b2, c2, t2, f2 = h.shape
    out = h.permute(0, 2, 1, 3).reshape(b2, t2, c2 * f2)
    return out, torch.div(x_len, 4, rounding_mode="floor")


def _ceil_half(n):
    """ceil(n / 2) of an int or an integer tensor."""
    return (n + 1) // 2


def vgg2l_init(gen: torch.Generator, feat_dim: int) -> Tuple[Params, int]:
    p = {
        "conv1": L.conv2d_init(gen, 3, 3, 1, 64),
        "conv2": L.conv2d_init(gen, 3, 3, 64, 64),
        "conv3": L.conv2d_init(gen, 3, 3, 64, 128),
        "conv4": L.conv2d_init(gen, 3, 3, 128, 128),
    }
    return p, 128 * _ceil_half(_ceil_half(feat_dim))


def vgg2l_apply(p: Params, x: torch.Tensor, x_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, D] -> [B, ceil(ceil(T/2)/2), 128 * ceil(ceil(D/2)/2)], lengths
    ceil(ceil(len/2)/2): ESPnet's ``VGG2L`` with one input channel, the
    conv image [B, 1, T, D], 2x2 max pools in ceil mode (a last odd row or
    column pooled alone), the output flattened as [channel, freq] a frame."""
    h = x[:, None]
    h = torch.relu(L.conv2d(p["conv1"], h))
    h = torch.relu(L.conv2d(p["conv2"], h))
    h = L.maxpool2d(h, ceil=True)
    h = torch.relu(L.conv2d(p["conv3"], h))
    h = torch.relu(L.conv2d(p["conv4"], h))
    h = L.maxpool2d(h, ceil=True)
    b2, c2, t2, f2 = h.shape
    return h.permute(0, 2, 1, 3).reshape(b2, t2, c2 * f2), _ceil_half(_ceil_half(x_len))


# ---------------------------------------------------------------- CNN prenet
def cnn_init(gen: torch.Generator, feat_dim: int, out_dim: int) -> Tuple[Params, int]:
    return {"conv1": L.conv1d_init(gen, 3, feat_dim, out_dim),
            "conv2": L.conv1d_init(gen, 3, out_dim, out_dim)}, out_dim


def cnn_apply(p: Params, x: torch.Tensor, x_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, D] -> [B, ceil(ceil(T/2)/2), out_dim], len // 4 (as the JAX
    ``cnn_apply`` counts it: a frame past that stays, zeroed by the first
    layer's mask)."""
    h = torch.relu(L.conv1d(p["conv1"], x, stride=2))
    h = torch.relu(L.conv1d(p["conv2"], h, stride=2))
    return h, torch.div(x_len, 4, rounding_mode="floor")


# ----------------------------------------------------------------- RNN layer
def rnn_layer_init(
    gen: torch.Generator, in_dim: int, dim: int, layer_norm: bool, proj: bool, sample_rate: int,
    sample_style: str, module: str = "LSTM", bidirectional: bool = True,
) -> Tuple[Params, int]:
    gates = 4 if rnn_ops.cell_of(module) == "lstm" else 3
    p: Params = {"fwd": L.lstm_init(gen, in_dim, dim, gates)}
    out_dim = dim
    if bidirectional:
        p["bwd"] = L.lstm_init(gen, in_dim, dim, gates)
        out_dim = 2 * dim
    if sample_rate > 1 and sample_style == "concat":
        out_dim = out_dim * sample_rate
    if layer_norm:
        p["ln"] = L.layernorm_init(out_dim, gen.device)
    if proj:
        p["proj"] = L.dense_init(gen, out_dim, out_dim)
    return p, out_dim


def rnn_layer_apply(
    p: Params, x: torch.Tensor, x_len: torch.Tensor, sample_rate: int, sample_style: str,
    dropout: float = 0.0, generator: Optional[torch.Generator] = None, train: bool = False,
    impl: str = "auto", module: str = "LSTM",
) -> Tuple[torch.Tensor, torch.Tensor]:
    cell = rnn_ops.cell_of(module)
    if "bwd" in p:
        out = rnn_ops.bidir(x, x_len, p["fwd"], p["bwd"], cell=cell, impl=impl)
    else:
        out = (rnn_ops.lstm if cell == "lstm" else rnn_ops.gru)(x, x_len, p["fwd"])
    if sample_rate > 1:
        b, t, d = out.shape
        t2 = t // sample_rate
        if sample_style == "drop":
            out = out[:, ::sample_rate][:, :t2]
        elif sample_style == "concat":
            out = out[:, : t2 * sample_rate].reshape(b, t2, d * sample_rate)
        else:
            raise ValueError(f"unknown sample_style {sample_style}")
        x_len = torch.div(x_len, sample_rate, rounding_mode="floor")
    if "ln" in p:
        out = L.layernorm(p["ln"], out)
    out = L.dropout(out, dropout, generator, train)
    if "proj" in p:
        out = torch.tanh(L.dense(p["proj"], out))
    # re-mask after downsample/proj so padding stays exactly zero
    mask = (torch.arange(out.shape[1], device=out.device)[None, :] < x_len[:, None])[..., None]
    return torch.where(mask, out, 0.0), x_len


# ------------------------------------------------------------------- Encoder
def encoder_init(gen: torch.Generator, feat_dim: int, cfg: EncoderConfig) -> Tuple[Params, int]:
    p: Params = {}
    dim = feat_dim
    if cfg.prenet == "vgg":
        p["prenet"], dim = vgg_init(gen, feat_dim)
    elif cfg.prenet == "vgg2l":
        p["prenet"], dim = vgg2l_init(gen, feat_dim)
    elif cfg.prenet == "cnn":
        p["prenet"], dim = cnn_init(gen, feat_dim, cfg.dim[0])
    elif cfg.prenet not in ("", None):
        raise ValueError(f"unknown prenet {cfg.prenet}")
    p["layers"] = []
    for i, ldim in enumerate(cfg.dim):
        lp, dim = rnn_layer_init(
            gen, dim, ldim, cfg.layer_norm[i], cfg.proj[i], cfg.sample_rate[i], cfg.sample_style,
            cfg.module, cfg.bidirection,
        )
        p["layers"].append(lp)
    if cfg.out_proj:
        p["out_proj"] = L.dense_init(gen, dim, cfg.out_proj)
        dim = cfg.out_proj
    return p, dim


def encoder_apply(
    p: Params, cfg: EncoderConfig, feat: torch.Tensor, feat_len: torch.Tensor,
    generator: Optional[torch.Generator] = None, train: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, D] -> (enc [B, S, H], enc_len [B]). Dropout (after each
    layer's layer norm, before its projection) only with ``train`` and a
    generator; ``out_proj`` after the last layer."""
    x, x_len = feat, feat_len
    if cfg.prenet == "vgg":
        x, x_len = vgg_apply(p["prenet"], x, x_len)
    elif cfg.prenet == "vgg2l":
        x, x_len = vgg2l_apply(p["prenet"], x, x_len)
    elif cfg.prenet == "cnn":
        x, x_len = cnn_apply(p["prenet"], x, x_len)
    for i, lp in enumerate(p["layers"]):
        x, x_len = rnn_layer_apply(
            lp, x, x_len, cfg.sample_rate[i], cfg.sample_style, cfg.dropout[i], generator, train,
            impl=cfg.rnn_impl, module=cfg.module,
        )
    if "out_proj" in p:
        x = torch.tanh(L.dense(p["out_proj"], x))
        x = torch.where((torch.arange(x.shape[1], device=x.device)[None, :] < x_len[:, None])[..., None], x, 0.0)
    return x, torch.clamp(x_len, min=1)


def total_downsample(cfg: EncoderConfig) -> int:
    ds = 4 if cfg.prenet in ("vgg", "vgg2l", "cnn") else 1
    for s in cfg.sample_rate:
        ds *= s
    return ds
