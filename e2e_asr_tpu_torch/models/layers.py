"""Primitive layers as parameter dicts + plain apply functions.

Counterpart of ``e2e_asr_tpu/models/layers.py``; names and initialisation
distributions follow it (uniform fan-in bounds, LSTM forget-gate bias 1),
drawn from an explicit ``torch.Generator`` (the numbers differ from
``jax.random``; the tests carry JAX weights over with ``convert.py``).

Layout differences from the JAX package: conv weights are OIHW / OIW and
the 2-D convolutions' activations NCHW, PyTorch's own layout (``conv1d``
takes and returns [B, T, C], as the JAX one); dense weights stay [in, out].

Parameters are float32; the apply functions cast them to the input's type,
as the JAX package's do, so a bfloat16 input computes in bfloat16 (autograd
brings the parameters' gradients back to float32).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from e2e_asr_tpu_torch.parallel import dist

Params = Dict[str, object]


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * bound


def dense_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": uniform(gen, (d_in, d_out), bound)}
    if bias:
        p["b"] = uniform(gen, (d_out,), bound)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, dim: int) -> Params:
    return {"table": torch.randn((vocab, dim), generator=gen, device=gen.device) / math.sqrt(dim)}


def embed(p: Params, ids: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return p["table"].to(dtype)[ids]


# Below float32 the JAX package's elementwise functions round after every
# primitive they are made of (XLA rounds each op's result to the input's
# type); PyTorch's fused sigmoid and softmax round once. These three take
# the JAX decomposition there, and PyTorch's own functions in float32.
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid: 1 / (1 + exp(-x)), each step rounded below float32."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.softmax: exp(x - max) / sum, each step rounded below float32."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.log_softmax: (x - max) - log(sum(exp(x - max))), each step
    rounded below float32."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim)
    s = x - x.amax(dim, keepdim=True).detach()
    return s - torch.log(torch.exp(s).sum(dim, keepdim=True))


def layernorm_init(dim: int, device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), device=device), "bias": torch.zeros((dim,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def lstm_init(gen: torch.Generator, d_in: int, dim: int, gates: int = 4, forget_bias: float = 1.0) -> Params:
    """Recurrent weights {"wx": [D, G*H], "wh": [H, G*H], "b": [G*H]}: G = 4
    an LSTM (gates i,f,g,o; the forget bias set), G = 3 a GRU (r,z,n)."""
    bound = 1.0 / math.sqrt(dim)
    wx = uniform(gen, (d_in, gates * dim), bound)
    wh = uniform(gen, (dim, gates * dim), bound)
    b = uniform(gen, (gates * dim,), bound)
    if gates == 4 and forget_bias:
        b[dim : 2 * dim] = forget_bias
    return {"wx": wx, "wh": wh, "b": b}


def conv2d_init(gen: torch.Generator, h: int, w: int, c_in: int, c_out: int) -> Params:
    bound = 1.0 / math.sqrt(h * w * c_in)
    return {"w": uniform(gen, (c_out, c_in, h, w), bound), "b": uniform(gen, (c_out,), bound)}


def conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW), weights OIHW, stride 1, SAME padding. Below
    float32 the bias is added after the convolution's result is rounded, as
    the JAX package adds it."""
    if x.dtype == torch.float32:
        return F.conv2d(x, p["w"], p["b"], padding="same")
    return F.conv2d(x, p["w"].to(x.dtype), None, padding="same") + p["b"].to(x.dtype)[:, None, None]


def conv1d_init(gen: torch.Generator, k: int, c_in: int, c_out: int) -> Params:
    bound = 1.0 / math.sqrt(k * c_in)
    return {"w": uniform(gen, (c_out, c_in, k), bound), "b": uniform(gen, (c_out,), bound)}


def conv1d(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: [B, T, C] -> [B, ceil(T / stride), O], weights OIW, SAME padding
    as JAX pads it: (ceil(T / stride) - 1) * stride + K - T frames in all,
    the smaller half on the left (at stride 2, K 3 and an even T: none on
    the left, one on the right; ``F.conv1d``'s symmetric padding would give
    the same length with every window one frame early). Below float32 the
    bias is added after the convolution's result is rounded."""
    k, t = p["w"].shape[2], x.shape[1]
    total = max((-(-t // stride) - 1) * stride + k - t, 0)
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    if x.dtype == torch.float32:
        return F.conv1d(h, p["w"], p["b"], stride=stride).transpose(1, 2)
    return (F.conv1d(h, p["w"].to(x.dtype), None, stride=stride) + p["b"].to(x.dtype)[:, None]).transpose(1, 2)


def maxpool2d(x: torch.Tensor, ceil: bool = False) -> torch.Tensor:
    """[B, C, H, W] 2x2 max pool: in floor mode an odd H or W drops its last
    row; in ceil mode (``ceil``) it is pooled alone."""
    return F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=ceil)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Inverted dropout with keep mask ~ Bernoulli(1 - rate) drawn from
    ``generator`` (a no-op outside training, at rate 0 or without one), the
    uniforms at the global batch's shape, this rank's rows kept
    (``parallel/dist.py`` ``global_draw``; x's first axis is the batch)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = dist.global_draw(torch.rand, x.shape, generator).to(x.device) < keep
    return torch.where(mask, x / keep, 0.0)
