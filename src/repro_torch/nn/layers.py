"""Core functional layers over nested dicts of tensors (the JAX package's
``repro.nn.layers`` without the conv helpers).

Parameters keep the JAX layouts (``dense`` weights are (in, out)); weights
are cast to the activation dtype at use, as ``.astype(x.dtype)`` does there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# erf(+-2/sqrt(2)): the uniform range whose inverse-CDF lands in [-2, 2].
_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def trunc_normal(shape, std, dtype, device, generator):
    """``std * N(0, 1)`` truncated to [-2, 2], drawn in f32 then cast (the
    JAX ``_trunc_normal``; bits differ, the distribution does not)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(_TRUNC_LO, _TRUNC_HI, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(std).to(dtype)


def dense(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embedding(params, ids):
    return params["table"][ids.long()]


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def swiglu(gate, up):
    return F.silu(gate) * up


def squared_relu(x):
    r = F.relu(x)
    return r * r
