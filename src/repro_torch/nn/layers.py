"""Core functional layers over nested dicts of tensors (the JAX package's
``repro.nn.layers``).

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


#: Largest f32 draw ``trunc_normal`` makes at once: a larger tensor is
#: filled piece by piece along its leading axes, so that a full-width
#: stacked weight costs its own dtype's bytes plus at most this much.
DRAW_BYTES = 1 << 30


def _draw(shape, std, device, generator):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(_TRUNC_LO, _TRUNC_HI, generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)


def _fill(out, std, generator):
    if out.numel() * 4 <= DRAW_BYTES:
        out.copy_(_draw(out.shape, std, out.device, generator))
        return
    row = out[0].numel() * 4
    pieces = out if row > DRAW_BYTES else out.split(DRAW_BYTES // row)
    for piece in pieces:
        _fill(piece, std, generator)


def trunc_normal(shape, std, dtype, device, generator):
    """``std * N(0, 1)`` truncated to [-2, 2], drawn in f32 then cast (the
    JAX ``_trunc_normal``; bits differ, the distribution does not).  A
    tensor of more than ``DRAW_BYTES`` of f32 is drawn in pieces along its
    leading axes, in order, from the same generator."""
    out = torch.empty(shape, dtype=dtype, device=device)
    _fill(out, std, generator)
    return out


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


def conv1d_depthwise_init(width, channels, *, dtype, device, generator,
                          stack=None):
    """Depthwise causal conv used by the Mamba/Griffin front-ends: weights
    (width, channels), or (stack, width, channels), std 1/sqrt(width)."""
    shape = (width, channels) if stack is None else (stack, width, channels)
    return {"w": trunc_normal(shape, 1.0 / math.sqrt(width), dtype, device,
                              generator)}


def conv1d_depthwise(params, x):
    """x: (B, S, C) causal depthwise conv, left-padded; the taps are summed
    in the JAX function's order."""
    w = params["w"].to(x.dtype)  # (K, C)
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out


def conv1d_depthwise_step(params, conv_state, x_t):
    """Single decode step.  conv_state: (B, K-1, C); x_t: (B, C).  Mixed
    dtypes promote as ``jnp.concatenate``/``einsum`` do (an f32 state with a
    bf16 token gives f32, the weights rounded to the token's dtype first)."""
    w = params["w"].to(x_t.dtype)  # (K, C)
    k = w.shape[0]
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None, :].to(dt)], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w.to(dt))
    new_state = window[:, 1:, :] if k > 1 else conv_state
    return new_state, out


def gelu(x):
    return F.gelu(x, approximate="tanh")


def swiglu(gate, up):
    return F.silu(gate) * up


def squared_relu(x):
    r = F.relu(x)
    return r * r
