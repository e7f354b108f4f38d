"""Core functional layers over nested dicts of tensors (the JAX package's
``repro.nn.layers``).

Parameters keep the JAX layouts (``dense`` weights are (in, out)); weights
are cast to the activation dtype at use, as ``.astype(x.dtype)`` does there.
Where a JAX ``*_init`` returns ``(params, specs)``, the port's init returns
the parameters and a ``*_specs`` function beside it returns the specs: the
same tree with each leaf a tuple of logical axis names
(``repro_torch.sharding.rules``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import local as _local

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
    leading axes, in order, from the same generator.  On the ``meta``
    device (shapes only, the dry-run's parameters) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        _fill(out, std, generator)
    return out


def stacked(specs):
    """A spec tree with the "layers" axis prepended to every leaf (the
    parameters of a stacked layer axis)."""
    if isinstance(specs, dict):
        return {k: stacked(v) for k, v in specs.items()}
    return ("layers", *specs)


def dense_specs(in_axis="embed", out_axis="mlp", use_bias=False):
    """Specs of a ``dense`` layer's ``w`` (in, out) [and ``b`` (out,)]."""
    s = {"w": (in_axis, out_axis)}
    if use_bias:
        s["b"] = (out_axis,)
    return s


def norm_specs(norm="rmsnorm"):
    """Specs of an RMSNorm (``scale``) or a LayerNorm (``scale``, ``bias``)."""
    s = {"scale": ("norm",)}
    if norm == "layernorm":
        s["bias"] = ("norm",)
    return s


def dense(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embedding(params, ids):
    """``table[ids]``.  Under a mesh a vocabulary-parallel lookup (each rank
    looks up the ids in its block of the vocabulary, zero elsewhere, and
    the blocks' partial sums add up), run on the local shards: DTensor's
    own index and embedding-backward strategies fail on a batch sharded
    over two mesh axes and on a vocabulary-sharded backward."""
    table = params["table"]
    mesh = _local.mesh_of(table, ids)
    if mesh is None:
        return table[ids.long()]
    return _vocab_parallel_lookup(table, ids, mesh)


def _vocab_parallel_lookup(table, ids, mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.rules import logical_to_spec, placements
    tpl = placements(logical_to_spec(("vocab", None), table.shape, mesh),
                     mesh)
    ipl = placements(logical_to_spec(("batch",) + (None,) * (ids.dim() - 1),
                                     ids.shape, mesh), mesh)
    ipl = tuple(Replicate() if t.is_shard() else p for t, p in zip(tpl, ipl))
    out = tuple(Shard(0) if i.is_shard() else Partial() if t.is_shard()
                else Replicate() for t, i in zip(tpl, ipl))
    # a rank's table gradient covers its own batch rows: summed over them
    grad = tuple(Shard(0) if t.is_shard() else Partial() if i.is_shard()
                 else Replicate() for t, i in zip(tpl, ipl))
    rows = table.shape[0] // math.prod(
        mesh.size(k) for k, t in enumerate(tpl) if t.is_shard())
    off = _local.shard_offset(mesh, tpl, 0, rows)

    def look(t, i):
        j = i.long() - off
        ok = (j >= 0) & (j < t.shape[0])
        return t[j.clamp(0, t.shape[0] - 1)] * ok[..., None].to(t.dtype)

    return _local.run_local(look, mesh, out, (table, ids), (tpl, ipl),
                            (grad, ipl))


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


def conv1d_depthwise_specs():
    return {"w": ("conv", "rnn")}


def conv1d_depthwise(params, x):
    """x: (B, S, C) causal depthwise conv, left-padded; the taps are summed
    in the JAX function's order.  Under a mesh on every rank's batch rows
    and channels (the sequence gathered), autograd included: DTensor's
    ``pad`` fails to plan its redistribution on torch 2.11."""
    w = params["w"].to(x.dtype)  # (K, C)
    mesh = _local.mesh_of(x, w)
    if mesh is None:
        return _conv1d(w, x)
    from torch.distributed.tensor import Partial, Shard
    xpl = _local.keep_shards(x, mesh, (0, 2))
    wpl = _local.follow(xpl, {2: Shard(1)})
    # a rank's weight gradient covers its batch rows: summed over them
    wgrad = tuple(Partial() if p == Shard(0) else q for p, q in zip(xpl, wpl))
    return _local.run_local(_conv1d, mesh, xpl, (w, x), (wpl, xpl),
                            (wgrad, xpl))


def _conv1d(w, x):
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
