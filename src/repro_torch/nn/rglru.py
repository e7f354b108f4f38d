"""RG-LRU recurrent block (Griffin / RecurrentGemma): the port of
``repro.nn.rglru``.

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = a^(c * r_t),  a = sigmoid(Lambda)  (per channel), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``forward`` runs the linear recurrence as the JAX function does: with
``use_kernel=False`` (the default, and the model's full-sequence forward,
training included) through :func:`rglru_scan_reference`, which autograd
differentiates; with ``use_kernel=True`` (the serving prefill) through
:func:`repro_torch.kernels.ops.rglru`: the hand-written ``rglru`` kernel on
a CUDA tensor, the same reference on a CPU one.  The block around
it is Griffin's recurrent block: two linear branches, a short causal
depthwise conv on the recurrent one, a GeLU gate.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn import layers as L
from repro_torch.sharding import local as _local
from repro_torch.sharding.rules import constrain, logical_to_spec, placements

_C = 8.0
_MAX_SQRT = 1e-6


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4


def init(cfg: RGLRUConfig, generator, device, *, stack=None,
         dtype=torch.float32):
    """The JAX ``init``'s tree, shapes and per-leaf dtypes (``b_a``, ``b_x``
    and ``lam`` f32 in any model dtype), drawn from ``generator``."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    std_m = 1.0 / math.sqrt(cfg.d_model)
    std_r = 1.0 / math.sqrt(cfg.d_rnn)

    def draw(shape, std):
        return L.trunc_normal(sh(*shape), std, dtype, device, generator)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in_x": draw((cfg.d_model, cfg.d_rnn), std_m),
        "w_in_gate": draw((cfg.d_model, cfg.d_rnn), std_m),
        "conv": L.conv1d_depthwise_init(cfg.conv_width, cfg.d_rnn, dtype=dtype,
                                        device=device, generator=generator,
                                        stack=stack),
        "w_a": draw((cfg.d_rnn, cfg.d_rnn), std_r),
        "b_a": torch.zeros(sh(cfg.d_rnn), **f32),
        "w_x": draw((cfg.d_rnn, cfg.d_rnn), std_r),
        "b_x": torch.zeros(sh(cfg.d_rnn), **f32),
        # Lambda = logit(0.95): a = sigmoid(Lambda) in (0.9, 0.999).
        "lam": torch.full(sh(cfg.d_rnn), math.log(0.95 / 0.05), **f32),
        "w_out": draw((cfg.d_rnn, cfg.d_model), std_r),
    }


def specs(cfg: RGLRUConfig):
    """Logical axes of the RG-LRU parameters: the recurrent width is
    "rnn"."""
    return {"w_in_x": ("embed", "rnn"), "w_in_gate": ("embed", "rnn"),
            "conv": L.conv1d_depthwise_specs(), "w_a": ("rnn", "rnn"),
            "b_a": ("rnn",), "w_x": ("rnn", "rnn"), "b_x": ("rnn",),
            "lam": ("rnn",), "w_out": ("rnn", "embed")}


def cache_specs():
    return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}


_GATE_KEYS = ("w_a", "b_a", "w_x", "b_x", "lam")


def _gate_math(xf, w_a, b_a, w_x, b_x, lam, x_own):
    """(a, b) for the output channels of ``w_a``/``w_x``: ``x_own`` is xf
    restricted to them."""
    r = torch.sigmoid(xf @ w_a.float() + b_a.float())
    i = torch.sigmoid(xf @ w_x.float() + b_x.float())
    log_a = _C * r * F.logsigmoid(lam.float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=_MAX_SQRT))
    return a, mult * (i * x_own)


def _gates(params, xr):
    """xr: (..., d_rnn) post-conv recurrent-branch input -> (a, b), f32.
    Under a mesh every rank computes its batch rows' gates for its block of
    channels (the "rnn" rule's; the input gathered over the channels,
    column-parallel), autograd included: DTensor has no strategy for
    ``aten.log_sigmoid_backward`` and, on torch 2.11, cannot turn the
    row-sharded product's shards into the partial sums the bias add
    needs."""
    xf = xr.float()
    weights = [params[k] for k in _GATE_KEYS]
    mesh = _local.mesh_of(xf, *weights)
    if mesh is None:
        return _gate_math(xf, *weights, xf)
    from torch.distributed.tensor import Partial, Replicate, Shard
    d = xf.shape[-1]
    cols = placements(logical_to_spec(("rnn",), (d,), mesh), mesh)
    have = _local.placements_of(xf, mesh)
    rows = tuple(Shard(0) if p == Shard(0) and not c.is_shard()
                 else Replicate() for p, c in zip(have, cols))
    last = xf.dim() - 1
    out = tuple(Shard(last) if c.is_shard() else r
                for c, r in zip(cols, rows))
    wpl = _local.follow(cols, {0: Shard(1)})
    vpl = cols
    # a rank's gradients: the input's summed over the channel blocks, the
    # weights' over the batch rows
    xgrad = tuple(Partial() if c.is_shard() else r
                  for c, r in zip(cols, rows))
    wgrad = tuple(Partial() if r.is_shard() else w
                  for r, w in zip(rows, wpl))
    vgrad = tuple(Partial() if r.is_shard() else v
                  for r, v in zip(rows, vpl))
    n = d // math.prod(mesh.size(i) for i, c in enumerate(cols)
                       if c.is_shard())
    off = _local.shard_offset(mesh, out, last, n)

    def local(x, w_a, b_a, w_x, b_x, lam):
        return _gate_math(x, w_a, b_a, w_x, b_x, lam, x[..., off:off + n])

    return _local.run_local(local, mesh, (out, out), (xf, *weights),
                            (rows, wpl, vpl, wpl, vpl, vpl),
                            (xgrad, wgrad, vgrad, wgrad, vgrad, vgrad))


def rglru_scan_reference(a, b, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t along axis 1 of (B, S, D)
    f32 tensors, from ``h0`` (B, D) or zero.  A log-step (Hillis-Steele)
    scan over S with the JAX ``associative_scan``'s combine
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] = b[:, 0, :] + a[:, 0, :] * h0
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def _scan_local(scan, a, b):
    """``scan(a, b) -> h``; under a mesh on every rank's batch rows and
    channels (the recurrence is independent across both), as ``a`` is
    placed (its sequence, if sharded, gathered)."""
    mesh = _local.mesh_of(a, b)
    if mesh is None:
        return scan(a, b)
    pl = _local.keep_shards(a, mesh, (0, 2))
    return _local.run_local(scan, mesh, pl, (a, b), (pl, pl))


def forward(params, cfg: RGLRUConfig, x, *, use_kernel=False,
            return_cache=False):
    """x: (B, S, D) -> (B, S, D) [, cache]."""
    xr_pre = x @ params["w_in_x"].to(x.dtype)
    gate = L.gelu(x @ params["w_in_gate"].to(x.dtype))
    xr_pre = constrain(xr_pre, ("batch", None, "rnn"))
    xr = L.conv1d_depthwise(params["conv"], xr_pre)
    a, b = _gates(params, xr)
    h = _scan_local(ops.rglru if use_kernel else rglru_scan_reference, a, b)
    y = (h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    y = constrain(y, ("batch", None, "embed_act"))
    if return_cache:
        kw = cfg.conv_width - 1
        cache = {"h": h[:, -1, :].float(),
                 "conv": xr_pre[:, xr_pre.shape[1] - kw:, :]}
        return y, cache
    return y


def init_cache(cfg: RGLRUConfig, batch, *, device, dtype=torch.float32,
               stack=None):
    """Zeroed decode state: h (B, d_rnn) in f32 whatever ``dtype`` is, the
    conv window (B, K-1, d_rnn) in ``dtype``; a leading ``stack`` axis for
    stacked layers."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    return {
        "h": torch.zeros(sh(batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(sh(batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=dtype, device=device),
    }


def decode_step(params, cfg: RGLRUConfig, cache, x):
    """x: (B, 1, D).  Returns (y (B, 1, D), new cache)."""
    xt = x[:, 0, :]
    xr = xt @ params["w_in_x"].to(x.dtype)
    gate = L.gelu(xt @ params["w_in_gate"].to(x.dtype))
    new_conv, xr = L.conv1d_depthwise_step(params["conv"], cache["conv"], xr)
    a, b = _gates(params, xr)
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype))[:, None, :]
    return constrain(y, ("batch", None, "embed_act")), {"h": h,
                                                         "conv": new_conv}
