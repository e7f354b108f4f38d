"""Mamba-2 SSD (state-space duality) block: the port of ``repro.nn.ssm``.

``forward`` runs the chunked scan as the JAX function does: with
``use_kernel=False`` (the default, and the model's full-sequence forward,
training included) through :func:`ssd_reference` (the JAX package's
chunked reference in plain PyTorch, which autograd differentiates); with
``use_kernel=True`` (the serving prefill) through
:func:`repro_torch.kernels.ops.ssd`: the hand-written ``ssd`` kernel on a
CUDA tensor, the same reference on a CPU one.  ``decode_step`` is one
token of the same recurrence in plain tensor code.  The JAX function's
logical-axis constraints are kept (``constrain``, a no-op without an
active mesh).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd import chunk_size
from repro_torch.nn import layers as L
from repro_torch.sharding import local as _local
from repro_torch.sharding.rules import constrain


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    ngroups: int = 1

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def num_heads(self):
        return self.d_inner // self.head_dim


def specs(cfg: SSDConfig):
    """Logical axes of the SSD parameters: the inner width is "rnn"."""
    return {"in_proj": ("embed", "rnn"), "conv": L.conv1d_depthwise_specs(),
            "A_log": ("rnn",), "D": ("rnn",), "dt_bias": ("rnn",),
            "norm": ("rnn",), "out_proj": ("rnn", "embed")}


def cache_specs():
    return {"ssm": ("batch", "rnn", None, None),
            "conv_x": ("batch", None, "rnn"),
            "conv_b": ("batch", None, None),
            "conv_c": ("batch", None, None)}


def softplus(x):
    """``jax.nn.softplus`` exactly: log(1 + e^x) with no linear branch
    (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init(cfg: SSDConfig, generator, device, *, stack=None,
         dtype=torch.float32):
    """The JAX ``init``'s tree, shapes and per-leaf dtypes (``A_log``, ``D``
    and ``dt_bias`` f32 in any model dtype), drawn from ``generator``."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + cfg.num_heads
    conv_ch = cfg.d_inner + 2 * cfg.ngroups * cfg.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.trunc_normal(sh(cfg.d_model, d_in_proj),
                                  1.0 / math.sqrt(cfg.d_model), dtype, device,
                                  generator),
        "conv": L.conv1d_depthwise_init(cfg.conv_width, conv_ch, dtype=dtype,
                                        device=device, generator=generator,
                                        stack=stack),
        "A_log": torch.zeros(sh(cfg.num_heads), **f32),  # A = -exp(0) = -1
        "D": torch.ones(sh(cfg.num_heads), **f32),
        "dt_bias": torch.zeros(sh(cfg.num_heads), **f32),
        "norm": torch.ones(sh(cfg.d_inner), dtype=dtype, device=device),
        "out_proj": L.trunc_normal(sh(cfg.d_inner, cfg.d_model),
                                   1.0 / math.sqrt(cfg.d_inner), dtype, device,
                                   generator),
    }


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums
    segsum[i, j] = sum_{j < m <= i} x[m], -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, B, C, chunk):
    """Chunked SSD scan (the JAX ``ssd_reference``, operation for operation).

    x: (b, s, h, p); dt: (b, s, h) positive step sizes; A: (h,) negative
    decay rates; B, C: (b, s, g, n), g groups broadcast over heads.
    ``chunk`` must divide s: :func:`repro_torch.kernels.ops.ssd` resolves
    it by the JAX chunk rule before calling this or the kernel.
    Returns y (b, s, h, p) and the final state (b, h, p, n)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = chunk
    if s % q:
        raise ValueError(f"chunk {q} does not divide s={s}")
    nc = s // q
    hg = h // g

    xb = (x * dt[..., None]).reshape(b, nc, q, h, p)
    dA = (dt * A[None, None, :]).reshape(b, nc, q, h)
    Bh = B.reshape(b, nc, q, g, n).repeat_interleave(hg, dim=3)
    Ch = C.reshape(b, nc, q, g, n).repeat_interleave(hg, dim=3)

    # 1. Intra-chunk (diagonal block): y = (C B^T * L) x.
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (b,nc,h,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * Lmat, xb)

    # 2. Chunk-final states: decay-to-end * B^T x.
    csum = torch.cumsum(dA, dim=2)                               # (b,nc,q,h)
    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bh,
                          xb * decay_to_end[..., None])

    # 3. Inter-chunk recurrence over chunk states (lax.scan in JAX).
    chunk_decay = torch.exp(dA.sum(dim=2)).float()               # (b,nc,h)
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(hs)
        hs = hs * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_before = torch.stack(before, dim=1)                        # (b,nc,h,p,n)

    # 4. Off-diagonal contribution: decay-from-start * C h_before.
    decay_from_start = torch.exp(csum)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         Ch * decay_from_start[..., None].to(Ch.dtype),
                         h_before.to(Ch.dtype))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hs


def _split_in_proj(params, cfg: SSDConfig, dtype):
    di, gn = cfg.d_inner, cfg.ngroups * cfg.d_state
    w = params["in_proj"].to(dtype)
    wz, wx, wB, wC, wdt = torch.split(
        w, [di, di, gn, gn, w.shape[-1] - 2 * di - 2 * gn], dim=-1)
    cwx, cwB, cwC = torch.split(params["conv"]["w"], [di, gn, gn], dim=-1)
    return (wz, wx, wB, wC, wdt), ({"w": cwx}, {"w": cwB}, {"w": cwC})


def forward(params, cfg: SSDConfig, x, *, use_kernel=False,
            return_cache=False):
    """Full-sequence forward.  x: (B, S, D) -> (B, S, D) [, cache]."""
    b, s, _ = x.shape
    di = cfg.d_inner
    (wz, wx, wB, wC, wdt), (cwx, cwB, cwC) = _split_in_proj(params, cfg,
                                                           x.dtype)
    z = constrain(x @ wz, ("batch", None, "rnn"))
    xin_pre = constrain(x @ wx, ("batch", None, "rnn"))
    B_pre = constrain(x @ wB, ("batch", None, None))
    C_pre = constrain(x @ wC, ("batch", None, None))
    dt = constrain(x @ wdt, ("batch", None, None))
    xin = F.silu(L.conv1d_depthwise(cwx, xin_pre))
    B = F.silu(L.conv1d_depthwise(cwB, B_pre))
    C = F.silu(L.conv1d_depthwise(cwC, C_pre))
    xin = constrain(xin, ("batch", None, "rnn"))

    h = cfg.num_heads
    xh = constrain(xin.reshape(b, s, h, cfg.head_dim),
                   ("batch", None, "rnn", None))
    Bh = constrain(B.reshape(b, s, cfg.ngroups, cfg.d_state),
                   ("batch", None, None, None))
    Ch = constrain(C.reshape(b, s, cfg.ngroups, cfg.d_state),
                   ("batch", None, None, None))
    A = -torch.exp(params["A_log"].float())
    dtp = constrain(softplus(dt.float() + params["dt_bias"].float()),
                    ("batch", None, "rnn"))

    if use_kernel:
        scan = lambda *a: ops.ssd(*a, cfg.chunk)  # noqa: E731
    else:
        def scan(xh, dtp, A, Bh, Ch):
            return ssd_reference(xh.float(), dtp, A, Bh.float(), Ch.float(),
                                 chunk_size(cfg.chunk, xh.shape[1]))
    y, final = _scan_local(scan, xh, dtp, A, Bh, Ch)
    y = y.to(x.dtype) + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    # Gated RMSNorm (Mamba-2 style): norm(y) * silu(z).
    y = L.rmsnorm({"scale": params["norm"]}, y * F.silu(z))
    out = constrain(y @ params["out_proj"].to(x.dtype),
                    ("batch", None, "embed_act"))
    if return_cache:
        kw = cfg.conv_width - 1
        cache = {"ssm": final.float(),
                 "conv_x": xin_pre[:, s - kw:, :],
                 "conv_b": B_pre[:, s - kw:, :],
                 "conv_c": C_pre[:, s - kw:, :]}
        return out, cache
    return out


def _scan_local(scan, xh, dtp, A, Bh, Ch):
    """``scan(xh, dtp, A, Bh, Ch) -> (y, final)``; under a mesh on every
    rank's batch rows and heads (the scan is independent across both), as
    ``xh`` is placed (its sequence, if sharded, gathered), autograd
    included."""
    mesh = _local.mesh_of(xh, dtp, Bh, Ch)
    if mesh is None:
        return scan(xh, dtp, A, Bh, Ch)
    from torch.distributed.tensor import Partial, Shard
    have = _local.placements_of(xh, mesh)
    xpl = _local.follow(have, {0: Shard(0), 2: Shard(2)})
    bpl = _local.follow(have, {0: Shard(0)})
    apl = _local.follow(have, {2: Shard(0)})
    fpl = _local.follow(have, {0: Shard(0), 2: Shard(1)})
    # a rank's gradients: A's summed over the batch rows, B's and C's (one
    # group shared by every head) over the heads
    agrad = tuple(Partial() if x == Shard(0) else a
                  for x, a in zip(xpl, apl))
    bgrad = tuple(Partial() if x == Shard(2) else b
                  for x, b in zip(xpl, bpl))
    return _local.run_local(scan, mesh, (xpl, fpl), (xh, dtp, A, Bh, Ch),
                            (xpl, xpl, apl, bpl, bpl),
                            (xpl, xpl, agrad, bgrad, bgrad))


def init_cache(cfg: SSDConfig, batch, *, device, dtype=torch.float32,
               stack=None):
    """Zeroed decode state: the (B, h, p, n) SSM state in f32 whatever
    ``dtype`` is, and the three conv windows (B, K-1, C) in ``dtype``; a
    leading ``stack`` axis for stacked layers."""
    gn = cfg.ngroups * cfg.d_state
    kw = cfg.conv_width - 1
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    return {
        "ssm": torch.zeros(sh(batch, cfg.num_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros(sh(batch, kw, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros(sh(batch, kw, gn), dtype=dtype, device=device),
        "conv_c": torch.zeros(sh(batch, kw, gn), dtype=dtype, device=device),
    }


def _step(ssm, dtp, xh, Bh, Ch, A, D):
    """One token of the recurrence: (new state, y) from the f32 state (B,
    H, P, N), dt (B, H), x (B, H, P), B and C (B, H, N), A and D (H,)."""
    decay = torch.exp(dtp * A[None, :])
    hs = ssm * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dtp, xh, Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, hs)
    return hs, y + xh * D[None, :, None]


def _step_local(ssm, dtp, xh, Bh, Ch, A, D):
    """:func:`_step`; under a mesh on every rank's batch rows and heads, as
    the state is placed: DTensor cannot flatten this einsum's sharded heads
    on torch 2.11."""
    mesh = _local.mesh_of(ssm, xh)
    if mesh is None:
        return _step(ssm, dtp, xh, Bh, Ch, A, D)
    from torch.distributed.tensor import Shard
    spl = _local.keep_shards(ssm, mesh, (0, 1))
    hpl = _local.follow(spl, {1: Shard(0)})
    return _local.run_local(_step, mesh, (spl, spl),
                            (ssm, dtp, xh, Bh, Ch, A, D),
                            (spl, spl, spl, spl, spl, hpl, hpl))


def decode_step(params, cfg: SSDConfig, cache, x):
    """One token.  x: (B, 1, D).  Returns (out (B, 1, D), new cache); the
    state update is f32."""
    b = x.shape[0]
    di = cfg.d_inner
    (wz, wx, wB, wC, wdt), (cwx, cwB, cwC) = _split_in_proj(params, cfg,
                                                           x.dtype)
    xt = x[:, 0, :]
    z = xt @ wz
    xin_pre = xt @ wx
    B_pre = xt @ wB
    C_pre = xt @ wC
    dt = xt @ wdt
    ncx, xin = L.conv1d_depthwise_step(cwx, cache["conv_x"], xin_pre)
    ncb, B = L.conv1d_depthwise_step(cwB, cache["conv_b"], B_pre)
    ncc, C = L.conv1d_depthwise_step(cwC, cache["conv_c"], C_pre)
    xin, B, C = F.silu(xin), F.silu(B), F.silu(C)

    h, p, n = cfg.num_heads, cfg.head_dim, cfg.d_state
    hg = h // cfg.ngroups
    xh = xin.reshape(b, h, p).float()
    Bh = B.reshape(b, cfg.ngroups, n).repeat_interleave(hg, dim=1).float()
    Ch = C.reshape(b, cfg.ngroups, n).repeat_interleave(hg, dim=1).float()
    A = -torch.exp(params["A_log"].float())
    dtp = softplus(dt.float() + params["dt_bias"].float())          # (B, H)

    hs, y = _step_local(cache["ssm"], dtp, xh, Bh, Ch, A,
                        params["D"].float())
    y = y.reshape(b, di).to(x.dtype)
    y = L.rmsnorm({"scale": params["norm"]}, y * F.silu(z))
    out = (y @ params["out_proj"].to(x.dtype))[:, None, :]
    return (constrain(out, ("batch", None, "embed_act")),
            {"ssm": hs, "conv_x": ncx, "conv_b": ncb, "conv_c": ncc})
