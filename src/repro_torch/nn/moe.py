"""Token-choice top-k Mixture-of-Experts with capacity-based one-hot
dispatch: ``repro.nn.moe``, algorithm and quirks included.

The tokens of the whole batch are regrouped into groups of ``t`` tokens
(``t`` the largest divisor of B·S that is at most ``tokens_per_group``), so
every row of a batch (pad rows and a serving engine's idle slots too)
competes for the same expert capacity.  Each group routes in f32 (softmax,
top-k, the selected gates renormalised), fills every expert's ``capacity``
queue in slot order (slot ``i``'s queue positions start after the counts of
slots ``< i``, dropped tokens included), and dispatches and combines with
one-hot tensors (``dispatch`` in the activation dtype, ``combine`` in f32)
around the expert products ``gecd,edf->gecf``.  The Switch load-balance
loss ``E · Σ_e f_e · P_e`` is taken on the top-1 choice.  No TPU kernel
backs MoE in the JAX package; these are plain tensor products.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn import layers as L
from repro_torch.sharding import local as _local
from repro_torch.sharding.rules import constrain


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    expert_dim: int
    tokens_per_group: int = 128
    capacity_factor: float = 1.25


def init(cfg: MoEConfig, generator, device, *, stack=None,
         dtype=torch.float32):
    """The JAX ``init``'s tree and shapes: ``router`` (d, E) always in f32,
    the stacked experts ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f,
    d) in ``dtype``; a leading ``stack`` axis for stacked layers."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    std_in = 1.0 / math.sqrt(cfg.d_model)
    std_out = 1.0 / math.sqrt(cfg.expert_dim)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.expert_dim

    def draw(shape, std, dt):
        return L.trunc_normal(shape, std, dt, device, generator)

    return {"router": draw(sh(d, e), std_in, torch.float32),
            "w_gate": draw(sh(e, d, f), std_in, dtype),
            "w_up": draw(sh(e, d, f), std_in, dtype),
            "w_down": draw(sh(e, f, d), std_out, dtype)}


def specs(cfg: MoEConfig):
    """Logical axes of the MoE parameters: experts on "experts"."""
    return {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}


def _capacity(cfg: MoEConfig, t: int) -> int:
    c = math.ceil(t * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(1, min(c, t))


def group_size(cfg: MoEConfig, n: int) -> int:
    """The tokens a dispatch group holds for ``n`` tokens in all: the
    largest divisor of ``n`` that is at most ``tokens_per_group``."""
    t = min(cfg.tokens_per_group, n)
    while n % t != 0:
        t -= 1
    return t


def _ffn(x_disp, w_gate, w_up, w_down):
    gate = torch.einsum("gecd,edf->gecf", x_disp, w_gate)
    up = torch.einsum("gecd,edf->gecf", x_disp, w_up)
    h = constrain(L.swiglu(gate, up), ("groups", "experts", None, None))
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _experts(x_disp, w_gate, w_up, w_down):
    """The expert SwiGLU on the dispatched tokens (G, E, C, d).  Under a
    mesh every rank runs its experts on its groups (as ``x_disp`` is
    placed, the weights gathered over their FSDP axis), autograd included:
    the expert products are independent per (group, expert), and DTensor's
    own einsum here views a permuted local shard it cannot view."""
    mesh = _local.mesh_of(x_disp, w_gate)
    if mesh is None:
        return _ffn(x_disp, w_gate, w_up, w_down)
    from torch.distributed.tensor import Partial, Shard
    xpl = _local.keep_shards(x_disp, mesh, (0, 1))
    wpl = _local.follow(xpl, {1: Shard(0)})
    # a rank's weight gradient covers its groups only: summed over groups
    wgrad = tuple(Partial() if p == Shard(0) else w
                  for p, w in zip(xpl, wpl))
    return _local.run_local(_ffn, mesh, xpl, (x_disp, w_gate, w_up, w_down),
                            (xpl, wpl, wpl, wpl), (xpl, wgrad, wgrad, wgrad))


def _combine(combine, y_disp):
    """``einsum("gtec,gecd->gtd")``: the experts' outputs back to their
    tokens.  Under a mesh every rank combines its groups from every expert
    (the experts gathered): DTensor cannot flatten the experts-sharded
    operands of this contraction on torch 2.11."""
    fn = lambda c, y: torch.einsum("gtec,gecd->gtd", c, y)  # noqa: E731
    mesh = _local.mesh_of(combine, y_disp)
    if mesh is None:
        return fn(combine, y_disp)
    pl = _local.keep_shards(y_disp, mesh, (0,))
    return _local.run_local(fn, mesh, pl, (combine, y_disp), (pl, pl))


def forward(params, cfg: MoEConfig, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss f32 scalar)."""
    b, s, d = x.shape
    n = b * s
    t = group_size(cfg, n)
    g = n // t
    xt = constrain(_local.reshape(x, g, t, d), ("groups", None, "embed_act"))

    logits = torch.einsum("gtd,de->gte", xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                          # (G,T,E)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)   # (G,T,K)
    # Renormalize the selected gates (standard for top-k routing).
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(cfg, t)
    experts = torch.arange(e, device=x.device)
    slots = torch.arange(cap, device=x.device)
    counts = torch.zeros((g, 1, e), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((g, t, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, t, e, cap), dtype=torch.float32, device=x.device)
    for i in range(k):
        mk = (expert_idx[:, :, i, None] == experts).float()        # (G,T,E)
        pos = torch.cumsum(mk, dim=1) - mk + counts                # queue position
        keep = (pos < cap) * mk                                    # (G,T,E)
        counts = counts + mk.sum(dim=1, keepdim=True)
        # one_hot(pos, cap): all zeros at a position past the capacity
        slot = (pos.long()[..., None] == slots).float()            # (G,T,E,C)
        d_i = slot * keep[..., None]
        dispatch = dispatch + d_i.to(x.dtype)
        combine = combine + d_i * gate_vals[:, :, i][:, :, None, None]
    dispatch = constrain(dispatch, ("groups", None, "experts", None))
    combine = constrain(combine, ("groups", None, "experts", None))

    x_disp = torch.einsum("gtec,gtd->gecd", dispatch, xt)         # (G,E,C,D)
    x_disp = constrain(x_disp, ("groups", "experts", None, "embed_act"))
    y_disp = _experts(x_disp, params["w_gate"].to(x.dtype),
                      params["w_up"].to(x.dtype),
                      params["w_down"].to(x.dtype))
    y = constrain(_combine(combine.to(x.dtype), y_disp),
                  ("groups", None, "embed_act"))

    # Switch load-balance loss: E * sum_e f_e * P_e.
    f = (expert_idx[:, :, 0, None] == experts).float().mean(dim=(0, 1))
    p_mean = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f * p_mean)
    return _local.reshape(y, b, s, d), aux
