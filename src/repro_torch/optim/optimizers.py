"""Optimizers as pure (init, update) pairs over nested dicts of tensors.

The paper trains with SGD + momentum 0.9 + weight decay, LR 1e-1 stepped
down 10x at 1/2 and 3/4 of training — `step_decay` reproduces that shape.
The update functions match the JAX package's ``repro/optim/optimizers.py``
line for line, including the *coupled* weight decay of ``sgd_momentum``
(``g + wd * p``), whatever its docstring there says.  Updates are
functional: they return new tensors and leave their inputs alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, opt_state, params, step) -> (new_params, new_state)


def constant_schedule(lr):
    return lambda step: float(np.float32(lr))


def decay_lr(lr, n, factor=0.1):
    """``lr * factor ** n`` in float32 arithmetic, as the JAX schedule
    computes it; ``n`` (the boundaries passed) an int or an integer numpy
    array."""
    return np.float32(lr) * np.power(np.float32(factor),
                                     np.asarray(n, np.float32))


def step_decay(lr, boundaries, factor=0.1):
    """Paper schedule: decay by `factor` at each boundary step (a step
    counts a boundary once ``step >= boundary``)."""
    bs = [int(b) for b in boundaries]

    def sched(step):
        return float(decay_lr(lr, sum(int(step) >= b for b in bs), factor))

    return sched


def cosine_schedule(lr, total_steps, warmup=0):
    def sched(step):
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                   1.0)
        return lr * warm * 0.5 * (1.0 + math.cos(math.pi * prog))

    return sched


def _lr_like(lr, p):
    """A per-edge lr tensor (R,) broadcast against a stacked leaf (R, ...);
    a Python float as it is."""
    if isinstance(lr, torch.Tensor):
        return lr.reshape(lr.shape + (1,) * (p.dim() - lr.dim()))
    return lr


def sgd_momentum(schedule, momentum=0.9, weight_decay=1e-4, nesterov=False):
    """SGD with momentum and weight decay added to the gradient (coupled,
    as the reference's code does).  ``update`` also takes ``step=None`` with
    a precomputed ``lr=`` (a float, or a per-edge tensor for stacked
    states)."""
    if not callable(schedule):
        schedule = constant_schedule(schedule)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)}

    def update(grads, state, params, step, lr=None):
        lr = schedule(step) if lr is None else lr

        def upd(g, mu, p):
            pf = p.float()
            g = g.float() + weight_decay * pf
            mu_new = momentum * mu + g
            d = g + momentum * mu_new if nesterov else mu_new
            return (pf - _lr_like(lr, p) * d).to(p.dtype), mu_new

        flat = tree_map(upd, grads, state["mu"], params)
        is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
        new_params = _pick(flat, 0, is_pair)
        new_mu = _pick(flat, 1, is_pair)
        return new_params, {"mu": new_mu}

    return Optimizer(init, update)


def _pick(tree, i, is_pair):
    if is_pair(tree):
        return tree[i]
    return {k: _pick(v, i, is_pair) for k, v in tree.items()}


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    if not callable(schedule):
        schedule = constant_schedule(schedule)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step, lr=None):
        lr = schedule(step) if lr is None else lr
        t = float(np.float32(step) + np.float32(1.0))
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.float()
            pf = p.float()
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            d = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p_new = pf - lr * (d + weight_decay * pf)
            return p_new.to(p.dtype), m_new, v_new

        flat = tree_map(upd, grads, state["m"], state["v"], params)
        is_triple = lambda t: isinstance(t, tuple)  # noqa: E731
        return _pick(flat, 0, is_triple), {"m": _pick(flat, 1, is_triple),
                                           "v": _pick(flat, 2, is_triple)}

    return Optimizer(init, update)


def update_in_place(opt: Optimizer, grads, state, params, step):
    """``opt.update`` taken one leaf at a time, each new leaf written over
    the old one's place in the dicts ``params`` and ``state`` (and each
    gradient dropped from ``grads`` once used): the caller gives the three
    trees up, as ``jax.jit(..., donate_argnums=...)`` does.  An old leaf is
    freed as soon as its replacement exists, so a step holds one leaf's
    temporaries beside the trees instead of a second copy of the parameters
    and the optimizer slots.  The values are those of ``opt.update``: the
    same function computes each leaf.  Returns ``(params, state)``."""

    def walk(p, g, s):
        for key in list(p):
            if isinstance(p[key], dict):
                walk(p[key], g[key], {k: v[key] for k, v in s.items()})
                continue
            leaf_g, g[key] = g[key], None
            new_p, new_s = opt.update(leaf_g, {k: v[key] for k, v in s.items()},
                                      p[key], step)
            del leaf_g
            p[key] = new_p
            for k, v in s.items():
                v[key] = new_s[k]

    walk(params, grads, state)
    return params, state
