"""Vectorized multi-edge Phase-1 engine.

The R edge trainings of a round are independent (disjoint shards, disjoint
model states), so this module stacks the R edge states along a leading
axis and trains them together: each optimizer step is one
``torch.func.vmap`` of ``torch.func.grad_and_value`` over the stacked
states, followed by one batched SGD update.  The PyTorch counterpart of the
JAX package's ``repro/core/vectorized.py``, whose vmapped ``lax.scan``
becomes a Python loop over steps here:

  * per-edge batch schedules come from the same ``data.pipeline.batches``
    stream as the sequential path (same seeds, same permutations), stored
    as ``(R, S, B)`` index arrays into the once-stacked shard data;
  * edges with fewer steps than the longest edge are padded with masked
    no-op steps (``torch.where`` keeps state and optimizer; the edge's step
    counter does not advance), so heterogeneous shard sizes vectorize
    without changing any edge's math;
  * each edge keeps its own LR-decay boundaries (they depend on shard
    size); the per-edge learning rate of every step is computed on the
    host, where the step counters are known.

BN state comes back from the model as a value, never by in-place updates,
which ``vmap`` needs.

Under an active mesh (``repro_torch.launch.mesh.mesh_context``) the edge
axis is sharded over the data axes the logical "batch" rule resolves to,
as the reference's ``shard_map`` does: each rank trains its block of edges
(its coordinate on those axes) with the same vmapped trainer on plain
local tensors, and the stacked states are all-gathered over those axes.
Where the rule resolves to no axis (the edge count does not divide), every
rank trains every edge.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distill
from repro_torch.data.pipeline import batches
from repro_torch.optim import decay_lr, sgd_momentum
from repro_torch.sharding.rules import get_active_mesh_or_none, logical_to_spec
from repro_torch.tree import (stack_trees, tree_device, tree_map,
                              unstack_tree)


@dataclasses.dataclass
class BatchPlan:
    """Stacked batch schedule for one round of edge training.

    x: (R, N, ...) padded shard inputs;  y: (R, N) padded labels;
    idx: (R, S, B) int32 per-step sample indices;
    valid: (R, S) step mask (False = padding step, a masked no-op);
    boundaries: (R, 2) per-edge LR step-decay boundaries.
    """

    x: np.ndarray
    y: np.ndarray
    idx: np.ndarray
    valid: np.ndarray
    boundaries: np.ndarray


def build_batch_plan(edge_dss, batch_size, epochs, seed) -> Optional[BatchPlan]:
    """Build the stacked per-edge batch schedules (a copy of the
    reference's).  Returns None when the shards are too heterogeneous to
    stack (some shard is smaller than ``batch_size``, or empty) — callers
    then fall back to the sequential path."""
    per_edge = []
    for ds in edge_dss:
        if len(ds) == 0:
            return None  # empty shard: defer to the sequential path
        bs = min(batch_size, len(ds))
        steps_per_epoch = max(len(ds) // bs, 1)
        total = steps_per_epoch * epochs
        sels = list(batches(ds, batch_size, seed=seed, epochs=epochs,
                            indices_only=True))
        per_edge.append((bs, total, np.stack(sels).astype(np.int32)))

    if len({bs for bs, _, _ in per_edge}) != 1:
        return None  # heterogeneous batch shapes: sequential fallback
    max_steps = max(idx.shape[0] for _, _, idx in per_edge)
    max_n = max(len(ds) for ds in edge_dss)

    def pad_to(a, n):
        return np.concatenate(
            [a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)]) \
            if a.shape[0] < n else a

    x = np.stack([pad_to(np.asarray(ds.x), max_n) for ds in edge_dss])
    y = np.stack([pad_to(np.asarray(ds.y), max_n) for ds in edge_dss])
    idx = np.stack([pad_to(i, max_steps) for _, _, i in per_edge])
    valid = np.stack([np.arange(max_steps) < i.shape[0]
                      for _, _, i in per_edge])
    boundaries = np.stack([[total // 2, 3 * total // 4]
                           for _, total, _ in per_edge])
    return BatchPlan(x=x, y=y, idx=idx, valid=valid, boundaries=boundaries)


def lr_table(lr, valid, boundaries):
    """(S, R) float32 learning rates: edge r's step counter advances only
    on its valid steps, and its rate decays 10x at each of its
    boundaries."""
    counters = np.cumsum(valid, axis=1) - valid          # (R, S) before step
    n = (counters[:, :, None] >= boundaries[:, None, :]).sum(-1)
    return decay_lr(lr, n).T.astype(np.float32)


def _select(pred, new, old):
    """Per-leaf ``where`` over the edge axis — the masked no-op for pad
    steps."""
    def sel(n, o):
        return torch.where(pred.reshape(pred.shape + (1,) * (n.dim() - 1)),
                           n, o)
    return tree_map(sel, new, old)


def make_edge_trainer(adapter, lr, weight_decay):
    """Build the vmapped multi-edge trainer of the paper's L_edge (Eq. 2,
    cross-entropy).

    Returns ``train(stacked_states, plan) -> stacked`` where the states
    carry a leading edge axis.
    """
    opt = sgd_momentum(lr, weight_decay=weight_decay)

    def objective(params, st, x, y):
        lg, new_st = adapter.logits(adapter.with_params(st, params), x, True)
        return distill.ce_loss(lg, y), new_st

    grad_fn = torch.func.vmap(torch.func.grad_and_value(objective,
                                                        has_aux=True))

    def train(stacked, plan: BatchPlan):
        mesh = get_active_mesh_or_none()
        if mesh is not None:
            axes = logical_to_spec(("batch",), plan.valid.shape[:1], mesh)[0]
            if axes is not None:
                return _train_sharded(train_local, stacked, plan, mesh,
                                      (axes,) if isinstance(axes, str)
                                      else axes)
        return train_local(stacked, plan)

    def train_local(stacked, plan: BatchPlan):
        device = tree_device(stacked)
        r, s = plan.valid.shape
        x = torch.as_tensor(plan.x, device=device)
        y = torch.as_tensor(plan.y, device=device)
        idx = torch.as_tensor(plan.idx, device=device).long()
        lrs = torch.as_tensor(lr_table(lr, plan.valid, plan.boundaries),
                              device=device)
        valid = torch.as_tensor(plan.valid, device=device)
        rows = torch.arange(r, device=device)[:, None]
        opt_state = opt.init(adapter.params(stacked))
        for k in range(s):
            sel = idx[:, k]                                    # (R, B)
            params = adapter.params(stacked)
            grads, (_, new_st) = grad_fn(params, stacked, x[rows, sel],
                                         y[rows, sel])
            with torch.no_grad():
                new_params, new_opt = opt.update(grads, opt_state, params,
                                                 None, lr=lrs[k])
                new = adapter.with_params(new_st, new_params)
                if plan.valid[:, k].all():
                    stacked, opt_state = new, new_opt
                else:
                    ok = valid[:, k]
                    stacked = _select(ok, new, stacked)
                    opt_state = _select(ok, new_opt, opt_state)
        return stacked

    return train


def _train_sharded(train_local, stacked, plan: BatchPlan, mesh, axes):
    """This rank's block of the edge axis trained by ``train_local``, the
    blocks all-gathered over the mesh ``axes`` (mesh-major block order,
    as a DTensor sharded on those axes lays them out)."""
    from torch.distributed.tensor import DTensor, Shard
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    block, n = 0, 1
    for a in axes:
        i = names.index(a)
        block, n = block * mesh.size(i) + coord[i], n * mesh.size(i)
    per = plan.valid.shape[0] // n
    lo, hi = block * per, (block + 1) * per
    part = BatchPlan(**{f.name: getattr(plan, f.name)[lo:hi]
                        for f in dataclasses.fields(BatchPlan)})
    out = train_local(tree_map(lambda t: t[lo:hi], stacked), part)
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    return tree_map(lambda t: DTensor.from_local(
        t.contiguous(), sub, [Shard(0)] * len(axes),
        run_check=False).full_tensor(), out)


class VectorizedEdgeEngine:
    """Round-level entry: resolve a round's init states, stack, train."""

    def __init__(self, adapter, lr, weight_decay):
        self.adapter = adapter
        self._trainer = make_edge_trainer(adapter, lr, weight_decay)

    def train_round(self, init_states, edge_dss, batch_size, epochs, seed):
        """Train all edges of one round together.  Returns the list of
        trained teacher states, or None if the shards cannot be stacked
        (the caller falls back to sequential training)."""
        plan = build_batch_plan(edge_dss, batch_size, epochs, seed)
        if plan is None:
            return None
        out = self._trainer(stack_trees(init_states), plan)
        return unstack_tree(out, len(init_states))
