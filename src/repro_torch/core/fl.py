"""Knowledge-distillation-based Federated Learning — the paper's Algorithm 1.

Phases:
    Phase 0  core pre-training on the core set C            (L_core, Eq. 1)
    Phase 1  edge k trains on its shard E_k from the core's weights
             (or from stale weights when it is a straggler)  (L_edge, Eq. 2)
    Phase 2  distill the returned teacher(s) into the core   (L_KD / L_BKD)

The PyTorch counterpart of the JAX package's ``repro/core/fl.py``: methods
come by name from the registry (``core/methods.py``), rounds from a plan
source with ``plans(rounds)`` (the synchronous ``RoundScheduler`` or the
legacy ``FLConfig.straggler`` strings; the event-driven simulator of
``core/simulator.py`` or its vectorized twin in ``core/fleet.py``, whose
staleness emerges from device heterogeneity; or the two-level
region/core stream of ``fleet.HierarchicalFleetSimulator``, which ``run``
routes to the hierarchical round loop), Phase 1 runs the R edges of a
round together (``core/vectorized.py``; ``vectorize=False`` for the
sequential loop) and Phase 2 runs through ``core/distill_engine.py`` with
a pluggable loss backend.  On a CUDA device ``loss_backend="auto"`` sends
every Phase-2 loss through the hand-written kernel pair
``kd_stats_fwd``/``kd_grad_bwd``.
``FLConfig.transport`` puts an edge→core uplink codec between the teachers
and the core (``repro_torch.transport``); with ``int8``/``int4`` and one
teacher a round the loss runs on the dequant-fused pair
``kd_quant_stats_fwd``/``kd_quant_grad_bwd`` instead.

States are nested dicts of tensors with the reference's keys and layouts
(``repro_torch.interop`` moves them between the packages), and every
function over them is pure.  ``FederatedKD`` runs on ``device="cuda"``
unless given ``device="cpu"``; ``run`` takes a seed or a
``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distill
from repro_torch.core.distill_engine import DistillEngine
from repro_torch.core.methods import resolve_method
from repro_torch.core.scheduler import FROZEN, RoundScheduler
from repro_torch.core.vectorized import VectorizedEdgeEngine
from repro_torch.data.pipeline import Dataset, batches
from repro_torch.optim import sgd_momentum, step_decay
from repro_torch.tree import tree_device


@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    """Functional model interface.  `state` is opaque (params + e.g. BN stats)."""

    init: Callable          # (torch.Generator, device) -> state
    logits: Callable        # (state, x, train: bool) -> (logits, new_state)
    params: Callable        # state -> trainable params dict
    with_params: Callable   # (state, params) -> state
    features: Optional[Callable] = None  # (state, x) -> penultimate features


def mlp_adapter(in_dim, hidden, classes, depth=2):
    from repro_torch.nn import resnet as R

    def init(gen, device):
        return R.mlp_init(gen, in_dim, hidden, classes, depth, device=device)

    def logits(state, x, train):
        return R.mlp_apply(state, x), state

    return ModelAdapter(init, logits, lambda s: s, lambda s, p: p,
                        R.mlp_features)


def resnet_adapter(cfg):
    from repro_torch.nn import resnet as R

    def init(gen, device):
        params, bn = R.init(gen, cfg, device=device)
        return {"params": params, "bn": bn}

    def logits(state, x, train):
        lg, bn = R.apply(state["params"], state["bn"], cfg, x, train)
        return lg, {"params": state["params"], "bn": bn}

    return ModelAdapter(init, logits,
                        lambda s: s["params"],
                        lambda s, p: {"params": p, "bn": s["bn"]})


@dataclasses.dataclass
class FLConfig:
    num_edges: int = 19
    rounds: int = 19
    aggregation_r: int = 1            # R: teachers per distillation round
    tau: float = 2.0
    method: str = "bkd"               # any name in repro_torch.core.methods.METHODS
    ema_decay: float = 0.9
    ft_weight: float = 0.1   # simplified-FT scale; 0.1 reproduces FT+KD ~= KD
    kd_warm_rounds: int = 0           # R>1: plain-KD warm-up rounds (paper §4.2)
    # Optimization (paper: SGD momentum .9, wd 1e-4, step decay)
    core_epochs: int = 20
    edge_epochs: int = 20
    kd_epochs: int = 10
    batch_size: int = 128
    lr: float = 0.1
    kd_lr: float = 0.02
    weight_decay: float = 1e-4
    # Straggler scenario (legacy strings; pass a RoundScheduler for more)
    straggler: str = "none"           # none | alternate | frozen_w0
    withdraw: bool = False
    seed: int = 0
    # Phase 1: all R edges of a round trained together (falls back to the
    # sequential loop when shards can't stack).
    vectorize: bool = True
    # Phase 2 (core/distill_engine.py): scan=True gathers each batch from a
    # device copy of the core set, scan=False cuts it on the host (same
    # math).  loss_backend: auto (pallas on a CUDA device, else jnp) | jnp
    # | pallas (the hand-written kernel pair) | topk_cached (bkd_cached).
    scan: bool = True
    loss_backend: str = "auto"
    cache_topk: int = 8               # k for loss_backend="topk_cached"
    # Edge->core uplink transport: "none" or a codec spec from
    # repro_torch.transport ("identity", "topk:k", "int8", "int4",
    # "entropy:T", "+"-compositions); bytes go to distill_engine.uplink_log.
    transport: str = "none"


# ---------------------------------------------------------------------------


def _generator(key):
    """A ``torch.Generator`` from a seed (or the generator itself)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def grad_step(adapter: ModelAdapter, opt, loss_fn=None):
    """One optimizer step on a batch:
    ``step(state, opt_state, x, y, i) -> (state, opt_state)``.
    ``loss_fn(logits, y, params)`` defaults to cross-entropy."""
    if loss_fn is None:
        def loss_fn(lg, y, params):
            return distill.ce_loss(lg, y)

    def objective(params, state, x, y):
        lg, new_state = adapter.logits(adapter.with_params(state, params), x,
                                       True)
        return loss_fn(lg, y, params), new_state

    grad_fn = torch.func.grad_and_value(objective, has_aux=True)

    def step(state, opt_state, x, y, i):
        params = adapter.params(state)
        grads, (_, new_state) = grad_fn(params, state, x, y)
        with torch.no_grad():
            new_params, opt_state = opt.update(grads, opt_state, params, i)
        return adapter.with_params(new_state, new_params), opt_state

    return step


def _evaluate(adapter, state, ds: Dataset, bs=512):
    """One inference pass -> (accuracy, argmax predictions), with one host
    sync per pass (not per batch)."""
    device = tree_device(state)
    preds = []
    with torch.no_grad():
        for i in range(0, len(ds), bs):
            lg, _ = adapter.logits(
                state, torch.as_tensor(ds.x[i:i + bs], device=device), False)
            preds.append(torch.argmax(lg, -1))
    preds = (torch.cat(preds).cpu().numpy() if preds
             else np.zeros(0, np.int64))
    acc = float((preds == ds.y[:len(preds)]).sum()) / max(len(preds), 1)
    return acc, preds


def _accuracy(adapter, state, ds: Dataset, bs=512):
    return _evaluate(adapter, state, ds, bs)[0]


@dataclasses.dataclass
class RoundMetrics:
    """One round's recorded metrics — a structured record with a read-only
    mapping interface (``hist[-1]["test_acc"]``, ``"lost" in rec``,
    ``rec.get("forget_score")``).  Fields that are `None` behave as absent
    keys."""

    round: int
    edges: list
    straggler: bool
    staleness: list
    test_acc: float
    acc_cur_edge: float
    acc_prev_edge: Optional[float] = None
    forget_score: Optional[float] = None
    lost: Optional[int] = None
    gained: Optional[int] = None
    retained: Optional[int] = None

    def __getitem__(self, key):
        val = getattr(self, key)
        if val is None:
            raise KeyError(key)
        return val

    def __contains__(self, key):
        return (key in self.__dataclass_fields__
                and getattr(self, key) is not None)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def keys(self):
        return [f for f in self.__dataclass_fields__ if f in self]

    def as_dict(self):
        return {k: getattr(self, k) for k in self.keys()}


def _train_on(adapter, state, ds, cfg: FLConfig, epochs, lr, seed):
    steps_per_epoch = max(len(ds) // min(cfg.batch_size, len(ds)), 1)
    total = steps_per_epoch * epochs
    opt = sgd_momentum(step_decay(lr, [total // 2, 3 * total // 4]),
                       weight_decay=cfg.weight_decay)
    opt_state = opt.init(adapter.params(state))
    step = grad_step(adapter, opt)
    device = tree_device(state)
    i = 0
    for x, y in batches(ds, cfg.batch_size, seed=seed, epochs=epochs):
        state, opt_state = step(state, opt_state,
                                torch.as_tensor(x, device=device),
                                torch.as_tensor(y, device=device), i)
        i += 1
    return state


class FederatedKD:
    """Runs Algorithm 1 and records the paper's metrics per round."""

    def __init__(self, adapter: ModelAdapter, cfg: FLConfig,
                 core_ds: Dataset, edge_dss: list, test_ds: Dataset,
                 scheduler=None, *, device="cuda"):
        resolve_method(cfg.method)   # fail fast on unknown method names
        self.device = resolve_device(device)
        self.adapter, self.cfg = adapter, cfg
        self.core_ds, self.edge_dss, self.test_ds = core_ds, edge_dss, test_ds
        self.scheduler = scheduler or RoundScheduler.from_config(cfg)
        self.engine = (VectorizedEdgeEngine(adapter, cfg.lr, cfg.weight_decay)
                       if cfg.vectorize else None)
        self.distill_engine = DistillEngine(adapter, cfg, core_ds, self.device)
        self.history = []

    # Phase 0 ---------------------------------------------------------------
    def pretrain_core(self, key):
        state = self.adapter.init(_generator(key), self.device)
        state = _train_on(self.adapter, state, self.core_ds, self.cfg,
                          self.cfg.core_epochs, self.cfg.lr, self.cfg.seed)
        self.w0 = state
        return state

    # Phase 1 ---------------------------------------------------------------
    def train_edge(self, init_state, edge_idx, seed):
        return _train_on(self.adapter, init_state, self.edge_dss[edge_idx],
                         self.cfg, self.cfg.edge_epochs, self.cfg.lr, seed)

    def train_round_edges(self, init_states, edge_ids, seed):
        """All of a round's Phase-1 trainings; one vectorized computation
        when the engine can stack the shards, else the sequential loop."""
        if self.engine is not None:
            out = self.engine.train_round(
                init_states, [self.edge_dss[e] for e in edge_ids],
                self.cfg.batch_size, self.cfg.edge_epochs, seed)
            if out is not None:
                return out
        return [self.train_edge(st, e, seed)
                for st, e in zip(init_states, edge_ids)]

    # Phase 2 ---------------------------------------------------------------
    def _round_method(self, round_idx):
        """This round's method name (the paper's §4.2 plain-KD warm-up
        overrides cfg.method for the first kd_warm_rounds when R > 1)."""
        cfg = self.cfg
        if cfg.aggregation_r > 1 and round_idx < cfg.kd_warm_rounds:
            return "kd"
        return cfg.method

    def _shard_weights(self, edge_ids):
        """Teacher weights: the sizes of the edges' shards."""
        return ([len(self.edge_dss[e]) for e in edge_ids]
                if edge_ids is not None else None)

    def distill(self, state, teacher_states, round_idx, edge_ids=None):
        """Distill the round's teachers into ``state`` through the Phase-2
        engine (the teachers weighted by their shards' sizes)."""
        return self.distill_engine.run(
            state, teacher_states, round_idx,
            method=self._round_method(round_idx),
            teacher_weights=self._shard_weights(edge_ids))

    def distill_stepper(self, state, teacher_states, round_idx, edge_ids=None):
        """A resumable ``RoundStepper`` for this round's Phase 2 (the
        teachers weighted by their shards' sizes)."""
        return self.distill_engine.stepper(
            state, teacher_states, round_idx,
            method=self._round_method(round_idx),
            teacher_weights=self._shard_weights(edge_ids))

    # Full protocol ----------------------------------------------------------
    def _resolve_init(self, task, core_log, state):
        """Map an EdgeTask's staleness onto concrete weights: 0 = current
        core, FROZEN = W0, s > 0 = the core as of s rounds ago (clamped to
        the oldest retained state)."""
        if task.staleness == FROZEN:
            return self.w0
        if task.staleness == 0:
            return state
        return core_log[max(len(core_log) - 1 - task.staleness, 0)]

    def _round_union(self, edge_ids):
        """The round's current-edge evaluation set: the union of the round's
        shards (deduplicating repeated edge ids)."""
        ids = list(dict.fromkeys(edge_ids))
        if len(ids) == 1:
            return self.edge_dss[ids[0]]
        return Dataset(np.concatenate([self.edge_dss[e].x for e in ids]),
                       np.concatenate([self.edge_dss[e].y for e in ids]))

    def _record_round(self, state, round_idx, edges, straggler, staleness,
                      cur_ds, pre_preds, prev_edge_ds):
        """Record one distillation round's metrics (single inference pass
        per dataset) and return (record, current-edge predictions)."""
        acc_cur, cur_preds = _evaluate(self.adapter, state, cur_ds)
        rec = RoundMetrics(
            round=round_idx,
            edges=list(edges),
            straggler=straggler,
            staleness=list(staleness),
            test_acc=_accuracy(self.adapter, state, self.test_ds),
            acc_cur_edge=acc_cur,
        )
        if prev_edge_ds is not None:
            acc_prev, post = _evaluate(self.adapter, state, prev_edge_ds)
            rec.acc_prev_edge = acc_prev
            rec.forget_score = rec.acc_cur_edge - rec.acc_prev_edge
            cb = pre_preds == prev_edge_ds.y
            ca = post == prev_edge_ds.y
            rec.lost = int(np.sum(cb & ~ca))
            rec.gained = int(np.sum(~cb & ca))
            rec.retained = int(np.sum(cb & ca))
        self.history.append(rec)
        return rec, cur_preds

    def run(self, key, log=print):
        """Algorithm 1 over the plan stream; ``key`` is a seed or a
        ``torch.Generator`` for the core's initial weights.  Returns
        ``(state, history)``."""
        plans = list(self.scheduler.plans(self.cfg.rounds))
        if any(getattr(p, "level", "") == "region" for p in plans):
            # A two-level stream (fleet.HierarchicalFleetSimulator): region
            # rounds keep per-region models, core rounds distill their
            # uplinked snapshots.
            state = self.pretrain_core(key)
            return self._run_hierarchical(state, plans, log)
        # The flat loop is the live trainer driven to completion.
        from repro_torch.live.trainer import LiveTrainer
        trainer = LiveTrainer(self, key, plans=plans, log=log)
        trainer.run()
        return trainer.state, self.history

    def _run_hierarchical(self, state, plans, log):
        """Drive a two-level plan stream: region rounds distill edge
        teachers into per-region models; core rounds distill the uplinked
        region-model snapshots into the core (weighted by the regions'
        total shard sizes), then sync the consumed regions back down.
        ``history`` records one entry per *core* round."""
        cfg = self.cfg
        level = lambda p: getattr(p, "level", "")  # noqa: E731
        region_plans = [p for p in plans if level(p) == "region"]
        core_plans = [p for p in plans if level(p) == "core"]
        regions = sorted({p.region for p in region_plans})
        # Each region resolves its own emergent staleness against its own
        # past models, kept as deep as its deepest task needs.
        keep = {g: 1 + max((t.staleness
                            for p in region_plans if p.region == g
                            for t in p.tasks if t.staleness > 0), default=0)
                for g in regions}
        # Only region-model versions some core round consumes are kept,
        # each until it is consumed.
        needed = {(g, v) for p in core_plans for g, v in p.region_versions}
        reg = {g: state for g in regions}       # current region models
        reg_log = {g: [] for g in regions}
        snaps = {}
        prev_edge_ds, prev_preds = None, None
        for plan in plans:
            if level(plan) == "region":
                g = plan.region
                reg_log[g] = (reg_log[g] + [reg[g]])[-keep[g]:]
                inits = [self._resolve_init(t, reg_log[g], reg[g])
                         for t in plan.tasks]
                teachers = self.train_round_edges(
                    inits, plan.edge_ids, seed=cfg.seed + 31 * plan.round_idx)
                reg[g] = self.distill(reg[g], teachers, plan.round_idx,
                                      edge_ids=plan.edge_ids)
                v = plan.region_round + 1
                if (g, v) in needed:
                    snaps[(g, v)] = reg[g]
                if log:
                    log(f"[region {g} r{plan.region_round:02d}] "
                        f"edges={plan.edge_ids} t={plan.time:.2f} "
                        f"via {plan.trigger}")
                continue
            # Core round: the uplinked region-model snapshots are the
            # teachers, weighted by their regions' total shard sizes.
            teachers = [snaps.pop((g, v)) for g, v in plan.region_versions]
            weights = [sum(len(self.edge_dss[e]) for e in members)
                       for members in plan.member_edges]
            cur_ds = self._round_union(
                [e for members in plan.member_edges for e in members])
            pre_preds = prev_preds
            state = self.distill_engine.run(state, teachers, plan.round_idx,
                                            method=cfg.method,
                                            teacher_weights=weights)
            consumed = [g for g, _ in plan.region_versions]
            rec, cur_preds = self._record_round(
                state, plan.core_round, consumed, plan.straggler,
                [t.staleness for t in plan.tasks], cur_ds, pre_preds,
                prev_edge_ds)
            for g in consumed:
                reg[g] = state      # sync-down: the region gets the new core
            if log:
                log(f"[core round {plan.core_round:02d}] regions={consumed} "
                    f"test_acc={rec.test_acc:.4f} t={plan.time:.2f} "
                    f"via {plan.trigger}")
            prev_edge_ds, prev_preds = cur_ds, cur_preds
        return state, self.history
