"""Round scheduling — which edges train this round, and from which weights.

A numpy-only copy of the JAX package's ``repro/core/scheduler.py``; the
asynchronous, fleet and hierarchical scenarios build the port's copies of
``core/simulator.py`` and ``core/fleet.py``.  The original's text follows.

The paper's straggler experiments (§4.3, Figs. 9 & 11) are two points in a
much larger scenario space: every round, the orchestrator must decide (a)
which of the K edges participate, and (b) how *stale* the weights each edge
starts from are.  The seed code hard-wired both decisions into three magic
strings (``straggler=none|alternate|frozen_w0``) inside ``FederatedKD.run``;
this module factors them into two composable policies:

  * an :class:`EdgeSampler` picks the participating edge ids
    (round-robin — the paper's schedule —, uniform random sampling, or
    random sampling with partial participation where edges drop out);
  * a :class:`StalenessPolicy` assigns each picked edge a staleness
    (0 = current core weights, ``s > 0`` = the core as of ``s`` rounds ago,
    :data:`FROZEN` = the Phase-0 weights W0, never re-synchronized).

A :class:`RoundScheduler` combines the two plus a withdraw rule (skip the
distillation of rounds that contain stale teachers — the trivial baseline
of Fig. 11) and emits one :class:`RoundPlan` per round.  The legacy strings
map onto schedulers via :meth:`RoundScheduler.from_config`, and the named
scenarios used by the benchmarks/docs live in :data:`SCENARIOS` /
:func:`build_scenario`.

Determinism: policies draw from ``numpy.random.default_rng`` streams seeded
at construction, so a scheduler replayed from the same seed emits the same
plans — plans depend only on (seed, round index), never on wall-clock.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Sentinel staleness: the edge trains from the Phase-0 core weights W0 and
#: is never re-synchronized (the Fig. 9 zero-synchronization extreme).
FROZEN = -1


@dataclasses.dataclass(frozen=True)
class EdgeTask:
    """One Phase-1 training assignment within a round."""

    edge_id: int
    staleness: int = 0  # 0 fresh | s>0 rounds stale | FROZEN (= W0)

    @property
    def stale(self) -> bool:
        return self.staleness != 0


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Everything ``FederatedKD.run`` needs to execute one round."""

    round_idx: int
    tasks: tuple[EdgeTask, ...]
    withdraw: bool = False  # skip Phase-2 distillation this round

    @property
    def straggler(self) -> bool:
        return any(t.stale for t in self.tasks)

    @property
    def edge_ids(self) -> list[int]:
        return [t.edge_id for t in self.tasks]


# ---------------------------------------------------------------------------
# Edge samplers: which edges participate.
# ---------------------------------------------------------------------------


class EdgeSampler:
    """Picks the edge ids for a round.  Stateless in round_idx: calling
    ``select`` twice for the same round returns the same ids."""

    def select(self, round_idx: int, count: int) -> list[int]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RoundRobinSampler(EdgeSampler):
    """The paper's schedule: edges visited cyclically, R per round."""

    num_edges: int

    def select(self, round_idx, count):
        start = round_idx * count
        return [(start + i) % self.num_edges for i in range(count)]


@dataclasses.dataclass(frozen=True)
class RandomSampler(EdgeSampler):
    """Uniform sampling without replacement within a round.

    ``participation < 1`` models partial participation: each selected edge
    independently drops out with probability ``1 - participation`` (at least
    one edge always remains, so every round has a teacher).
    """

    num_edges: int
    seed: int = 0
    participation: float = 1.0

    def _rng(self, round_idx):
        return np.random.default_rng((self.seed, 0x5EED, round_idx))

    def select(self, round_idx, count):
        rng = self._rng(round_idx)
        count = min(count, self.num_edges)
        ids = rng.choice(self.num_edges, size=count, replace=False)
        if self.participation < 1.0:
            keep = rng.random(count) < self.participation
            if not keep.any():
                keep[rng.integers(count)] = True
            ids = ids[keep]
        return [int(i) for i in ids]


# ---------------------------------------------------------------------------
# Staleness policies: which weights each edge starts from.
# ---------------------------------------------------------------------------


class StalenessPolicy:
    """Assigns a staleness to each (round, slot) assignment."""

    #: Deepest ``s > 0`` this policy can emit — the orchestrator keeps a
    #: ring buffer of that many past core states (FROZEN uses W0 instead).
    max_staleness: int = 0

    def staleness(self, round_idx: int, slot: int, edge_id: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Fresh(StalenessPolicy):
    """Every edge trains from the current core weights (no stragglers)."""

    def staleness(self, round_idx, slot, edge_id):
        return 0


@dataclasses.dataclass(frozen=True)
class Alternate(StalenessPolicy):
    """Fig. 11: every ``period``-th round the teachers are one round stale
    (trained from the previous round's core weights)."""

    period: int = 2

    @property
    def max_staleness(self):
        return 1

    def staleness(self, round_idx, slot, edge_id):
        return 1 if round_idx % self.period == self.period - 1 else 0


@dataclasses.dataclass(frozen=True)
class FrozenW0(StalenessPolicy):
    """Fig. 9: zero synchronization — every teacher starts from W0."""

    def staleness(self, round_idx, slot, edge_id):
        return FROZEN


@dataclasses.dataclass(frozen=True)
class RandomDelay(StalenessPolicy):
    """Per-edge random delays: each assignment is stale with probability
    ``p``, with a staleness depth drawn geometrically (mean ``1/decay``)
    and capped at ``max_delay``.  Models heterogeneous edge hardware where
    slow clients return models trained from weights several rounds old."""

    p: float = 0.5
    max_delay: int = 3
    decay: float = 0.5
    seed: int = 0

    @property
    def max_staleness(self):
        return self.max_delay

    def staleness(self, round_idx, slot, edge_id):
        rng = np.random.default_rng((self.seed, 0xDE1A, round_idx, slot))
        if rng.random() >= self.p:
            return 0
        return int(min(1 + rng.geometric(self.decay) - 1, self.max_delay))


# ---------------------------------------------------------------------------
# The scheduler.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundScheduler:
    """Composable round planner: sampler x staleness x withdraw rule."""

    sampler: EdgeSampler
    staleness: StalenessPolicy = Fresh()
    teachers_per_round: int = 1          # R, the aggregation size (paper §4.2)
    withdraw_on_stale: bool = False      # Fig. 11 'withdraw' baseline

    @property
    def max_staleness(self) -> int:
        return self.staleness.max_staleness

    def plan(self, round_idx: int) -> RoundPlan:
        ids = self.sampler.select(round_idx, self.teachers_per_round)
        tasks = tuple(
            EdgeTask(edge_id=e,
                     staleness=self.staleness.staleness(round_idx, slot, e))
            for slot, e in enumerate(ids))
        withdraw = self.withdraw_on_stale and any(t.stale for t in tasks)
        return RoundPlan(round_idx=round_idx, tasks=tasks, withdraw=withdraw)

    def plans(self, rounds: int) -> list[RoundPlan]:
        """The full synchronous round stream — the scheduler as a *plan
        source*, the interface ``FederatedKD.run`` drives.  The event-driven
        simulator (:class:`repro.core.simulator.EventDrivenSimulator`) emits
        the same interface with emergent rather than scripted staleness."""
        return [self.plan(r) for r in range(rounds)]

    @classmethod
    def from_config(cls, cfg) -> "RoundScheduler":
        """Map the legacy ``FLConfig.straggler`` strings onto policies.

        Produces plans identical to the seed orchestrator: round-robin edge
        selection, ``alternate`` stale on odd rounds, ``frozen_w0`` always
        W0, ``withdraw`` skipping stale rounds.
        """
        policies = {"none": Fresh(), "alternate": Alternate(),
                    "frozen_w0": FrozenW0()}
        if cfg.straggler not in policies:
            raise ValueError(f"unknown straggler schedule {cfg.straggler!r}; "
                             f"pass a RoundScheduler for custom policies")
        return cls(sampler=RoundRobinSampler(cfg.num_edges),
                   staleness=policies[cfg.straggler],
                   teachers_per_round=cfg.aggregation_r,
                   withdraw_on_stale=cfg.withdraw)


def max_retained_staleness(plans) -> int:
    """The deepest ``s > 0`` across a plan stream: how many past core states
    (beyond the current one) a round loop must retain to resolve every task's
    starting weights.  :data:`FROZEN` is excluded — it resolves to W0, not
    to the ring buffer."""
    return max((t.staleness for p in plans for t in p.tasks
                if t.staleness > 0), default=0)


# ---------------------------------------------------------------------------
# Named scenarios (benchmarks, docs/scenarios.md, sweep --scenarios).
# ---------------------------------------------------------------------------

SCENARIOS = {
    "none": "round-robin edges, always-fresh weights (paper default)",
    "alternate": "every other round one-round-stale teachers (Fig. 11)",
    "frozen_w0": "zero synchronization, all teachers from W0 (Fig. 9)",
    "withdraw_alternate": "alternate + skip distilling stale rounds (Fig. 11 baseline)",
    "random_sampling": "uniform random client sampling, fresh weights",
    "partial_participation": "random sampling, edges drop out w.p. 0.4",
    "random_delay": "per-edge geometric delays up to 3 rounds stale",
    # Event-driven asynchronous scenarios (repro/core/simulator.py): device
    # heterogeneity on a virtual clock — staleness is emergent, not scripted.
    "async_uniform": "event-driven: uniform device speeds, buffered window of R arrivals",
    "async_heavy_tail": "event-driven: heavy-tail (lognormal) device speeds, deadline aggregation",
    "async_dropout": "event-driven: 5-35% update loss per dispatch, distill-on-arrival",
    # Fleet-scale vectorized scenarios (repro/core/fleet.py): the same
    # timeline semantics on flat arrays (plan-for-plan identical to the heap
    # simulator), plus two-level region -> core aggregation.
    "fleet_uniform": "vectorized fleet timeline: uniform speeds, buffered window of R (heap-parity twin of async_uniform)",
    "hier_uniform": "two-level: per-region buffered windows, regions distill into the core on a window",
    "hier_heavy_tail": "two-level: heavy-tail edge speeds, regional windows, core deadline aggregation",
}

#: The SCENARIOS entries served by the event-driven simulator.
ASYNC_SCENARIOS = ("async_uniform", "async_heavy_tail", "async_dropout")

#: The SCENARIOS entries served by the vectorized FleetSimulator (flat).
FLEET_SCENARIOS = ("fleet_uniform",)

#: The SCENARIOS entries served by the HierarchicalFleetSimulator.  Their
#: plan streams interleave region- and core-level rounds — `FederatedKD.run`
#: consumes them, but the flat LLM trainer (`repro.launch.train`) does not.
HIER_SCENARIOS = ("hier_uniform", "hier_heavy_tail")


def _hier_regions(num_edges: int) -> int:
    """Default region count for the hier_* scenarios: ~sqrt(num_edges),
    clamped so every region owns at least two edges (one region when the
    fleet is too small to split)."""
    return max(1, min(max(2, int(np.sqrt(num_edges))), num_edges // 2))


def build_scenario(name: str, num_edges: int, *, aggregation_r: int = 1,
                   seed: int = 0):
    """Instantiate a named scenario from :data:`SCENARIOS` — a
    :class:`RoundScheduler` for the synchronous names, an
    :class:`~repro_torch.core.simulator.EventDrivenSimulator` for the ``async_*``
    names, a :class:`~repro_torch.core.fleet.FleetSimulator` /
    :class:`~repro_torch.core.fleet.HierarchicalFleetSimulator` for the
    ``fleet_*`` / ``hier_*`` names.  All are plan sources
    (``.plans(rounds)``), so any drops into
    ``FederatedKD(..., scheduler=...)`` unchanged."""
    if name in FLEET_SCENARIOS or name in HIER_SCENARIOS:
        # Imported lazily: fleet.py imports this module at its top.
        from repro_torch.core.fleet import (FleetSimulator,
                                      HierarchicalFleetSimulator)
        from repro_torch.core.simulator import BufferedWindow, Deadline
        if name == "fleet_uniform":
            return FleetSimulator(num_edges, profiles="uniform",
                                  trigger=BufferedWindow(max(aggregation_r, 1)),
                                  seed=seed)
        regions = _hier_regions(num_edges)
        window = BufferedWindow(max(1, min(aggregation_r,
                                           num_edges // regions)))
        if name == "hier_uniform":
            return HierarchicalFleetSimulator(
                num_edges, regions, "uniform", region_trigger=window,
                core_trigger=BufferedWindow(min(2, regions)), seed=seed)
        return HierarchicalFleetSimulator(
            num_edges, regions, "heavy_tail", region_trigger=window,
            core_trigger=Deadline(interval=3.0), seed=seed)
    if name in ASYNC_SCENARIOS:
        # Imported lazily: simulator.py imports this module at its top.
        from repro_torch.core.simulator import (BufferedWindow, Deadline,
                                          DistillOnArrival,
                                          EventDrivenSimulator)
        profile = name[len("async_"):]
        trigger = {"uniform": BufferedWindow(max(aggregation_r, 1)),
                   "heavy_tail": Deadline(interval=2.0),
                   "dropout": DistillOnArrival()}[profile]
        return EventDrivenSimulator(num_edges, profiles=profile,
                                    trigger=trigger, seed=seed)
    rr = RoundRobinSampler(num_edges)
    if name == "none":
        return RoundScheduler(rr, Fresh(), aggregation_r)
    if name == "alternate":
        return RoundScheduler(rr, Alternate(), aggregation_r)
    if name == "frozen_w0":
        return RoundScheduler(rr, FrozenW0(), aggregation_r)
    if name == "withdraw_alternate":
        return RoundScheduler(rr, Alternate(), aggregation_r,
                              withdraw_on_stale=True)
    if name == "random_sampling":
        return RoundScheduler(RandomSampler(num_edges, seed=seed), Fresh(),
                              aggregation_r)
    if name == "partial_participation":
        return RoundScheduler(
            RandomSampler(num_edges, seed=seed, participation=0.6), Fresh(),
            aggregation_r)
    if name == "random_delay":
        return RoundScheduler(rr, RandomDelay(seed=seed), aggregation_r)
    raise ValueError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
