"""Event-driven asynchronous FL simulation — emergent staleness (§4.3).

A numpy-only copy of the JAX package's ``repro/core/simulator.py``; the
random streams, the event order and the emitted plans are the original's,
byte for byte.  The original's text follows.

The paper's straggler experiments (Figs. 9 & 11) *script* staleness: a
:class:`~repro_torch.core.scheduler.StalenessPolicy` decides that round r's
teachers are s rounds stale.  Real deployments are the other way around —
edges are heterogeneous devices (slow SoCs, lossy links, flaky power), the
server consumes model updates whenever they *arrive*, and staleness is
whatever the timeline produced.  This module simulates that regime on a
virtual clock:

  * each edge has a :class:`DeviceProfile` (compute speed, network latency,
    dropout probability) drawn from a named distribution family
    (:func:`make_profiles`);
  * a dispatch hands the edge the **core version that exists at dispatch
    time**; training takes ``work / speed (+ jitter) + latency`` virtual
    time; the finished teacher *arrives* as a timeline event;
  * the server consumes arrivals through a pluggable
    :class:`AggregationTrigger` — distill on every arrival, buffer a window
    of R arrivals (the paper's R-teacher aggregation, §4.2), or aggregate on
    a fixed deadline with late-teacher handling;
  * each consumption becomes one distillation round; a teacher's staleness
    is **emergent**: ``rounds distilled since its dispatch``, never a
    scripted number.

The simulator is a *plan source*: :meth:`EventDrivenSimulator.plans` runs
the whole event timeline (durations don't depend on weights, so it can run
eagerly) and returns :class:`AsyncRoundPlan` records that
``FederatedKD.run`` — and the LLM trainer ``repro_torch.launch.train --sim`` —
drive exactly like synchronous :class:`~repro_torch.core.scheduler.RoundScheduler`
plans.  With homogeneous devices, zero jitter, and ``concurrency = R`` the
timeline degenerates to the paper's lock-step protocol: the emitted plans
are bit-for-bit the ``RoundRobinSampler``/``Fresh`` plans
(``tests/test_simulator.py::test_sync_parity``).

Determinism: every stochastic draw comes from ``numpy.random.default_rng``
streams keyed on ``(seed, tag)`` and indexed per ``(edge, dispatch
ordinal)`` (:class:`DispatchDraws`), so a simulator replayed with the same
constructor arguments emits an identical timeline — and the vectorized
:class:`~repro_torch.core.fleet.FleetSimulator`, which batch-gathers the same
draws, emits plan-for-plan identical timelines (``tests/test_fleet.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.scheduler import EdgeTask, RoundPlan

__all__ = [
    "DeviceProfile", "PROFILE_FAMILIES", "make_profiles", "profile_arrays",
    "ProfileArrays", "DispatchDraws",
    "AggregationTrigger", "DistillOnArrival", "BufferedWindow", "Deadline",
    "make_trigger", "AsyncRoundPlan", "EventDrivenSimulator",
]


# ---------------------------------------------------------------------------
# Device profiles: the heterogeneity that staleness emerges from.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One edge device: how fast it trains, how laggy its link is, and how
    often its update is lost in transit."""

    speed: float = 1.0     #: work units completed per virtual-time unit
    latency: float = 0.0   #: fixed network delay added to every dispatch
    dropout: float = 0.0   #: probability the finished update never arrives

    def __post_init__(self):
        if self.speed <= 0:
            raise ValueError(f"device speed must be positive, got {self.speed}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")


#: Named distribution families for :func:`make_profiles`.
PROFILE_FAMILIES = ("homogeneous", "uniform", "heavy_tail", "dropout")


@dataclasses.dataclass(frozen=True)
class ProfileArrays:
    """A device population as flat float64 arrays — the form the vectorized
    :class:`~repro_torch.core.fleet.FleetSimulator` consumes directly (no per-edge
    Python objects at 100k+ edges).  :func:`profile_arrays` draws one from a
    named family; :meth:`from_profiles` converts a :class:`DeviceProfile`
    list, so both simulators describe populations in the same vocabulary."""

    speed: np.ndarray
    latency: np.ndarray
    dropout: np.ndarray

    def __post_init__(self):
        for name in ("speed", "latency", "dropout"):
            object.__setattr__(self, name,
                               np.asarray(getattr(self, name), np.float64))
        if not (self.speed.shape == self.latency.shape == self.dropout.shape):
            raise ValueError("speed/latency/dropout arrays must align")
        if np.any(self.speed <= 0):
            raise ValueError("device speeds must be positive")
        if np.any((self.dropout < 0) | (self.dropout >= 1)):
            raise ValueError("dropout must be in [0, 1)")

    def __len__(self):
        return len(self.speed)

    def __eq__(self, other):
        return (isinstance(other, ProfileArrays)
                and np.array_equal(self.speed, other.speed)
                and np.array_equal(self.latency, other.latency)
                and np.array_equal(self.dropout, other.dropout))

    @classmethod
    def from_profiles(cls, profiles: Sequence[DeviceProfile]):
        return cls(np.array([p.speed for p in profiles], np.float64),
                   np.array([p.latency for p in profiles], np.float64),
                   np.array([p.dropout for p in profiles], np.float64))

    def slice(self, lo: int, hi: int) -> "ProfileArrays":
        return ProfileArrays(self.speed[lo:hi], self.latency[lo:hi],
                             self.dropout[lo:hi])


def profile_arrays(family: str, num_edges: int, seed: int = 0) -> ProfileArrays:
    """Draw ``num_edges`` device profiles from a named family as one batched
    operation (same RNG stream and values as :func:`make_profiles` — the two
    forms describe identical populations).

    ``homogeneous``  identical ideal devices (the sync degenerate case)
    ``uniform``      speeds U[0.5, 2.0], latencies U[0, 0.3] — mild spread
    ``heavy_tail``   lognormal speeds (a few devices are order-of-magnitude
                     slower — the regime where buffering matters most)
    ``dropout``      uniform speeds plus 5–35% per-dispatch update loss
    """
    rng = np.random.default_rng((seed, 0xA51C))
    zeros = np.zeros(num_edges)
    if family == "homogeneous":
        return ProfileArrays(np.ones(num_edges), zeros, zeros)
    if family == "uniform":
        return ProfileArrays(rng.uniform(0.5, 2.0, num_edges),
                             rng.uniform(0.0, 0.3, num_edges), zeros)
    if family == "heavy_tail":
        speeds = np.exp(rng.normal(0.0, 0.9, num_edges))
        lats = rng.exponential(0.15, num_edges)
        return ProfileArrays(np.maximum(speeds, 0.05), lats, zeros)
    if family == "dropout":
        return ProfileArrays(rng.uniform(0.6, 1.8, num_edges),
                             rng.uniform(0.0, 0.2, num_edges),
                             rng.uniform(0.05, 0.35, num_edges))
    raise ValueError(f"unknown profile family {family!r}; "
                     f"known: {PROFILE_FAMILIES}")


def make_profiles(family: str, num_edges: int, seed: int = 0):
    """:func:`profile_arrays` as a list of :class:`DeviceProfile` objects
    (the per-edge form the heap simulator carries)."""
    arrs = profile_arrays(family, num_edges, seed)
    return [DeviceProfile(speed=float(s), latency=float(l), dropout=float(d))
            for s, l, d in zip(arrs.speed, arrs.latency, arrs.dropout)]


class DispatchDraws:
    """Per-(edge, dispatch-ordinal) randomness for a simulated timeline,
    drawn in batches: ``z[e, k]`` is the standard-normal jitter draw and
    ``u[e, k]`` the dropout uniform for edge ``e``'s ``k``-th dispatch.

    Both simulators share this vocabulary — the heap loop reads one scalar
    per dispatch, the fleet simulator gathers whole batches — and because
    column blocks grow on a fixed doubling schedule from one generator
    keyed ``(seed, 0xD15C)``, the two see bit-identical values for the same
    constructor arguments.  That keying (per edge *ordinal*, not per global
    dispatch counter) is what decouples the edges' timelines enough to
    vectorize them."""

    def __init__(self, seed, num_edges: int):
        self._rng = np.random.default_rng((seed, 0xD15C))
        self._n = num_edges
        self._z = np.empty((num_edges, 0))
        self._u = np.empty((num_edges, 0))

    def _ensure(self, k: int):
        while self._z.shape[1] <= k:
            block = max(self._z.shape[1], 16)
            self._z = np.concatenate(
                [self._z, self._rng.standard_normal((self._n, block))], axis=1)
            self._u = np.concatenate(
                [self._u, self._rng.random((self._n, block))], axis=1)

    def jitter_z(self, edge: int, k: int) -> float:
        self._ensure(k)
        return float(self._z[edge, k])

    def drop_u(self, edge: int, k: int) -> float:
        self._ensure(k)
        return float(self._u[edge, k])

    def gather(self, edges, ks):
        """Vectorized access: (jitter_z, drop_u) arrays for ``edges[i]``'s
        ``ks[i]``-th dispatch."""
        if len(ks):
            self._ensure(int(np.max(ks)))
        return self._z[edges, ks], self._u[edges, ks]


# ---------------------------------------------------------------------------
# Aggregation triggers: when buffered arrivals become a distillation round.
# ---------------------------------------------------------------------------


class AggregationTrigger:
    """Decides when the server turns buffered teacher arrivals into one
    Phase-2 distillation round."""


@dataclasses.dataclass(frozen=True)
class DistillOnArrival(AggregationTrigger):
    """Fully asynchronous: every arrival immediately distills (R = 1)."""


@dataclasses.dataclass(frozen=True)
class BufferedWindow(AggregationTrigger):
    """Buffer arrivals until ``r`` have accumulated, then distill them as
    one R-teacher ensemble (the paper's §4.2 aggregation, asynchronously)."""

    r: int = 2

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"window size must be >= 1, got {self.r}")


@dataclasses.dataclass(frozen=True)
class Deadline(AggregationTrigger):
    """Aggregate every ``interval`` virtual-time units with whatever
    arrived; an empty window distills nothing.  ``max_late`` handles
    teachers that missed earlier windows: an arrival whose emergent
    staleness at the deadline exceeds ``max_late`` is discarded (its edge is
    re-dispatched with fresh weights); ``None`` includes every late teacher,
    staleness recorded."""

    interval: float = 2.0
    max_late: Optional[int] = None

    def __post_init__(self):
        if self.interval <= 0:
            raise ValueError(f"deadline interval must be positive, "
                             f"got {self.interval}")


def make_trigger(spec: Union[str, AggregationTrigger],
                 aggregation_r: Optional[int] = None) -> AggregationTrigger:
    """Parse ``"arrival" | "window[:R]" | "deadline[:T[:max_late]]"`` (an
    already-built trigger passes through).  A bare ``"window"`` uses
    ``aggregation_r`` when given, else BufferedWindow's own default."""
    if isinstance(spec, AggregationTrigger):
        return spec
    head, *rest = str(spec).split(":")
    if head == "arrival":
        return DistillOnArrival()
    if head == "window":
        if rest:
            return BufferedWindow(int(rest[0]))
        if aggregation_r is not None:
            return BufferedWindow(max(aggregation_r, 1))
        return BufferedWindow()
    if head == "deadline":
        interval = float(rest[0]) if rest else 2.0
        max_late = int(rest[1]) if len(rest) > 1 else None
        return Deadline(interval=interval, max_late=max_late)
    raise ValueError(f"unknown trigger spec {spec!r}; expected "
                     f"'arrival', 'window[:R]', or 'deadline[:T[:max_late]]'")


# ---------------------------------------------------------------------------
# The emitted plan: a RoundPlan plus the timeline that produced it.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncRoundPlan(RoundPlan):
    """A :class:`~repro_torch.core.scheduler.RoundPlan` carrying its event-time
    provenance — drop-in for the synchronous round loop, richer for logs and
    benchmarks."""

    time: float = 0.0                  #: virtual time the round was triggered
    trigger: str = ""                  #: "arrival" | "window" | "deadline"
    dispatch_versions: tuple = ()      #: core version each teacher trained from
    arrival_times: tuple = ()          #: virtual time each teacher arrived
    uplink_bytes: tuple = ()           #: wire bytes each teacher's uplink cost


@dataclasses.dataclass(frozen=True)
class _Arrival:
    edge: int
    version: int     # core version the dispatch carried
    time: float


# ---------------------------------------------------------------------------
# The simulator.
# ---------------------------------------------------------------------------


_EV_ARRIVAL, _EV_DEADLINE = 0, 1


class EventDrivenSimulator:
    """Virtual-clock event loop over heterogeneous edges.

    A *plan source* (like :class:`~repro_torch.core.scheduler.RoundScheduler`):
    :meth:`plans` returns the stream of distillation rounds the orchestrator
    drives.  ``concurrency`` bounds how many edges train at once (default:
    all of them — the realistic always-training regime; set it to R with
    homogeneous profiles for the synchronous degenerate case).  Idle edges
    are re-dispatched in round-robin order with the **current** core
    version, so a dispatch's version and its consumption round can drift
    apart — that drift is the emergent staleness.
    """

    def __init__(self, num_edges: int,
                 profiles: Union[str, Sequence[DeviceProfile]] = "uniform",
                 trigger: Union[str, AggregationTrigger] = "arrival", *,
                 concurrency: Optional[int] = None, work: float = 1.0,
                 jitter: float = 0.15, payload_bytes: float = 0.0,
                 seed: int = 0):
        if isinstance(profiles, str):
            self.profile_family = profiles
            profiles = make_profiles(profiles, num_edges, seed)
        else:
            self.profile_family = "custom"
            if isinstance(profiles, ProfileArrays):
                profiles = [DeviceProfile(speed=float(s), latency=float(l),
                                          dropout=float(d))
                            for s, l, d in zip(profiles.speed,
                                               profiles.latency,
                                               profiles.dropout)]
        if len(profiles) != num_edges:
            raise ValueError(f"{len(profiles)} profiles for {num_edges} edges")
        self.num_edges = num_edges
        self.profiles = list(profiles)
        self.trigger = make_trigger(trigger)
        if concurrency is not None and concurrency < 1:
            raise ValueError(f"concurrency must be >= 1 (or None for all "
                             f"edges), got {concurrency}")
        self.concurrency = min(concurrency or num_edges, num_edges)
        if (isinstance(self.trigger, BufferedWindow)
                and self.trigger.r > self.concurrency):
            raise ValueError(
                f"BufferedWindow(r={self.trigger.r}) can never fill with "
                f"concurrency={self.concurrency}: at most {self.concurrency} "
                f"teachers are ever in flight")
        if work <= 0:
            raise ValueError(f"work must be positive, got {work}")
        if payload_bytes < 0:
            raise ValueError(f"payload_bytes must be >= 0, "
                             f"got {payload_bytes}")
        self.work = work
        self.jitter = jitter
        #: Wire bytes one teacher uplink costs (from a transport codec's
        #: ``payload_bytes``; 0 disables byte accounting).  Recorded on
        #: every emitted plan and totalled in :attr:`stats`.
        self.payload_bytes = float(payload_bytes)
        self.seed = seed
        #: Timeline statistics of the last :meth:`plans` call.
        self.stats: dict = {}

    # -- the event loop -----------------------------------------------------

    def plans(self, rounds: int) -> list:
        """Simulate until ``rounds`` distillation rounds were triggered and
        return them as :class:`AsyncRoundPlan` records (eager: durations
        don't depend on training results, so the full timeline is known
        upfront).  Re-running with the same arguments replays the identical
        timeline."""
        self.stats = {}          # a stalled run must not leak stale numbers
        heap: list = []          # (time, seq, kind, payload)
        seq = itertools.count()
        busy = [False] * self.num_edges
        buffer: list[_Arrival] = []
        out: list[AsyncRoundPlan] = []
        ptr = 0                  # round-robin dispatch pointer
        version = 0              # number of distillation rounds so far
        dispatches = drops = late_drops = 0
        draws = DispatchDraws(self.seed, self.num_edges)
        ordinal = [0] * self.num_edges   # per-edge dispatch counter

        def dispatch(edge, t):
            nonlocal dispatches
            k = ordinal[edge]
            ordinal[edge] += 1
            dispatches += 1
            p = self.profiles[edge]
            dur = self.work / p.speed
            if self.jitter:
                dur *= float(np.exp(self.jitter * draws.jitter_z(edge, k)))
            dur += p.latency
            ok = bool(draws.drop_u(edge, k) >= p.dropout)
            busy[edge] = True
            heapq.heappush(heap, (t + dur, next(seq), _EV_ARRIVAL,
                                  (edge, version, ok)))

        def fill(t):
            # Restore concurrency: dispatch idle edges in round-robin order
            # starting at the pointer; the pointer advances past each edge
            # actually dispatched (so the homogeneous degenerate case visits
            # edges exactly like RoundRobinSampler).
            nonlocal ptr
            need = self.concurrency - sum(busy)
            base = ptr
            for i in range(self.num_edges):
                if need <= 0:
                    break
                e = (base + i) % self.num_edges
                if not busy[e]:
                    dispatch(e, t)
                    need -= 1
                    ptr = e + 1

        def consume(arrivals, t, trig):
            nonlocal version
            tasks = tuple(EdgeTask(edge_id=a.edge, staleness=version - a.version)
                          for a in arrivals)
            plan = AsyncRoundPlan(
                round_idx=version, tasks=tasks, withdraw=False,
                time=t, trigger=trig,
                dispatch_versions=tuple(a.version for a in arrivals),
                arrival_times=tuple(a.time for a in arrivals),
                uplink_bytes=tuple(self.payload_bytes for _ in arrivals))
            version += 1
            for a in arrivals:
                busy[a.edge] = False
            return plan

        if isinstance(self.trigger, Deadline):
            heapq.heappush(heap, (self.trigger.interval, next(seq),
                                  _EV_DEADLINE, None))
        fill(0.0)
        t = 0.0
        events = 0
        budget = max(10_000, 1_000 * rounds)
        while len(out) < rounds:
            events += 1
            if events > budget or not heap:
                raise RuntimeError(
                    f"async simulator stalled after {events - 1} events with "
                    f"{len(out)}/{rounds} rounds (trigger={self.trigger!r}, "
                    f"concurrency={self.concurrency})")
            t, _, kind, payload = heapq.heappop(heap)
            if kind == _EV_DEADLINE:
                kept = []
                for a in buffer:
                    trig = self.trigger
                    if (trig.max_late is not None
                            and version - a.version > trig.max_late):
                        late_drops += 1
                        busy[a.edge] = False   # discarded; edge re-dispatches
                    else:
                        kept.append(a)
                buffer = []
                if kept:
                    out.append(consume(kept, t, "deadline"))
                heapq.heappush(heap, (t + self.trigger.interval, next(seq),
                                      _EV_DEADLINE, None))
                fill(t)
                continue
            edge, v, ok = payload
            if not ok:
                drops += 1
                busy[edge] = False
                fill(t)
                continue
            buffer.append(_Arrival(edge, v, t))
            if isinstance(self.trigger, DistillOnArrival):
                out.append(consume(buffer, t, "arrival"))
                buffer = []
                fill(t)
            elif (isinstance(self.trigger, BufferedWindow)
                    and len(buffer) >= self.trigger.r):
                out.append(consume(buffer, t, "window"))
                buffer = []
                fill(t)
            # Deadline trigger: arrivals just accumulate until the tick.

        stale = [s for p in out for s in (tk.staleness for tk in p.tasks)]
        self.stats = {
            "rounds": len(out),
            "makespan": out[-1].time if out else 0.0,
            "dispatches": dispatches,
            "drops": drops,
            "late_drops": late_drops,
            "in_flight": sum(busy),
            "teachers": len(stale),
            "mean_staleness": float(np.mean(stale)) if stale else 0.0,
            "max_staleness": int(max(stale)) if stale else 0,
            "stale_fraction": float(np.mean([s > 0 for s in stale]))
            if stale else 0.0,
            # Byte accounting: consumed teachers paid for, dropped/late
            # uplinks wasted.  Derived from the counters above so the fleet
            # twin's totals are bit-identical by construction.
            "uplink_bytes": self.payload_bytes * len(stale),
            "wasted_uplink_bytes": self.payload_bytes * (drops + late_drops),
        }
        return out
