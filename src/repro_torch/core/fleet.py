"""Fleet-scale vectorized FL timeline simulation + hierarchical aggregation.

A numpy-only copy of the JAX package's ``repro/core/fleet.py``; the plan
streams and statistics are the original's, byte for byte.  The original's
text follows.

The event-driven simulator (:mod:`repro_torch.core.simulator`) is a host-side
Python heap loop over per-edge objects — right for the paper's tens of
edges (Figs. 9 & 11), wrong for the 10^4–10^5-device fleets the KD-FL
surveys treat as the real regime.  This module re-implements the *same*
timeline semantics on flat arrays:

  * device populations are :class:`~repro_torch.core.simulator.ProfileArrays`
    (batched draws per named family — no per-edge Python objects);
  * per-dispatch randomness comes from the shared
    :class:`~repro_torch.core.simulator.DispatchDraws` vocabulary, keyed per
    ``(edge, dispatch ordinal)`` and gathered in batches;
  * dropout chains are resolved vectorized (all freed edges advance
    together until their next surviving arrival);
  * trigger windows are resolved by top-k selection over arrival times
    (``argpartition`` + a dispatch-sequence tie-break that reproduces the
    heap's pop order) and deadline windows by boolean masks over the tick
    grid — never by a Python heap.

:class:`FleetSimulator` emits the *identical* :class:`AsyncRoundPlan`
stream as :class:`~repro_torch.core.simulator.EventDrivenSimulator` for the same
constructor arguments — bit-equal times, versions, staleness, and stats —
proven across every trigger x profile-family combination by
``tests/test_fleet.py`` and over random configurations by
``tests/test_fleet_property.py``.  (The one unsupported corner:
``concurrency < num_edges`` combined with dropout, where a drop's
round-robin re-fill is inherently sequential — the constructor rejects it
and points at the heap simulator.)

:class:`HierarchicalFleetSimulator` adds the two-level question no flat
simulator can ask: edges are partitioned into regions, each region runs
its own buffered window over its edges (a regional
:class:`FleetSimulator`), and regions distill into the core
asynchronously — region-round completions become uplink arrivals consumed
by a core-level trigger.  Staleness is now emergent at *both* levels
(edge-vs-region and region-vs-core), turning the paper's edge-bias
question into "does buffering compose?".  The emitted stream interleaves
:class:`RegionRoundPlan` and :class:`CoreRoundPlan` records in virtual-time
order; ``FederatedKD.run`` consumes it directly (region models distilled
from edge teachers, the core distilled from uplinked region-model
snapshots, consumed regions synced back down).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.scheduler import EdgeTask
from repro_torch.core.simulator import (AggregationTrigger, AsyncRoundPlan,
                                  BufferedWindow, Deadline, DeviceProfile,
                                  DispatchDraws, DistillOnArrival,
                                  ProfileArrays, make_trigger, profile_arrays)

__all__ = ["FleetSimulator", "HierarchicalFleetSimulator",
           "RegionRoundPlan", "CoreRoundPlan"]


# ---------------------------------------------------------------------------
# Two-level plan records (flat plans reuse AsyncRoundPlan unchanged).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionRoundPlan(AsyncRoundPlan):
    """One region-level distillation round: the region's buffered window
    filled, and the region model distills its edge teachers.  ``tasks``
    carry *global* edge ids; staleness is region-relative (region rounds
    since the edge's dispatch).  ``round_idx`` is the plan's position in
    the merged two-level stream; ``region_round`` is the region-local
    round index (the region model's version afterwards is
    ``region_round + 1``)."""

    level: str = "region"
    region: int = 0
    region_round: int = 0


@dataclasses.dataclass(frozen=True)
class CoreRoundPlan(AsyncRoundPlan):
    """One core-level round: the core trigger consumed region-model
    uplinks.  ``tasks`` describe the consumed uplinks — ``edge_id`` is the
    *region* id and ``staleness`` counts core rounds since that region
    last synced down.  ``region_versions`` names the exact region-model
    snapshot each teacher is (``(region, region_model_version)``), and
    ``member_edges`` lists each consumed region's global edge ids (for
    shard-size teacher weighting and round metrics)."""

    level: str = "core"
    core_round: int = 0
    region_versions: tuple = ()
    member_edges: tuple = ()


# ---------------------------------------------------------------------------
# The flat vectorized simulator.
# ---------------------------------------------------------------------------


class FleetSimulator:
    """Vectorized twin of :class:`~repro_torch.core.simulator.EventDrivenSimulator`
    — same constructor vocabulary, same emitted plans, array state instead
    of a heap.  Use it wherever the heap loop is too slow (100k-edge
    timelines simulate in seconds); parity at overlapping scales is pinned
    by ``tests/test_fleet.py``."""

    def __init__(self, num_edges: int,
                 profiles: Union[str, ProfileArrays,
                                 Sequence[DeviceProfile]] = "uniform",
                 trigger: Union[str, AggregationTrigger] = "arrival", *,
                 concurrency: Optional[int] = None, work: float = 1.0,
                 jitter: float = 0.15, payload_bytes: float = 0.0,
                 seed: int = 0):
        if isinstance(profiles, str):
            self.profile_family = profiles
            profiles = profile_arrays(profiles, num_edges, seed)
        else:
            self.profile_family = "custom"
            if not isinstance(profiles, ProfileArrays):
                profiles = ProfileArrays.from_profiles(list(profiles))
        if len(profiles) != num_edges:
            raise ValueError(f"{len(profiles)} profiles for {num_edges} edges")
        self.num_edges = num_edges
        self.profiles = profiles
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
        if (self.concurrency < num_edges
                and bool(np.any(profiles.dropout > 0))):
            raise ValueError(
                "FleetSimulator requires concurrency == num_edges when any "
                "device can drop updates: a drop re-fills through the "
                "round-robin pointer, which is inherently sequential at "
                "partial concurrency — use EventDrivenSimulator there")
        if work <= 0:
            raise ValueError(f"work must be positive, got {work}")
        if payload_bytes < 0:
            raise ValueError(f"payload_bytes must be >= 0, "
                             f"got {payload_bytes}")
        self.work = work
        self.jitter = jitter
        #: Wire bytes per teacher uplink (same accounting as the heap
        #: simulator — plan/stats byte fields stay bit-identical twins).
        self.payload_bytes = float(payload_bytes)
        self.seed = seed
        #: Timeline statistics of the last :meth:`plans` call.
        self.stats: dict = {}

    # -- the vectorized timeline --------------------------------------------

    def plans(self, rounds: int) -> list:
        """Simulate ``rounds`` distillation rounds and return them as
        :class:`AsyncRoundPlan` records — the same records, in the same
        order, with the same times and staleness, as the heap simulator
        replaying the same arguments."""
        self.stats = {}          # a stalled run must not leak stale numbers
        E, C = self.num_edges, self.concurrency
        speed = self.profiles.speed
        latency = self.profiles.latency
        dropout = self.profiles.dropout
        draws = DispatchDraws(self.seed, E)

        busy = np.zeros(E, bool)
        arr_t = np.full(E, np.inf)           # next surviving arrival time
        disp_t = np.zeros(E)                 # last (re-)dispatch time
        disp_seq = np.zeros(E, np.int64)     # heap tie-break: dispatch order
        ver = np.zeros(E, np.int64)          # version at dispatch; -1 = bisect
        ordinal = np.zeros(E, np.int64)      # per-edge dispatch counter
        trig_times: list = []
        out: list = []
        disp_events: list = []               # dispatch times (stats)
        drop_events: list = []               # dropped-arrival times (stats)
        stale_all: list = []
        late_drops = 0
        state = {"version": 0, "ptr": 0, "seq": 0}

        def dispatch(edges, t):
            """Dispatch ``edges`` (round-robin order) at ``t`` and resolve
            each edge's dropout chain to its next surviving arrival — all
            edges advance together, one vectorized step per chain link."""
            pend = np.asarray(edges, np.int64)
            if not pend.size:
                return
            disp_seq[pend] = np.arange(state["seq"], state["seq"] + pend.size)
            state["seq"] += pend.size
            ver[pend] = state["version"]
            busy[pend] = True
            pt = np.broadcast_to(np.asarray(t, np.float64),
                                 pend.shape).astype(np.float64)
            links = 0
            while pend.size:
                links += 1
                if links > 100_000:
                    raise RuntimeError("dropout chain did not terminate")
                disp_t[pend] = pt
                disp_events.append(pt)
                z, u = draws.gather(pend, ordinal[pend])
                ordinal[pend] += 1
                dur = self.work / speed[pend]
                if self.jitter:
                    dur = dur * np.exp(self.jitter * z)
                dur = dur + latency[pend]
                at = pt + dur
                ok = u >= dropout[pend]
                arr_t[pend[ok]] = at[ok]
                if ok.all():
                    break
                # Dropped: the update is lost in transit; the edge re-
                # dispatches at the drop time.  The version it carries is
                # whatever the core is at *that* time — resolved at
                # consumption by bisecting the trigger-time history.
                drop_events.append(at[~ok])
                pend, pt = pend[~ok], at[~ok]
                ver[pend] = -1

        def fill(t):
            # Restore concurrency: idle edges dispatch in round-robin order
            # from the pointer (the heap's fill, batched).
            need = C - int(busy.sum())
            if need <= 0:
                return
            idle = np.flatnonzero(~busy)
            ptr = state["ptr"]
            if ptr:
                idle = np.concatenate([idle[idle >= ptr], idle[idle < ptr]])
            chosen = idle[:need]
            if chosen.size:
                state["ptr"] = int(chosen[-1]) + 1
                dispatch(chosen, t)

        def resolve_ver(sel):
            v = ver[sel].copy()
            unk = v < 0
            if unk.any():
                v[unk] = np.searchsorted(np.asarray(trig_times),
                                         disp_t[sel][unk], side="right")
            return v

        def consume(sel, t, trig):
            v = resolve_ver(sel)
            stale = state["version"] - v
            plan = AsyncRoundPlan(
                round_idx=state["version"],
                tasks=tuple(EdgeTask(edge_id=int(e), staleness=int(s))
                            for e, s in zip(sel, stale)),
                withdraw=False, time=float(t), trigger=trig,
                dispatch_versions=tuple(int(x) for x in v),
                arrival_times=tuple(float(x) for x in arr_t[sel]),
                uplink_bytes=tuple(self.payload_bytes for _ in sel))
            state["version"] += 1
            trig_times.append(float(t))
            stale_all.extend(int(s) for s in stale)
            busy[sel] = False
            arr_t[sel] = np.inf
            out.append(plan)

        def pick(r):
            """The next ``r`` arrivals in heap pop order: smallest by
            ``(arrival time, dispatch sequence)``, via argpartition plus a
            tie-break sort only over the boundary."""
            cand = np.flatnonzero(busy)
            if cand.size < r:
                return None
            at = arr_t[cand]
            if cand.size > r:
                kth = at[np.argpartition(at, r - 1)[r - 1]]
                strict = cand[at < kth]
                ties = cand[at == kth]
                need = r - strict.size
                if need < ties.size:
                    ties = ties[np.argsort(disp_seq[ties])[:need]]
                sel = np.concatenate([strict, ties])
            else:
                sel = cand
            return sel[np.lexsort((disp_seq[sel], arr_t[sel]))]

        budget = max(10_000, 1_000 * rounds)
        iters = 0

        def check_budget():
            nonlocal iters
            iters += 1
            if iters > budget:
                raise RuntimeError(
                    f"fleet simulator stalled after {iters - 1} steps with "
                    f"{len(out)}/{rounds} rounds (trigger={self.trigger!r}, "
                    f"concurrency={self.concurrency})")

        fill(0.0)
        if isinstance(self.trigger, Deadline):
            interval, max_late = self.trigger.interval, self.trigger.max_late
            T_prev = 0.0
            while len(out) < rounds:
                check_budget()
                T = T_prev + interval
                # An arrival at exactly T only made this window if its
                # dispatch preceded the previous tick (the heap's push-order
                # boundary rule).
                window = busy & ((arr_t < T) | ((arr_t == T) & (disp_t < T_prev)))
                sel = np.flatnonzero(window)
                if sel.size:
                    sel = sel[np.lexsort((disp_seq[sel], arr_t[sel]))]
                    if max_late is not None:
                        late = (state["version"] - resolve_ver(sel)) > max_late
                        lsel = sel[late]
                        late_drops += int(lsel.size)
                        busy[lsel] = False     # discarded; re-dispatches below
                        arr_t[lsel] = np.inf
                        sel = sel[~late]
                    if sel.size:
                        consume(sel, T, "deadline")
                T_prev = T
                fill(T)
        else:
            if isinstance(self.trigger, DistillOnArrival):
                r, label = 1, "arrival"
            else:
                r, label = self.trigger.r, "window"
            while len(out) < rounds:
                check_budget()
                sel = pick(r)
                if sel is None:
                    raise RuntimeError(
                        f"fleet simulator stalled with {len(out)}/{rounds} "
                        f"rounds: only {int(busy.sum())} teachers in flight "
                        f"for a window of {r}")
                T = float(arr_t[sel[-1]])
                consume(sel, T, label)
                fill(T)

        T_last = out[-1].time if out else 0.0
        disp_all = (np.concatenate(disp_events) if disp_events
                    else np.zeros(0))
        drop_all = (np.concatenate(drop_events) if drop_events
                    else np.zeros(0))
        self.stats = {
            "rounds": len(out),
            "makespan": T_last,
            "dispatches": int((disp_all <= T_last).sum()),
            "drops": int((drop_all <= T_last).sum()),
            "late_drops": late_drops,
            "in_flight": int(busy.sum()),
            "teachers": len(stale_all),
            "mean_staleness": float(np.mean(stale_all)) if stale_all else 0.0,
            "max_staleness": int(max(stale_all)) if stale_all else 0,
            "stale_fraction": float(np.mean([s > 0 for s in stale_all]))
            if stale_all else 0.0,
            # Byte accounting, derived from the same counters as the heap
            # simulator's — bit-identical totals by construction.
            "uplink_bytes": self.payload_bytes * len(stale_all),
            "wasted_uplink_bytes": self.payload_bytes
            * (int((drop_all <= T_last).sum()) + late_drops),
        }
        return out


# ---------------------------------------------------------------------------
# Hierarchical aggregation: edge -> region window -> core trigger.
# ---------------------------------------------------------------------------


class HierarchicalFleetSimulator:
    """Two-level timeline: edges are split into contiguous balanced
    regions, each region runs its own :class:`FleetSimulator` (its buffered
    window over its edges), and every region-round completion becomes an
    *uplink* arrival at the core after a per-region uplink latency.  The
    core trigger (window / arrival / deadline) consumes uplinks into core
    rounds; consumed regions sync the new core model back down instantly.

    Staleness is emergent at both levels: a region plan's tasks carry
    edge-vs-region staleness (from the regional timeline), and a core
    plan's tasks carry region-vs-core staleness — core rounds since the
    uplinking region last synced down.  ``plans(rounds)`` returns the
    merged stream of :class:`RegionRoundPlan` and :class:`CoreRoundPlan`
    records in virtual-time order, sized so exactly ``rounds`` core rounds
    are present."""

    def __init__(self, num_edges: int, num_regions: int,
                 profiles: Union[str, ProfileArrays] = "uniform",
                 region_trigger: Union[str, AggregationTrigger] = "window:2",
                 core_trigger: Union[str, AggregationTrigger] = "window:2", *,
                 uplink_latency: float = 0.25, work: float = 1.0,
                 jitter: float = 0.15, payload_bytes: float = 0.0,
                 core_payload_bytes: float = 0.0, seed: int = 0):
        if not 1 <= num_regions <= num_edges:
            raise ValueError(f"need 1 <= num_regions <= num_edges, got "
                             f"{num_regions} regions for {num_edges} edges")
        if uplink_latency < 0:
            raise ValueError(f"uplink_latency must be >= 0, "
                             f"got {uplink_latency}")
        if isinstance(profiles, str):
            self.profile_family = profiles
            profiles = profile_arrays(profiles, num_edges, seed)
        else:
            self.profile_family = "custom"
            if not isinstance(profiles, ProfileArrays):
                profiles = ProfileArrays.from_profiles(list(profiles))
        if len(profiles) != num_edges:
            raise ValueError(f"{len(profiles)} profiles for {num_edges} edges")
        self.num_edges, self.num_regions = num_edges, num_regions
        self.profiles = profiles
        self.region_trigger = make_trigger(region_trigger)
        self.core_trigger = make_trigger(core_trigger)
        if isinstance(self.core_trigger, BufferedWindow):
            pass  # any window size is fillable: every region uplinks forever
        # Balanced contiguous split: region g owns edges [starts[g], starts[g+1]).
        sizes = np.full(num_regions, num_edges // num_regions)
        sizes[: num_edges % num_regions] += 1
        self.starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        rng = np.random.default_rng((seed, 0x0EF1))
        #: Per-region uplink latency (region aggregator -> core).
        self.uplink = uplink_latency * rng.uniform(0.5, 1.5, num_regions)
        if payload_bytes < 0 or core_payload_bytes < 0:
            raise ValueError("payload_bytes/core_payload_bytes must be >= 0")
        #: Wire bytes per edge->region teacher uplink (codec-compressed
        #: logits) and per region->core uplink (a region-model snapshot).
        self.payload_bytes = float(payload_bytes)
        self.core_payload_bytes = float(core_payload_bytes)
        self.seed = seed
        self.sims = [
            FleetSimulator(
                int(sizes[g]), profiles=profiles.slice(
                    int(self.starts[g]), int(self.starts[g + 1])),
                trigger=self.region_trigger, work=work, jitter=jitter,
                payload_bytes=payload_bytes,
                seed=int(np.random.SeedSequence(
                    (seed, 0xF1EE7, g)).generate_state(1)[0]))
            for g in range(num_regions)]
        self.stats: dict = {}

    def region_edges(self, g: int) -> tuple:
        """The global edge ids owned by region ``g``."""
        return tuple(range(int(self.starts[g]), int(self.starts[g + 1])))

    # -- uplink merge + core trigger resolution ------------------------------

    def _uplinks(self, per_region_rounds: int):
        """Simulate every region for ``per_region_rounds`` rounds and merge
        their uplink arrivals into one time-sorted stream.  Returns the
        per-region plan lists plus flat arrays (arrival time, region,
        region-model version, send time) and the *horizon*: the merged
        stream is only complete up to the earliest per-region last
        arrival."""
        reg_plans = [sim.plans(per_region_rounds) for sim in self.sims]
        times, regs, vers, sends = [], [], [], []
        for g, plans_g in enumerate(reg_plans):
            for p in plans_g:
                sends.append(p.time)
                times.append(p.time + float(self.uplink[g]))
                regs.append(g)
                vers.append(p.round_idx + 1)
        times = np.asarray(times)
        regs = np.asarray(regs, np.int64)
        vers = np.asarray(vers, np.int64)
        sends = np.asarray(sends)
        order = np.lexsort((regs, times))
        horizon = min(times[regs == g].max() for g in range(self.num_regions))
        return (reg_plans, times[order], regs[order], vers[order],
                sends[order], float(horizon))

    def _core_rounds(self, rounds, times, regs, vers, sends, horizon):
        """Resolve the core trigger over the merged uplink stream.  Returns
        ``None`` when the stream is too short (the caller grows the
        per-region simulation), else a list of core-round records."""
        trig = self.core_trigger
        sync: list = [[(-np.inf, 0)] for _ in range(self.num_regions)]
        late_drops = 0
        core: list = []

        def entry(i, c):
            g = int(regs[i])
            hist = sync[g]
            # The core-version context inside this uplink: the last core
            # model region g had received when it sent the update.
            v = 0
            for t_sync, vv in reversed(hist):
                if t_sync <= sends[i]:
                    v = vv
                    break
            return {"region": g, "version": int(vers[i]),
                    "synced": v, "staleness": c - v,
                    "arrival": float(times[i]), "send": float(sends[i])}

        def commit(T, entries):
            c = len(core)
            core.append({"time": float(T), "entries": entries})
            for e in entries:
                sync[e["region"]].append((float(T), c + 1))

        if isinstance(trig, Deadline):
            T, i = 0.0, 0
            ticks = 0
            while len(core) < rounds:
                ticks += 1
                if ticks > max(10_000, 1_000 * rounds):
                    raise RuntimeError(
                        f"hierarchical core deadline stalled with "
                        f"{len(core)}/{rounds} rounds (trigger={trig!r})")
                T = T + trig.interval
                if T > horizon:
                    return None
                entries = []
                while i < len(times) and times[i] <= T:
                    e = entry(i, len(core))
                    if trig.max_late is not None and \
                            e["staleness"] > trig.max_late:
                        late_drops += 1
                    else:
                        entries.append(e)
                    i += 1
                if entries:
                    commit(T, entries)
        else:
            w = 1 if isinstance(trig, DistillOnArrival) else trig.r
            if len(times) < rounds * w or times[rounds * w - 1] > horizon:
                return None
            for c in range(rounds):
                idxs = range(c * w, (c + 1) * w)
                entries = [entry(i, c) for i in idxs]
                commit(times[(c + 1) * w - 1], entries)
        self._core_late_drops = late_drops
        return core

    # -- the merged two-level plan stream ------------------------------------

    def plans(self, rounds: int) -> list:
        """Simulate until ``rounds`` core rounds were triggered and return
        the merged region/core plan stream in virtual-time order."""
        self.stats = {}
        self._core_late_drops = 0
        trig = self.core_trigger
        w = (1 if isinstance(trig, DistillOnArrival)
             else trig.r if isinstance(trig, BufferedWindow)
             else self.num_regions)
        base = max(2, -(-rounds * w // self.num_regions) + w + 1)
        core = None
        for attempt in range(10):
            reg_plans, times, regs, vers, sends, horizon = \
                self._uplinks(base * (2 ** attempt))
            core = self._core_rounds(rounds, times, regs, vers, sends,
                                     horizon)
            if core is not None:
                break
        if core is None:
            raise RuntimeError(
                f"hierarchical simulator could not produce {rounds} core "
                f"rounds from {self.num_regions} regions "
                f"(core trigger={trig!r})")

        label = ("deadline" if isinstance(trig, Deadline)
                 else "arrival" if isinstance(trig, DistillOnArrival)
                 else "window")
        T_last = core[-1]["time"]
        merged: list = []
        for g, plans_g in enumerate(reg_plans):
            lo = int(self.starts[g])
            for p in plans_g:
                if p.time > T_last:
                    break
                merged.append(("region", p.time, g, p))
        for c, rec in enumerate(core):
            merged.append(("core", rec["time"], -1, (c, rec)))
        # Region plans precede core plans at equal times: an uplink consumed
        # at T was necessarily sent strictly earlier (latency > 0), and at
        # latency 0 the producing region round must still come first.
        merged.sort(key=lambda m: (m[1], m[0] != "region", m[2]))

        out: list = []
        core_stale: list = []
        edge_stale: list = []
        region_rounds = 0
        # Per-region uplink byte totals over the emitted (T_last-trimmed)
        # stream: edge->region teachers plus the region's own core uplinks.
        edge_cnt = np.zeros(self.num_regions, np.int64)
        core_cnt = np.zeros(self.num_regions, np.int64)
        for idx, (kind, t, g, payload) in enumerate(merged):
            if kind == "region":
                p = payload
                lo = int(self.starts[g])
                out.append(RegionRoundPlan(
                    round_idx=idx,
                    tasks=tuple(EdgeTask(edge_id=tk.edge_id + lo,
                                         staleness=tk.staleness)
                                for tk in p.tasks),
                    withdraw=False, time=p.time, trigger=p.trigger,
                    dispatch_versions=p.dispatch_versions,
                    arrival_times=p.arrival_times,
                    uplink_bytes=p.uplink_bytes,
                    region=g, region_round=p.round_idx))
                edge_stale.extend(tk.staleness for tk in p.tasks)
                edge_cnt[g] += len(p.tasks)
                region_rounds += 1
                continue
            c, rec = payload
            entries = rec["entries"]
            out.append(CoreRoundPlan(
                round_idx=idx,
                tasks=tuple(EdgeTask(edge_id=e["region"],
                                     staleness=int(e["staleness"]))
                            for e in entries),
                withdraw=False, time=rec["time"], trigger=label,
                dispatch_versions=tuple(e["synced"] for e in entries),
                arrival_times=tuple(e["arrival"] for e in entries),
                uplink_bytes=tuple(self.core_payload_bytes
                                   for _ in entries),
                core_round=c,
                region_versions=tuple((e["region"], e["version"])
                                      for e in entries),
                member_edges=tuple(self.region_edges(e["region"])
                                   for e in entries)))
            core_stale.extend(int(e["staleness"]) for e in entries)
            for e in entries:
                core_cnt[e["region"]] += 1

        self.stats = {
            "rounds": len(core),
            "makespan": T_last,
            "regions": self.num_regions,
            "region_rounds": region_rounds,
            "teachers": len(core_stale),
            "mean_staleness": float(np.mean(core_stale)) if core_stale
            else 0.0,
            "max_staleness": int(max(core_stale)) if core_stale else 0,
            "stale_fraction": float(np.mean([s > 0 for s in core_stale]))
            if core_stale else 0.0,
            "core_late_drops": self._core_late_drops,
            "edge_teachers": len(edge_stale),
            "edge_mean_staleness": float(np.mean(edge_stale)) if edge_stale
            else 0.0,
            "edge_max_staleness": int(max(edge_stale)) if edge_stale else 0,
            "dispatches": int(sum(s.stats["dispatches"] for s in self.sims)),
            "drops": int(sum(s.stats["drops"] for s in self.sims)),
            "late_drops": int(sum(s.stats["late_drops"] for s in self.sims)),
            "in_flight": int(sum(s.stats["in_flight"] for s in self.sims)),
            # Byte accounting over the emitted (T_last-trimmed) stream, at
            # both levels plus a per-region split.
            "edge_uplink_bytes": self.payload_bytes * len(edge_stale),
            "core_uplink_bytes": self.core_payload_bytes * len(core_stale),
            "uplink_bytes": self.payload_bytes * len(edge_stale)
            + self.core_payload_bytes * len(core_stale),
            "region_uplink_bytes": tuple(
                self.payload_bytes * int(edge_cnt[g])
                + self.core_payload_bytes * int(core_cnt[g])
                for g in range(self.num_regions)),
        }
        return out
