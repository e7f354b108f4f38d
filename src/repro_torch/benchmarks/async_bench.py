"""Asynchronous-FL benchmark of the PyTorch port — bkd vs kd vs fedavg
under emergent delay (the JAX package's ``benchmarks/async_bench.py``).

The simulator-scale version of the paper's Figs. 9 & 11: instead of
scripting staleness, each ``async_*`` scenario runs the event-driven
virtual-clock simulator (``core/simulator.py``) over a heterogeneous
device population (uniform speed spread; heavy-tail lognormal speeds with
deadline aggregation; lossy edges with distill-on-arrival), and every
method consumes the *same* emergent arrival timeline.  The ``hier_*``
family adds the two-level regime (``core/fleet.py``): each region buffers
its own window of edges and regions distill into the core asynchronously,
so the report says whether the buffered-vs-plain gap (``bkd_minus_kd``)
survives when aggregation composes across levels.  The fleet-scale
section times the vectorized ``FleetSimulator`` on a 100k-edge timeline
(held to ``FLEET_SCALE_BUDGET_S``) against the heap loop at an overlapping
scale.  Everything lands in one JSON document; the exit code is 0 only if
every accuracy is finite, some teacher was stale, every scenario produced
its rounds, the 100k timeline kept its budget and the ``hier_*`` scenarios
reported ``bkd_minus_kd``.

    PYTHONPATH=src python -m repro_torch.benchmarks.async_bench \\
        [--smoke] [--out f.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import run_method
from repro_torch.core.scheduler import (ASYNC_SCENARIOS, HIER_SCENARIOS,
                                        build_scenario)

METHODS = ("bkd", "kd", "fedavg")

#: Wall-clock ceiling for the 100k-edge fleet timeline ("simulates in
#: seconds").
FLEET_SCALE_BUDGET_S = 60.0


def bench_fleet_scale(smoke, seed=0):
    """Time the vectorized simulator at fleet scale (100k edges) and
    against the heap loop at an overlapping scale.  ``within_budget`` says
    whether the 100k timelines stayed within FLEET_SCALE_BUDGET_S."""
    from repro_torch.core.fleet import (FleetSimulator,
                                        HierarchicalFleetSimulator)
    from repro_torch.core.simulator import BufferedWindow, EventDrivenSimulator

    edges, rounds = 100_000, 100 if smoke else 300
    t0 = time.time()
    flat = FleetSimulator(edges, "heavy_tail", BufferedWindow(64), seed=seed)
    flat.plans(rounds)
    flat_s = time.time() - t0

    t0 = time.time()
    hier = HierarchicalFleetSimulator(
        edges, 100, "uniform", region_trigger=BufferedWindow(8),
        core_trigger=BufferedWindow(8), seed=seed)
    hier.plans(20 if smoke else 50)
    hier_s = time.time() - t0

    # Heap against fleet at an overlapping scale: same arguments, same
    # plans; here only the wall-clock ratio.
    small, small_rounds = 2_000, 50
    t0 = time.time()
    EventDrivenSimulator(small, "heavy_tail", BufferedWindow(16),
                         seed=seed).plans(small_rounds)
    heap_s = time.time() - t0
    t0 = time.time()
    FleetSimulator(small, "heavy_tail", BufferedWindow(16),
                   seed=seed).plans(small_rounds)
    fleet_small_s = time.time() - t0

    ok = flat_s < FLEET_SCALE_BUDGET_S and hier_s < FLEET_SCALE_BUDGET_S
    print(f"# fleet-scale: {edges} edges x {rounds} rounds in {flat_s:.2f}s "
          f"(budget {FLEET_SCALE_BUDGET_S:.0f}s -> "
          f"{'ok' if ok else 'OVER BUDGET'}); hierarchical "
          f"{hier.stats['regions']} regions in {hier_s:.2f}s; "
          f"{small}-edge heap {heap_s:.2f}s vs fleet {fleet_small_s:.2f}s "
          f"({heap_s / max(fleet_small_s, 1e-9):.0f}x)", flush=True)
    return {
        "edges": edges, "rounds": rounds, "seconds": round(flat_s, 3),
        "budget_seconds": FLEET_SCALE_BUDGET_S, "within_budget": ok,
        "timeline": {k: flat.stats[k] for k in
                     ("dispatches", "teachers", "mean_staleness",
                      "max_staleness", "makespan")},
        "hierarchical": {"regions": hier.stats["regions"],
                         "core_rounds": hier.stats["rounds"],
                         "region_rounds": hier.stats["region_rounds"],
                         "seconds": round(hier_s, 3)},
        "heap_vs_fleet": {"edges": small, "rounds": small_rounds,
                          "heap_seconds": round(heap_s, 3),
                          "fleet_seconds": round(fleet_small_s, 3),
                          "speedup": round(heap_s / max(fleet_small_s, 1e-9),
                                           1)},
    }


def bench_scenario(name, *, methods, rounds, num_edges, aggregation_r, seed,
                   epochs, device="cuda"):
    # The timeline does not depend on the method (device heterogeneity, not
    # weights, drives it): simulate it once for the stats all share.
    sim = build_scenario(name, num_edges, aggregation_r=aggregation_r,
                         seed=seed)
    plans = sim.plans(rounds)
    timeline = dict(sim.stats)
    # Two-level (hier_*) streams interleave region rounds between the core
    # rounds; the per-round teacher counts describe the top-level rounds.
    timeline["teachers_per_round"] = [
        len(p.tasks) for p in plans if getattr(p, "level", "") != "region"]

    per_method = {}
    for method in methods:
        hist, dt = run_method(method, rounds=rounds, num_edges=num_edges,
                              aggregation_r=aggregation_r, seed=seed,
                              epochs=epochs, scenario=name, device=device)
        accs = [h["test_acc"] for h in hist]
        forget = [h["forget_score"] for h in hist if "forget_score" in h]
        per_method[method] = {
            "final_acc": round(accs[-1], 4),
            "mean_acc": round(float(np.mean(accs)), 4),
            "mean_forget": (round(float(np.mean(forget)), 4)
                            if forget else None),
            "seconds": round(dt, 2),
        }
        print(f"# {name}/{method}: final={accs[-1]:.3f} "
              f"mean={np.mean(accs):.3f}", flush=True)
    out = {"timeline": timeline, "methods": per_method}
    if "bkd" in per_method and "kd" in per_method:
        # The paper's question, per scenario: does buffering beat plain KD
        # under this timeline?  (hier_*: across two levels.)
        out["bkd_minus_kd"] = round(per_method["bkd"]["mean_acc"]
                                    - per_method["kd"]["mean_acc"], 4)
    return out


def passes(report):
    """The exit rule of the JAX package's bench over a report."""
    scenarios, methods = report["scenarios"], report["config"]["methods"]
    rounds = report["config"]["rounds"]
    ok = all(np.isfinite(m["final_acc"])
             for s in scenarios.values() for m in s["methods"].values())
    # The scenarios must exercise the async machinery: some emergent
    # staleness somewhere, and every scenario produced its rounds.
    ok &= any(s["timeline"]["max_staleness"] > 0 for s in scenarios.values())
    ok &= all(s["timeline"]["rounds"] == rounds for s in scenarios.values())
    # The 100k-edge timeline simulates in seconds, and the hierarchical
    # family reported the bkd-vs-kd gap.
    ok &= report["fleet_scale"]["within_budget"]
    ok &= all("bkd_minus_kd" in scenarios[n] for n in HIER_SCENARIOS
              if {"bkd", "kd"} <= set(methods))
    return bool(ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes — a wiring check, not a benchmark")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--edges", type=int, default=None)
    ap.add_argument("--aggregation-r", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods", nargs="+", default=list(METHODS))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rounds = args.rounds or (2 if args.smoke else 6)
    edges = args.edges or (4 if args.smoke else 6)
    epochs = (4, 4, 2) if args.smoke else (10, 10, 5)

    scenarios = {}
    for name in ASYNC_SCENARIOS + HIER_SCENARIOS:
        scenarios[name] = bench_scenario(
            name, methods=args.methods, rounds=rounds, num_edges=edges,
            aggregation_r=args.aggregation_r, seed=args.seed, epochs=epochs,
            device=args.device)

    fleet_scale = bench_fleet_scale(args.smoke, seed=args.seed)

    report = {
        "config": {"smoke": args.smoke, "rounds": rounds, "edges": edges,
                   "aggregation_r": args.aggregation_r, "seed": args.seed,
                   "methods": list(args.methods), "device": args.device},
        "scenarios": scenarios,
        "fleet_scale": fleet_scale,
    }
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if passes(report) else 1


if __name__ == "__main__":
    raise SystemExit(main())
