"""Transport benchmark of the port — accuracy against uplink bytes per codec.

The paper's uplink is the edge→core link each round's teacher must cross;
``repro_torch.transport`` makes that link a pluggable codec (identity,
top-k, int8, int4 affine quantization, entropy filtering).  This benchmark
runs the same FL problem under every codec across three round regimes (the
synchronous paper default ``none``, the emergent-staleness timeline
``async_uniform`` and the two-level fleet ``hier_uniform``) and reports one
frontier per regime: final/mean accuracy against exact uplink bytes from
the Phase-2 engine's accounting (``DistillEngine.uplink_log``).  The same
problem, codecs and gates as the JAX package's
``benchmarks/transport_bench.py``:

- ``identity`` must reproduce the no-transport baseline bit-for-bit (the
  codec passes its input through, so the accuracies must be *equal*, not
  close);
- every lossy codec compresses: ``int4 < int8 < identity`` in bytes, and
  the filtered ``entropy:0.5+int8`` costs at most int8 plus a quarter of
  identity;
- the heap and fleet simulators report bit-identical uplink-byte stats for
  one timeline (``heap_fleet_bit_identical``), and the hierarchical fleet's
  edge-logit and core-snapshot bytes add up, in all and region by region
  (``split_consistent``): ``bench_sim_accounting``.

    PYTHONPATH=src python -m repro_torch.benchmarks.transport_bench \\
        [--device cpu] [--smoke] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import build_setup
from repro_torch.core.fl import FederatedKD, FLConfig
from repro_torch.core.scheduler import build_scenario
from repro_torch.transport import parse_codec

#: The frontier: the exact baseline plus every lossy family, including one
#: filter composition.  "none" is the control the identity gate compares to.
CODEC_SPECS = ("identity", "topk:16", "int8", "int4", "entropy:0.5+int8")

#: One synchronous regime, one emergent-staleness timeline, one two-level
#: fleet: the frontier must survive all three plan streams.
SCENARIO_NAMES = ("none", "async_uniform", "hier_uniform")

METHOD = "bkd"


def run_one(scenario, transport, *, rounds, num_edges, epochs, seed,
            device="cuda"):
    """One end-to-end FL run through FederatedKD (the bench needs the
    engine's uplink_log, which ``run_method`` does not return)."""
    adapter, core, edges, test = build_setup(num_edges=num_edges, seed=seed)
    cfg = FLConfig(num_edges=num_edges, rounds=rounds, method=METHOD,
                   core_epochs=epochs[0], edge_epochs=epochs[1],
                   kd_epochs=epochs[2], batch_size=128, seed=seed,
                   transport=transport)
    scheduler = (None if scenario == "none" else
                 build_scenario(scenario, num_edges, seed=seed))
    fl = FederatedKD(adapter, cfg, core, edges, test, scheduler=scheduler,
                     device=device)
    t0 = time.time()
    _, hist = fl.run(seed, log=None)
    dt = time.time() - t0
    eng = fl.distill_engine
    accs = [h["test_acc"] for h in hist]
    return {
        "final_acc": accs[-1],
        "mean_acc": float(np.mean(accs)),
        "uplink_bytes": eng.uplink_bytes_total,
        "dispatches": len(eng.uplink_log),
        "teachers": sum(r["teachers"] for r in eng.uplink_log),
        "seconds": round(dt, 2),
    }


def bench_frontier(scenario, *, rounds, num_edges, epochs, seed,
                   device="cuda"):
    """The no-transport control plus every codec, as one frontier."""
    kw = dict(rounds=rounds, num_edges=num_edges, epochs=epochs, seed=seed,
              device=device)
    base = run_one(scenario, "none", **kw)
    print(f"# {scenario}/none: final={base['final_acc']:.3f}", flush=True)
    points, ident_bytes = [], None
    for spec in CODEC_SPECS:
        r = run_one(scenario, spec, **kw)
        if spec == "identity":
            ident_bytes = r["uplink_bytes"]
        points.append({"codec": spec, **{k: (round(v, 4)
                       if isinstance(v, float) else v) for k, v in r.items()}})
        print(f"# {scenario}/{spec}: final={r['final_acc']:.3f} "
              f"bytes={r['uplink_bytes']}", flush=True)
    for p in points:
        p["compression_vs_identity"] = (
            round(ident_bytes / p["uplink_bytes"], 2)
            if p["uplink_bytes"] else None)
    identity = next(p for p in points if p["codec"] == "identity")
    return {
        "baseline": {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in base.items()},
        "frontier": points,
        # The acceptance gate: identity transport passes its input through,
        # so its accuracies must EQUAL the no-transport run's.
        "identity_bit_for_bit": (
            identity["final_acc"] == round(base["final_acc"], 4)
            and identity["mean_acc"] == round(base["mean_acc"], 4)),
    }


def mlp_payload_bytes():
    """Wire bytes of one region→core snapshot: one float32 a weight of the
    MLP the frontiers train (32-64-64-10, ``build_setup``'s adapter)."""
    from repro_torch.nn import resnet as R
    params = R.mlp_init(torch.Generator().manual_seed(0), 32, 64, 10, 2)
    return float(sum(4 * p.numel() for p in params.values()))


def bench_sim_accounting(seed=0):
    """Uplink-byte accounting at the simulator level: the heap and fleet
    simulators must report bit-identical byte stats for the same timeline,
    and the hierarchical fleet splits edge-logit vs core-snapshot bytes per
    region."""
    from repro_torch.core.fleet import (FleetSimulator,
                                        HierarchicalFleetSimulator)
    from repro_torch.core.simulator import BufferedWindow, EventDrivenSimulator

    payload = float(parse_codec("int8").payload_bytes(2048, 10))
    args = dict(trigger=BufferedWindow(8), seed=seed, payload_bytes=payload)
    heap = EventDrivenSimulator(512, profiles="heavy_tail", **args)
    heap.plans(30)
    fleet = FleetSimulator(512, profiles="heavy_tail", **args)
    fleet.plans(30)
    keys = ("uplink_bytes", "wasted_uplink_bytes")
    parity = all(heap.stats[k] == fleet.stats[k] for k in keys)

    # Region→core snapshots are parameters, not logits.
    core_payload = mlp_payload_bytes()
    hier = HierarchicalFleetSimulator(
        512, 16, "uniform", region_trigger=BufferedWindow(8),
        core_trigger=BufferedWindow(4), seed=seed,
        payload_bytes=payload, core_payload_bytes=core_payload)
    hier.plans(10)
    hs = hier.stats
    split_ok = (hs["uplink_bytes"]
                == hs["edge_uplink_bytes"] + hs["core_uplink_bytes"]
                and sum(hs["region_uplink_bytes"]) == hs["uplink_bytes"])
    print(f"# sim accounting: heap==fleet {parity}, hier split {split_ok} "
          f"({hs['uplink_bytes'] / 1e6:.1f} MB over "
          f"{hs['regions']} regions)", flush=True)
    return {
        "payload_bytes_per_teacher": payload,
        "heap_fleet_bit_identical": parity,
        "heap_stats": {k: heap.stats[k] for k in keys},
        "fleet_stats": {k: fleet.stats[k] for k in keys},
        "hierarchical": {
            "core_payload_bytes": core_payload,
            "edge_uplink_bytes": hs["edge_uplink_bytes"],
            "core_uplink_bytes": hs["core_uplink_bytes"],
            "uplink_bytes": hs["uplink_bytes"],
            "region_uplink_bytes": list(hs["region_uplink_bytes"]),
            "split_consistent": split_ok,
        },
    }


def gates(scenarios, sim_accounting=None):
    """The acceptance checks over a report's scenarios: finite accuracies,
    identity bit-for-bit, every lossy codec compressing, and (given
    ``bench_sim_accounting``'s result) its two gates."""
    ok = all(np.isfinite(p["final_acc"])
             for s in scenarios.values() for p in s["frontier"])
    ok &= all(s["identity_bit_for_bit"] for s in scenarios.values())
    for s in scenarios.values():
        by = {p["codec"]: p["uplink_bytes"] for p in s["frontier"]}
        ok &= by["int4"] < by["int8"] < by["identity"]
        ok &= by["entropy:0.5+int8"] <= by["int8"] + by["identity"] // 4
    if sim_accounting is not None:
        ok &= sim_accounting["heap_fleet_bit_identical"]
        ok &= sim_accounting["hierarchical"]["split_consistent"]
    return bool(ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes — a wiring check, not a benchmark")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--edges", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenarios", default=",".join(SCENARIO_NAMES),
                    help="comma-separated scenario names (default: the "
                         "synchronous, async and hierarchical regimes)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rounds = args.rounds or (2 if args.smoke else 5)
    edges = args.edges or (4 if args.smoke else 5)
    epochs = (3, 3, 2) if args.smoke else (8, 8, 4)

    scenarios = {}
    for name in args.scenarios.split(","):
        scenarios[name] = bench_frontier(name, rounds=rounds, num_edges=edges,
                                         epochs=epochs, seed=args.seed,
                                         device=args.device)
    sim_accounting = bench_sim_accounting(seed=args.seed)
    report = {
        "config": {"smoke": args.smoke, "rounds": rounds, "edges": edges,
                   "seed": args.seed, "method": METHOD,
                   "codecs": list(CODEC_SPECS), "device": args.device},
        "scenarios": scenarios,
        "sim_accounting": sim_accounting,
    }
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if gates(scenarios, sim_accounting) else 1


if __name__ == "__main__":
    raise SystemExit(main())
