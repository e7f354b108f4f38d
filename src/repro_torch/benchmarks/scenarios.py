"""Run any named round-scheduling scenario end to end on the PyTorch port
(the JAX package's ``benchmarks/scenarios.py``, CPU scale).

Scenarios are the ``RoundScheduler`` policies of
``repro_torch.core.scheduler`` (straggler schedules of Figs. 9/11, random
client sampling, partial participation, per-edge random delays), the
event-driven ``async_*`` scenarios (``core/simulator.py``), where staleness
emerges from device heterogeneity on a virtual clock, and the ``fleet_*``
and two-level ``hier_*`` ones (``core/fleet.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios \\
        --scenario random_delay --method bkd --rounds 3 [--device cpu]
    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios \\
        --scenario all --rounds 2 [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import csv_row, run_method
from repro_torch.core.methods import method_names
from repro_torch.core.scheduler import SCENARIOS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    choices=sorted(SCENARIOS) + ["all"])
    ap.add_argument("--method", default="bkd", choices=list(method_names()))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--aggregation-r", type=int, default=1)
    ap.add_argument("--epochs", type=int, nargs=3, default=(6, 6, 3),
                    metavar=("CORE", "EDGE", "KD"))
    ap.add_argument("--transport", default="none",
                    help="uplink codec spec (repro_torch.transport registry) "
                         "or 'none'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    if args.transport != "none":
        from repro_torch.transport import parse_codec
        try:
            parse_codec(args.transport)
        except ValueError as e:
            ap.error(str(e))

    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    results = {}
    for name in names:
        hist, dt = run_method(args.method, rounds=args.rounds,
                              num_edges=args.edges,
                              aggregation_r=args.aggregation_r,
                              seed=args.seed, epochs=tuple(args.epochs),
                              scenario=name, transport=args.transport,
                              device=args.device)
        results[name] = hist
        stale = sum(1 for h in hist if h["straggler"])
        print(csv_row(f"scenario_{name}_{args.method}", hist, dt,
                      extra=f";stale_rounds={stale}"))
    return results


if __name__ == "__main__":
    main()
