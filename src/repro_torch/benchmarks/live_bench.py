"""Live co-scheduled system on the PyTorch port: serving cost + per-swap
quality drift (the JAX package's ``benchmarks/live_bench.py``).

One device serves a request stream (``ServeEngine.tick``) while Phase-2
distillation rounds update the core (``LiveTrainer.step``), with the round
stream gated onto the serving clock (``ticks_per_time`` over the async
simulator's event times) and each completed round hot-swapped between
ticks.  Measured, per arrival process (``diurnal`` and ``heavy_tail``):

  * **serve-only tok/s**: the same stream on a frozen pretrained core,
    cold and warm, the no-training baseline;
  * **co-scheduled tok/s** per method (``bkd`` vs ``kd``): the throughput
    cost of interleaving distill microbatches with decode ticks (on the
    card every Phase-2 step runs the KD kernel pair and every decode tick
    ``swa_decode``);
  * **per-swap drift**: at every committed hot-swap, core-domain eval NLL
    (``repro_torch.live.lm.nll_on``), the distilled teacher-shard accuracy
    and held-out test accuracy.

Emits one JSON document (stdout, plus --out FILE) with the reference's
keys (``config.backend`` names the device) and its exit rule: every
co-run must complete its rounds, commit real swaps and keep its drift
metrics finite; throughput is recorded, not gated.  The reference runs
under a one-device test mesh; the port runs on one device without one (a
one-rank mesh places nothing; the meshed serving path is
``simulate(mesh=...)``, and the launch drivers under a mesh are ROADMAP
queue 1's last slice).

    PYTHONPATH=src python -m repro_torch.benchmarks.live_bench \\
        [--smoke] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.benchmarks.phase2_bench import _sync, device_name
from repro_torch.configs import registry
from repro_torch.core.fl import FederatedKD, FLConfig
from repro_torch.core.simulator import EventDrivenSimulator
from repro_torch.launch.serve import summarize
from repro_torch.live import (LiveSystem, LiveTrainer, lm_adapter, lm_fl_data,
                              nll_on)
from repro_torch.serve import ServeEngine, build_stream

STREAMS = ("diurnal", "heavy_tail")
METHODS = ("bkd", "kd")


def build_trainer(cfg, flcfg, data, method, device, log=None):
    """A LiveTrainer over the async simulator's uniform plan stream
    (Phase 0 runs here)."""
    core, edges, test, _ = data
    fl = FederatedKD(lm_adapter(cfg),
                     dataclasses.replace(flcfg, method=method),
                     core, edges, test,
                     scheduler=EventDrivenSimulator(
                         flcfg.num_edges, "uniform", seed=flcfg.seed),
                     device=device)
    return LiveTrainer(fl, flcfg.seed, log=log)


def _timed(device, fn, *args, **kw):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def serve_run(engine, reqs):
    finished, wall = _timed(engine.device, engine.run, reqs, log=None)
    return summarize(finished, wall)


def co_run(cfg, system, reqs, silos):
    """One co-scheduled session; per-swap drift metrics ride the records."""

    def on_swap(sys_, rec):
        state = sys_.trainer.state
        last = sys_.trainer.last_record
        rec["eval_nll_core"] = round(nll_on(cfg, state, silos["core"]), 4)
        rec["teacher_shard_acc"] = round(last.acc_cur_edge, 4)
        rec["test_acc"] = round(last.test_acc, 4)

    system.on_swap = on_swap
    finished, wall = _timed(system.engine.device, system.run, reqs, log=None)
    return summarize(finished, wall), system.swap_records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes — a wiring check, not a benchmark")
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--quantum", type=int, default=2,
                    help="distill microbatches per co-scheduler turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    rounds = args.rounds or (2 if args.smoke else 4)
    n_req = args.requests or (8 if args.smoke else 24)
    device = resolve_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    data = lm_fl_data(cfg, num_edges=2, seq_len=8,
                      n_seqs=96 if args.smoke else 256, seed=args.seed)
    silos = data[3]
    flcfg = FLConfig(num_edges=2, rounds=rounds, method="bkd", core_epochs=1,
                     edge_epochs=1, kd_epochs=2, batch_size=8,
                     seed=args.seed)

    def stream(name):
        return build_stream(name, n_req, vocab=cfg.vocab_size,
                            seed=args.seed, prompt_max=10, out_max=4)

    report = {"config": {"smoke": args.smoke, "arch": cfg.name,
                         "rounds": rounds, "requests": n_req,
                         "slots": args.slots, "max_len": args.max_len,
                         "quantum": args.quantum, "seed": args.seed,
                         "methods": list(METHODS),
                         "backend": device_name(device)},
              "streams": {}}
    ok = True
    # One pretrained core is the shared starting point: the serve-only
    # baseline serves it frozen, every co-run starts from it.
    w0_trainer = build_trainer(cfg, flcfg, data, "bkd", device)
    w0 = w0_trainer.state
    nll0 = round(nll_on(cfg, w0, silos["core"]), 4)
    baseline = ServeEngine(cfg, w0, slots=args.slots, max_len=args.max_len,
                           device=device)
    for name in STREAMS:
        cold = serve_run(baseline, stream(name))
        baseline.reset()
        warm = serve_run(baseline, stream(name))
        baseline.reset()
        entry = {"serve_only_cold": cold, "serve_only": warm,
                 "eval_nll_core_pretrain": nll0}
        print(f"# {name}: serve-only {warm['tok_per_sec']} tok/s (warm)",
              flush=True)
        for method in METHODS:
            trainer = build_trainer(cfg, flcfg, data, method, device)
            engine = ServeEngine(cfg, trainer.state, slots=args.slots,
                                 max_len=args.max_len, device=device)
            # Gate the round stream onto the serving clock: the last
            # simulated round becomes runnable ~60% into the stream's
            # estimated horizon.
            horizon = max(r.arrival for r in stream(name)) + 2 * n_req
            t_last = max(p.time for p in trainer.plans)
            system = LiveSystem(trainer, engine, quantum=args.quantum,
                                ticks_per_time=0.6 * horizon / t_last)
            stats, swaps = co_run(cfg, system, stream(name), silos)
            nlls = [nll0] + [s["eval_nll_core"] for s in swaps
                             if s.get("swap") is not None]
            entry[method] = {
                "serve": stats,
                "overhead_vs_serve_only": round(
                    warm["tok_per_sec"] / stats["tok_per_sec"], 2)
                if stats["tok_per_sec"] else None,
                "swaps": swaps,
                "drift_nll_per_swap": [round(b - a, 4) for a, b in
                                       zip(nlls, nlls[1:])],
                "final_nll_minus_pretrain": round(nlls[-1] - nll0, 4),
            }
            committed = [s for s in swaps if s.get("swap") is not None]
            ok &= bool(committed) and all(
                np.isfinite(s["eval_nll_core"]) for s in committed)
            ok &= trainer.rounds_done == rounds
            print(f"# {name}/{method}: co-scheduled "
                  f"{stats['tok_per_sec']} tok/s, "
                  f"{len(committed)} swaps, "
                  f"dNLL {entry[method]['final_nll_minus_pretrain']}",
                  flush=True)
        report["streams"][name] = entry
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
