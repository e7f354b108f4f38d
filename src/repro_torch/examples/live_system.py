"""Live co-scheduled system demo on the PyTorch port: serve traffic while FL
rounds update the served model (the JAX package's
``examples/live_system.py``).

One ``ServeEngine`` decodes a request stream tick by tick while a
``LiveTrainer`` advances Phase-2 distillation microbatches on the same
device; each completed round hot-swaps the served params between ticks.
Rounds come from the async event-driven simulator, so their event times
are gated onto the serving clock: a round only starts once the stream has
reached its simulated arrival.

The log interleaves ``admit``/``finish`` lines from the engine, ``[round
NN]`` lines from the trainer, and ``== swap ==`` lines when a new core goes
live mid-stream (with the core-domain NLL of the model now serving).

    PYTHONPATH=src python -m repro_torch.examples.live_system \\
        [--stream diurnal] [--method bkd] [--device cpu]
"""

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.fl import FederatedKD, FLConfig
from repro_torch.core.simulator import EventDrivenSimulator
from repro_torch.launch.serve import summarize
from repro_torch.live import (LiveSystem, LiveTrainer, lm_adapter, lm_fl_data,
                              nll_on)
from repro_torch.serve import STREAMS, ServeEngine, build_stream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--stream", default="diurnal", choices=sorted(STREAMS))
    ap.add_argument("--method", default="bkd",
                    help="distillation method for the live rounds")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--quantum", type=int, default=2,
                    help="distill microbatches per co-scheduler turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: nothing to serve")
    core, edges, test, silos = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                          n_seqs=96, seed=args.seed)
    flcfg = FLConfig(num_edges=2, rounds=args.rounds, method=args.method,
                     core_epochs=1, edge_epochs=1, kd_epochs=2, batch_size=8,
                     seed=args.seed)
    reqs = build_stream(args.stream, args.requests, vocab=cfg.vocab_size,
                        seed=args.seed, prompt_max=10, out_max=4)

    fl = FederatedKD(lm_adapter(cfg), flcfg, core, edges, test,
                     scheduler=EventDrivenSimulator(
                         flcfg.num_edges, "uniform", seed=args.seed),
                     device=device)
    print(f"# pretraining core ({cfg.name}, {args.method}, "
          f"{args.rounds} rounds, {device})...", flush=True)
    trainer = LiveTrainer(fl, args.seed, log=print)
    print(f"# core NLL after pretrain: "
          f"{nll_on(cfg, trainer.state, silos['core']):.4f}", flush=True)
    engine = ServeEngine(cfg, trainer.state, slots=args.slots,
                         max_len=args.max_len, device=device)
    horizon = max(r.arrival for r in reqs) + 2 * args.requests
    t_last = max(p.time for p in trainer.plans)

    def on_swap(system, rec):
        nll = nll_on(cfg, system.trainer.state, silos["core"])
        rec["eval_nll_core"] = round(nll, 4)
        print(f"== swap == round {rec['round']} live at tick "
              f"{rec['tick']} (swap #{rec['swap']}, core NLL "
              f"{nll:.4f})", flush=True)

    system = LiveSystem(trainer, engine, quantum=args.quantum,
                        ticks_per_time=0.6 * horizon / t_last,
                        on_swap=on_swap)
    t0 = time.perf_counter()
    finished = system.run(reqs, log=print)
    stats = summarize(finished, time.perf_counter() - t0)
    print(f"\nserved {stats['requests']} requests / {stats['tokens']} tokens "
          f"in {stats['seconds']}s across {engine.ticks} ticks; "
          f"{engine.swaps} hot-swaps at ticks {engine.swap_log}")
    print(f"rounds completed: {trainer.rounds_done}/{args.rounds}; "
          f"final core NLL {nll_on(cfg, trainer.state, silos['core']):.4f}")
    return system


if __name__ == "__main__":
    main()
