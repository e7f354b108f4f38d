"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults 1,2,3] [--seconds 20] [--leaves]

For each seed: the numbers that decide ``correct`` for a sound run of the
program (the lower readings); on the ``--control`` seeds the same numbers
for the plain reference computed in float8 (the control: the step below
the configuration's bfloat16) put in the program's place; on the
``--faults`` seeds for the program with each fault of
``benchlib.faults`` planted underneath.  All on the card, at the cell's
own sizes, one JSON line a reading.  Serving seeds run the cell's own load
for ``--seconds`` so that the sample compares as many tokens as a run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def phase2(cell, args, device):
    from benchlib import compare, faults, record, weights
    from runners import phase2 as drv
    for seed in args.seeds:
        t = time.perf_counter()
        step, state, feed = drv.build(cell, seed, device)
        prog = drv.checked_steps(cell, seed, device, step, state, feed)
        del step, state
        record.free(device)
        ref = drv.reference(cell, seed, device, feed)
        yield {"seed": seed, "kind": "program",
               **compare.training_numbers(prog, ref),
               "seconds": time.perf_counter() - t}
        if args.leaves:
            names = weights.leaf_names(cell.config)
            yield {"seed": seed, "kind": "leaves",
                   "grad_norms": dict(zip(names, ref["grad_norms"])),
                   "change_norms": dict(zip(names, ref["change_norms"])),
                   "gaps": compare.leaf_gaps(prog, ref, names),
                   "losses": [prog["losses"], ref["losses"]]}
        if seed in args.control:
            ctl = drv.reference(cell, seed, device, feed, prec="fp8")
            yield {"seed": seed, "kind": "control_fp8",
                   **compare.training_numbers(ctl, ref)}
        if seed in args.faults:
            for name in faults.TRAINING:
                with faults.planted(name):
                    step, state, feed = drv.build(cell, seed, device)
                    bad = drv.checked_steps(cell, seed, device, step, state,
                                            feed)
                    del step, state
                    record.free(device)
                yield {"seed": seed, "kind": f"fault_{name}",
                       **compare.training_numbers(bad, ref)}


def serve(cell, args, device):
    from benchlib import faults
    from runners import serve as drv
    for seed in args.seeds:
        t = time.perf_counter()
        precs = ("f32", "fp8") if seed in args.control else ("f32",)
        gaps = drv.served_gaps(cell, seed, args.seconds, device, precs)
        yield {"seed": seed, "kind": "program", "logit_gap": gaps["f32"],
               "seconds": time.perf_counter() - t}
        if "fp8" in gaps:
            yield {"seed": seed, "kind": "control_fp8",
                   "logit_gap": gaps["fp8"]}
        if seed in args.faults:
            for name in faults.SERVING:
                with faults.planted(name, serving=True):
                    bad = drv.served_gaps(cell, seed, args.seconds, device)
                yield {"seed": seed, "kind": f"fault_{name}",
                       "logit_gap": bad["f32"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--leaves", action="store_true",
                    help="also print every leaf's norms and gaps")
    args = ap.parse_args()
    import torch

    from benchlib import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    run = phase2 if cell.traffic["runner"] == "phase2" else serve
    for reading in run(cell, args, torch.device("cuda")):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
