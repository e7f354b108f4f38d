"""Benchmark entry point of the port: the paper-figure benches, the kernel
bench and the claim-check tally (the JAX package's ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows per figure and for the kernels
(``kernels_bench``: the fused KD loss against the plain loss's autograd,
``rglru`` and ``ssd`` parity), then ``# claim-checks: n/m passed`` and the
names of the checks that failed.  ``--fast`` runs 3 rounds where the
default runs 5 (fig7 one fewer, at least 2; fig9 one more), as the
reference does.  When dry-run dumps exist (``experiments/dryrun``, written
by ``repro_torch.launch.sweep``), the 16 x 16 roofline table is printed
before the tally, as the reference prints its own.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from repro_torch.benchmarks import (fig4_main, fig5_forget, fig7_aggregation,
                                    fig9_straggler, kernels_bench)


def tally(checks):
    """The tally line over one dict of named boolean claim checks."""
    failed = [k for k, v in checks.items() if not v]
    return (f"# claim-checks: {sum(checks.values())}/{len(checks)} passed"
            + (f"  FAILED: {failed}" if failed else ""))


def main(argv=None):
    """Runs every figure bench and prints the tally; returns each figure's
    checks, ``{"fig4": {...}, "fig5": ..., "fig7": ..., "fig9": ...}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="3 rounds instead of 5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rounds = 3 if args.fast else 5
    dev = dict(device=args.device)

    print("# fig4 — main R=1 comparison (paper Fig. 4)")
    _, c4 = fig4_main.main(rounds=rounds, **dev)
    print("# fig5/6 — forgetting metrics (paper Figs. 5-6, supp. 1)")
    _, c5 = fig5_forget.main(rounds=rounds, **dev)
    print("# fig7 — lightweight aggregation R=2 (paper Fig. 7)")
    _, c7 = fig7_aggregation.main(rounds=max(rounds - 1, 2), **dev)
    print("# fig9/11 — straggler robustness (paper Figs. 9 & 11)")
    _, c9 = fig9_straggler.main(rounds=rounds + 1, **dev)
    print("# kernels — fused KD loss / RG-LRU / SSD")
    kernels_bench.main(**dev)

    if os.path.isdir("experiments/dryrun"):
        print("# roofline — from the multi-pod dry-run (H100 rates)")
        from repro_torch.benchmarks import roofline
        roofline.main(["--mesh", "16x16"])

    print(tally({**c4, **c5, **c7, **c9}))
    return {"fig4": c4, "fig5": c5, "fig7": c7, "fig9": c9}


if __name__ == "__main__":
    main()
