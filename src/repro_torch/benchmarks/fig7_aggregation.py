"""Paper Fig. 7 — lightweight aggregation R=2, on the PyTorch port (the JAX
package's ``benchmarks/fig7_aggregation.py``).

The ensemble of two edge teachers is distilled per round.  Per §4.2 the
paper warm-starts with plain KD for the first rounds before switching to
buffered distillation (the BKD curve otherwise rises too slowly); we use
kd_warm_rounds=1 at this reduced scale.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_aggregation \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import csv_row, run_method


def main(rounds=4, seed=0, verbose=True, device="cuda"):
    out = {}
    for name, kw in (
        ("kd_r2", dict(aggregation_r=2)),
        ("bkd_r2", dict(aggregation_r=2, kd_warm_rounds=1)),
    ):
        hist, dt = run_method(name.split("_")[0] if "bkd" not in name else "bkd",
                              rounds=rounds, seed=seed, device=device, **kw)
        out[name] = hist
        print(csv_row(f"fig7_{name}", hist, dt))
    kd = [h["test_acc"] for h in out["kd_r2"]]
    bkd = [h["test_acc"] for h in out["bkd_r2"]]
    checks = {"bkd_r2_final_ge_kd_r2": bkd[-1] >= kd[-1] - 1e-9}
    if verbose:
        for k, v in checks.items():
            print(f"fig7_check,{0},{k}={v}")
    return out, checks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
