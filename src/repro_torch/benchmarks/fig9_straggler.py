"""Paper Figs. 9 & 11 — the straggler experiments, on the PyTorch port (the
JAX package's ``benchmarks/fig9_straggler.py``).

  * Fig. 9 (extreme): no edge is ever re-synchronized (all teachers start
    from W0).  KD stalls / degrades; BKD keeps improving.
  * Fig. 11 (alternate): every other round the teacher is a straggler
    trained from the previous core weights.  KD fluctuates; BKD is stable;
    'withdraw' (skip straggler rounds) underperforms BKD.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig9_straggler \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import csv_row, run_method

#: (run name, method, synchronous scenario of repro_torch.core.scheduler).
RUNS = (
    ("kd_w0", "kd", "frozen_w0"),
    ("bkd_w0", "bkd", "frozen_w0"),
    ("kd_alt", "kd", "alternate"),
    ("bkd_alt", "bkd", "alternate"),
    ("withdraw_alt", "kd", "withdraw_alternate"),
    ("bkd_nostrag", "bkd", "none"),
)


def fluctuation(accs):
    return float(np.mean(np.abs(np.diff(accs))))


def main(rounds=6, seed=0, verbose=True, device="cuda"):
    out = {}
    for name, method, scenario in RUNS:
        hist, dt = run_method(method, rounds=rounds, seed=seed,
                              scenario=scenario, device=device)
        out[name] = [h["test_acc"] for h in hist]
        print(csv_row(f"fig9_{name}", hist, dt,
                      extra=f";fluct={fluctuation(out[name]):.4f}"))
    checks = {
        # Fig. 9: in the zero-sync extreme BKD ends higher than KD.
        "w0_bkd_beats_kd": out["bkd_w0"][-1] >= out["kd_w0"][-1],
        # Fig. 9: BKD's curve still improves from its start.
        "w0_bkd_improves": out["bkd_w0"][-1] >= out["bkd_w0"][0] - 1e-9,
        # Fig. 11: BKD fluctuates less than KD under alternating stragglers.
        "alt_bkd_less_fluct": fluctuation(out["bkd_alt"]) <= fluctuation(out["kd_alt"]),
        # Fig. 11: withdrawing stragglers is worse than BKD-with-stragglers.
        "withdraw_worse_than_bkd": out["withdraw_alt"][-1] <= out["bkd_alt"][-1] + 1e-9,
    }
    if verbose:
        for k, v in checks.items():
            print(f"fig9_check,{0},{k}={v}")
    return out, checks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
