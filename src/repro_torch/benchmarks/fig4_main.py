"""Paper Fig. 4 — main R=1 comparison: KD vs BKD (+EMA, melting ablation),
on the PyTorch port.

Claims checked (as the JAX package's ``benchmarks/fig4_main.py`` does):
  * BKD test accuracy >= KD at (nearly) all rounds, higher final accuracy.
  * EMA weight smoothing does not close the gap (Fig. 4a).
  * 'Melting' the buffer (re-clone each epoch) collapses to KD.
  * bkd_cached (beyond-paper) matches bkd exactly on a static core set.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4_main [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import build_setup, csv_row, run_method
from repro_torch.core.aggregation import FedAvg, FedAvgConfig

METHODS = ["kd", "bkd", "ema", "melting", "bkd_cached", "ft"]


def main(rounds=5, seed=0, verbose=True, device="cuda"):
    out = {}
    for m in METHODS:
        hist, dt = run_method(m, rounds=rounds, seed=seed, device=device)
        out[m] = hist
        print(csv_row(f"fig4_{m}", hist, dt))

    # Context row: synchronized FedAvg (the parameter-averaging line the
    # paper positions KD-based FL against, §2) on the same silos.
    adapter, core, edges, test = build_setup(num_edges=5, seed=seed)
    t0 = time.time()
    _, fa_hist = FedAvg(adapter, FedAvgConfig(rounds=rounds,
                                              clients_per_round=5,
                                              local_epochs=6, seed=seed),
                        edges, test, device=device).run(seed)
    print(f"fig4_fedavg_sync,{(time.time() - t0) * 1e6 / rounds:.0f},"
          f"final_acc={fa_hist[-1]['test_acc']:.4f} (requires full sync; "
          f"not available in the paper's async scenario)")
    kd = [h["test_acc"] for h in out["kd"]]
    bkd = [h["test_acc"] for h in out["bkd"]]
    cached = [h["test_acc"] for h in out["bkd_cached"]]
    ft = [h["test_acc"] for h in out["ft"]]
    checks = {
        "bkd_final_ge_kd": bkd[-1] >= kd[-1],
        "bkd_mean_ge_kd": float(np.mean(bkd)) >= float(np.mean(kd)),
        "cached_equals_bkd": bool(np.allclose(bkd, cached, atol=1e-6)),
        "ema_not_better_than_bkd": out["ema"][-1]["test_acc"] <= bkd[-1] + 1e-9,
        # paper §4.1: a better KD method alone (FT+KD) tracks KD, not BKD
        "ft_tracks_kd": abs(ft[-1] - kd[-1]) < 0.15,
    }
    if verbose:
        for k, v in checks.items():
            print(f"fig4_check,{0},{k}={v}")
    return out, checks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
