"""Paper Fig. 5 + Fig. 6 + supp. Fig. 1 — forgetting metrics, on the
PyTorch port (the JAX package's ``benchmarks/fig5_forget.py``).

  * Fig. 5a: core accuracy on the current edge set E_t (KD overfits E_t).
  * Fig. 5b: core accuracy on the previous edge set E_{t-1} (BKD retains).
  * mean forget score = mean_t [acc(E_t) - acc(E_{t-1})]  (lower = better).
  * Fig. 6: lost / gained / retained correct predictions on E_{t-1}.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_forget [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import run_method


def summarize(hist):
    rows = [h for h in hist if "forget_score" in h]
    return {
        "acc_cur": float(np.mean([h["acc_cur_edge"] for h in rows])),
        "acc_prev": float(np.mean([h["acc_prev_edge"] for h in rows])),
        "forget": float(np.mean([h["forget_score"] for h in rows])),
        "lost": float(np.mean([h["lost"] for h in rows])),
        "gained": float(np.mean([h["gained"] for h in rows])),
        "retained": float(np.mean([h["retained"] for h in rows])),
    }


def main(rounds=5, seed=0, verbose=True, device="cuda"):
    res = {}
    for m in ("kd", "bkd"):
        hist, dt = run_method(m, rounds=rounds, seed=seed, device=device)
        s = summarize(hist)
        res[m] = s
        print(f"fig5_{m},{dt*1e6/rounds:.0f},acc_cur={s['acc_cur']:.4f};"
              f"acc_prev={s['acc_prev']:.4f};forget={s['forget']:.4f};"
              f"lost={s['lost']:.1f};gained={s['gained']:.1f};"
              f"retained={s['retained']:.1f}")
    checks = {
        # BKD is more conservative on E_t (doesn't chase the current edge)...
        "bkd_less_overfit_cur": res["bkd"]["acc_cur"] <= res["kd"]["acc_cur"] + 0.02,
        # ...retains E_{t-1} better...
        "bkd_better_prev": res["bkd"]["acc_prev"] >= res["kd"]["acc_prev"],
        # ...and has a lower mean forget score (paper supp. Fig. 1c).
        "bkd_lower_forget": res["bkd"]["forget"] <= res["kd"]["forget"],
        # Fig. 6: fewer lost, more retained.
        "bkd_fewer_lost": res["bkd"]["lost"] <= res["kd"]["lost"],
        "bkd_more_retained": res["bkd"]["retained"] >= res["kd"]["retained"],
    }
    if verbose:
        for k, v in checks.items():
            print(f"fig5_check,{0},{k}={v}")
    return res, checks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
