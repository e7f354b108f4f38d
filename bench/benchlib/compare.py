"""The comparisons that decide ``correct``: each number with its limit.

Training: every checked step's loss, the first gradient's norm leaf by
leaf, and the parameters' change after the checked steps leaf by leaf,
each as the gap between the program's reading and the reference's,
relative to the reference's (a norm's gap relative to the larger of the
leaf's own norm and the median leaf's).  A leaf whose reference gradient
is under a thousandth of the median leaf's moves by round-off alone and is
left out of the change.  Serving: the widest gap by which a served token's
logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
import statistics


def _norm_gaps(prog, ref, keep):
    base = statistics.median(ref)
    return [abs(p - r) / max(r, base)
            for p, r, k in zip(prog, ref, keep) if k]


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [..], "grad_norms": [..],
    "change_norms": [..]} over the same steps and leaves."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    base = statistics.median(ref["grad_norms"])
    moving = [g >= base / 1000 for g in ref["grad_norms"]]
    every = [True] * len(moving)
    return {"loss_gap": max(losses),
            "grad_gap": max(_norm_gaps(prog["grad_norms"], ref["grad_norms"],
                                       every)),
            "change_gap": max(_norm_gaps(prog["change_norms"],
                                         ref["change_norms"], moving))}


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Every leaf's gradient and change gap (what the worst-leaf numbers
    are the largest of), for looking at which leaf sets them."""
    base_g = statistics.median(ref["grad_norms"])
    base_c = statistics.median(ref["change_norms"])
    return {n: (abs(pg - rg) / max(rg, base_g), abs(pc - rc) / max(rc, base_c))
            for n, pg, rg, pc, rc in zip(names, prog["grad_norms"],
                                         ref["grad_norms"],
                                         prog["change_norms"],
                                         ref["change_norms"])}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}); a number that is not finite
    fails."""
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
