"""Shared experiment harness for the paper-figure benchmarks of the port.

Reduced scale of the paper's setup: Gaussian-mixture classification
(sub-clustered classes so edge bias is real), Dirichlet(alpha=1) non-iid
partitioning into 1 core + K edge silos, MLP or ResNet cores/edges.  Every
algorithmic choice (losses, schedule shape, tau=2, SGD momentum) matches
the paper and the JAX package's ``benchmarks/common.py``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.fl import (FederatedKD, FLConfig, mlp_adapter,
                                 resnet_adapter)
from repro_torch.data import (Dataset, dirichlet_partition, make_cifar_like,
                              make_synthetic_classification)


def build_setup(num_classes=10, dim=32, per_class=360, num_edges=5, seed=0,
                n_test=600, resnet=False):
    if resnet:
        from repro_torch.nn.resnet import ResNetConfig
        x, y = make_cifar_like(num_classes=num_classes, n=3000, seed=seed)
        adapter = resnet_adapter(ResNetConfig(depth=8, num_classes=num_classes))
    else:
        x, y = make_synthetic_classification(num_classes=num_classes, dim=dim,
                                             per_class=per_class, seed=seed)
        adapter = mlp_adapter(dim, 64, num_classes)
    xt, yt = x[:n_test], y[:n_test]
    xtr, ytr = x[n_test:], y[n_test:]
    parts = dirichlet_partition(ytr, num_edges + 1, alpha=1.0, seed=seed + 1)
    core = Dataset(xtr[parts[0]], ytr[parts[0]])
    edges = [Dataset(xtr[p], ytr[p]) for p in parts[1:]]
    return adapter, core, edges, Dataset(xt, yt)


def run_method(method, *, rounds=5, num_edges=5, aggregation_r=1,
               straggler="none", withdraw=False, kd_warm_rounds=0, seed=0,
               resnet=False, epochs=(10, 10, 5), scenario=None,
               transport="none", device="cuda"):
    """Run one method end-to-end on ``device``; returns (history, seconds).
    ``scenario`` (a synchronous name from
    ``repro_torch.core.scheduler.SCENARIOS``) overrides the legacy
    straggler/withdraw strings; ``transport`` is a codec spec from
    ``repro_torch.transport`` (or "none")."""
    adapter, core, edges, test = build_setup(num_edges=num_edges, seed=seed,
                                             resnet=resnet)
    cfg = FLConfig(num_edges=num_edges, rounds=rounds, method=method,
                   aggregation_r=aggregation_r, straggler=straggler,
                   withdraw=withdraw, kd_warm_rounds=kd_warm_rounds,
                   core_epochs=epochs[0], edge_epochs=epochs[1],
                   kd_epochs=epochs[2], batch_size=128, seed=seed,
                   transport=transport)
    scheduler = None
    if scenario is not None:
        from repro_torch.core.scheduler import build_scenario
        scheduler = build_scenario(scenario, num_edges,
                                   aggregation_r=aggregation_r, seed=seed)
    fl = FederatedKD(adapter, cfg, core, edges, test, scheduler=scheduler,
                     device=device)
    t0 = time.time()
    _, hist = fl.run(seed, log=None)
    return hist, time.time() - t0


def csv_row(name, hist, dt, extra=""):
    accs = [h["test_acc"] for h in hist]
    final = accs[-1]
    mean_forget = np.mean([h["forget_score"] for h in hist if "forget_score" in h]) \
        if any("forget_score" in h for h in hist) else float("nan")
    us = dt * 1e6 / max(len(hist), 1)
    return (f"{name},{us:.0f},final_acc={final:.4f};mean_acc={np.mean(accs):.4f};"
            f"mean_forget={mean_forget:.4f}{extra}")
