"""Quickstart — the paper in ~60 lines, on the PyTorch port.

Builds a non-iid federated setup (Dirichlet alpha=1), runs Algorithm 1 with
vanilla KD and with buffered KD (the paper's contribution), and prints the
per-round test accuracy of both.  The same data and configuration as the
JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On a CUDA device the Phase-2 losses run through the hand-written
``kd_stats_fwd``/``kd_grad_bwd`` kernels.
"""

import argparse

from repro_torch.core.fl import FederatedKD, FLConfig, mlp_adapter
from repro_torch.data import (Dataset, dirichlet_partition,
                              make_synthetic_classification)


def setup():
    """(adapter, core, edges, test) of the quickstart."""
    # 1. Data: 10 classes, each with several modes -> edges see different
    #    modes, so edge teachers carry genuinely biased knowledge (Fig. 2).
    x, y = make_synthetic_classification(num_classes=10, dim=32,
                                         per_class=360, sub_clusters=3, seed=0)
    x_test, y_test, x_tr, y_tr = x[:600], y[:600], x[600:], y[600:]
    # 2. Partition: 1 core silo + 5 edge silos, Dirichlet(alpha=1) class mix.
    parts = dirichlet_partition(y_tr, 6, alpha=1.0, seed=1)
    core = Dataset(x_tr[parts[0]], y_tr[parts[0]])
    edges = [Dataset(x_tr[p], y_tr[p]) for p in parts[1:]]
    test = Dataset(x_test, y_test)
    return mlp_adapter(in_dim=32, hidden=64, classes=10), core, edges, test


def config(method, **overrides):
    return FLConfig(**{**dict(num_edges=5, rounds=5, method=method, tau=2.0,
                              core_epochs=10, edge_epochs=10, kd_epochs=5,
                              batch_size=128, seed=0), **overrides})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    adapter, core, edges, test = setup()
    print(f"core={len(core)} samples, edges={[len(e) for e in edges]}")
    # 3. Run Algorithm 1 with both distillation schemes.
    out = {}
    for method in ("kd", "bkd"):
        fl = FederatedKD(adapter, config(method), core, edges, test,
                         device=args.device)
        _, hist = fl.run(0, log=None)
        out[method] = hist
        accs = " ".join(f"{h['test_acc']:.3f}" for h in hist)
        print(f"{method:4s} test accuracy per round: {accs}")
        lost = [h.get("lost") for h in hist if "lost" in h]
        print(f"     forgetting (lost samples/round): {lost}")
    return out


if __name__ == "__main__":
    main()
