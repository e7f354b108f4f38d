"""Paper-faithful configuration at reduced scale: ResNet edges + core, on
the PyTorch port (the JAX package's ``examples/fl_resnet_cifar.py``).

This is the paper's §4 setup (ResNet-32, CIFAR-100, 19 edges, SGD momentum,
tau=2, Dirichlet alpha=1) with the reference's three reductions: ResNet-8
instead of ResNet-32, CIFAR-*like* synthetic images instead of the real
download, and 3 edges x 8 epochs instead of 19 x 160.  Every algorithmic
component (losses, cloning, schedules) is the paper's.  On a CUDA device
the Phase-2 losses run through the hand-written ``kd_stats_fwd``/
``kd_grad_bwd`` kernels.

    PYTHONPATH=src python -m repro_torch.examples.fl_resnet_cifar \\
        [--edges 3] [--rounds 3] [--device cpu]
"""

import argparse

from repro_torch.core.fl import FederatedKD, FLConfig, resnet_adapter
from repro_torch.data import Dataset, dirichlet_partition, make_cifar_like
from repro_torch.nn.resnet import ResNetConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--depth", type=int, default=8, help="6n+2 (paper: 32)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, y = make_cifar_like(num_classes=args.classes, n=2400, seed=0)
    x_test, y_test, x_tr, y_tr = x[:400], y[:400], x[400:], y[400:]
    parts = dirichlet_partition(y_tr, args.edges + 1, alpha=1.0, seed=1)
    core = Dataset(x_tr[parts[0]], y_tr[parts[0]])
    edges = [Dataset(x_tr[p], y_tr[p]) for p in parts[1:]]
    test = Dataset(x_test, y_test)

    adapter = resnet_adapter(ResNetConfig(depth=args.depth,
                                          num_classes=args.classes))
    out = {}
    for method in ("kd", "bkd"):
        cfg = FLConfig(num_edges=args.edges, rounds=args.rounds, method=method,
                       tau=2.0, core_epochs=args.epochs,
                       edge_epochs=args.epochs, kd_epochs=max(args.epochs // 2, 2),
                       batch_size=128, lr=0.1, weight_decay=1e-4, seed=0)
        fl = FederatedKD(adapter, cfg, core, edges, test, device=args.device)
        _, hist = fl.run(0, log=lambda m: print(f"  {method}: {m}"))
        out[method] = hist
        print(f"{method}: final test acc {hist[-1]['test_acc']:.4f}")
    return out


if __name__ == "__main__":
    main()
