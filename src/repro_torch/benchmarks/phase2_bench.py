"""Phase-2 distillation throughput per execution path / loss backend, on
the PyTorch port (the JAX package's ``benchmarks/phase2_bench.py``).

Times ``DistillEngine.run`` (one full set of KD epochs, bkd method) at the
default CIFAR-shaped config for the reference's variants, under its names:

    python_loop       scan=False (each batch cut on the host and copied
                      over), plain losses, and a fresh engine per round
    python_loop_warm  scan=False, one engine across rounds
    scan_jnp          scan=True (batches gathered from a device copy of the
                      core set), the plain losses
    scan_pallas       scan=True, the fused KD loss: the hand-written kernel
                      pair kd_stats_fwd/kd_grad_bwd on a CUDA device, their
                      plain versions on the CPU
    scan_topk_cached  scan=True, bkd_cached with the top-k compressed
                      logit cache

and checks the ``bkd_cached`` accuracy contract: a short FL run with the
compressed cache must land within 0.5pt of the exact cache.  Output is one
JSON document (stdout, plus --out FILE); ``device`` names the card where
the reference records ``jax.default_backend()``.

The exit rule is the reference's: ``speedup_scan_vs_loop`` (scan_jnp over
python_loop steps/s) at least 2.0 (1.0 with ``--smoke``) and the contract
met.  The 2.0 measures a JAX effect (a fresh engine re-traces its jitted
step every round); the port has no trace to pay, so its ratio is near 1
and a full-size run can exit 1 with every number in order.

``--all-methods`` switches to the registry-completeness mode: every method
in the registry (``repro_torch/core/methods.py``) runs one full round
end-to-end through ``FederatedKD`` at toy scale and has its Phase-2 timed;
it exits 0 only when every method's accuracy is finite.

    PYTHONPATH=src python -m repro_torch.benchmarks.phase2_bench \\
        [--smoke] [--all-methods] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distill_engine import DistillEngine
from repro_torch.core.fl import FederatedKD, FLConfig, mlp_adapter
from repro_torch.data import (Dataset, dirichlet_partition, make_cifar_like,
                              make_synthetic_classification)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device):
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def cifar_shaped(smoke):
    """CIFAR-shaped Phase-2 workload: 32x32x3 inputs, 10 classes, batch 128."""
    n = 512 if smoke else 2048
    x, y = make_cifar_like(num_classes=10, n=n, seed=0)
    core = Dataset(x.reshape(n, -1), y)
    adapter = mlp_adapter(core.x.shape[-1], 128, 10)
    cfg_kw = dict(batch_size=128, kd_epochs=1 if smoke else 3, seed=0)
    return adapter, core, cfg_kw


def time_variant(adapter, core, cfg_kw, *, scan, method="bkd",
                 loss_backend="jnp", repeats, cold_per_round=False,
                 device="cuda"):
    cfg = FLConfig(method=method, scan=scan, loss_backend=loss_backend,
                   cache_topk=8, **cfg_kw)
    state = adapter.init(torch.Generator().manual_seed(0), device)
    teacher = adapter.init(torch.Generator().manual_seed(1), device)
    steps = max(len(core) // cfg.batch_size, 1) * cfg.kd_epochs

    def one_round(engine, r):
        engine.run(state, [teacher], r)
        _sync(device)

    engine = DistillEngine(adapter, cfg, core, device)
    if not cold_per_round:
        one_round(engine, 0)                         # warm the engine
    t0 = time.perf_counter()
    for r in range(1, repeats + 1):
        if cold_per_round:
            # The reference's seed semantics: every round built a new
            # engine (its optimizer and, in JAX, its traced step).
            engine = DistillEngine(adapter, cfg, core, device)
        one_round(engine, r)
    dt = time.perf_counter() - t0
    return {"steps_per_sec": round(repeats * steps / dt, 2),
            "total_steps": repeats * steps, "seconds": round(dt, 4)}


def accuracy_contract(smoke, device="cuda"):
    """bkd_cached end-to-end: top-k compressed cache vs exact cache."""
    x, y = make_synthetic_classification(num_classes=10, dim=32, per_class=120,
                                         seed=0)
    xt, yt, xtr, ytr = x[:300], y[:300], x[300:], y[300:]
    parts = dirichlet_partition(ytr, 4, alpha=0.5, seed=1)
    core = Dataset(xtr[parts[0]], ytr[parts[0]])
    edges = [Dataset(xtr[p], ytr[p]) for p in parts[1:]]
    test = Dataset(xt, yt)
    adapter = mlp_adapter(32, 64, 10)
    ep = 2 if smoke else 6
    accs = {}
    for backend in ("jnp", "topk_cached"):
        cfg = FLConfig(num_edges=3, rounds=1 if smoke else 3,
                       method="bkd_cached", loss_backend=backend, cache_topk=8,
                       core_epochs=ep, edge_epochs=ep, kd_epochs=max(ep // 2, 1),
                       batch_size=64, seed=0)
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        _, hist = fl.run(0, log=None)
        accs[backend] = hist[-1]["test_acc"]
    return {"exact_cache_acc": accs["jnp"],
            "topk_cached_acc": accs["topk_cached"],
            "abs_delta": round(abs(accs["jnp"] - accs["topk_cached"]), 4)}


def _method_setup(smoke):
    """Toy FL setup shared by the per-method round-trips."""
    x, y = make_synthetic_classification(num_classes=10, dim=32,
                                         per_class=60 if smoke else 120,
                                         seed=0)
    n_test = 150
    xt, yt, xtr, ytr = x[:n_test], y[:n_test], x[n_test:], y[n_test:]
    parts = dirichlet_partition(ytr, 4, alpha=0.5, seed=1)
    core = Dataset(xtr[parts[0]], ytr[parts[0]])
    edges = [Dataset(xtr[p], ytr[p]) for p in parts[1:]]
    return mlp_adapter(32, 64, 10), core, edges, Dataset(xt, yt)


def all_methods_report(smoke, repeats, device="cuda"):
    """Registry completeness: every registered method (a) round-trips
    through FederatedKD for one round and (b) has its Phase-2 timed.
    ``steps_per_sec`` is null for full-round methods (fedavg runs no
    gradient steps — its ``seconds`` is the averaging wall time)."""
    from repro_torch.core.methods import method_names, resolve_method

    adapter, core, edges, test = _method_setup(smoke)
    ep = 2 if smoke else 4
    out = {}
    for name in method_names():
        cfg = FLConfig(num_edges=3, rounds=1, method=name, core_epochs=ep,
                       edge_epochs=ep, kd_epochs=max(ep // 2, 1),
                       batch_size=64, seed=0)
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        _, hist = fl.run(0, log=None)
        final_acc = hist[-1]["test_acc"]

        # Phase-2 timing on the same engine (round 0 warms it).
        engine = fl.distill_engine
        state = adapter.init(torch.Generator().manual_seed(0), device)
        teacher = adapter.init(torch.Generator().manual_seed(1), device)
        steps = max(len(core) // cfg.batch_size, 1) * cfg.kd_epochs
        full_round = resolve_method(name).full_round
        engine.run(state, [teacher], 0, teacher_weights=[1])
        _sync(device)
        t0 = time.perf_counter()
        for r in range(1, repeats + 1):
            engine.run(state, [teacher], r, teacher_weights=[1])
        _sync(device)
        dt = time.perf_counter() - t0
        out[name] = {
            "final_acc": final_acc,
            "steps_per_sec": (None if full_round
                              else round(repeats * steps / dt, 2)),
            "seconds": round(dt, 4),
        }
        print(f"# {name}: acc={final_acc:.3f} "
              f"steps/s={out[name]['steps_per_sec']}", flush=True)
    return out


#: The reference's variants under its names, on the port's Phase-2 engine.
VARIANTS = {
    "python_loop": dict(scan=False, loss_backend="jnp", cold_per_round=True),
    "python_loop_warm": dict(scan=False, loss_backend="jnp"),
    "scan_jnp": dict(scan=True, loss_backend="jnp"),
    "scan_pallas": dict(scan=True, loss_backend="pallas"),
    "scan_topk_cached": dict(scan=True, method="bkd_cached",
                             loss_backend="topk_cached"),
}


def throughput_report(smoke, repeats, device="cuda"):
    """Every variant's steps/s, the scan/loop ratio and the bkd_cached
    contract, as the reference's report."""
    adapter, core, cfg_kw = cifar_shaped(smoke)
    throughput = {}
    for name, kw in VARIANTS.items():
        throughput[name] = time_variant(adapter, core, cfg_kw,
                                        repeats=repeats, device=device, **kw)
        print(f"# {name}: {throughput[name]['steps_per_sec']} steps/s",
              flush=True)
    return {
        "config": {"smoke": smoke, "core_examples": len(core),
                   "input_dim": int(core.x.shape[-1]), "classes": 10,
                   "batch_size": cfg_kw["batch_size"],
                   "kd_epochs": cfg_kw["kd_epochs"], "repeats": repeats,
                   "device": device_name(device)},
        "throughput": throughput,
        "speedup_scan_vs_loop": round(
            throughput["scan_jnp"]["steps_per_sec"]
            / throughput["python_loop"]["steps_per_sec"], 2),
        "bkd_cached_accuracy": accuracy_contract(smoke, device),
    }


def passes(report, smoke):
    """The reference's exit rule over a throughput report."""
    return (report["speedup_scan_vs_loop"] >= (1.0 if smoke else 2.0)
            and report["bkd_cached_accuracy"]["abs_delta"]
            <= 0.005 + (0.05 if smoke else 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes — a wiring check, not a benchmark")
    ap.add_argument("--all-methods", action="store_true",
                    help="registry completeness: run + time every "
                         "registered DistillMethod for one round")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    repeats = args.repeats or (1 if args.smoke else 3)
    device = resolve_device(args.device)

    if args.all_methods:
        methods = all_methods_report(args.smoke, repeats, device)
        report = {
            "config": {"smoke": args.smoke, "repeats": repeats,
                       "device": device_name(device)},
            "methods": methods,
        }
        ok = all(np.isfinite(m["final_acc"]) for m in methods.values())
    else:
        report = throughput_report(args.smoke, repeats, device)
        ok = passes(report, args.smoke)
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
