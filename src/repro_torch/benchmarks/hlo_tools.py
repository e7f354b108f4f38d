"""Op-trace inspection of the dry-run (the port of the JAX package's
``benchmarks/hlo_tools.py``, whose name it keeps: the port has no HLO, so
the reports read the per-device op trace of one meta run).

    PYTHONPATH=src python -m repro_torch.benchmarks.hlo_tools \\
        --arch nemotron-4-340b --shape train_4k [--layers 2] [--top 15]

Runs a ``--layers`` probe of the combo (one super-block by default) on the
production mesh under the dry-run's counter with its trace on, and prints
(a) an op histogram by result bytes, (b) the largest collectives with
their result shapes, (c) the dtype mix of the all-reduce traffic.  A trace
row is ``(op, result bytes, dtype, shape, collective kind or None)``.
"""

from __future__ import annotations

import argparse
import collections


def op_histogram(trace, top=15):
    """[(op, result bytes summed)] of the ``top`` ops by bytes."""
    sizes = collections.Counter()
    for op, nbytes, _, _, _ in trace:
        sizes[op] += nbytes
    return sizes.most_common(top)


def biggest_collectives(trace, top=10):
    """[(count, kind, shape, bytes each, promoted)] of the ``top``
    collective shapes by total bytes; ``promoted`` is the reference's
    column (an f32 all-reduce XLA promoted from bf16) and always False
    here: the port reduces in the tensor's own dtype."""
    agg = collections.Counter()
    size = {}
    for _, nbytes, dtype, shape, kind in trace:
        if kind is None:
            continue
        key = (kind, f"{dtype}{list(shape)}", False)
        agg[key] += 1
        size[key] = nbytes
    out = [(n, kind, shape, size[(kind, shape, p)], p)
           for (kind, shape, p), n in agg.items()]
    out.sort(key=lambda r: -r[0] * r[3])
    return out[:top]


def ar_dtype_mix(trace):
    """{dtype: all-reduce result bytes}."""
    agg = collections.Counter()
    for _, nbytes, dtype, _, kind in trace:
        if kind == "all-reduce":
            agg[dtype] += nbytes
    return dict(agg)


def probe_trace(arch, shape, layers=None, multi_pod=False,
                buffer_mode="clone"):
    """The op trace of a ``layers``-deep probe of one combination."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import fake_group, measure
    from repro_torch.launch.mesh import make_production_mesh, production_shape
    layers = layers or len(registry.get_config(arch).block_pattern)
    made = fake_group(math.prod(production_shape(multi_pod)[0]))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        m = measure(arch, shape, mesh, buffer_mode, None,
                    dict(num_layers=layers), trace=True)
    finally:
        if made:
            dist.destroy_process_group()
    return m["counter"].trace, layers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--buffer-mode", default="clone")
    args = ap.parse_args(argv)
    trace, layers = probe_trace(args.arch, args.shape, args.layers,
                                args.multi_pod, args.buffer_mode)
    print(f"== op histogram (result bytes, {layers}-layer probe) ==")
    for op, b in op_histogram(trace, args.top):
        print(f"  {op:28s} {b/1e9:10.2f} GB")
    print("== largest collectives ==")
    for n, kind, shape, b, _ in biggest_collectives(trace, args.top):
        print(f"  {n:4d} x {kind:18s} {shape:32s} {n*b/1e9:8.2f} GB")
    print("== all-reduce dtype mix ==")
    for dt, b in ar_dtype_mix(trace).items():
        print(f"  {dt:6s} {b/1e9:10.2f} GB")
    return trace


if __name__ == "__main__":
    main()
