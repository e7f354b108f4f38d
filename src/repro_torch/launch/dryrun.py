"""Multi-pod dry-run of the port: run every (arch x input shape x mesh)
combination once on ``meta`` tensors against a fake process group of 256
(16 x 16) or 512 (2 x 16 x 16) ranks, count what one device does, and put
the counts against the H100's rates (``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multi-pod] [--buffer-mode clone] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every combo

Nothing is allocated: parameters, optimizer state, buffer, batch and caches
are DTensors whose local shards are ``meta`` tensors, distributed by the
reference's shardings (``repro_torch.launch.specs``), and the step (the
Phase-2 step for train, the prefill step, the serving engine's decode
step) runs eagerly under ``mesh_context``: DTensor propagates shapes and
issues the collectives, the kernels' wrappers take their plain versions
on ``meta``.  One ``TorchDispatchMode`` sees every op a device runs on its
local shards and counts, per device:

  * flops, from ``torch.utils.flop_counter``'s formulas on the local
    shapes;
  * bytes accessed: the local operand and result bytes of every op that is
    not a view;
  * collective bytes: the result bytes of every ``_c10d_functional``
    collective times the ring factor of its kind (``_FACTOR``), by kind;
  * argument bytes (the local shards of every input), output bytes, and
    the peak of the bytes of live tensors the step made (a tracker of every
    result until it is freed: the port's own measure of temporaries, not
    XLA's buffer assignment).

Eager torch counts every layer as it runs (XLA's cost analysis counts a
while-loop body once, so the reference extrapolates from unrolled probes):
``run_one(probe=...)`` keeps the reference's argument and needs no probe.
The fake group is the only use of ``torch.testing._internal`` in the port.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import sys
import time
import weakref

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BW, NET_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, mesh_context,
                                     production_shape)
from repro_torch.sharding.rules import tree_map_axes

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# Bytes-on-the-wire factor per result byte (ring cost model): all-reduce
# moves ~2x its payload (reduce-scatter + all-gather phases); the others ~1x.
_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}
# ``_c10d_functional`` op -> collective kind.
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute"}
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "wait_tensor", "lift_fresh"}


def fake_group(world_size: int):
    """Make the default process group a fake one of ``world_size`` ranks
    (rank 0); returns True when this call made it."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry-run needs "
                               f"{world_size}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    return True


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class DeviceCounter:
    """Per-device counts of the ops run under it (a ``TorchDispatchMode``
    over the local shards DTensor hands to each op).  ``trace`` keeps one
    ``(op, result bytes, dtype, shape, kind)`` row per op for
    ``repro_torch.benchmarks.hlo_tools``."""

    def __init__(self, trace=False):
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.trace = [] if trace else None

    def _free(self, n):
        self.live -= n

    def mode(self):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented   # counted on its local shards
                out = func(*args, **kwargs)
                ins = _tensors((args, kwargs))
                outs = _tensors(out)
                if any(isinstance(t, FakeTensor) for t in ins + outs):
                    return out   # DTensor's shape propagation, not a device op
                counter._count(func, args, kwargs, ins, outs, out,
                               flop_registry)
                return out

        return _Mode()

    def _count(self, func, args, kwargs, ins, outs, out, flop_registry):
        name = func._schema.name.split("::")[-1]
        res = sum(_nbytes(t) for t in outs)
        kind = None
        if func.namespace == "_c10d_functional":
            kind = _KINDS.get(name)
            if kind is not None:
                self.coll[kind] += res * _FACTOR[kind]
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view and name not in _NO_DATA:
                self.bytes += sum(_nbytes(t) for t in ins) + res
        ids = {id(t) for t in ins}
        for t in outs:
            if id(t) in ids or t._base is not None:
                continue   # in place, or a view: nothing allocated
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        if self.trace is not None and outs:
            t = outs[0]
            self.trace.append((name, res, str(t.dtype).split(".")[-1],
                               tuple(t.shape), kind))


def _local_shape(shape, mesh, placements):
    shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    return tuple(shape)


def distribute_meta(leaf, mesh, placements):
    """A DTensor of ``leaf``'s global shape and dtype whose local shard is
    a ``meta`` tensor."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(leaf.shape, mesh, placements),
                        dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def _distribute(specs, shapes, mesh, dtype=None):
    def one(axes, leaf):
        _, pl = S.named_sharding(axes, leaf.shape, mesh)
        if dtype is not None:
            leaf = torch.empty(leaf.shape, dtype=dtype, device="meta")
        return distribute_meta(leaf, mesh, pl)
    return tree_map_axes(one, specs, shapes)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def build_combo(arch, shape_name, mesh, buffer_mode="clone", topk=None,
                overrides=None):
    """``(run, args)`` for one combination: ``run()`` calls the step on
    ``args`` (meta DTensors placed by the reference's shardings); nothing
    runs here."""
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw
    cfg = registry.for_shape(arch, shape_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    batch_meta = S.input_specs(cfg, shape)
    batch_sh = S.batch_shardings(batch_meta, mesh)
    batch = {k: distribute_meta(v, mesh, batch_sh[k][1])
             for k, v in batch_meta.items()}
    p_meta, p_specs = S.abstract_params(cfg)
    params = _distribute(p_specs, p_meta, mesh)

    if shape.kind == "train":
        opt = adamw(1e-4)
        opt_state = {k: _distribute(p_specs, p_meta, mesh, torch.float32)
                     for k in ("m", "v")}
        step = St.make_phase2_step(cfg, opt, buffer_mode=buffer_mode,
                                   topk=topk)
        if buffer_mode == "clone":
            buf = _copy_tree(params)
        elif buffer_mode == "cached":
            k = topk or 256
            b, s_ = shape.global_batch, shape.seq_len
            buf = {}
            for name, shp, dt in (("top_vals", (b, s_, k), torch.float32),
                                  ("top_idx", (b, s_, k), torch.int32),
                                  ("tail_lse", (b, s_), torch.float32)):
                leaf = torch.empty(shp, dtype=dt, device="meta")
                _, pl = S.named_sharding(("batch", None, None)[:len(shp)],
                                         shp, mesh)
                buf[name] = distribute_meta(leaf, mesh, pl)
        else:
            buf = None
        args = (params, _copy_tree(params), buf, opt_state, batch, 0)
        return (lambda: step(*args)), args

    if shape.kind == "prefill":
        step = St.make_prefill_step(cfg, shape.seq_len)
        args = (params, batch)
        return (lambda: step(*args)), args

    c_meta, c_specs = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    caches = _distribute(c_specs, c_meta, mesh)
    step = St.make_serve_step(cfg)
    args = (params, caches, batch["token"], shape.seq_len - 1)
    return (lambda: step(*args)), args


def measure(arch, shape_name, mesh, buffer_mode="clone", topk=None,
            overrides=None, trace=False):
    """Build one combination and run its step once under a
    :class:`DeviceCounter`; returns the counts and seconds."""
    t0 = time.time()
    run, args = build_combo(arch, shape_name, mesh, buffer_mode, topk,
                            overrides)
    t_build = time.time() - t0
    counter = DeviceCounter(trace=trace)
    arg_bytes = _local_bytes(args)
    param_bytes = _local_bytes(args[0])
    with mesh_context(mesh), counter.mode():
        out = run()
    t_run = time.time() - t0 - t_build
    return {"counter": counter, "argument_bytes": arg_bytes,
            "param_bytes": param_bytes, "output_bytes": _local_bytes(out),
            "t_build": t_build, "t_run": t_run}


def _local_bytes(tree):
    """Bytes of the local shards (one device's) of every tensor in a
    tree."""
    return sum(_nbytes(t.to_local()) if hasattr(t, "to_local") else _nbytes(t)
               for t in _tensors(tree))


def run_one(arch, shape_name, multi_pod=False, buffer_mode="clone", topk=None,
            overrides=None, verbose=True, probe=True):
    """One combination's per-device counts and H100 roofline, in the
    reference's JSON layout (plus ``param_bytes_per_device``, the bytes of
    one device's parameter shards).  ``lower_s`` is the seconds spent
    building the meta arguments and the step, ``compile_s`` the seconds of
    the eager meta run (the port lowers and compiles nothing).  ``probe`` is the
    reference's argument; eager torch counts every layer, so no probe or
    extrapolation is needed and it changes nothing."""
    del probe
    shape_dims, _ = production_shape(multi_pod)
    made = fake_group(math.prod(shape_dims))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        shape = SHAPES[shape_name]
        cfg0 = registry.for_shape(arch, shape_name)
        if overrides:
            cfg0 = dataclasses.replace(cfg0, **overrides)
        m = measure(arch, shape_name, mesh, buffer_mode, topk, overrides)
        n_dev = mesh.size()
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()
    c = m["counter"]
    flops, bytes_acc = c.flops, c.bytes
    coll = sum(c.coll.values())
    n_params = S.param_count(cfg0)
    n_active = S.param_count(cfg0, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    fwd_mult = {"train": 10, "prefill": 2, "decode": 2}[shape.kind]
    if shape.kind == "train" and buffer_mode != "clone":
        fwd_mult = 8  # student fwd+bwd (6) + teacher fwd (2); no buffer fwd
    model_flops = fwd_mult * n_active * tokens / n_dev  # per-device
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "buffer_mode": buffer_mode, "topk": topk,
        "devices": n_dev,
        "lower_s": round(m["t_build"], 2), "compile_s": round(m["t_run"], 2),
        "per_device": {
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": c.peak,
            "peak_bytes": m["argument_bytes"] + c.peak,
            "flops": flops,
            "bytes_accessed": bytes_acc,
            "collective_bytes": coll,
            "collective_by_kind": dict(c.coll),
        },
        "roofline": {
            "compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll / NET_BW,
        },
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else None,
        "params_total": n_params, "params_active": n_active,
        # beyond the reference's keys: one device's parameter shards
        "param_bytes_per_device": m["param_bytes"],
    }
    terms = res["roofline"]
    res["bottleneck"] = max(terms, key=terms.get)
    if verbose:
        print(json.dumps(res, indent=2))
    return res


ALL_DEFAULT_COMBOS = [
    (a, s)
    for a in registry.list_archs()
    for s in SHAPES
    if registry.skip_reason(a, s) is None
]


def parse_overrides(items):
    """``["num_layers=2", "seq_parallel=true"]`` -> a dict of field
    values."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = {"true": True, "false": False}.get(v.lower(), v)
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--buffer-mode", default="clone",
                    choices=["clone", "cached", "none"])
    ap.add_argument("--topk", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. num_layers=2 or "
                         "seq_parallel=true (repeatable)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        results = []
        for a, s in ALL_DEFAULT_COMBOS:
            for mp in (False, True):
                print(f"=== {a} x {s} ({'2x16x16' if mp else '16x16'}) ===",
                      file=sys.stderr)
                results.append(run_one(a, s, mp, args.buffer_mode, args.topk,
                                       verbose=False))
        out = args.out or "dryrun_all.json"
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {out}")
        return results

    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --all")
    res = run_one(args.arch, args.shape, args.multi_pod, args.buffer_mode,
                  args.topk, overrides=parse_overrides(args.override) or None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
