"""Serving CLI of the port: builds a named request stream, serves it through
the :class:`~repro_torch.serve.engine.ServeEngine` (dense caches by default,
a ring-buffer window with ``--ring``, the block-paged pool with
``--paged``) and prints throughput, latency percentiles and, when paged,
prefix-cache counters.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --stream poisson --requests 8 --slots 4 [--ring | --paged] [--full] \
        [--device cpu]

``--legacy`` runs the frozen pre-engine loop instead
(``repro_torch.serve.legacy``), the comparison baseline.

Under ``torchrun`` (or with ``--mesh``, a one-rank mesh) the CLI runs on a
mesh (``launch.mesh.cli_mesh``), as the JAX CLI does: the parameters are
placed by their logical axes, the engine is built and run in the mesh's
scope with the decode kernels on each rank's shards, every rank serves the
same whole tokens and rank 0 prints:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu
``--arch mamba2-370m`` and ``--arch recurrentgemma-9b`` serve the recurrent
archs on the dense engine with exact-length admission; ``--paged`` on them
raises, as the JAX CLI does (recurrent state has no pages).  Weights are
random, drawn from ``--seed`` on the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.launch.mesh import cli_mesh, mesh_scope, rank0_print
from repro_torch.launch.specs import place_params
from repro_torch.models.transformer import Transformer
from repro_torch.serve import STREAMS, build_stream
from repro_torch.serve import legacy as legacy_mod
from repro_torch.serve.engine import engine_on
from repro_torch.sharding.rules import axis_sizes


def _percentile_ms(vals, q):
    """None (not NaN, so the JSON stays strict) when there are no samples."""
    if not vals:
        return None
    return round(float(np.percentile(np.asarray(vals), q)) * 1e3, 3)


def summarize(finished, wall_seconds):
    """Aggregate a finished request list into throughput and latency stats."""
    toks = sum(len(r.out) for r in finished)
    ttfts = [r.ttft for r in finished if r.t_first >= 0 and r.t_enqueue >= 0]
    # every gap between consecutive tokens of a request, so the p99 is a
    # tail of gaps and not of per-request means
    itls = [b - a for r in finished
            for a, b in zip(r.t_tokens, r.t_tokens[1:])]
    return {
        "requests": len(finished),
        "tokens": toks,
        "seconds": round(wall_seconds, 4),
        "tok_per_sec": round(toks / wall_seconds, 2) if wall_seconds else None,
        "ttft_p50_ms": _percentile_ms(ttfts, 50),
        "ttft_p99_ms": _percentile_ms(ttfts, 99),
        "itl_p50_ms": _percentile_ms(itls, 50),
        "itl_p99_ms": _percentile_ms(itls, 99),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its SMOKE config)")
    ap.add_argument("--stream", default="poisson", choices=sorted(STREAMS),
                    help="named arrival process (repro_torch.serve.streams)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prompt-max", type=int, default=48)
    ap.add_argument("--out-max", type=int, default=12)
    ap.add_argument("--ring", action="store_true",
                    help="ring-buffer windowed cache (long-context serving)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache with prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical page (with --paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical system-prompt tokens "
                         "to every request (exercises the prefix cache)")
    ap.add_argument("--sample", default="greedy", choices=("greedy", "topk"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--legacy", action="store_true",
                    help="run the frozen pre-engine loop (baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--mesh", action="store_true",
                    help="run on a one-rank mesh without torchrun (under "
                         "torchrun the CLI always runs on a mesh)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with cli_mesh(full=args.full, requested=args.mesh, device=device) as mesh:
        return _serve(args, device, mesh)


def _serve(args, device, mesh):
    say = rank0_print(mesh)
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_smoke_config(args.arch))
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    if args.ring:
        cfg = dataclasses.replace(cfg, sliding_window=32, ring_cache=True)
    with mesh_scope(mesh):
        params = Transformer.init(cfg, args.seed, device=device)
        if mesh is not None:
            params = place_params(cfg, params, mesh)
    if args.ring and args.paged:
        raise SystemExit("--ring and --paged are exclusive (the page pool "
                         "replaces the ring buffer)")
    reqs = build_stream(args.stream, args.requests, vocab=cfg.vocab_size,
                        seed=args.seed,
                        prompt_max=min(args.prompt_max, args.max_len - 2
                                       - args.shared_prefix),
                        out_max=args.out_max,
                        shared_prefix=args.shared_prefix)
    if args.legacy:
        t0 = time.perf_counter()
        finished = legacy_mod.simulate(cfg, params, reqs, args.slots,
                                       args.max_len, mesh=mesh, log=say)
    else:
        with engine_on(cfg, params, args.slots, args.max_len, mesh=mesh,
                       sample=args.sample, temperature=args.temperature,
                       top_k=args.top_k if args.sample == "topk" else 0,
                       seed=args.seed, paged=args.paged,
                       page_size=args.page_size, device=device) as engine:
            t0 = time.perf_counter()
            finished = engine.run(reqs, log=say)
    stats = summarize(finished, time.perf_counter() - t0)
    cache = "paged" if args.paged else ("ring" if args.ring else "full")
    mode = "legacy" if args.legacy else f"engine[{args.sample}, {cache} cache]"
    where = device if mesh is None else f"{device}, mesh {axis_sizes(mesh)}"
    say(f"served {stats['requests']}/{args.requests} requests "
        f"({args.stream} stream, {mode} on "
        f"{where}): {stats['tokens']} tokens in {stats['seconds']}s = "
        f"{stats['tok_per_sec']} tok/s; "
        f"TTFT p50/p99 {stats['ttft_p50_ms']}/{stats['ttft_p99_ms']} ms; "
        f"ITL p50/p99 {stats['itl_p50_ms']}/{stats['itl_p99_ms']} ms")
    if not args.paged or args.legacy:
        return finished
    ps = engine.prefix_stats()
    say(f"paged: {ps['hits']} prefix hits / {ps['misses']} misses, "
        f"peak {ps['peak_pages']} pages "
        f"({engine.resident_cache_bytes()} B resident vs "
        f"{engine.slots * engine.pages_per_slot * engine.cache_page_bytes()}"
        f" B dense-equivalent)")
    return finished


if __name__ == "__main__":
    main()
