"""Serving throughput/latency on the PyTorch port: the engine against the
frozen pre-engine loop (the JAX package's ``benchmarks/serve_bench.py``).

Times the same request stream through both serving paths at the smoke
config (``--full`` for the real config on the card):

    legacy   the pre-engine loop (``repro_torch.serve.legacy``): shared
             ``ptick`` decode, one exact-length prefill an admission, one
             host read per slot per tick
    engine   ``repro_torch.serve.ServeEngine``: per-slot device-resident
             positions, one host sync a tick, bucketed batched prefill

then per-arrival-process stats on the warm engine, and a third section on
the block-paged KV cache (``--page-size``) against two claims: resident
cache bytes at skewed occupancy (an engine provisioned for 4x the
headline ``--max-len`` serving short prompts; gate: >= 4x reduction) and
prefix-hit TTFT on a shared-system-prompt stream, with dense/paged token
parity on every named stream.

Emits one JSON document (stdout, plus --out FILE) with the reference's
keys; ``config.backend`` names the device where the reference records
``jax.default_backend()``.  The exit rule is the reference's: speedup >=
1.5 (2.0 at full size), the prefill shape count within its bucketing
bound, paged tokens equal on every stream and residency cut >= 4x.  The
speedup gate mostly measures JAX retracing one prefill per distinct prompt
length in the legacy loop, which the port (eager) does not pay, so the
port may exit 1 with every number in order.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench \\
        [--smoke] [--full] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.benchmarks.phase2_bench import _sync, device_name
from repro_torch.configs import registry
from repro_torch.launch.serve import summarize
from repro_torch.models.transformer import Transformer
from repro_torch.serve import STREAMS, ServeEngine, build_stream
from repro_torch.serve import legacy as legacy_mod
from repro_torch.serve.engine import bucket_length


def run_legacy(cfg, params, reqs, slots, max_len, device):
    _sync(device)
    t0 = time.perf_counter()
    finished = legacy_mod.simulate(cfg, params, reqs, slots, max_len,
                                   log=lambda *a: None)
    _sync(device)
    return summarize(finished, time.perf_counter() - t0)


def run_engine(cfg, params, reqs, slots, max_len, device, engine=None):
    _sync(device)
    t0 = time.perf_counter()
    if engine is None:
        engine = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                             device=device)
    else:
        engine.reset()
    finished = engine.run(reqs, log=None)
    _sync(device)
    return summarize(finished, time.perf_counter() - t0), engine


def _ttft_ms(reqs):
    vals = [r.ttft for r in reqs if r.t_first >= 0 and r.t_enqueue >= 0]
    return round(float(np.median(vals)) * 1e3, 3) if vals else None


def paged_section(cfg, params, args, n_req, device):
    """Dense vs paged: token parity on every named stream, resident-cache
    bytes at skewed occupancy, and prefix-hit vs miss TTFT.  The engines
    are provisioned for 4x the headline ``--max-len`` and serve prompts
    shorter than a page: the dense engine holds its full ``slots x
    max_len`` allocation, the pool's peak tracks pages written."""
    slots, ps = args.slots, args.page_size
    max_len = 4 * args.max_len
    short_max = max(4, ps - 2)     # prompts below one page: the skew
    dense = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                        device=device)
    paged = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                        paged=True, page_size=ps, device=device)

    residency, parity_ok = {}, True
    for name in sorted(STREAMS):
        mk = lambda: build_stream(name, n_req, vocab=cfg.vocab_size,  # noqa: E731
                                  seed=args.seed, prompt_max=short_max,
                                  out_max=args.out_max)
        dense.reset()
        paged.reset()
        want = {r.rid: r.out for r in dense.run(mk(), log=None)}
        got = {r.rid: r.out for r in paged.run(mk(), log=None)}
        parity_ok &= got == want
        d, p = dense.resident_cache_bytes(), paged.resident_cache_bytes()
        residency[name] = {
            "dense_bytes": d, "paged_peak_bytes": p,
            "reduction_x": round(d / p, 2) if p else None,
            "tokens_match": got == want,
        }
        print(f"# paged {name}: {d} -> {p} B "
              f"({residency[name]['reduction_x']}x), "
              f"parity={got == want}", flush=True)

    # Prefix-hit vs miss TTFT on a shared-system-prompt stream: hits
    # prefill only the suffix past the shared pages.  A warm-up run first,
    # so that the lone cold miss is not charged for first-call costs.
    shared = 2 * ps
    mk = lambda: build_stream("poisson", n_req, vocab=cfg.vocab_size,  # noqa: E731
                              seed=args.seed, shared_prefix=shared,
                              prompt_max=args.prompt_max,
                              out_max=args.out_max)
    paged.reset()
    paged.run(mk(), log=None)
    paged.reset()
    finished = paged.run(mk(), log=None)
    hits = [r for r in finished if r.prefix_pages > 0]
    misses = [r for r in finished if r.prefix_pages == 0]
    stats = paged.prefix_stats()
    prefix = {
        "shared_prefix_tokens": shared,
        "hits": stats["hits"], "misses": stats["misses"],
        "evictions": stats["evictions"],
        "ttft_hit_p50_ms": _ttft_ms(hits),
        "ttft_miss_p50_ms": _ttft_ms(misses),
    }
    print(f"# paged prefix: {stats['hits']} hits / {stats['misses']} "
          f"misses, TTFT hit {prefix['ttft_hit_p50_ms']} ms vs miss "
          f"{prefix['ttft_miss_p50_ms']} ms", flush=True)

    worst = min(r["reduction_x"] for r in residency.values()
                if r["reduction_x"])
    return {
        "page_size": ps,
        "skew": {"max_len": max_len, "prompt_max": short_max},
        "residency": residency,
        "worst_reduction_x": worst,
        "prefix": prefix,
        "tokens_match_all_streams": parity_ok,
    }


def passes(report, smoke):
    """The reference's exit rule over a report."""
    compiles = report["prefill_compiles"]
    paged = report["paged"]
    return (report["speedup_tok_s"] >= (1.5 if smoke else 2.0)
            and compiles["count"] <= compiles["bound"]
            and paged["tokens_match_all_streams"]
            and paged["worst_reduction_x"] >= 4.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes — a wiring check, not a benchmark")
    ap.add_argument("--full", action="store_true",
                    help="the full arch config")
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-max", type=int, default=40)
    ap.add_argument("--out-max", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    n_req = args.requests or (12 if args.smoke else 32)
    device = resolve_device(args.device)

    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_smoke_config(args.arch))
    params = Transformer.init(cfg, args.seed, device=device)

    def stream(name):
        return build_stream(name, n_req, vocab=cfg.vocab_size,
                            seed=args.seed, prompt_max=args.prompt_max,
                            out_max=args.out_max)

    # Headline comparison: a fresh engine vs the legacy loop on the same
    # stream (poisson has many distinct prompt lengths).
    legacy_stats = run_legacy(cfg, params, stream("poisson"), args.slots,
                              args.max_len, device)
    print(f"# legacy: {legacy_stats['tok_per_sec']} tok/s", flush=True)
    engine_stats, engine = run_engine(cfg, params, stream("poisson"),
                                      args.slots, args.max_len, device)
    print(f"# engine: {engine_stats['tok_per_sec']} tok/s", flush=True)
    speedup = round(engine_stats["tok_per_sec"]
                    / legacy_stats["tok_per_sec"], 2)

    # Scenario sweep on the (now warm) engine: per-arrival-process stats.
    scenarios = {}
    for name in sorted(STREAMS):
        stats, _ = run_engine(cfg, params, stream(name), args.slots,
                              args.max_len, device, engine=engine)
        scenarios[name] = stats
        print(f"# stream {name}: {stats['tok_per_sec']} tok/s, "
              f"ttft p99 {stats['ttft_p99_ms']} ms", flush=True)

    paged = paged_section(cfg, params, args, n_req, device)

    bound = int(math.log2(bucket_length(args.prompt_max))) + 1
    compiles = engine.prefill_compile_count()
    report = {
        "config": {"smoke": args.smoke, "arch": cfg.name,
                   "requests": n_req, "slots": args.slots,
                   "max_len": args.max_len, "prompt_max": args.prompt_max,
                   "out_max": args.out_max, "seed": args.seed,
                   "page_size": args.page_size,
                   "backend": device_name(device)},
        "legacy": legacy_stats,
        "engine": engine_stats,
        "speedup_tok_s": speedup,
        "streams": scenarios,
        "prefill_compiles": {"count": compiles, "bound": bound},
        "paged": paged,
    }
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if passes(report, args.smoke) else 1


if __name__ == "__main__":
    raise SystemExit(main())
