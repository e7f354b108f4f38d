"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration file and a traffic
file; the traffic file names its runner (``runners/<runner>.py``), which
builds the program (``repro_torch``, under ``src/``) from the seed, warms
it up, measures for ``--seconds`` seconds and checks what the timed path
produced against the plain reference: the architecture module that the
configuration's ``reference`` key names (under ``reference/``), which also
states the parameter tree and the FLOP counts.  With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (a short traced sub-window follows the window).  Each
metric is read by ``metrics/<name>.py``.

Exits 2 without a result when no CUDA card (or too few) is present, and
3 when the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """The loaded modules (``names``, by default ``sys.modules``) whose
    top-level name (before the first dot) is JAX's or the JAX package's,
    compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    _caches()
    import torch

    from benchlib import spec

    cell = spec.cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"bench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: {cards}",
              file=sys.stderr)
        return 2
    runner = importlib.import_module(f"runners.{cell.traffic['runner']}")
    rec, correct, checks = runner.run(cell, args.seed, args.seconds,
                                      bool(args.trace), torch.device("cuda"),
                                      T0)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed,
              "metrics": read_metrics(cell.per_layer if args.trace
                                      else cell.end_to_end, rec),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes": rec.memory_peak_bytes}}
    if args.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks
    print(f"bench: setup_s {rec.setup_s:.3f} window_s {rec.window_s:.3f} "
          f"reference_s {rec.reference_s:.3f} total_s "
          f"{time.perf_counter() - T0:.3f}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def read_metrics(entries, rec):
    """{name: {"value", "unit"}} of every metric whose reader finds
    something in the run."""
    from benchlib import spec
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
