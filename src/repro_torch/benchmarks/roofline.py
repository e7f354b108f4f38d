"""Roofline report of the dry-run: the table and the harness's CSV lines
from the JSON dumps ``repro_torch.launch.sweep`` writes (the port of the
JAX package's ``benchmarks/roofline.py``; a dump of either package renders
alike, the port's terms taken at the H100's rates).

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline \\
        [--dir experiments/dryrun] [--markdown out.md] [--mesh 16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname):
    rows = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        if os.path.basename(p).startswith("_"):
            continue
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def fmt_row(r):
    rl = r["roofline"]
    dom = r["bottleneck"].replace("_s", "")
    ratio = r.get("useful_flops_ratio")
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{rl['compute_s']*1e3:.1f} | {rl['memory_s']*1e3:.1f} | "
            f"{rl['collective_s']*1e3:.1f} | **{dom}** | "
            f"{(ratio if ratio else 0):.2f} | "
            f"{r['per_device']['peak_bytes']/1e9:.1f} |")


HEADER = ("| arch | shape | mesh | compute (ms) | memory (ms) | "
          "collective (ms) | bottleneck | useful-FLOP ratio | peak GB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--mesh", default=None, help="filter: 16x16 or 2x16x16")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.mesh:
        rows = [r for r in rows if r["mesh"] == args.mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    lines = [HEADER] + [fmt_row(r) for r in rows]
    text = "\n".join(lines)
    print(text)
    # Per-benchmark CSV line for the harness contract.
    for r in rows:
        rl = r["roofline"]
        print(f"roofline_{r['arch']}_{r['shape']}_{r['mesh']},"
              f"{max(rl.values())*1e6:.0f},bottleneck={r['bottleneck']}")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(text + "\n")
    return rows


if __name__ == "__main__":
    main()
