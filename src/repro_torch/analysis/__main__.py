"""The port's lint CLI — torch-aware static analysis over the port.

Usage:
    python -m repro_torch.analysis src/repro_torch chip_smoke.py \
        tests/test_torch_*.py \
        --baseline src/repro_torch/analysis/lint_baseline.json \
        [--report lint_findings.json]
    python -m repro_torch.analysis --list-rules [--json]
    python -m repro_torch.analysis src/repro_torch --write-baseline FILE

Exit codes: 0 clean (vs baseline), 1 new findings, 2 usage/baseline error.
Stdlib-only: runs without importing torch.  The arguments and exit codes
are the JAX package's ``tools/reprolint.py``'s.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.engine import (apply_baseline, load_baseline,
                                         make_baseline, scan_paths)
from repro_torch.analysis.report import (render_rules, render_text,
                                         result_as_dict, rules_as_dicts)
from repro_torch.analysis.rules import RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories to scan")
    ap.add_argument("--baseline", help="triaged baseline JSON to gate against")
    ap.add_argument("--report", help="write the full findings report (JSON)")
    ap.add_argument("--json", action="store_true",
                    help="print JSON instead of text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry (code, summary, fix hint)")
    ap.add_argument("--select", help="comma-separated rule codes to run")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write current findings as a baseline skeleton "
                         "(reasons must then be filled in by hand)")
    args = ap.parse_args(argv)

    if args.list_rules:
        if args.json:
            print(json.dumps(rules_as_dicts(), indent=2))
        else:
            print(render_rules())
        return 0

    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    select = None
    if args.select:
        select = [c.strip().upper() for c in args.select.split(",")]
        unknown = [c for c in select if c not in RULES]
        if unknown:
            ap.error(f"unknown rule code(s): {', '.join(unknown)}")

    findings, files_scanned = scan_paths(args.paths, select=select)

    if args.write_baseline:
        doc = make_baseline(findings)
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
        print(f"wrote {len(doc['entries'])} baseline entr(ies) to "
              f"{args.write_baseline}; fill in the 'reason' fields")
        return 0

    baseline = {}
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"reprolint: bad baseline: {exc}", file=sys.stderr)
            return 2

    result = apply_baseline(findings, baseline, files_scanned=files_scanned)

    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(result_as_dict(result, args.baseline), fh, indent=2)
            fh.write("\n")

    if args.json:
        print(json.dumps(result_as_dict(result, args.baseline), indent=2))
    else:
        print(render_text(result, args.baseline))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
