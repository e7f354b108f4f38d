"""Rendering for the port's lint: terminal text, JSON artifacts, the rule
table (its own copy of ``repro.analysis.report``).

Stdlib-only.  ``render_rules``/``rules_as_dicts`` are the single source of
truth for the registry listing — the CLI's ``--list-rules`` and the README
table check in ``tests/test_torch_reprolint.py`` both go through here.
"""

from __future__ import annotations

from repro_torch.analysis.engine import LintResult, normalize_path
from repro_torch.analysis.rules import iter_rules


def _fmt(f) -> str:
    return f"{normalize_path(f.path)}:{f.line}:{f.col}: {f.code} {f.message}"


def render_text(result: LintResult, baseline_path=None) -> str:
    """Human-readable report: new findings, then staleness, then summary."""
    lines = [_fmt(f) for f in result.new]
    if result.stale:
        lines.append("")
        lines.append("stale baseline entries (shrink the baseline file):")
        for e in result.stale:
            lines.append(
                f"  {e['path']}: {e['code']} allows {e['count']}, "
                f"found {e['actual']}")
    lines.append("")
    via = f" vs baseline {baseline_path}" if baseline_path else ""
    lines.append(
        f"reprolint: {len(result.new)} new finding(s), "
        f"{len(result.suppressed)} baselined, "
        f"{result.files_scanned} file(s) scanned{via}")
    return "\n".join(lines).lstrip("\n")


def result_as_dict(result: LintResult, baseline_path=None) -> dict:
    """JSON document for --report / --json (the CI artifact)."""
    return {
        "ok": result.ok,
        "baseline": baseline_path,
        "files_scanned": result.files_scanned,
        "new": [dict(f.as_dict(), path=normalize_path(f.path))
                for f in result.new],
        "suppressed": [dict(f.as_dict(), path=normalize_path(f.path))
                       for f in result.suppressed],
        "stale_baseline": result.stale,
    }


def rules_as_dicts() -> list:
    return [{"code": r.code, "summary": r.summary, "hint": r.hint,
             "doc": r.doc} for r in iter_rules()]


def render_rules() -> str:
    """The --list-rules listing: code, summary, fix hint per rule."""
    lines = []
    for r in iter_rules():
        lines.append(f"{r.code}  {r.summary}")
        lines.append(f"      fix: {r.hint}")
    return "\n".join(lines)
