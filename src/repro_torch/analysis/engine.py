"""The port's lint engine: file walking, pragmas, and the baseline gate
(its own copy of ``repro.analysis.engine``, over the torch-aware rules).

Stdlib-only (``ast`` + ``json``): it runs without importing torch.

Suppression has exactly two mechanisms, both visible in the diff:

* inline pragmas — ``# reprolint: disable=R001,R002`` (or ``disable=all``)
  on the finding line or the line directly above; ``# reprolint: skip-file``
  anywhere skips the whole module;
* the checked-in baseline (``src/repro_torch/analysis/lint_baseline.json``)
  — per-(path, rule)
  allowed counts, each entry carrying a one-line ``reason``.  The gate is
  zero findings *beyond* the baseline, and stale entries (count higher than
  reality) are reported so the baseline only ever shrinks.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable, Optional

from repro_torch.analysis.rules import RULES, Finding, ModuleContext

_PRAGMA = re.compile(
    r"#\s*reprolint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")
_SKIP_FILE = re.compile(r"#\s*reprolint:\s*skip-file")


@dataclasses.dataclass
class LintResult:
    """Outcome of a scan after baseline subtraction."""

    new: list            # findings not covered by the baseline -> gate fails
    suppressed: list     # findings absorbed by a baseline entry
    stale: list          # baseline entries whose count exceeds reality
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.new


def _pragmas(source: str):
    """line -> set of disabled codes (the literal string 'all' disables
    everything on that line)."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(line)
        if m:
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            out[i] = {c if c == "all" else c.upper() for c in codes}
    return out


def scan_source(source: str, path: str,
                select: Optional[Iterable[str]] = None) -> list:
    """Run every (or the selected) rule over one module's source."""
    if _SKIP_FILE.search(source):
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path=path, line=exc.lineno or 0, col=exc.offset or 0,
                        code="E001",
                        message=f"syntax error, file not scanned: {exc.msg}")]
    ctx = ModuleContext(tree, path, source)
    codes = sorted(select) if select is not None else sorted(RULES)
    findings = []
    for code in codes:
        findings.extend(RULES[code].check(ctx))
    pragmas = _pragmas(source)
    kept = []
    for f in findings:
        disabled = pragmas.get(f.line, set()) | pragmas.get(f.line - 1, set())
        if f.code in disabled or "all" in disabled:
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.line, f.col, f.code))
    return kept


def iter_python_files(paths: Iterable[str]) -> list:
    """Expand files/directories into a sorted list of .py files."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
    return sorted(set(out))


def scan_paths(paths: Iterable[str],
               select: Optional[Iterable[str]] = None):
    """Scan files/dirs; returns (findings, files_scanned)."""
    findings = []
    files = iter_python_files(paths)
    for path in files:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        findings.extend(scan_source(source, path, select=select))
    return findings, len(files)


# ---------------------------------------------------------------------------
# Baseline.
# ---------------------------------------------------------------------------


def normalize_path(path: str) -> str:
    """Repo-relative, forward-slash path for stable baseline keys."""
    rel = os.path.relpath(path)
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def load_baseline(path: str) -> dict:
    """Load and validate a baseline file.

    Format: ``{"entries": [{"path", "code", "count", "reason"}, ...]}``.
    Every entry must carry a non-empty ``reason`` — the baseline is a triage
    record, not a mute button.  Returns ``{(path, code): entry}``.
    """
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    entries = raw.get("entries")
    if not isinstance(entries, list):
        raise ValueError(f"{path}: baseline must have an 'entries' list")
    out = {}
    for i, e in enumerate(entries):
        missing = {"path", "code", "count", "reason"} - set(e)
        if missing:
            raise ValueError(
                f"{path}: entry {i} missing {sorted(missing)}")
        if not isinstance(e["count"], int) or e["count"] < 1:
            raise ValueError(f"{path}: entry {i} count must be a positive int")
        if not str(e["reason"]).strip():
            raise ValueError(
                f"{path}: entry {i} ({e['path']}, {e['code']}) has an empty "
                f"reason; baseline entries must be triaged")
        key = (e["path"], e["code"])
        if key in out:
            raise ValueError(f"{path}: duplicate baseline entry for {key}")
        out[key] = dict(e)
    return out


def apply_baseline(findings: list, baseline: dict,
                   files_scanned: int = 0) -> LintResult:
    """Split findings into new-vs-suppressed against allowed counts.

    For each (path, code) group the first ``count`` findings (by line) are
    suppressed; anything beyond is new.  Baseline entries matching fewer
    findings than their count are reported stale.
    """
    groups = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        groups.setdefault((normalize_path(f.path), f.code), []).append(f)
    new, suppressed = [], []
    used = {}
    for key, fs in groups.items():
        allowed = baseline.get(key, {}).get("count", 0)
        suppressed.extend(fs[:allowed])
        new.extend(fs[allowed:])
        used[key] = min(allowed, len(fs))
    stale = []
    for key, entry in baseline.items():
        if used.get(key, 0) < entry["count"]:
            stale.append(dict(entry, actual=used.get(key, 0)))
    new.sort(key=lambda f: (f.path, f.line, f.col))
    return LintResult(new=new, suppressed=suppressed, stale=stale,
                      files_scanned=files_scanned)


def make_baseline(findings: list, reason: str = "TODO: triage") -> dict:
    """Serializable baseline document covering the given findings."""
    counts = {}
    for f in findings:
        counts[(normalize_path(f.path), f.code)] = \
            counts.get((normalize_path(f.path), f.code), 0) + 1
    entries = [{"path": p, "code": c, "count": n, "reason": reason}
               for (p, c), n in sorted(counts.items())]
    return {"entries": entries}
