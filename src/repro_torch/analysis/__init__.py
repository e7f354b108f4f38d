"""The port's static analysis and compile guard: the counterpart of the
JAX package's ``repro.analysis``.

* ``rules`` / ``engine`` / ``report``: an AST rule engine with torch-aware
  lint rules R001-R008, one for each of the JAX package's codes (compiles,
  graph captures and kernel builds on a hot path, host syncs in loops,
  draws from torch's global RNG, control flow on traced values, caches
  keyed on tensors, trees read after an in-place step, broad excepts,
  mutable defaults).  ``python -m repro_torch.analysis`` is the CLI; the
  gate is zero findings beyond the triaged baseline
  (``lint_baseline.json`` beside this module).
* ``sanitize``: ``trace_guard``, which asserts a compile bound over a
  region at run time: new call signatures of the guarded callables, or
  process-wide kernel builds, ``torch.compile`` frames and CUDA graph
  captures.

The static side is stdlib-only: the CLI and the rules never import torch.
"""

from repro_torch.analysis.engine import (Finding, LintResult, apply_baseline,
                                         load_baseline, scan_paths,
                                         scan_source)
from repro_torch.analysis.rules import RULES, Rule

__all__ = [
    "Finding", "LintResult", "RULES", "Rule",
    "apply_baseline", "load_baseline", "scan_paths", "scan_source",
]
