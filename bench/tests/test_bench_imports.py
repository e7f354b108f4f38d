"""The import rule: nothing under bench/ imports JAX or the JAX package
(top-level names compared whole, so the port ``repro_torch`` is not the JAX
package ``repro``), and the plain reference imports nothing of the
program."""

import ast
from pathlib import Path

import bench_tiny  # noqa: F401

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): sorted(set(imported(f)) & FORBIDDEN) for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_the_rule_compares_whole_names():
    import run
    ok = ["repro_torch", "repro_torch.serve", "jaxtyping", "reprox", "torch"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core.fl", "jax.numpy",
                                       "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_reference_imports_only_torch_and_the_standard_library():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert set(imported(f)) <= {"__future__", "math", "torch"}, f

