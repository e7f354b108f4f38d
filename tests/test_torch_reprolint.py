"""The port's lint (``repro_torch.analysis``): its engine and report give
the JAX package's results on the same inputs, one positive and one
negative fixture for each torch-aware rule R001-R008, the CLI's exit
codes, the README's rule table against the registry, and the port clean
against its own baseline with no stale entries.

The snippets are parsed, never run.  R008 (mutable defaults) reads the
same in both packages, so the engine comparisons use it.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro.analysis import engine as ref_engine  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro_torch.analysis import (RULES, apply_baseline,  # noqa: E402
                                  load_baseline, scan_paths, scan_source)
from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis.engine import make_baseline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join("src", "repro_torch", "analysis",
                        "lint_baseline.json")
PORT_PATHS = ["src/repro_torch", "chip_smoke.py"]


def lint(src, select=None, path="snippet.py"):
    return scan_source(textwrap.dedent(src), path, select=select)


def codes(src, select=None, path="snippet.py"):
    return [f.code for f in lint(src, select=select, path=path)]


# -- the engine and the report against the JAX package's ---------------------

_SOURCES = {
    "plain": "def f(x=[]):\n    return x\n",
    "pragma on the line": "def f(x=[]):  # reprolint: disable=R008\n"
                          "    return x\n",
    "pragma above": "# reprolint: disable=R008\ndef f(x=[]):\n    return x\n",
    "disable=all": "def f(x=[]):  # reprolint: disable=all\n    return x\n",
    "another code": "def f(x=[]):  # reprolint: disable=R001\n"
                    "    return x\n",
    "skip-file": "# reprolint: skip-file\ndef f(x=[]):\n    return x\n",
    "two findings": "def f(x=[], y={}):\n    return x, y\n"
                    "def g(z=set()):\n    return z\n",
    "syntax error": "def f(:\n",
}


def _keys(findings):
    return [(f.path, f.line, f.col, f.code) for f in findings]


@pytest.mark.parametrize("name", list(_SOURCES))
def test_scan_matches_the_jax_engine(name):
    src = _SOURCES[name]
    got = scan_source(src, "pkg/mod.py", select=["R008"])
    want = ref_engine.scan_source(src, "pkg/mod.py", select=["R008"])
    assert _keys(got) == _keys(want)
    if name == "syntax error":
        assert [f.code for f in got] == ["E001"]   # reported, not raised


def _baseline_file(tmp_path, entries):
    p = tmp_path / "base.json"
    p.write_text(json.dumps({"entries": entries}))
    return str(p)


@pytest.mark.parametrize("count", [1, 2, 5], ids=["exact", "partial",
                                                  "stale"])
def test_baseline_counts_and_stale_entries_match_the_jax_engine(tmp_path,
                                                                 count):
    src = _SOURCES["two findings"]
    base = _baseline_file(tmp_path, [{"path": "pkg/mod.py", "code": "R008",
                                      "count": count, "reason": "triaged"}])
    mine = apply_baseline(scan_source(src, "pkg/mod.py", select=["R008"]),
                          load_baseline(base), files_scanned=1)
    theirs = ref_engine.apply_baseline(
        ref_engine.scan_source(src, "pkg/mod.py", select=["R008"]),
        ref_engine.load_baseline(base), files_scanned=1)
    assert (_keys(mine.new), _keys(mine.suppressed), mine.stale, mine.ok) == \
        (_keys(theirs.new), _keys(theirs.suppressed), theirs.stale,
         theirs.ok)
    assert report.result_as_dict(mine, base) == \
        ref_report.result_as_dict(theirs, base)
    assert bool(mine.stale) == (count > 3)


@pytest.mark.parametrize("entry, match", [
    ({"path": "a.py", "code": "R001", "count": 1, "reason": "  "},
     "triaged"),
    ({"path": "a.py", "code": "R001"}, "missing"),
    ({"path": "a.py", "code": "R001", "count": 0, "reason": "x"},
     "positive"),
], ids=["no reason", "missing keys", "zero count"])
def test_bad_baseline_entries_are_refused_as_the_jax_engine_does(
        tmp_path, entry, match):
    base = _baseline_file(tmp_path, [entry])
    with pytest.raises(ValueError, match=match):
        load_baseline(base)
    with pytest.raises(ValueError, match=match):
        ref_engine.load_baseline(base)


def test_make_baseline_matches_the_jax_engine():
    src = _SOURCES["two findings"]
    assert make_baseline(scan_source(src, "m.py", select=["R008"])) == \
        ref_engine.make_baseline(ref_engine.scan_source(src, "m.py",
                                                        select=["R008"]))


# -- one positive and one negative fixture a rule ------------------------------

# (code, positive snippet, negative snippet)
FIXTURES = [
    ("R001", """
        import torch
        def per_round(f, xs):
            for x in xs:
                y = torch.compile(f)(x)
            return y
        """, """
        import torch
        def make(f):
            return torch.compile(f)
        def run(step, xs):
            for x in xs:
                y = step(x)
            return y
        """),
    ("R001", """
        import torch
        def f(g, x):
            return torch.jit.script(g)(x)
        """, """
        import torch
        def f(g, x):
            scripted = torch.jit.script(g)
            return scripted(x)
        """),
    ("R001", """
        from repro_torch.kernels import build
        def rebuild(names):
            for n in names:
                build.build(n)
        """, """
        from repro_torch.kernels import build
        def library(name):
            return build.load(name)
        """),
    ("R001", """
        import torch
        def capture(fn, x, n):
            for _ in range(n):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(x)
        """, """
        import torch
        def capture(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            return g
        """),
    ("R002", """
        import torch
        def tick(xs):
            out = []
            for x in xs:
                y = torch.argmax(x)
                out.append(int(y))
            return out
        """, """
        import torch
        def tick(xs):
            ys = torch.stack([torch.argmax(x) for x in xs])
            return ys.tolist()
        """),
    ("R002", """
        import torch
        def timed(fn, n):
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
        """, """
        import torch
        def timed(fn, n):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        """),
    ("R002", """
        import torch
        def f(x):
            return x * float(x.sum())
        g = torch.func.vmap(f)
        """, """
        import torch
        def f(x):
            return x * float(x.shape[0])
        g = torch.func.vmap(f)
        """),
    ("R003", """
        import torch
        def noise(shape):
            return torch.randn(shape)
        """, """
        import torch
        def noise(shape, gen):
            return torch.randn(shape, generator=gen)
        """),
    ("R003", """
        import torch
        def init(w):
            w.uniform_(-0.1, 0.1)
        """, """
        import numpy as np
        import torch
        def init(w, gen):
            w.uniform_(-0.1, 0.1, generator=gen)
            return np.random.default_rng(0).normal()
        """),
    ("R003", """
        import torch
        def setup(seed):
            torch.manual_seed(seed)
        """, """
        import torch
        def setup(seed):
            return torch.Generator().manual_seed(seed)
        """),
    ("R004", """
        import torch
        def step(x):
            if x.sum() > 0:
                return x
            return -x
        batched = torch.func.vmap(step)
        """, """
        import torch
        def step(x, b=None):
            if b is None and x.dim() == 2 and isinstance(x, torch.Tensor):
                return torch.where(x.sum() > 0, x, -x)
            return x
        batched = torch.func.vmap(step)
        """),
    ("R005", """
        import functools
        import torch
        @functools.lru_cache(maxsize=None)
        def mask(x: torch.Tensor):
            return x > 0
        """, """
        import functools
        @functools.lru_cache(maxsize=None)
        def plan(rows: int, v: int):
            return rows * v
        """),
    ("R006", """
        from repro_torch.optim import update_in_place
        def step(opt, grads, state, params):
            new_p, new_s = update_in_place(opt, grads, state, params, 0)
            return params["w"].sum()
        """, """
        from repro_torch.optim import update_in_place
        def step(opt, grads, state, params):
            params, state = update_in_place(opt, grads, state, params, 0)
            return params["w"].sum()
        """),
    ("R006", """
        from repro_torch.launch import steps
        def run(cfg, opt, p, s, batch):
            step = steps.make_pretrain_step(cfg, opt)
            new_p, new_s, m = step(p, s, batch, 0)
            return p
        """, """
        from repro_torch.launch import steps
        def run(cfg, opt, p, s, batch):
            step = steps.make_pretrain_step(cfg, opt)
            p, s, m = step(p, s, batch, 0)
            return p
        """),
    ("R007", """
        import torch
        def launch(lib):
            try:
                return lib.run()
            except Exception:
                return None
        """, """
        import torch
        def launch(lib):
            try:
                return lib.run()
            except OSError:
                raise
        """),
    ("R008", """
        import dataclasses
        import torch
        @dataclasses.dataclass
        class Cfg:
            ids: list = []
        def f(x=torch.zeros(3)):
            return x
        """, """
        import dataclasses
        @dataclasses.dataclass
        class Cfg:
            ids: list = dataclasses.field(default_factory=list)
        def f(x=None):
            return x
        """),
]


@pytest.mark.parametrize("code, pos, neg", FIXTURES,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(FIXTURES)])
def test_rule_fires_on_its_positive_and_not_its_negative_fixture(code, pos,
                                                                 neg):
    assert code in codes(pos, select=[code])
    assert codes(neg, select=[code]) == []


def test_every_rule_has_fixtures_a_summary_hint_and_doc():
    assert sorted({c for c, _, _ in FIXTURES}) == sorted(RULES) == [
        f"R00{i}" for i in range(1, 9)]
    for r in RULES.values():
        assert r.summary and r.hint and r.doc


def test_manual_seed_is_allowed_in_tests():
    src = "import torch\ntorch.manual_seed(0)\n"
    assert codes(src, select=["R003"], path="tests/test_x.py") == []
    assert codes(src, select=["R003"], path="pkg/mod.py") == ["R003"]


def test_aliased_torch_and_kwargs_are_read():
    assert codes("""
        import torch as T
        def f(n):
            return T.rand(n)
        """, select=["R003"]) == ["R003"]
    # **kwargs may carry generator=: the rule stays silent
    assert codes("""
        import torch
        def f(n, **kw):
            return torch.rand(n, **kw)
        """, select=["R003"]) == []


# -- the CLI ---------------------------------------------------------------------


def _cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd or REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))


def test_cli_exit_codes_and_report(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("import torch\nx = torch.rand(3)\n")
    proc = _cli(str(bad), cwd=str(tmp_path))
    assert proc.returncode == 1 and "R003" in proc.stdout

    base = _baseline_file(tmp_path, [{"path": "mod.py", "code": "R003",
                                      "count": 1, "reason": "fixture"}])
    out = tmp_path / "report.json"
    proc = _cli(str(bad), "--baseline", base, "--report", str(out),
                cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["ok"] and len(doc["suppressed"]) == 1 and not doc["new"]

    (tmp_path / "bad.json").write_text('{"entries": [{}]}')
    assert _cli(str(bad), "--baseline", str(tmp_path / "bad.json"),
                cwd=str(tmp_path)).returncode == 2
    assert _cli(cwd=str(tmp_path)).returncode == 2          # no paths
    assert _cli(str(bad), "--select", "R999",
                cwd=str(tmp_path)).returncode == 2


def test_cli_list_rules_covers_the_registry():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for code, r in RULES.items():
        assert code in proc.stdout and r.hint in proc.stdout
    listed = json.loads(_cli("--list-rules", "--json").stdout)
    assert [r["code"] for r in listed] == sorted(RULES)


def test_readme_rule_table_equals_list_rules():
    readme = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    rows = [ln for ln in readme.splitlines() if ln.startswith("| **R00")]
    table = {}
    for ln in rows:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        table.setdefault(cells[0].strip("*"), []).append(cells[1:])
    for r in report.rules_as_dicts():
        assert [r["summary"], r["hint"]] in table.get(r["code"], []), (
            f"{r['code']}: the README's table of the port's rules differs "
            f"from `python -m repro_torch.analysis --list-rules`")


# -- the port gates itself -------------------------------------------------------


def test_port_is_clean_against_its_baseline_with_no_stale_entries():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        tests = sorted(os.path.join("tests", n)
                       for n in os.listdir("tests")
                       if n.startswith("test_torch_") and n.endswith(".py"))
        findings, n = scan_paths(PORT_PATHS + tests)
        result = apply_baseline(findings, load_baseline(BASELINE),
                                files_scanned=n)
    finally:
        os.chdir(cwd)
    assert n > 100
    assert result.ok, "\n".join(
        f"{f.path}:{f.line}: {f.code} {f.message}" for f in result.new)
    assert not result.stale, f"stale baseline entries: {result.stale}"
    for entry in load_baseline(os.path.join(REPO, BASELINE)).values():
        assert entry["reason"].strip()
