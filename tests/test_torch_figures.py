"""The port's paper-figure benches against the JAX package's, on the CPU.

Figs. 5, 7 and 9 run at toy scale (2 rounds, 3 edges, epochs (2, 2, 1)) in
both packages from the same data and the JAX package's initial state
(carried over by ``repro_torch.interop`` through a patched
``build_setup``), and their histories agree round by round.  ``summarize``,
``fluctuation`` and ``run.py``'s tally equal the reference's on the same
inputs; ``phase2_bench`` (both modes) and the ResNet example run on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig4_main as jfig4  # noqa: E402
from benchmarks import fig5_forget as jfig5  # noqa: E402
from benchmarks import fig7_aggregation as jfig7  # noqa: E402
from benchmarks import fig9_straggler as jfig9  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro.core import fl as jfl  # noqa: E402
from repro_torch.benchmarks import (common, fig4_main, fig5_forget,  # noqa: E402
                                    fig7_aggregation, fig9_straggler,
                                    phase2_bench, run)
from repro_torch.examples import fl_resnet_cifar  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402

TOY = dict(num_edges=3, epochs=(2, 2, 1))
ROUNDS = 2
# Accuracies (test, current and previous edge set) within 0.02 absolute,
# as tests/test_torch_fl.py holds the quickstart: the two packages' f32
# sums differ by ~1e-6 a step (the reference itself moves that much with
# batch shape), which can flip a few samples on a decision boundary.
ACC_TOL = 0.02
# The forget score is the difference of two such accuracies: 2 x 0.02.
FORGET_TOL = 2 * ACC_TOL
# lost / gained / retained count the previous edge set's samples whose
# correctness changed or held: each flipped sample moves one count by one,
# and 0.02 of the set flip at most; the tolerance is 0.02 of its size.

PAIRS = ((jfig5, fig5_forget), (jfig7, fig7_aggregation),
         (jfig9, fig9_straggler))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def toy(monkeypatch):
    """Both packages' benches at toy scale on the CPU, every run recorded
    as (method, keyword arguments, history); the port's runs start from the
    JAX package's initial state for the run's seed."""
    runs = {"jax": [], "port": []}

    def recorded(fn, side):
        def wrapper(method, **kw):
            hist, dt = fn(method, **TOY, **kw)
            runs[side].append((method, kw, hist))
            return hist, dt
        return wrapper

    build = common.build_setup

    def carried(**kw):
        adapter, core, edges, test = build(**kw)
        state0 = jax.tree.map(np.asarray, jfl.mlp_adapter(32, 64, 10).init(
            jax.random.key(kw["seed"])))
        return (dataclasses.replace(
            adapter, init=lambda gen, device: params_from_numpy(state0, device)),
            core, edges, test)

    monkeypatch.setattr(common, "build_setup", carried)
    for jmod, mod in PAIRS:
        monkeypatch.setattr(jmod, "run_method",
                            recorded(jcommon.run_method, "jax"))
        monkeypatch.setattr(mod, "run_method",
                            recorded(common.run_method, "port"))
    return runs


def _count_tol(rec):
    prev = rec["lost"] + rec["gained"] + rec["retained"]
    return ACC_TOL * max(prev, 1)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[1].__name__)
def test_figure_bench_matches_jax_round_by_round(toy, pair):
    jmod, mod = pair
    kd.kd_stats_fwd.launches = 0
    jres, jchecks = jmod.main(rounds=ROUNDS, verbose=False)
    res, checks = mod.main(rounds=ROUNDS, verbose=False, device="cpu")
    assert checks.keys() == jchecks.keys()
    assert all(isinstance(v, bool) for v in checks.values())
    assert res.keys() == jres.keys()
    assert len(toy["port"]) == len(toy["jax"]) > 0
    for (m, kw, hist), (jm, jkw, jhist) in zip(toy["port"], toy["jax"]):
        assert kw.pop("device") == "cpu"
        assert (m, kw) == (jm, jkw)
        assert [h["round"] for h in hist] == [h["round"] for h in jhist]
        assert [h["edges"] for h in hist] == [h["edges"] for h in jhist]
        assert [h["staleness"] for h in hist] == [h["staleness"] for h in jhist]
        for h, jh in zip(hist, jhist):
            assert h.keys() == jh.keys()
            for key in ("test_acc", "acc_cur_edge", "acc_prev_edge"):
                if key in jh:
                    assert abs(h[key] - jh[key]) <= ACC_TOL, (m, key)
            if "forget_score" in jh:
                assert abs(h["forget_score"] - jh["forget_score"]) <= FORGET_TOL
                for key in ("lost", "gained", "retained"):
                    assert abs(h[key] - jh[key]) <= _count_tol(jh), (m, key)
    if mod is fig5_forget:
        assert any("forget_score" in r for _, _, h in toy["port"] for r in h)
        for k in res:
            for key in ("acc_cur", "acc_prev"):
                assert abs(res[k][key] - jres[k][key]) <= ACC_TOL
    assert kd.kd_stats_fwd.launches == 0


def test_summarize_and_fluctuation_equal_the_reference(toy):
    """On one history (the JAX package's, and the port's records) the
    port's ``summarize`` and ``fluctuation`` equal the reference's."""
    jhist, _ = jfig5.run_method("bkd", rounds=3, seed=0)
    hist, _ = fig5_forget.run_method("bkd", rounds=3, seed=0, device="cpu")
    for h in (jhist, hist):
        assert fig5_forget.summarize(h) == jfig5.summarize(h)
        accs = [r["test_acc"] for r in h]
        assert fig9_straggler.fluctuation(accs) == jfig9.fluctuation(accs)
    accs = list(np.random.default_rng(1).random(7))
    assert fig9_straggler.fluctuation(accs) == jfig9.fluctuation(accs)


def _stub_mains(monkeypatch, pairs, checks):
    """Replace each figure's ``main`` with one that records its rounds and
    returns the given checks."""
    calls = []
    for name, mod in pairs:
        def fake(rounds=5, seed=0, verbose=True, name=name, **kw):
            calls.append((name, rounds))
            return None, checks[name]
        monkeypatch.setattr(mod, "main", fake)
    return calls


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fails", [(), ("fig5", "fig9"), ("fig4", "fig7")])
def test_tally_equals_the_reference(monkeypatch, capsys, fast, fails):
    """``run.py`` on the same check dicts: the figures run at the same
    rounds, and the tally line is the reference's."""
    checks = {f: {f"{f}_a": True, f"{f}_b": f not in fails}
              for f in ("fig4", "fig5", "fig7", "fig9")}
    from benchmarks import kernels_bench
    monkeypatch.setattr(kernels_bench, "main", lambda *a, **k: None)
    benched = []
    monkeypatch.setattr(run.kernels_bench, "main",
                        lambda *a, **k: benched.append(k))
    monkeypatch.setattr(jrun.os.path, "isdir", lambda p: False)
    jcalls = _stub_mains(monkeypatch, (("fig4", jfig4), ("fig5", jfig5),
                                       ("fig7", jfig7), ("fig9", jfig9)),
                         checks)
    calls = _stub_mains(monkeypatch, (("fig4", fig4_main),
                                      ("fig5", fig5_forget),
                                      ("fig7", fig7_aggregation),
                                      ("fig9", fig9_straggler)), checks)
    monkeypatch.setattr("sys.argv", ["run"] + (["--fast"] if fast else []))
    jrun.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("# claim-checks")]
    got = run.main(["--device", "cpu"] + (["--fast"] if fast else []))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("# claim-checks")]
    assert lines == want and len(want) == 1
    assert calls == jcalls
    assert got == checks
    assert f"{8 - len(fails)}/8 passed" in lines[0]
    assert benched == [{"device": "cpu"}]   # the kernel bench, as jrun runs it


def test_phase2_bench_runs_on_cpu(capsys):
    """Both modes at ``--smoke`` sizes: every registered method round-trips
    with a finite accuracy (exit 0), and the throughput report has the
    reference's variants, the scan/loop ratio and the bkd_cached contract."""
    from repro.core.methods import method_names
    assert phase2_bench.main(["--smoke", "--all-methods",
                              "--device", "cpu"]) == 0
    capsys.readouterr()
    report = phase2_bench.throughput_report(True, 1, "cpu")
    assert list(report["throughput"]) == [
        "python_loop", "python_loop_warm", "scan_jnp", "scan_pallas",
        "scan_topk_cached"]
    assert all(v["steps_per_sec"] > 0 for v in report["throughput"].values())
    assert report["config"]["device"] == "cpu"
    contract = report["bkd_cached_accuracy"]
    assert contract["abs_delta"] == round(abs(
        contract["exact_cache_acc"] - contract["topk_cached_acc"]), 4)
    assert phase2_bench.passes(report, True) == (
        report["speedup_scan_vs_loop"] >= 1.0
        and contract["abs_delta"] <= 0.055)
    from repro_torch.core.methods import method_names as port_methods
    assert port_methods() == method_names()


def test_resnet_example_runs_on_cpu(capsys):
    out = fl_resnet_cifar.main(["--device", "cpu", "--edges", "1",
                                "--rounds", "1", "--epochs", "1",
                                "--depth", "2"])
    assert set(out) == {"kd", "bkd"}
    for hist in out.values():
        assert len(hist) == 1 and 0.0 <= hist[0]["test_acc"] <= 1.0
    assert "final test acc" in capsys.readouterr().out


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: fig5_forget.main(rounds=1),
                 lambda: fig7_aggregation.main(rounds=1),
                 lambda: fig9_straggler.main(rounds=1),
                 lambda: run.main(["--fast"]),
                 lambda: phase2_bench.main(["--smoke"]),
                 lambda: fl_resnet_cifar.main([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
