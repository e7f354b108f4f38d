"""Asynchronous, fleet-scale and hierarchical FL in the PyTorch port against
the JAX package, on the CPU.

The numpy-only copies (``core/simulator.py``, ``core/fleet.py`` and the
``async_*``/``fleet_*``/``hier_*`` branches of ``build_scenario``) must emit
the originals' plan streams and statistics *exactly* (field for field,
bit-equal floats) on the same arguments.  ``FederatedKD.run`` under the six
async, fleet and hierarchical scenarios, from the JAX package's initial
state, must match the JAX run round by round: ``edges``, ``staleness`` and
``straggler`` exactly, ``test_acc`` and ``acc_cur_edge`` within 0.02 (4 of
200 test samples; f32 sums ~1e-6 apart over ~100 steps can move a few
samples on a decision boundary, as in ``tests/test_torch_fl.py``).  The
port's scenarios, async and transport benches run on the CPU, and the
transport bench's simulator accounting equals the JAX bench's.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from repro.core import fl as jfl  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.benchmarks import async_bench, scenarios  # noqa: E402
from repro_torch.benchmarks import transport_bench  # noqa: E402
from repro_torch.core import fl, fleet, scheduler, simulator  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402

NAMES = (jscheduler.ASYNC_SCENARIOS + jscheduler.FLEET_SCENARIOS
         + jscheduler.HIER_SCENARIOS)
TRIGGERS = ("arrival", "window:3", "deadline:1.5", "deadline:1.0:1")
ACC_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_stream(got, want):
    """Plan for plan: the same record type, and every field (nested
    EdgeTasks included) equal, floats bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
        assert g.edge_ids == w.edge_ids and g.straggler == w.straggler


def _same_run(port_sim, jax_sim, rounds):
    _same_stream(port_sim.plans(rounds), jax_sim.plans(rounds))
    assert port_sim.stats == jax_sim.stats


# -- the numpy copies ---------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_scenario_plan_streams_equal_the_originals(name, seed):
    for edges, r in ((4, 2), (9, 3)):
        port = scheduler.build_scenario(name, edges, aggregation_r=r,
                                        seed=seed)
        want = jscheduler.build_scenario(name, edges, aggregation_r=r,
                                         seed=seed)
        assert type(port).__name__ == type(want).__name__
        _same_run(port, want, rounds=6)


@pytest.mark.parametrize("trigger,family", list(itertools.product(
    TRIGGERS, jsimulator.PROFILE_FAMILIES)))
def test_every_trigger_and_family_equals_the_originals(trigger, family):
    """The heap and fleet simulators (with byte accounting) and the
    hierarchical fleet, for every trigger x profile family, at seeds 0
    and 1."""
    for seed in (0, 1):
        kw = dict(profiles=family, trigger=trigger, seed=seed,
                  payload_bytes=1000.0)
        _same_run(simulator.EventDrivenSimulator(6, **kw),
                  jsimulator.EventDrivenSimulator(6, **kw), rounds=10)
        _same_run(fleet.FleetSimulator(6, **kw),
                  jfleet.FleetSimulator(6, **kw), rounds=10)
        hk = dict(region_trigger="window:2", core_trigger=trigger,
                  seed=seed, payload_bytes=1000.0, core_payload_bytes=64.0)
        _same_run(fleet.HierarchicalFleetSimulator(9, 3, family, **hk),
                  jfleet.HierarchicalFleetSimulator(9, 3, family, **hk),
                  rounds=4)


def test_profiles_draws_and_refusals_equal_the_originals():
    for family in jsimulator.PROFILE_FAMILIES:
        for seed in (0, 1):
            got = simulator.profile_arrays(family, 50, seed)
            want = jsimulator.profile_arrays(family, 50, seed)
            for k in ("speed", "latency", "dropout"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k))
            assert ([dataclasses.astuple(p) for p in
                     simulator.make_profiles(family, 5, seed)]
                    == [dataclasses.astuple(p) for p in
                        jsimulator.make_profiles(family, 5, seed)])
    draws = simulator.DispatchDraws(3, 4)
    jdraws = jsimulator.DispatchDraws(3, 4)
    edges, ks = np.array([0, 3, 1, 2]), np.array([0, 40, 17, 100])
    for a, b in zip(draws.gather(edges, ks), jdraws.gather(edges, ks)):
        np.testing.assert_array_equal(a, b)
    for spec in ("arrival", "window", "window:4", "deadline:2.5:1"):
        assert (dataclasses.astuple(simulator.make_trigger(spec, 3))
                == dataclasses.astuple(jsimulator.make_trigger(spec, 3)))
    # The fleet twin refuses partial concurrency with dropout, as the
    # original does, and both refuse a window that can never fill.
    for mod in (fleet, jfleet):
        with pytest.raises(ValueError, match="concurrency == num_edges"):
            mod.FleetSimulator(6, "dropout", "arrival", concurrency=3)
    for mod in (simulator, jsimulator):
        with pytest.raises(ValueError, match="can never fill"):
            mod.EventDrivenSimulator(4, "uniform", "window:5")
    assert jscheduler._hier_regions(40) == scheduler._hier_regions(40) == 6


# -- whole runs against the JAX package -------------------------------------


def _setup():
    """The quickstart's data at a third of its size, 4 edges."""
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=10, dim=32, per_class=120, sub_clusters=3, seed=0)
    parts = jpartition.dirichlet_partition(y[200:], 5, alpha=1.0, seed=1)
    core = jpipeline.Dataset(x[200:][parts[0]], y[200:][parts[0]])
    edges = [jpipeline.Dataset(x[200:][p], y[200:][p]) for p in parts[1:]]
    return core, edges, jpipeline.Dataset(x[:200], y[:200])


@pytest.mark.parametrize("name", NAMES)
def test_run_matches_jax_round_by_round(name):
    """Two (core) rounds of bkd at R = 2 over 4 edges under each scenario,
    from the JAX package's initial state: the region rounds of the hier_*
    streams run underneath and ``history`` has one entry a core round."""
    core, edges, test = _setup()
    kw = dict(num_edges=4, rounds=2, method="bkd", aggregation_r=2, tau=2.0,
              core_epochs=2, edge_epochs=2, kd_epochs=1, batch_size=64,
              seed=0)
    jadapter = jfl.mlp_adapter(32, 64, 10)
    jstate0 = jax.tree.map(np.asarray, jadapter.init(jax.random.key(0)))
    _, jhist = jfl.FederatedKD(
        jadapter, jfl.FLConfig(**kw), core, edges, test,
        scheduler=jscheduler.build_scenario(name, 4, aggregation_r=2)).run(
            jax.random.key(0), log=None)
    adapter = dataclasses.replace(
        fl.mlp_adapter(32, 64, 10),
        init=lambda gen, device: params_from_numpy(jstate0, device))
    lines = []
    _, hist = fl.FederatedKD(
        adapter, fl.FLConfig(**kw), core, edges, test,
        scheduler=scheduler.build_scenario(name, 4, aggregation_r=2),
        device="cpu").run(0, log=lines.append)
    assert len(hist) == len(jhist) == 2
    for h, jh in zip(hist, jhist):
        assert (h.round, h.edges, h.staleness, h.straggler) == \
            (jh.round, jh.edges, jh.staleness, jh.straggler)
        assert abs(h["test_acc"] - jh["test_acc"]) <= ACC_TOL
        assert abs(h["acc_cur_edge"] - jh["acc_cur_edge"]) <= ACC_TOL
        assert h.keys() == jh.keys()
    # Every log line carries its plan's event-time provenance.
    assert lines and all(" via " in line for line in lines)
    if name in jscheduler.HIER_SCENARIOS:
        assert any(line.startswith("[region ") for line in lines)
    assert kd.kd_stats_fwd.launches == 0


def test_stale_inits_stack_in_one_vectorized_round():
    """A round whose two teachers start from cores of different staleness
    trains them together (``VectorizedEdgeEngine``), as the JAX engine
    does, and equals the sequential loop."""
    core, edges, test = _setup()
    adapter = fl.mlp_adapter(32, 64, 10)
    cfg = fl.FLConfig(num_edges=4, edge_epochs=1, batch_size=64)
    a = adapter.init(torch.Generator().manual_seed(0), "cpu")
    b = adapter.init(torch.Generator().manual_seed(1), "cpu")
    out = {}
    for vec in (True, False):
        f = fl.FederatedKD(adapter, dataclasses.replace(cfg, vectorize=vec),
                           core, edges, test, device="cpu")
        out[vec] = f.train_round_edges([a, b], [1, 3], seed=2)
    for x, y in zip(out[True], out[False]):
        for k in x:
            torch.testing.assert_close(x[k], y[k], atol=1e-5, rtol=0)


# -- the benches on the CPU -------------------------------------------------


def test_scenarios_bench_runs_every_new_family_on_the_cpu(capsys):
    for name in ("async_dropout", "fleet_uniform", "hier_heavy_tail"):
        out = scenarios.main(["--scenario", name, "--rounds", "1",
                              "--edges", "4", "--epochs", "1", "1", "1",
                              "--device", "cpu"])
        assert len(out[name]) == 1
        assert f"scenario_{name}_bkd," in capsys.readouterr().out


def test_async_bench_on_the_cpu_equals_the_jax_timelines():
    """One async scenario and both hier ones through the port's bench (bkd
    and kd), the timeline stats equal to the JAX simulators', and the 100k-edge
    fleet timeline within its budget; the exit rule over the report."""
    report = {"config": {"rounds": 1, "methods": ["bkd", "kd"]},
              "scenarios": {}}
    for name in ("async_heavy_tail",) + jscheduler.HIER_SCENARIOS:
        out = async_bench.bench_scenario(
            name, methods=("bkd", "kd"), rounds=1, num_edges=4,
            aggregation_r=2, seed=0, epochs=(1, 1, 1), device="cpu")
        sim = jscheduler.build_scenario(name, 4, aggregation_r=2, seed=0)
        plans = sim.plans(1)
        want = dict(sim.stats, teachers_per_round=[
            len(p.tasks) for p in plans
            if getattr(p, "level", "") != "region"])
        assert out["timeline"] == want
        assert set(out["methods"]) == {"bkd", "kd"} and "bkd_minus_kd" in out
        report["scenarios"][name] = out
    report["fleet_scale"] = async_bench.bench_fleet_scale(True)
    assert report["fleet_scale"]["within_budget"]
    assert report["fleet_scale"]["hierarchical"]["core_rounds"] == 20
    staleness = [s["timeline"]["max_staleness"]
                 for s in report["scenarios"].values()]
    assert async_bench.passes(report) == any(m > 0 for m in staleness)


def test_transport_bench_sim_accounting_equals_the_jax_bench():
    """``bench_sim_accounting``'s two gates hold and its numbers, the core
    payload counted from the port's MLP included, equal the JAX bench's."""
    from benchmarks import transport_bench as jtransport_bench
    got = transport_bench.bench_sim_accounting(seed=0)
    assert got == jtransport_bench.bench_sim_accounting(seed=0)
    assert got["heap_fleet_bit_identical"]
    assert got["hierarchical"]["split_consistent"]
    assert transport_bench.SCENARIO_NAMES == jtransport_bench.SCENARIO_NAMES
