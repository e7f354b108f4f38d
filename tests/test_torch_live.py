"""The PyTorch port's live system (``repro_torch.live``) and its fused
checkpoints, on the CPU.

* ``lm_fl_data`` gives the JAX package's arrays exactly; ``nll_on`` agrees
  with the JAX function on carried weights.
* A quantum-driven ``LiveTrainer`` equals ``FederatedKD.run`` bit for bit
  (withdraw rounds included).
* The fused checkpoint: a ``LiveSystem`` saved mid-round, mid-epoch and
  mid-stream, restored into a fresh system and resumed ends bit-identical
  to the uninterrupted run: state, history, tokens, clock, swap log,
  swap records and uplink log.
* Engine carry/restore, dense and paged, resumes to the uninterrupted
  tokens (the JAX package's ``tests/test_live.py`` case on the port).
* The sampling-state deviation: the port writes its generator's state as
  ``engine/generator`` and the JAX engine's unadvanced greedy key as
  ``engine/key``; a checkpoint without ``engine/generator`` (one the JAX
  package wrote) restores a greedy engine and is refused by a sampling one.

Cross-package runs of the whole live system are in
``tests/test_torch_live_jax.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.live import lm as jlm  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import build_stream as jbuild_stream  # noqa: E402
from repro_torch.checkpoint import io, save_tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.fl import FederatedKD, FLConfig, mlp_adapter  # noqa: E402
from repro_torch.data import (Dataset, dirichlet_partition,  # noqa: E402
                              make_synthetic_classification)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.live import (LiveSystem, LiveTrainer, lm_adapter,  # noqa: E402
                              lm_fl_data, nll_on)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _cfg(lib_registry=registry):
    """Granite SMOKE with three attention layers (the JAX test's
    ``_lm_setup``)."""
    cfg = lib_registry.get_smoke_config("granite-3-2b")
    return dataclasses.replace(cfg, block_pattern=("attn",) * 3)


# -- the LM adapter and data ------------------------------------------------


def test_lm_fl_data_equals_jax_and_nll_on_agrees():
    cfg, jcfg = _cfg(), _cfg(jregistry)
    ours = lm_fl_data(cfg, num_edges=2, seq_len=8, n_seqs=96, seed=5)
    theirs = jlm.lm_fl_data(jcfg, num_edges=2, seq_len=8, n_seqs=96, seed=5)
    for a, b in zip([ours[0], *ours[1], ours[2]],
                    [theirs[0], *theirs[1], theirs[2]]):
        assert isinstance(a, Dataset)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert ours[3].keys() == theirs[3].keys()
    for k in ours[3]:
        np.testing.assert_array_equal(ours[3][k], theirs[3][k])
    with mesh_context(make_test_mesh()):
        jparams, _ = JTransformer.init(jcfg, jax.random.key(1))
        want = jlm.nll_on(jcfg, jparams, theirs[3]["core"])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got = nll_on(cfg, params, ours[3]["core"])
    assert abs(got - want) <= 1e-5, (got, want)
    # the adapter: the last position's logits over the real vocabulary
    lg, st = lm_adapter(cfg).logits(params, torch.as_tensor(ours[0].x[:3]),
                                    False)
    assert lg.shape == (3, cfg.vocab_size) and st is params
    with pytest.raises(ValueError, match="decoder"):
        lm_adapter(registry.get_smoke_config("hubert-xlarge"))


# -- LiveTrainer == FederatedKD.run -----------------------------------------


@pytest.fixture(scope="module")
def mlp_setup():
    x, y = make_synthetic_classification(num_classes=6, dim=16,
                                         per_class=150, seed=0)
    parts = dirichlet_partition(y[200:], 4, alpha=1.0, seed=1)
    core = Dataset(x[200:][parts[0]], y[200:][parts[0]])
    edges = [Dataset(x[200:][p], y[200:][p]) for p in parts[1:]]
    return mlp_adapter(16, 32, 6), core, edges, Dataset(x[:200], y[:200])


def _mk_fl(setup, **kw):
    adapter, core, edges, test = setup
    base = dict(num_edges=3, rounds=2, method="bkd", core_epochs=2,
                edge_epochs=2, kd_epochs=2, batch_size=64, seed=0)
    return FederatedKD(adapter, FLConfig(**{**base, **kw}), core, edges,
                       test, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"straggler": "alternate",
                                     "withdraw": True}])
def test_live_trainer_matches_monolithic_run(mlp_setup, kw):
    fl_ref = _mk_fl(mlp_setup, **kw)
    state_ref, hist_ref = fl_ref.run(0, log=None)
    for quantum in (1, 3):
        fl = _mk_fl(mlp_setup, **kw)
        trainer = LiveTrainer(fl, 0, log=None)
        while trainer.pending():
            trainer.step(quantum)
        assert trainer.rounds_done == fl.cfg.rounds
        assert trainer.next_plan() is None
        assert trainer.last_record is fl.history[-1]
        assert_tree_equal(trainer.state, state_ref)
        assert [h.as_dict() for h in fl.history] == \
            [h.as_dict() for h in hist_ref]


# -- the fused live checkpoint ----------------------------------------------


def _lm_setup(rounds=2):
    cfg = _cfg()
    core, edges, test, _ = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                      n_seqs=96, seed=0)
    flcfg = FLConfig(num_edges=2, rounds=rounds, method="bkd", core_epochs=1,
                     edge_epochs=1, kd_epochs=2, batch_size=8, seed=0)
    return cfg, flcfg, core, edges, test


def _mk_system(cfg, flcfg, core, edges, test, **engine_kw):
    fl = FederatedKD(lm_adapter(cfg), flcfg, core, edges, test, device="cpu")
    trainer = LiveTrainer(fl, 0, log=None)
    engine = ServeEngine(cfg, trainer.state, slots=2, max_len=32,
                         device="cpu", **engine_kw)
    return LiveSystem(trainer, engine, quantum=1)


def _lm_stream(cfg, seed=3):
    return build_stream("poisson", 5, vocab=cfg.vocab_size, seed=seed,
                        prompt_max=10, out_max=4)


def _run_to_save_point(system, stream, path):
    """Co-run until mid-round, mid-epoch (``st.i > 0``, ``st._idx`` set)
    and save there; returns True if a save point came."""
    eng, tr = system.engine, system.trainer
    eng.begin(stream, log=None)
    while eng.pending() or tr.pending():
        if eng.pending():
            eng.tick()
        if tr.pending():
            system._train_quantum()
        st = tr._stepper
        if (tr.mid_round and st is not None and st.i > 0
                and st._idx is not None):
            system.save(path)
            return True
    return False


@pytest.mark.parametrize("sample", ["greedy", "topk"])
def test_live_checkpoint_save_restore_resume_bit_identical(tmp_path, sample):
    """Run A straight; run B to a mid-round, mid-epoch, mid-stream point and
    save; restore into a fresh system C and resume: C ends bit-identical
    to A.  ``topk`` carries the sampling generator's state across."""
    setup = _lm_setup()
    kw = {} if sample == "greedy" else dict(sample="topk", top_k=5, seed=7)
    path = str(tmp_path / "live.npz")
    sys_a = _mk_system(*setup, **kw)
    done_a = sys_a.run(_lm_stream(setup[0]), log=None)

    sys_b = _mk_system(*setup, **kw)
    assert _run_to_save_point(sys_b, _lm_stream(setup[0]), path)
    meta = io.load_meta(path)
    assert meta["trainer"]["stepper"]["mid_epoch"]
    assert sys_b.engine.pending()

    sys_c = _mk_system(*setup, **kw)
    reqs_c = _lm_stream(setup[0])
    sys_c.restore(path, reqs_c)
    done_c = sys_c.run(reqs_c, log=None, resume=True)

    assert_tree_equal(sys_c.trainer.state, sys_a.trainer.state)
    assert [h.as_dict() for h in sys_c.trainer.fl.history] == \
        [h.as_dict() for h in sys_a.trainer.fl.history]
    assert {r.rid: r.out for r in done_c} == {r.rid: r.out for r in done_a}
    assert sys_c.engine.ticks == sys_a.engine.ticks
    assert sys_c.engine.swap_log == sys_a.engine.swap_log
    assert sys_c.swap_records == sys_a.swap_records
    assert sys_c.trainer.fl.distill_engine.uplink_log == \
        sys_a.trainer.fl.distill_engine.uplink_log


def test_full_round_stepper_checkpoint_replays(tmp_path):
    """A FedAvg-style round holds no stepper arrays: saved mid-round, its
    meta has ``stepper: None`` and restore replays the round from the
    restored state, ending where the uninterrupted trainer does."""
    cfg, flcfg, core, edges, test = _lm_setup()
    flcfg = dataclasses.replace(flcfg, method="fedavg")

    def mk():
        return LiveTrainer(FederatedKD(lm_adapter(cfg), flcfg, core, edges,
                                       test, device="cpu"), 0, log=None)

    ref = mk()
    ref.run()
    tr = mk()
    tr.start_round()
    tree, meta = tr.carry()
    assert meta["round_started"] and meta["stepper"] is None
    assert "stepper" not in tree
    path = str(tmp_path / "fedavg")
    save_tree(path, tree, meta)
    resumed = mk()
    resumed.restore(path, meta)
    resumed.run()
    assert_tree_equal(resumed.state, ref.state)
    assert [h.as_dict() for h in resumed.fl.history] == \
        [h.as_dict() for h in ref.fl.history]


# -- engine carry/restore ---------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_engine_carry_restore_resume_bit_identical(tmp_path, paged):
    """Save mid-stream (in-flight slots and queued requests; page tables,
    allocator books and admissions when paged), restore into a fresh
    engine, resume: tokens, clock and (paged) the allocator snapshot and
    host page table equal an uninterrupted run's."""
    cfg = _cfg()
    params = Transformer.init(cfg, 0, device="cpu")
    path = str(tmp_path / "engine.npz")
    mk_reqs = lambda: build_stream("bursty", 8, vocab=cfg.vocab_size,  # noqa: E731
                                   seed=13, prompt_max=18, out_max=6,
                                   shared_prefix=10)
    kw = dict(paged=True, page_size=8) if paged else {}

    def mk_engine():
        return ServeEngine(cfg, params, slots=2, max_len=64, device="cpu",
                           **kw)

    eng_a = mk_engine()
    done_a = eng_a.run(mk_reqs(), log=None)
    eng_b = mk_engine()
    eng_b.begin(mk_reqs(), log=None)
    while not (any(r is not None for r in eng_b._host_active)
               and eng_b._queue):
        eng_b.tick()
        assert eng_b.pending(), "stream drained before a save point"
    tree, meta = eng_b.carry()
    assert meta["queue_cursor"] == eng_b.queue_cursor > 0
    save_tree(path, {"engine": tree}, meta)
    eng_c = mk_engine()
    eng_c.restore(path, meta, mk_reqs())
    while eng_c.pending():
        eng_c.tick()
    assert {r.rid: r.out for r in eng_c._finished} == \
        {r.rid: r.out for r in done_a}
    assert eng_c.ticks == eng_a.ticks
    if paged:
        assert eng_c._alloc.snapshot() == eng_a._alloc.snapshot()
        assert np.array_equal(eng_c._pt_host, eng_a._pt_host)
    with pytest.raises(ValueError, match="restore stream has 7"):
        mk_engine().restore(path, meta, mk_reqs()[:7])


def test_begin_rebases_unless_asked_not_to():
    cfg = _cfg()
    engine = ServeEngine(cfg, Transformer.init(cfg, 0, device="cpu"), slots=2, max_len=32,
                         device="cpu")
    engine.run(_lm_stream(cfg))
    ticks = engine.ticks
    engine.begin(_lm_stream(cfg))
    assert engine._base == ticks and engine.queue_cursor == 0
    engine.begin(_lm_stream(cfg), rebase=False)
    assert engine._base == 0 and engine._queue_total == 5


# -- the sampling-state deviation -------------------------------------------


@pytest.fixture(scope="module")
def jax_engine_checkpoint(tmp_path_factory):
    """A greedy JAX engine saved mid-stream (in-flight slots, queued
    requests), and the JAX engine's uninterrupted tokens on that stream."""
    jcfg = _cfg(jregistry)
    path = str(tmp_path_factory.mktemp("jax_engine") / "engine.npz")
    mk = lambda: jbuild_stream("bursty", 6, vocab=jcfg.vocab_size,  # noqa: E731
                               seed=13, prompt_max=14, out_max=5)
    from repro.checkpoint import io as jio
    with mesh_context(make_test_mesh()):
        jparams, _ = JTransformer.init(jcfg, jax.random.key(0))
        eng = JServeEngine(jcfg, jparams, slots=2, max_len=32)
        want = {r.rid: r.out for r in eng.run(mk(), log=None)}
        eng.reset()
        eng.begin(mk(), log=None)
        while not (any(r is not None for r in eng._host_active)
                   and eng._queue):
            eng.tick()
        tree, meta = eng.carry()
        jio.save_tree(path, {"engine": tree}, meta)
    return path, meta, jax.tree.map(np.asarray, jparams), want


def test_sampling_key_deviation_is_pinned(tmp_path, jax_engine_checkpoint):
    """The port writes ``engine/key`` as the JAX engine's greedy key
    ``[0, seed]`` (uint32) and its generator's state as
    ``engine/generator``.  A JAX-written checkpoint (no generator) restores
    a greedy port engine, which resumes to the JAX engine's tokens, and is
    refused by a sampling engine."""
    path, meta, weights, want = jax_engine_checkpoint
    cfg = _cfg()
    params = params_from_numpy(weights, "cpu")
    with np.load(path) as data:
        assert "engine/generator" not in data.files
        np.testing.assert_array_equal(data["engine/key"], [0, 0])
    reqs = build_stream("bursty", 6, vocab=cfg.vocab_size, seed=13,
                        prompt_max=14, out_max=5)
    engine = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    engine.restore(path, meta, reqs)
    while engine.pending():
        engine.tick()
    assert {r.rid: r.out for r in engine._finished} == want
    sampler = ServeEngine(cfg, params, slots=2, max_len=32, sample="topk",
                          top_k=4, device="cpu")
    with pytest.raises(ValueError, match="engine/generator"):
        sampler.restore(path, meta, build_stream(
            "bursty", 6, vocab=cfg.vocab_size, seed=13, prompt_max=14,
            out_max=5))
    # The port's own checkpoint carries both leaves.
    tree, _ = ServeEngine(cfg, params, slots=2, max_len=32, seed=5,
                          device="cpu").carry()
    assert tree["key"].dtype == np.uint32 and list(tree["key"]) == [0, 5]
    assert tree["generator"].dtype == torch.uint8


# -- the bench and the example ----------------------------------------------


def test_live_bench_smoke_and_example_run_on_cpu(tmp_path, capsys):
    """``live_bench --smoke`` exits 0 (every co-run finished its rounds,
    committed swaps, finite NLLs) with the reference's report keys; the
    example serves its stream through its hot swaps."""
    from repro_torch.benchmarks import live_bench
    from repro_torch.examples import live_system
    out = tmp_path / "live.json"
    assert live_bench.main(["--smoke", "--device", "cpu", "--requests", "4",
                            "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report["config"]) == {
        "smoke", "arch", "rounds", "requests", "slots", "max_len", "quantum",
        "seed", "methods", "backend"}
    assert set(report["streams"]) == {"diurnal", "heavy_tail"}
    for entry in report["streams"].values():
        assert set(entry) == {"serve_only_cold", "serve_only",
                              "eval_nll_core_pretrain", "bkd", "kd"}
        for method in ("bkd", "kd"):
            assert set(entry[method]) == {
                "serve", "overhead_vs_serve_only", "swaps",
                "drift_nll_per_swap", "final_nll_minus_pretrain"}
            assert len(entry[method]["drift_nll_per_swap"]) == \
                sum(s["swap"] is not None for s in entry[method]["swaps"])
    system = live_system.main(["--device", "cpu", "--rounds", "2",
                               "--requests", "4"])
    assert system.trainer.rounds_done == 2 and system.engine.swaps == 2
    assert "== swap ==" in capsys.readouterr().out
