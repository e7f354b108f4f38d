"""Algorithm 1 in the PyTorch port against the JAX package, on the CPU.

The numpy-only copies (data, partition, pipeline, scheduler, the Phase-1
batch plan) must equal their originals on the same seeds; the losses, the
optimizer and the buffer agree within 1e-5; one Phase-2 round of every
registered method, from the same carried MLP states, agrees within 1e-4;
and a reduced quickstart run agrees round by round.  States are initialised
by the JAX package and carried over (``repro_torch.interop``), because the
two packages' random generators cannot agree.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jaggregation  # noqa: E402
from repro.core import buffer as jbuffer  # noqa: E402
from repro.core import distill as jdistill  # noqa: E402
from repro.core import fl as jfl  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core import vectorized as jvectorized  # noqa: E402
from repro.core.distill_engine import DistillEngine as JDistillEngine  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.core import aggregation, buffer, distill, fl, scheduler  # noqa: E402
from repro_torch.core import vectorized  # noqa: E402
from repro_torch.core.distill_engine import DistillEngine  # noqa: E402
from repro_torch.data import partition, pipeline, synthetic  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.live.trainer import LiveTrainer  # noqa: E402

# Losses: f32 sums in another order than XLA's, ~1e-7 relative.
LOSS_TOL = 1e-5
# One Phase-2 round of an MLP: a few dozen SGD steps, each moving the
# parameters by ~lr * grad with grads ~1e-7 apart; 1e-4 absolute.
ROUND_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


# -- numpy-only copies: equal on the same seeds --------------------------------


def test_data_copies_equal_the_originals():
    for kw in (dict(), dict(num_classes=7, dim=5, per_class=31,
                            sub_clusters=2, seed=4)):
        for a, b in zip(synthetic.make_synthetic_classification(**kw),
                        jsynthetic.make_synthetic_classification(**kw)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.make_cifar_like(num_classes=10, n=50, seed=2),
                    jsynthetic.make_cifar_like(num_classes=10, n=50, seed=2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.make_token_stream(300, 4, 9, 2, seed=1),
                    jsynthetic.make_token_stream(300, 4, 9, 2, seed=1)):
        np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(0).integers(0, 10, 500)
    for a, b in zip(partition.dirichlet_partition(y, 6, alpha=1.0, seed=1),
                    jpartition.dirichlet_partition(y, 6, alpha=1.0, seed=1)):
        np.testing.assert_array_equal(a, b)
    x = np.arange(130 * 3, dtype=np.float32).reshape(130, 3)
    ds, jds = pipeline.Dataset(x, y[:130]), jpipeline.Dataset(x, y[:130])
    for kw in (dict(indices_only=True), dict(with_indices=True),
               dict(drop_remainder=False)):
        got = list(pipeline.batches(ds, 32, seed=5, epochs=2, **kw))
        want = list(jpipeline.batches(jds, 32, seed=5, epochs=2, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                np.testing.assert_array_equal(a, b)


def _plans(plans):
    return [(p.round_idx, [(t.edge_id, t.staleness) for t in p.tasks],
             p.withdraw, p.straggler) for p in plans]


@pytest.mark.parametrize("straggler,withdraw,r", [
    ("none", False, 1), ("alternate", False, 2), ("alternate", True, 1),
    ("frozen_w0", False, 3)])
def test_scheduler_from_config_equals_the_original(straggler, withdraw, r):
    kw = dict(num_edges=5, aggregation_r=r, straggler=straggler,
              withdraw=withdraw)
    got = scheduler.RoundScheduler.from_config(fl.FLConfig(**kw)).plans(7)
    want = jscheduler.RoundScheduler.from_config(jfl.FLConfig(**kw)).plans(7)
    assert _plans(got) == _plans(want)
    assert scheduler.max_retained_staleness(got) == \
        jscheduler.max_retained_staleness(want)


@pytest.mark.parametrize("name", ["none", "alternate", "frozen_w0",
                                  "withdraw_alternate", "random_sampling",
                                  "partial_participation", "random_delay"])
def test_sync_scenarios_equal_the_originals(name):
    got = scheduler.build_scenario(name, 6, aggregation_r=2, seed=3).plans(9)
    want = jscheduler.build_scenario(name, 6, aggregation_r=2,
                                     seed=3).plans(9)
    assert _plans(got) == _plans(want)
    assert set(scheduler.SCENARIOS) == set(jscheduler.SCENARIOS)


def test_batch_plan_equals_the_original():
    rng = np.random.default_rng(0)
    dss = [pipeline.Dataset(rng.standard_normal((n, 4)).astype(np.float32),
                            rng.integers(0, 3, n)) for n in (70, 41, 99)]
    got = vectorized.build_batch_plan(dss, 32, 3, seed=7)
    want = jvectorized.build_batch_plan(dss, 32, 3, seed=7)
    for f in ("x", "y", "idx", "valid", "boundaries"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert vectorized.build_batch_plan(dss + [dss[0].subset(np.arange(9))],
                                       32, 1, seed=0) is None


# -- losses, optimizer, buffer, aggregation ---------------------------------


def _logits(seed, shape=(6, 12), scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_distill_losses_match_jax():
    s, t, b = _logits(0), _logits(1), _logits(2)
    tls = np.stack([_logits(3), _logits(4), _logits(5)])
    y = np.random.default_rng(6).integers(0, 10, 6)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    tau = 2.0
    J, T = jnp.asarray, _t
    pairs = [
        (distill.ce_loss(T(s), T(y)), jdistill.ce_loss(J(s), J(y))),
        (distill.ce_loss(T(s), T(y), vocab=10, mask=T(mask)),
         jdistill.ce_loss(J(s), J(y), vocab=10, mask=J(mask))),
        (distill.kl_soft(T(s), T(t), tau, vocab=10, mask=T(mask)),
         jdistill.kl_soft(J(s), J(t), tau, vocab=10, mask=J(mask))),
        (distill.ensemble_probs(T(tls), tau),
         jdistill.ensemble_probs(J(tls), tau)),
        (distill.ensemble_probs([T(a) for a in tls], tau, vocab=10),
         jdistill.ensemble_probs([J(a) for a in tls], tau, vocab=10)),
        (distill.kl_soft_vs_probs(T(s), distill.ensemble_probs(T(tls), tau),
                                  tau),
         jdistill.kl_soft_vs_probs(J(s), jdistill.ensemble_probs(J(tls), tau),
                                   tau)),
        (distill.l_kd(T(s), T(tls[:1]), T(y), tau),
         jdistill.l_kd(J(s), J(tls[:1]), J(y), tau)),
        (distill.l_kd(T(s), T(tls), T(y), tau, mask=T(mask)),
         jdistill.l_kd(J(s), J(tls), J(y), tau, mask=J(mask))),
        (distill.l_bkd(T(s), [T(t)], T(b), T(y), tau),
         jdistill.l_bkd(J(s), [J(t)], J(b), J(y), tau)),
        (distill.topk_kl(T(s), T(t), tau, 4, vocab=10),
         jdistill.topk_kl(J(s), J(t), tau, 4, vocab=10)),
        (distill.factor_loss(T(s), T(t), T(np.eye(12, dtype=np.float32)
                                           * 0.5 + 0.1)),
         jdistill.factor_loss(J(s), J(t), J(np.eye(12, dtype=np.float32)
                                            * 0.5 + 0.1))),
    ]
    fns = [lambda h: h * 1.0, lambda h: h * 0.5]
    pairs.append((distill.chunked_token_bkd(
        fns[0], fns[1], fns[0], [T(s), T(t)], [T(y), T(y)], tau, 10),
        jdistill.chunked_token_bkd(fns[0], fns[1], fns[0], [J(s), J(t)],
                                   [J(y), J(y)], tau, 10)))
    for got, want in pairs:
        _close(got, np.asarray(want), LOSS_TOL)
    tv, ti = jax.lax.top_k(J(b), 4)
    tail = jax.scipy.special.logsumexp(J(b), axis=-1) - 0.3
    _close(distill.topk_kl_cached(T(s), T(tv), T(ti), T(tail), tau),
           np.asarray(jdistill.topk_kl_cached(J(s), tv, ti, tail, tau)),
           LOSS_TOL)
    _close(distill.ema_update({"a": T(s)}, {"a": T(t)}, 0.9),
           _np(jdistill.ema_update({"a": J(s)}, {"a": J(t)}, 0.9)), LOSS_TOL)


def test_optimizers_match_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(3).astype(np.float32)}}
    grads = jax.tree.map(lambda a: (a * 0.3 + 0.1).astype(np.float32), params)
    cases = [(optim.sgd_momentum(optim.step_decay(0.1, [2, 3])),
              joptim.sgd_momentum(joptim.step_decay(0.1, [2, 3]))),
             (optim.sgd_momentum(0.05, nesterov=True, weight_decay=0.01),
              joptim.sgd_momentum(0.05, nesterov=True, weight_decay=0.01)),
             (optim.adamw(optim.cosine_schedule(0.01, 6, warmup=2)),
              joptim.adamw(joptim.cosine_schedule(0.01, 6, warmup=2)))]
    for opt, jopt in cases:
        p, jp = params_from_numpy(params, "cpu"), jax.tree.map(jnp.asarray,
                                                               params)
        st, jst = opt.init(p), jopt.init(jp)
        for i in range(5):
            p, st = opt.update(params_from_numpy(grads, "cpu"), st, p, i)
            jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                                  jnp.asarray(i))
        _close(params_to_numpy(p), _np(jp), LOSS_TOL)
        _close(params_to_numpy(st), _np(jst), LOSS_TOL)


def _mlp_state(seed, in_dim=8, hidden=16, classes=5):
    return _np(jfl.mlp_adapter(in_dim, hidden, classes).init(
        jax.random.key(seed)))


def test_buffer_and_averaging_match_jax():
    jadapter, adapter = jfl.mlp_adapter(8, 16, 5), fl.mlp_adapter(8, 16, 5)
    state = _mlp_state(0)
    rng = np.random.default_rng(1)
    ds = pipeline.Dataset(rng.standard_normal((70, 8)).astype(np.float32),
                          rng.integers(0, 5, 70))
    want = jbuffer.core_logits(jadapter, state, ds, batch=32)
    got = buffer.core_logits(adapter, params_from_numpy(state, "cpu"), ds,
                             batch=32)
    _close(got, np.asarray(want), LOSS_TOL)
    jc = jbuffer.precompute_logits(jadapter, state, ds, batch=32, topk=3)
    c = buffer.precompute_logits(adapter, params_from_numpy(state, "cpu"), ds,
                                 batch=32, topk=3)
    (tv, ti, tail), (jtv, jti, jtail) = (c.lookup(np.arange(10, 40)),
                                         jc.lookup(np.arange(10, 40)))
    _close(tv, np.asarray(jtv), LOSS_TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    # The tail lse is log(1 - exp(top_lse - full_lse)) + full_lse: the
    # subtraction of two near-equal numbers turns 1e-7 apart into ~1e-5.
    _close(tail, np.asarray(jtail), 1e-4)
    _close(buffer.reconstruct_logits(c.lookup(slice(0, 9)), 5),
           np.asarray(jbuffer.reconstruct_logits(jc.lookup(slice(0, 9)), 5)),
           LOSS_TOL)
    states = [_mlp_state(s) for s in (1, 2, 3)]
    _close(aggregation.average_params(
        [params_from_numpy(s, "cpu") for s in states], [3, 1, 2]),
        _np(jaggregation.average_params(states, [3, 1, 2])), LOSS_TOL)


# -- Phase 2: one round per method, from carried states -------------------------


def _phase2_setup():
    """A small MLP core set, a student state and two teacher states, all
    initialised by the JAX package."""
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=5, dim=8, per_class=60, sub_clusters=2, seed=2)
    core = jpipeline.Dataset(x[:200], y[:200])
    return core, _mlp_state(10), [_mlp_state(11), _mlp_state(12)]


@pytest.mark.parametrize("method,backend", [
    ("kd", "jnp"), ("bkd", "jnp"), ("ema", "jnp"), ("melting", "jnp"),
    ("ft", "jnp"), ("bkd_cached", "jnp"), ("fedavg", "jnp"),
    ("feddf", "jnp"), ("kd", "pallas"), ("bkd", "pallas"),
    ("bkd_cached", "topk_cached")])
def test_one_phase2_round_per_method_matches_jax(method, backend):
    """Two epochs over 200 core samples (batch 64) distilling two teachers;
    the port's "pallas" backend runs the kernels' plain versions here and
    is held against the JAX package's plain losses."""
    core, student, teachers = _phase2_setup()
    kw = dict(method=method, kd_epochs=2, batch_size=64, tau=2.0,
              kd_lr=0.05, seed=3, loss_backend=backend)
    jadapter = jfl.mlp_adapter(8, 16, 5)
    adapter = fl.mlp_adapter(8, 16, 5)
    want = JDistillEngine(jadapter, jfl.FLConfig(
        **{**kw, "loss_backend": "jnp" if backend == "pallas" else backend}),
        core).run(jax.tree.map(jnp.asarray, student),
                  [jax.tree.map(jnp.asarray, t) for t in teachers], 1,
                  teacher_weights=[120, 80])
    engine = DistillEngine(adapter, fl.FLConfig(**kw), core, "cpu")
    got = engine.run(params_from_numpy(student, "cpu"),
                     [params_from_numpy(t, "cpu") for t in teachers], 1,
                     teacher_weights=[120, 80])
    _close(params_to_numpy(got), _np(want), ROUND_TOL)


def test_phase2_chunked_stepper_and_scan_false_equal_the_epoch_loop():
    core, student, teachers = _phase2_setup()
    adapter = fl.mlp_adapter(8, 16, 5)
    cfg = fl.FLConfig(method="bkd", kd_epochs=2, batch_size=64, seed=3)
    args = (params_from_numpy(student, "cpu"),
            [params_from_numpy(t, "cpu") for t in teachers], 2)
    want = DistillEngine(adapter, cfg, core, "cpu").run(*args)
    stepper = DistillEngine(adapter, cfg, core, "cpu").stepper(*args)
    while not stepper.finished:
        stepper.step(max_steps=2)
    assert stepper.steps_done == 2 * (200 // 64)
    no_scan = DistillEngine(adapter, dataclasses.replace(cfg, scan=False),
                            core, "cpu").run(*args)
    for got in (stepper.result, no_scan):
        _close(params_to_numpy(got), params_to_numpy(want), 0.0)


# -- Phase 1 and the whole run ----------------------------------------------


def _quickstart_setup():
    """The quickstart's data at a third of its size."""
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=10, dim=32, per_class=120, sub_clusters=3, seed=0)
    parts = jpartition.dirichlet_partition(y[200:], 4, alpha=1.0, seed=1)
    core = jpipeline.Dataset(x[200:][parts[0]], y[200:][parts[0]])
    edges = [jpipeline.Dataset(x[200:][p], y[200:][p]) for p in parts[1:]]
    return core, edges, jpipeline.Dataset(x[:200], y[:200])


def test_vectorized_phase1_equals_sequential_and_jax():
    core, edges, test = _quickstart_setup()
    adapter = fl.mlp_adapter(32, 64, 10)
    init = params_from_numpy(_mlp_state(0, 32, 64, 10), "cpu")
    cfg = fl.FLConfig(num_edges=3, edge_epochs=2, batch_size=64)
    out = {}
    for vec in (True, False):
        f = fl.FederatedKD(adapter, dataclasses.replace(cfg, vectorize=vec),
                           core, edges, test, device="cpu")
        out[vec] = f.train_round_edges([init, init, init], [0, 1, 2], seed=5)
    jf = jfl.FederatedKD(jfl.mlp_adapter(32, 64, 10), jfl.FLConfig(
        num_edges=3, edge_epochs=2, batch_size=64), core, edges, test)
    jinit = jax.tree.map(jnp.asarray, _mlp_state(0, 32, 64, 10))
    want = jf.train_round_edges([jinit] * 3, [0, 1, 2], seed=5)
    for a, b, w in zip(out[True], out[False], want):
        # Batched and per-edge matmuls sum in other orders: ~1e-7 apart.
        _close(params_to_numpy(a), params_to_numpy(b), 1e-5)
        _close(params_to_numpy(a), _np(w), ROUND_TOL)


@pytest.mark.parametrize("method", ["kd", "bkd"])
def test_reduced_quickstart_matches_jax_round_by_round(method):
    """Two rounds of the quickstart at a third of its data, from the JAX
    package's initial state.  Per-round test accuracy agrees within 0.02
    absolute (4 of 200 test samples): the two packages' float32 sums differ
    by ~1e-6 per step (the reference itself moves that much with batch
    shape), and over ~100 steps that can flip a few test samples sitting
    on a decision boundary."""
    core, edges, test = _quickstart_setup()
    kw = dict(num_edges=3, rounds=2, method=method, tau=2.0, core_epochs=3,
              edge_epochs=3, kd_epochs=2, batch_size=64, seed=0)
    jadapter = jfl.mlp_adapter(32, 64, 10)
    jstate0 = jadapter.init(jax.random.key(0))
    _, jhist = jfl.FederatedKD(jadapter, jfl.FLConfig(**kw), core, edges,
                               test).run(jax.random.key(0), log=None)
    adapter = dataclasses.replace(
        fl.mlp_adapter(32, 64, 10),
        init=lambda gen, device: params_from_numpy(_np(jstate0), device))
    _, hist = fl.FederatedKD(adapter, fl.FLConfig(**kw), core, edges, test,
                             device="cpu").run(0, log=None)
    assert [h.round for h in hist] == [h.round for h in jhist]
    for h, jh in zip(hist, jhist):
        assert abs(h["test_acc"] - jh["test_acc"]) <= 0.02
        assert abs(h["acc_cur_edge"] - jh["acc_cur_edge"]) <= 0.02
        assert h.keys() == jh.keys()
    assert kd.kd_stats_fwd.launches == 0


def test_live_trainer_in_chunks_equals_run():
    core, edges, test = _quickstart_setup()
    cfg = fl.FLConfig(num_edges=3, rounds=2, method="bkd", core_epochs=1,
                      edge_epochs=1, kd_epochs=2, batch_size=64)
    adapter = fl.mlp_adapter(32, 64, 10)
    f = fl.FederatedKD(adapter, cfg, core, edges, test, device="cpu")
    want, whist = f.run(1, log=None)
    f2 = fl.FederatedKD(adapter, cfg, core, edges, test, device="cpu")
    trainer = LiveTrainer(f2, 1, log=None)
    while trainer.pending():
        trainer.step(max_steps=1)
    _close(params_to_numpy(trainer.state), params_to_numpy(want), 0.0)
    assert [h.as_dict() for h in f2.history] == [h.as_dict() for h in whist]


def test_port_entry_points_and_unported_paths():
    core, edges, test = _quickstart_setup()
    adapter = fl.mlp_adapter(32, 64, 10)
    cfg = fl.FLConfig(num_edges=3, rounds=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fl.FederatedKD(adapter, cfg, core, edges, test)
        with pytest.raises(RuntimeError, match="cuda"):
            aggregation.FedAvg(adapter, aggregation.FedAvgConfig(), edges,
                               test)
    with pytest.raises(ValueError, match="registered codecs"):
        fl.FederatedKD(adapter, dataclasses.replace(cfg, transport="gzip"),
                       core, edges, test, device="cpu")
    fl.FederatedKD(adapter, dataclasses.replace(cfg, transport="int8"),
                   core, edges, test, device="cpu")
    # The async scenarios are ported: a plan source like the sync ones.
    sim = scheduler.build_scenario("async_uniform", 4)
    assert [len(p.tasks) for p in sim.plans(3)] == [1, 1, 1]
    assert sim.stats["rounds"] == 3
    with pytest.raises(ValueError, match="unknown method"):
        fl.FederatedKD(adapter, dataclasses.replace(cfg, method="nope"),
                       core, edges, test, device="cpu")
    trainer = LiveTrainer(fl.FederatedKD(
        adapter, dataclasses.replace(cfg, core_epochs=1), core, edges, test,
        device="cpu"), 0, log=None)
    # The trainer's checkpoint carry is ported (slice 6): it runs.
    tree, meta = trainer.carry()
    assert meta["cursor"] == 0 and not meta["round_started"]
    assert set(tree["trainer"]) == {"state", "w0", "core_log"}


def test_example_and_benchmark_setups_equal_the_originals():
    from benchmarks import common as jcommon
    _, core, edges, test = quickstart.setup()
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=10, dim=32, per_class=360, sub_clusters=3, seed=0)
    np.testing.assert_array_equal(test.x, x[:600])
    parts = jpartition.dirichlet_partition(y[600:], 6, alpha=1.0, seed=1)
    assert [len(e) for e in edges] == [len(p) for p in parts[1:]]
    assert len(core) == len(parts[0])
    for resnet in (False, True):
        got = common.build_setup(seed=1, resnet=resnet)[1:]
        want = jcommon.build_setup(seed=1, resnet=resnet)[1:]
        np.testing.assert_array_equal(got[0].x, want[0].x)
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g.y, w.y)
    hist, _ = common.run_method("bkd", rounds=1, epochs=(1, 1, 1),
                                device="cpu")
    assert len(hist) == 1 and 0.0 <= hist[0]["test_acc"] <= 1.0


@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
def test_standalone_fedavg_matches_jax(prox_mu):
    """Fig. 4's context row: synchronized FedAvg (FedProx with prox_mu > 0)
    over three edge silos, one round of two local epochs each, from the
    JAX package's initial state; parameters within 1e-4."""
    _, edges, test = _quickstart_setup()
    jadapter = jfl.mlp_adapter(32, 64, 10)
    jstate0 = _np(jadapter.init(jax.random.key(4)))
    kw = dict(rounds=1, clients_per_round=3, local_epochs=2, batch_size=64,
              prox_mu=prox_mu, seed=2)
    want, jhist = jaggregation.FedAvg(
        dataclasses.replace(jadapter, init=lambda key: jax.tree.map(
            jnp.asarray, jstate0)),
        jaggregation.FedAvgConfig(**kw), edges, test).run(jax.random.key(4))
    adapter = dataclasses.replace(
        fl.mlp_adapter(32, 64, 10),
        init=lambda gen, device: params_from_numpy(jstate0, device))
    got, hist = aggregation.FedAvg(adapter, aggregation.FedAvgConfig(**kw),
                                   edges, test, device="cpu").run(4)
    _close(params_to_numpy(got), _np(want), ROUND_TOL)
    assert abs(hist[0]["test_acc"] - jhist[0]["test_acc"]) <= 0.02
