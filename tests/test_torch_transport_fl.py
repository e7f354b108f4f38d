"""Phase 2 and whole FL runs of the port under uplink transport, against
the JAX package, on the CPU.

One Phase-2 round of every method under int8/int4 agrees with the JAX
engine's, with equal uplink logs (the fused branch runs the dequant-fused
loss's plain versions here); R=2, the JAX package's own dequant-fused
Pallas kernels (interpret mode) and the streamed codecs agree too; and
identity transport is bit-for-bit no transport for every method.  States
are initialised by the JAX package and carried over
(``repro_torch.interop``).  The codecs and the fused loss alone are held
against the JAX package in ``tests/test_torch_transport.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jbuffer  # noqa: E402
from repro.core import fl as jfl  # noqa: E402
from repro.core.distill_engine import DistillEngine as JDistillEngine  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.benchmarks import transport_bench  # noqa: E402
from repro_torch.core import distill_engine, fl  # noqa: E402
from repro_torch.core.distill_engine import DistillEngine  # noqa: E402
from repro_torch.core.methods import METHODS, resolve_method  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch import transport  # noqa: E402
from repro_torch.transport import codecs  # noqa: E402
from repro_torch.transport import method as tmethod  # noqa: E402
from repro_torch.transport.method import PAYLOAD_KEY  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

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


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


# -- Phase 2 under transport, from carried states -------------------------------


def _mlp_state(seed, in_dim=8, hidden=16, classes=5):
    return _np(jfl.mlp_adapter(in_dim, hidden, classes).init(
        jax.random.key(seed)))


def _phase2_setup():
    """A small MLP core set, a student state and two teacher states, all
    initialised by the JAX package (the same as tests/test_torch_fl.py)."""
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=5, dim=8, per_class=60, sub_clusters=2, seed=2)
    core = jpipeline.Dataset(x[:200], y[:200])
    return core, _mlp_state(10), [_mlp_state(11), _mlp_state(12)]


def _round_pair(method, spec, r=1, jax_backend="jnp"):
    """One Phase-2 round (two epochs, batch 64) of ``method`` under
    ``spec`` with ``r`` teachers in both packages: the port on its kernel
    backend where the method has one (the fused branch, through the plain
    versions on the CPU), the JAX package on ``jax_backend``.  Returns
    (port state, JAX state, port engine, JAX engine)."""
    core, student, teachers = _phase2_setup()
    teachers = teachers[:r]
    backend = ("pallas" if "pallas" in resolve_method(method).supported_backends
               else "jnp")
    kw = dict(method=method, kd_epochs=2, batch_size=64, tau=2.0, kd_lr=0.05,
              seed=3, transport=spec)
    jeng = JDistillEngine(jfl.mlp_adapter(8, 16, 5), jfl.FLConfig(
        **kw, loss_backend=jax_backend if backend == "pallas" else "jnp"),
        core)
    want = jeng.run(jax.tree.map(jnp.asarray, student),
                    [jax.tree.map(jnp.asarray, t) for t in teachers], 1,
                    teacher_weights=[120, 80][:r])
    eng = DistillEngine(fl.mlp_adapter(8, 16, 5),
                        fl.FLConfig(**kw, loss_backend=backend), core, "cpu")
    got = eng.run(params_from_numpy(student, "cpu"),
                  [params_from_numpy(t, "cpu") for t in teachers], 1,
                  teacher_weights=[120, 80][:r])
    return got, want, eng, jeng


@pytest.fixture
def jax_teachers(monkeypatch):
    """Both packages encode the JAX package's teacher logits.

    The two packages' f32 MLP logits differ by up to ~4e-6, and
    quantization is discontinuous: on this core set that flips 4 of 1,000
    int8 codes and 17 of 1,000 int4 codes, each moving a teacher logit by a
    whole step (equal inputs give identical codes, as the codec tests
    show).  So the port's teacher forwards — the per-round encode and the
    step's streamed logits — run through the JAX package's MLP on the same
    state.  Also counts the fused loss's plain forwards and the step's
    teacher forwards."""
    counts = {"fused": 0, "teacher_logits": 0}
    jadapter = jfl.mlp_adapter(8, 16, 5)
    fused = ref.kd_quant_stats_ref

    def jstate(state):
        return jax.tree.map(jnp.asarray, params_to_numpy(state))

    def core_logits(adapter, state, ds, batch=512):
        return _t(jbuffer.core_logits(jadapter, jstate(state), ds, batch))

    def teacher_logits(adapter, tstack, x):
        counts["teacher_logits"] += 1
        xs = jnp.asarray(x.numpy())
        n = next(iter(tstack.values())).shape[0]
        return torch.stack([_t(jadapter.logits(
            jstate({k: v[r] for k, v in tstack.items()}), xs, False)[0])
            for r in range(n)])

    def fused_spy(*a, **k):
        counts["fused"] += 1
        return fused(*a, **k)

    monkeypatch.setattr(tmethod, "core_logits", core_logits)
    monkeypatch.setattr(distill_engine, "teacher_logits", teacher_logits)
    monkeypatch.setattr(ref, "kd_quant_stats_ref", fused_spy)
    return counts


@pytest.mark.parametrize("spec", ["int8", "int4"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_one_phase2_round_per_method_under_quant_matches_jax(method, spec,
                                                             jax_teachers):
    """One teacher: kd, bkd, ema, melting and bkd_cached take the fused
    branch (codes to ``kd_loss_quant``, no teacher forward in the step); ft
    and feddf decode the payload; fedavg ships parameters.  The JAX package
    dequantizes and runs its plain losses, the same value."""
    got, want, eng, jeng = _round_pair(method, spec)
    _close(params_to_numpy(got), _np(want), ROUND_TOL)
    assert eng.uplink_log == jeng.uplink_log
    assert len(eng.uplink_log) == 1 and eng.uplink_bytes_total > 0
    steps = 2 * (200 // 64)
    fused = method in ("kd", "bkd", "ema", "melting", "bkd_cached")
    assert jax_teachers["fused"] == (steps if fused else 0)
    assert jax_teachers["teacher_logits"] == 0


def test_two_teacher_round_decodes_through_the_exact_kernels(jax_teachers):
    """R=2: the payload is decoded to (2, B, V) and the ensemble enters the
    exact kernel pair (their plain versions here) as tau*log(A_f)."""
    got, want, eng, jeng = _round_pair("bkd", "int8", r=2)
    _close(params_to_numpy(got), _np(want), ROUND_TOL)
    assert eng.uplink_log == jeng.uplink_log
    assert eng.uplink_log[0]["teachers"] == 2


def test_fused_round_matches_jax_pallas_interpret(jax_teachers):
    """bkd@int8 against the JAX package's own dequant-fused Pallas kernels
    (interpret mode) rather than its dequantize-then-plain branch."""
    got, want, eng, jeng = _round_pair("bkd", "int8", jax_backend="pallas")
    _close(params_to_numpy(got), _np(want), ROUND_TOL)
    assert eng.uplink_log == jeng.uplink_log


@pytest.mark.parametrize("spec", ["topk:3", "entropy:0.5+int8"])
def test_streamed_codecs_round_matches_jax(spec, jax_teachers):
    """Streamed codecs re-encode the step's teacher logits; the step
    computes them (one teacher forward per step)."""
    got, want, eng, jeng = _round_pair("bkd", spec)
    _close(params_to_numpy(got), _np(want), ROUND_TOL)
    assert eng.uplink_log == jeng.uplink_log
    assert jax_teachers["teacher_logits"] == 2 * (200 // 64)


def test_payload_rides_the_batch_gather():
    """The per-batch gather maps over the payload dict and passes the inner
    method's empty cache (None) through."""
    full = {PAYLOAD_KEY: {"codes": torch.arange(12).reshape(6, 1, 2),
                          "scale": torch.arange(6.0)[:, None]},
            "inner": None}
    sel = torch.tensor([4, 1])
    got = tree_map(lambda a: a[sel], full)
    assert got["inner"] is None
    assert got[PAYLOAD_KEY]["codes"].tolist() == [[[8, 9]], [[2, 3]]]
    assert got[PAYLOAD_KEY]["scale"].tolist() == [[4.0], [1.0]]


# -- whole runs -----------------------------------------------------------------


def _fl_setup():
    x, y = jsynthetic.make_synthetic_classification(
        num_classes=6, dim=16, per_class=60, seed=0)
    xt, yt = x[:90], y[:90]
    xtr, ytr = x[90:], y[90:]
    from repro_torch.data import Dataset, dirichlet_partition
    parts = dirichlet_partition(ytr, 4, alpha=0.5, seed=1)
    core = Dataset(xtr[parts[0]], ytr[parts[0]])
    edges = [Dataset(xtr[p], ytr[p]) for p in parts[1:]]
    return fl.mlp_adapter(16, 32, 6), core, edges, Dataset(xt, yt)


def _run_fl(setup, method, spec, **kw):
    adapter, core, edges, test = setup
    cfg = fl.FLConfig(num_edges=3, rounds=2, method=method, core_epochs=2,
                      edge_epochs=2, kd_epochs=2, batch_size=64, seed=0,
                      transport=spec, **kw)
    f = fl.FederatedKD(adapter, cfg, core, edges, test, device="cpu")
    _, hist = f.run(0, log=None)
    return hist, f.distill_engine


@pytest.mark.parametrize("method", sorted(METHODS))
def test_identity_transport_bit_for_bit_every_method(method):
    """identity wraps the method but changes nothing: the roundtrip returns
    its input object, so every accuracy is identical; the bytes are still
    accounted."""
    setup = _fl_setup()
    base, _ = _run_fl(setup, method, "none")
    ident, eng = _run_fl(setup, method, "identity")
    assert [h.as_dict() for h in ident] == [h.as_dict() for h in base]
    assert eng.uplink_bytes_total > 0 and len(eng.uplink_log) == 2


def test_engine_uplink_log_matches_codec_accounting():
    setup = _fl_setup()
    adapter, core = setup[0], setup[1]
    for spec in ("int8", "int4"):
        hist, eng = _run_fl(setup, "bkd", spec)
        per_teacher = codecs.parse_codec(spec).payload_bytes(len(core), 6)
        assert len(eng.uplink_log) == len(hist)
        assert all(rec["codec"] == spec
                   and rec["bytes"] == per_teacher * rec["teachers"]
                   for rec in eng.uplink_log)
    hist, eng = _run_fl(setup, "fedavg", "int8")
    nparams = sum(t.numel() for t in adapter.init(
        torch.Generator().manual_seed(0), "cpu").values())
    assert all(rec["bytes"] == 4 * nparams * rec["teachers"]
               for rec in eng.uplink_log)
    wrapped = transport.TransportMethod(resolve_method("bkd"), "int8")
    assert wrapped.name == "bkd@int8" and "bkd@int8" not in METHODS
    assert resolve_method(wrapped) is wrapped


def test_transport_bench_runs_every_codec_on_the_cpu():
    """FederatedKD under every spec of the bench's frontier, with its gates
    (identity bit-for-bit, int4 < int8 < identity bytes)."""
    out = transport_bench.bench_frontier("none", rounds=1, num_edges=2,
                                         epochs=(1, 1, 1), seed=0,
                                         device="cpu")
    assert [p["codec"] for p in out["frontier"]] == list(
        transport_bench.CODEC_SPECS)
    assert out["identity_bit_for_bit"]
    assert transport_bench.gates({"none": out})
    # The async regime of the frontier runs too, its bytes one int8
    # payload a consumed teacher.
    out = transport_bench.run_one("async_uniform", "int8", rounds=1,
                                  num_edges=2, epochs=(1, 1, 1), seed=0,
                                  device="cpu")
    assert out["dispatches"] == 1 and out["teachers"] >= 1
    assert np.isfinite(out["final_acc"]) and out["uplink_bytes"] > 0
