"""The port's LLM-scale training path against the JAX package, on the CPU in
f32: ``Transformer.apply`` (logits and the MoE aux loss),
``launch/steps.py``'s ``make_pretrain_step`` and ``make_phase2_step``
(buffer modes ``clone``, ``cached`` and ``none``, the fused-loss backend
and its three fallbacks), ``methods.validate_backend`` and what the LLM
driver refuses.

Parameters are initialised by the JAX package and carried over
(``repro_torch.interop``).  Gradients are read through an optimizer whose
update returns the gradient as the new parameters, in both packages, so the
steps' own autodiff is compared leaf by leaf.  Tolerances: logits 1e-4 and
aux 1e-6 absolute; losses 1e-5 absolute; gradients within 1e-4 of each
leaf's largest gradient (f32 sums in another order through two layers and
a 512-token vocabulary).
"""

import dataclasses
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import methods as jmethods  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.launch import steps as JSt  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.optimizers import Optimizer as JOptimizer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import Optimizer, adamw, update_in_place  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
ATOL_LOGITS = 1e-4
ATOL_AUX = 1e-6
ATOL_LOSS = 1e-5
GRAD_RTOL = 1e-4
B, S, TOPK = 2, 16, 8

_jinit = jax.jit(lambda cfg, key: JTransformer.init(cfg, key)[0],
                 static_argnums=(0,))
_japply = jax.jit(JTransformer.apply, static_argnums=0)

# The gradient itself as the "new parameters": both packages' steps then
# hand back d(loss)/d(params) leaf by leaf.
JGRAD = JOptimizer(init=lambda p: {}, update=lambda g, s, p, step: (g, s))
GRAD = Optimizer(init=lambda p: {},
                 update=lambda g, s, p, step, lr=None: (g, s))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """arch -> (mesh, JAX SMOKE config, port SMOKE config, numpy weights)."""
    mesh = make_test_mesh()
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jregistry.get_smoke_config(arch)
        with mesh_context(mesh):
            weights = jax.tree.map(np.asarray,
                                   _jinit(jcfg, jax.random.key(10 + i)))
        out[arch] = (mesh, jcfg, registry.get_smoke_config(arch), weights)
    return out


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


def _grads_close(got, want):
    """Each leaf within GRAD_RTOL of that leaf's largest JAX gradient."""
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = jax.tree_util.tree_flatten_with_path(params_to_numpy(got))[0]
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (path, w), (_, g) in zip(jflat, tflat):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, path
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, (jax.tree_util.keystr(path), err,
                                          scale)


def _batch(cfg, seed, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size - 1, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        m = rng.random((B, S)) < 0.7
        m[:, 0] = True
        batch["mask"] = m
    return batch


def _cached(cfg, seed):
    """A (top-k values, indices, tail logsumexp) buffer cache for _batch."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(cfg.vocab_size)[:TOPK]
                    for _ in range(B * S)]).reshape(B, S, TOPK)
    vals = np.sort(rng.standard_normal((B, S, TOPK)) + 3.0, axis=-1)[..., ::-1]
    tail = rng.standard_normal((B, S)) + 5.0
    return {"top_vals": vals.astype(np.float32),
            "top_idx": idx.astype(np.int32),
            "tail_lse": tail.astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree) \
        if isinstance(tree, dict) else torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax(smoke, arch):
    """Logits (B, S, V_pad) and the aux loss (the MoE layers' Switch loss;
    0 for granite) against ``JTransformer.apply``."""
    mesh, jcfg, cfg, weights = smoke[arch]
    batch = _batch(cfg, 1)
    with mesh_context(mesh):
        want, want_aux = _japply(jcfg, jax.tree.map(jnp.asarray, weights),
                                 {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        got, aux = Transformer.apply(cfg, params_from_numpy(weights, "cpu"),
                                     {"tokens": torch.from_numpy(
                                         batch["tokens"])})
    _close(got, want, ATOL_LOGITS)
    _close(aux, want_aux, ATOL_AUX)
    assert (float(aux) > 0.5) == (cfg.mlp == "moe")


def test_remat_changes_memory_not_numbers(smoke):
    """``remat="block"`` (each super-block under torch.utils.checkpoint)
    gives the same loss and gradients, bit for bit, as ``remat="none"``."""
    _, _, cfg, weights = smoke["phi3.5-moe-42b-a6.6b"]
    batch = _t(_batch(cfg, 2))
    out = {}
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        step = St.make_pretrain_step(c, GRAD, loss_chunk=8)
        out[remat] = step(params_from_numpy(weights, "cpu"), {}, batch, 0)
    assert float(out["none"][2]["loss"]) == float(out["block"][2]["loss"])
    for a, b in zip(jax.tree.leaves(params_to_numpy(out["none"][0])),
                    jax.tree.leaves(params_to_numpy(out["block"][0]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,chunk", [("granite-3-2b", 16),
                                        ("phi3.5-moe-42b-a6.6b", 8)])
def test_pretrain_step_loss_and_grads_match_jax(smoke, arch, chunk):
    """Chunked CE (one chunk, then two under checkpoint) plus the MoE aux
    loss at weight 0.01."""
    mesh, jcfg, cfg, weights = smoke[arch]
    batch = _batch(cfg, 3)
    with mesh_context(mesh):
        jstep = jax.jit(JSt.make_pretrain_step(jcfg, JGRAD, loss_chunk=chunk))
        want, _, jm = jstep(jax.tree.map(jnp.asarray, weights), {},
                            jax.tree.map(jnp.asarray, batch), jnp.int32(0))
    step = St.make_pretrain_step(cfg, GRAD, loss_chunk=chunk)
    got, _, m = step(params_from_numpy(weights, "cpu"), {}, _t(batch), 0)
    _close(m["loss"], jm["loss"], ATOL_LOSS)
    _grads_close(got, want)


# (buffer mode, backend, chunk, topk, ce_weight, mask, warning raised)
PHASE2_CASES = {
    "clone-jnp": ("clone", "jnp", 16, None, 1.0, False, None),
    "clone-pallas": ("clone", "pallas", 16, None, 1.0, False, None),
    "clone-pallas-2chunks": ("clone", "pallas", 8, None, 1.0, False, None),
    "none-pallas": ("none", "pallas", 16, None, 1.0, False, None),
    "cached-jnp": ("cached", "jnp", 16, None, 1.0, False, None),
    "cached-pallas": ("cached", "pallas", 8, None, 1.0, False, None),
    "topk-fallback": ("clone", "pallas", 16, TOPK, 1.0, False, "topk is set"),
    "ce0-fallback": ("none", "pallas", 16, None, 0.0, False, "ce_weight != 1"),
    "mask-fallback": ("clone", "pallas", 16, None, 1.0, True,
                      "masked batches"),
}


@pytest.mark.parametrize("case", list(PHASE2_CASES))
def test_phase2_step_loss_and_grads_match_jax(smoke, case):
    """One Phase-2 step of granite SMOKE from three JAX-initialised weight
    sets (student, teacher, buffer), with each case's buffer mode, loss
    backend ('pallas' is the JAX kernels in interpret mode against the
    port's kernel pair's plain versions), chunking and fallback; the
    fallback's warning is raised by both packages."""
    mode, backend, chunk, topk, ce_weight, masked, warn = PHASE2_CASES[case]
    mesh, jcfg, cfg, student = smoke["granite-3-2b"]
    with mesh_context(mesh):
        teacher = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.key(21)))
        buffer = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.key(22)))
    batch = _batch(cfg, 4, mask=masked)
    barg = {"clone": buffer, "cached": _cached(cfg, 5),
            "none": np.zeros((1,), np.float32)}[mode]
    kw = dict(tau=2.0, buffer_mode=mode, loss_chunk=chunk, topk=topk,
              loss_backend=backend, ce_weight=ce_weight)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        with mesh_context(mesh):
            jstep = jax.jit(JSt.make_phase2_step(jcfg, JGRAD, **kw))
            want, _, jm = jstep(jax.tree.map(jnp.asarray, student),
                                jax.tree.map(jnp.asarray, teacher),
                                jax.tree.map(jnp.asarray, barg), {},
                                jax.tree.map(jnp.asarray, batch),
                                jnp.int32(0))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        step = St.make_phase2_step(cfg, GRAD, **kw)
        got, _, m = step(params_from_numpy(student, "cpu"),
                         params_from_numpy(teacher, "cpu"),
                         params_from_numpy(barg, "cpu") if mode == "clone"
                         else _t(barg), {}, _t(batch), 0)
    for key in ("loss", "kd_loss"):
        _close(m[key], jm[key], ATOL_LOSS)
    _grads_close(got, want)
    if warn is None:
        assert not [w for w in tw if "loss_backend" in str(w.message)]
    else:
        for caught in (jw, tw):
            assert any(warn in str(w.message) for w in caught), warn


def test_phase2_step_launches_the_kernel_pair_on_each_chunk(smoke,
                                                            monkeypatch):
    """The 'pallas' backend goes through ``ops.kd_loss`` once a chunk, and
    the chunk's checkpoint recompute in the backward pass runs the forward
    stats again: 2·nc forward stats and nc gradients a step (1 and 1 at a
    single chunk)."""
    _, _, cfg, weights = smoke["granite-3-2b"]
    calls = {"stats": 0, "grad": 0}
    from repro_torch.kernels import ops
    stats, grad = ops.kd_stats, ops.kd_grad

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "kd_stats", count("stats", stats))
    monkeypatch.setattr(ops, "kd_grad", count("grad", grad))
    batch = _t(_batch(cfg, 6))
    for chunk, want in ((16, (1, 1)), (8, (4, 2)), (4, (8, 4))):
        calls.update(stats=0, grad=0)
        step = St.make_phase2_step(cfg, GRAD, loss_chunk=chunk,
                                   loss_backend="pallas")
        p = params_from_numpy(weights, "cpu")
        step(p, p, p, {}, batch, 0)
        assert (calls["stats"], calls["grad"]) == want, chunk


def test_auto_backend_is_the_plain_loss_on_the_cpu(smoke, monkeypatch):
    _, _, cfg, weights = smoke["granite-3-2b"]
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "kd_loss", None)   # must not be reached
    step = St.make_phase2_step(cfg, GRAD, loss_backend="auto")
    p = params_from_numpy(weights, "cpu")
    _, _, m = step(p, p, p, {}, _t(_batch(cfg, 6)), 0)
    assert np.isfinite(float(m["loss"]))


def test_donated_adamw_step_equals_the_functional_one(smoke):
    """``update_in_place`` (the steps' update, one leaf at a time, written
    over the given dicts) gives the same parameters and AdamW state, bit for
    bit, as the functional ``opt.update`` over two steps of real gradients;
    a Phase-2 step hands back the very dicts it was given."""
    _, _, cfg, weights = smoke["phi3.5-moe-42b-a6.6b"]
    opt = adamw(3e-4)
    batch = _t(_batch(cfg, 7))
    grad_step = St.make_phase2_step(cfg, GRAD, loss_backend="pallas")
    teacher = params_from_numpy(weights, "cpu")
    fun_p = params_from_numpy(weights, "cpu")
    fun_s = opt.init(fun_p)
    own_p = params_from_numpy(weights, "cpu")
    own_s = opt.init(own_p)
    for i in range(2):
        grads, _, _ = grad_step(params_from_numpy(params_to_numpy(fun_p),
                                                  "cpu"),
                                teacher, teacher, {}, batch, i)
        fun_p, fun_s = opt.update(grads, fun_s, fun_p, i)
        new_p, new_s = update_in_place(opt, grads, own_s, own_p, i)
        assert new_p is own_p and new_s is own_s
    for x, y in zip(jax.tree.leaves(params_to_numpy({"p": fun_p,
                                                     "s": fun_s})),
                    jax.tree.leaves(params_to_numpy({"p": own_p,
                                                     "s": own_s}))):
        np.testing.assert_array_equal(x, y)
    step = St.make_phase2_step(cfg, opt, loss_backend="pallas")
    params = params_from_numpy(weights, "cpu")
    state = opt.init(params)
    new_p, new_s, _ = step(params, teacher, teacher, state, batch, 0)
    assert new_p is params and new_s is state
    grads = params_from_numpy(weights, "cpu")
    update_in_place(opt, grads, opt.init(grads),
                    params_from_numpy(weights, "cpu"), 0)

    def dropped(tree):
        return all(dropped(v) if isinstance(v, dict) else v is None
                   for v in tree.values())

    assert dropped(grads)   # each gradient let go once used


def test_adamw_pretrain_step_matches_jax(smoke):
    """One AdamW step (lr 3e-4) of granite SMOKE.  AdamW's first step moves
    every parameter by about lr·sign(g), and where |g| is near its eps
    (1e-8) f32 gradient differences of 1e-9 move the update by up to 2·lr:
    parameters are held within 2·lr where the JAX gradient is below 1e-6 in
    magnitude, within 1e-6 elsewhere; the AdamW moments within 1e-4 of each
    leaf's largest."""
    mesh, jcfg, cfg, weights = smoke["granite-3-2b"]
    batch = _batch(cfg, 8)
    with mesh_context(mesh):
        jopt = jadamw(3e-4)
        jp = jax.tree.map(jnp.asarray, weights)
        jstep = jax.jit(JSt.make_pretrain_step(jcfg, jopt, loss_chunk=S))
        want, jstate, jm = jstep(jp, jopt.init(jp),
                                 jax.tree.map(jnp.asarray, batch),
                                 jnp.int32(0))
        jgrad_step = jax.jit(JSt.make_pretrain_step(jcfg, JGRAD,
                                                    loss_chunk=S))
        grads, _, _ = jgrad_step(jp, {}, jax.tree.map(jnp.asarray, batch),
                                 jnp.int32(0))
    opt = adamw(3e-4)
    params = params_from_numpy(weights, "cpu")
    got, state, m = St.make_pretrain_step(cfg, opt, loss_chunk=S)(
        params, opt.init(params), _t(batch), 0)
    _close(m["loss"], jm["loss"], ATOL_LOSS)
    for g, w, jg in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(want), jax.tree.leaves(grads)):
        tiny = np.abs(np.asarray(jg)) < 1e-6
        err = np.abs(g - np.asarray(w))
        assert err[~tiny].max(initial=0) <= 1e-6
        assert err[tiny].max(initial=0) <= 2 * 3e-4
    _grads_close(state["m"], jstate["m"])


@pytest.mark.parametrize("method", sorted(jmethods.METHODS))
def test_validate_backend_matches_jax(method):
    """Every method x backend, on the FL engine's set and the LLM driver's:
    the same pairs pass and the same ones raise, with the same text."""
    for llm in (False, True):
        for backend in ("auto", "jnp", "pallas", "topk_cached", "bogus"):
            errs = []
            for fn in (jmethods.validate_backend, methods.validate_backend):
                try:
                    fn(method, backend, llm=llm)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            assert errs[0] == errs[1], (method, backend, llm)


def test_llm_hints_equal_the_reference():
    for name in jmethods.method_names():
        a, b = methods.resolve_method(name), jmethods.resolve_method(name)
        for f in ("llm_driver", "llm_unsupported_reason", "llm_backends",
                  "llm_buffer", "llm_ce_weight", "llm_ema", "llm_averaging",
                  "llm_init_from_avg"):
            assert getattr(a, f) == getattr(b, f), (name, f)


ARGV = ["--device", "cpu", "--rounds", "1", "--edges", "2",
        "--steps-per-phase", "2", "--batch", "2", "--seq", "8"]


@pytest.mark.parametrize("argv,text", [
    (["--method", "ft"], "--method ft is CPU-scale only"),
    (["--method", "feddf"], "--method feddf is CPU-scale only"),
    (["--method", "melting", "--loss-backend", "topk_cached"],
     "not supported by method 'melting'"),
    (["--method", "fedavg", "--transport", "int8"],
     "uplinks parameters"),
    (["--transport", "bogus"], "bogus"),
    (["--sim", "nonsense"], "--sim must be"),
    (["--sim", "async:uniform", "--scenario", "alternate"], "conflicts"),
])
def test_train_refuses_what_the_reference_refuses(argv, text, capsys):
    """The argparse errors of the JAX driver, with its text."""
    with pytest.raises(SystemExit):
        train.main(ARGV + argv)
    assert text in capsys.readouterr().err


_NUMBER = re.compile(r"(loss|kd|domain)[=:] ?(-?\d+\.\d+)")


@pytest.mark.parametrize("argv", [
    ["--sim", "async:uniform"], ["--sim", "fleet:heavy_tail"],
    ["--scenario", "async_uniform"], ["--scenario", "async_dropout"],
    ["--scenario", "hier_uniform"], ["--scenario", "fleet_uniform"]])
def test_train_async_fleet_and_hierarchical_name_slice_7(smoke, argv,
                                                         monkeypatch, capsys):
    """The slice-7 plan sources of the LLM trainer against the JAX one's,
    from one carried granite SMOKE state over 3 rounds of 3 edges: the same
    simulator line, the same edge, staleness and event time each round,
    and every printed loss within 2e-4 (four printed decimals).  The
    two-level hier_* streams are refused with the reference's text."""
    from repro.launch import train as jtrain
    runs = ["--rounds", "3", "--edges", "3", "--steps-per-phase", "2",
            "--batch", "2", "--seq", "8"] + argv
    if argv[-1] in jscheduler.HIER_SCENARIOS:
        for main, extra in ((jtrain.main, []),
                            (train.main, ["--device", "cpu"])):
            with pytest.raises(SystemExit):
                main(runs + extra)
            err = capsys.readouterr().err
            assert ("--scenario hier_uniform emits a two-level region/core "
                    "plan stream; drive it through the CPU orchestrator "
                    "instead") in err
        return
    mesh, _, _, weights = smoke["granite-3-2b"]
    monkeypatch.setattr(JTransformer, "init", staticmethod(
        lambda cfg, key: (jax.tree.map(jnp.asarray, weights), None)))
    monkeypatch.setattr(Transformer, "init", staticmethod(
        lambda cfg, seed=0, *, device="cuda": params_from_numpy(weights,
                                                                device)))
    capsys.readouterr()
    jtrain.main(runs)
    want = capsys.readouterr().out
    train.main(runs + ["--device", "cpu"])
    got = capsys.readouterr().out
    rounds = re.compile(r"\[round \d+\] edge \d+ trained( stale=\S+)?"
                        r"( t=\S+)?,")
    assert rounds.findall(got) == rounds.findall(want)
    assert len(rounds.findall(got)) == 3
    sim = [l for l in want.splitlines() if "simulator:" in l]
    assert sim == [l for l in got.splitlines() if "simulator:" in l]
    assert len(sim) == (0 if argv[-1] == "fleet_uniform" else 1)
    mine = [(k, float(v)) for k, v in _NUMBER.findall(got)]
    theirs = [(k, float(v)) for k, v in _NUMBER.findall(want)]
    assert [k for k, _ in mine] == [k for k, _ in theirs] and len(mine) >= 8
    for (key, a), (_, b) in zip(mine, theirs):
        assert abs(a - b) <= 2e-4, (key, a, b, got, want)


def test_train_cli_runs_a_moe_arch_on_cpu(capsys):
    train.main(ARGV + ["--arch", "phi3.5-moe-42b-a6.6b"])
    out = capsys.readouterr().out
    assert re.search(r"\[round 0\] distilled \(bkd\), loss=\d", out)
    assert "final core NLL" in out


def test_llm_federated_distill_example_runs_on_cpu(capsys):
    from repro_torch.examples import llm_federated_distill
    base, results = llm_federated_distill.main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    assert set(results) == {"kd", "bkd"}
    assert all(np.isfinite(v) for r in results.values() for v in r)
    assert "forgetting" in capsys.readouterr().out


def test_kernels_bench_runs_on_cpu(capsys):
    """On the CPU the wrappers take the kernels' plain versions, so the
    fused loss equals the plain loss and the scans their references."""
    from repro_torch.benchmarks import kernels_bench
    out = kernels_bench.main(rows=16, vocab=300, device="cpu")
    assert out["kd_parity"] <= 1e-5 and out["kd_grad_err"] <= 1e-7
    assert out["rglru_err"] == 0 and out["ssd_err"] == 0
    rows = capsys.readouterr().out
    assert "kd_loss_kernel," in rows and "traffic_ratio=3.0x" in rows
