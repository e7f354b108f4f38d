"""The port's Mixture-of-Experts (``repro_torch/nn/moe.py``) and the MoE
archs ``kimi-k2-1t-a32b`` and ``phi3.5-moe-42b-a6.6b`` served by the port's
engines, against the JAX package, on the CPU in f32.

Parameters are initialised by the JAX package and carried over
(``repro_torch.interop``).  ``moe.forward``'s output agrees within 1e-5 and
its aux loss within 1e-6 (f32 sums in another order); the routing itself
(which expert, which capacity slot, which token is dropped) is exact, so a
token routed differently would show as an O(1) error.  Served greedily,
each port engine emits the same tokens as the same JAX engine (dense
against dense, paged against paged: their prefill batches differ, and the
MoE's groups couple the rows of a batch).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402

ARCHS = ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b")
ATOL_Y = 1e-5
ATOL_AUX = 1e-6
ATOL_LOGITS = 1e-4
MAX_LEN = 64

_jinit = jax.jit(lambda cfg, key: JTransformer.init(cfg, key)[0],
                 static_argnums=(0,))
_jforward = jax.jit(jmoe.forward, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def smoke():
    """arch -> (mesh, JAX SMOKE config, port SMOKE config, JAX params, port
    params)."""
    mesh = make_test_mesh()
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                                   remat="none")
        with mesh_context(mesh):
            weights = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.key(i)))
        out[arch] = (mesh, jcfg, registry.get_smoke_config(arch),
                     jax.tree.map(jnp.asarray, weights),
                     params_from_numpy(weights, "cpu"))
    return out


def _moe_case(cfg, shape, seed):
    """JAX-initialised expert weights for ``cfg`` (a JAX ``MoEConfig``),
    both packages' copies, and an input of ``shape``."""
    jp, _ = jmoe.init(jax.random.key(seed), cfg)
    weights = jax.tree.map(np.asarray, jp)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jp, params_from_numpy(weights, "cpu"), x


def _port_cfg(jcfg):
    return moe.MoEConfig(**dataclasses.asdict(jcfg))


def _run_both(jcfg, shape, seed):
    jp, tp, x = _moe_case(jcfg, shape, seed)
    want_y, want_aux = _jforward(jp, jcfg, jnp.asarray(x))
    y, aux = moe.forward(tp, _port_cfg(jcfg), torch.from_numpy(x))
    return (y, aux), (want_y, want_aux), tp, x


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_on_each_smoke_config(arch):
    jcfg = jregistry.get_smoke_config(arch).moe_cfg()
    (y, aux), (want_y, want_aux), _, _ = _run_both(jcfg, (2, 48, 256), 1)
    _close(y, want_y, ATOL_Y)
    _close(aux, want_aux, ATOL_AUX)
    assert registry.get_smoke_config(arch).moe_cfg() == _port_cfg(jcfg)


def _dropped(tp, cfg, x):
    """Top-k assignments that found their expert's queue full."""
    t = moe.group_size(cfg, x.shape[0] * x.shape[1])
    xt = torch.from_numpy(x).reshape(-1, t, x.shape[-1])
    probs = torch.softmax(xt @ tp["router"], dim=-1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices
    counts = torch.zeros(xt.shape[0], cfg.num_experts)
    for i in range(cfg.top_k):
        for g in range(xt.shape[0]):
            counts[g].index_add_(0, idx[g, :, i], torch.ones(t))
    cap = moe._capacity(cfg, t)
    return int(torch.clamp(counts - cap, min=0).sum())


def test_forward_matches_jax_when_tokens_are_dropped():
    """A 4-slot decode tick at phi3.5-moe's routing (16 experts, top-2,
    capacity factor 1.25): capacity ceil(4 * 2 * 1.25 / 16) = 1, so any
    expert picked twice drops the later token's share, as in the JAX
    package."""
    jcfg = jmoe.MoEConfig(d_model=64, num_experts=16, top_k=2, expert_dim=32,
                          tokens_per_group=512, capacity_factor=1.25)
    cfg = _port_cfg(jcfg)
    assert moe._capacity(cfg, 4) == 1
    (y, aux), (want_y, want_aux), tp, x = _run_both(jcfg, (4, 1, 64), 7)
    assert _dropped(tp, cfg, x) > 0
    _close(y, want_y, ATOL_Y)
    _close(aux, want_aux, ATOL_AUX)


def test_forward_matches_jax_on_an_odd_token_count():
    """B·S = 3 x 11 = 33 tokens with groups of at most 32: the group
    shrinks to 11 tokens, the largest divisor of 33 that fits."""
    jcfg = jregistry.get_smoke_config("kimi-k2-1t-a32b").moe_cfg()
    assert moe.group_size(_port_cfg(jcfg), 33) == 11
    (y, aux), (want_y, want_aux), _, _ = _run_both(jcfg, (3, 11, 256), 2)
    _close(y, want_y, ATOL_Y)
    _close(aux, want_aux, ATOL_AUX)


@pytest.mark.parametrize("experts,top_k,cf", [(4, 2, 1.25), (16, 2, 1.25),
                                              (384, 8, 1.25), (8, 1, 2.0),
                                              (3, 3, 0.5)])
def test_capacity_matches_jax_over_a_grid(experts, top_k, cf):
    jcfg = jmoe.MoEConfig(d_model=8, num_experts=experts, top_k=top_k,
                          expert_dim=8, capacity_factor=cf)
    cfg = _port_cfg(jcfg)
    for t in (1, 2, 3, 4, 7, 11, 32, 128, 512, 1000):
        assert moe._capacity(cfg, t) == jmoe._capacity(jcfg, t)
        assert 1 <= moe._capacity(cfg, t) <= t
        assert moe._capacity(cfg, t) == max(
            1, min(math.ceil(t * top_k * cf / experts), t))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_tree_round_trips_through_interop(smoke, arch):
    """The MoE tree (stacked experts under blocks/b0/mlp, the shared
    experts, the f32 router) has the JAX keys, shapes and dtypes in the
    port's own init, and carries over both ways bit for bit."""
    _, _, cfg, jparams, params = smoke[arch]
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for tree in (params, Transformer.init(cfg, 0, device="cpu")):
        tflat = jax.tree_util.tree_flatten_with_path(params_to_numpy(tree))[0]
        assert [k for k, _ in jflat] == [k for k, _ in tflat]
        for (_, a), (_, t) in zip(jflat, tflat):
            assert a.shape == t.shape and a.dtype == t.dtype
    mlp = params["blocks"]["b0"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["w_gate"].shape == (cfg.n_super, cfg.num_experts, cfg.d_model,
                                   cfg.expert_dim)
    assert ("shared" in mlp) == bool(cfg.shared_experts)
    back = params_to_numpy(params)
    for (_, a), (_, t) in zip(jflat,
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), t)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    router = Transformer.init(bf16, 0, device="cpu")["blocks"]["b0"]["mlp"]
    assert router["router"].dtype == torch.float32
    assert router["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(smoke, arch):
    """Prefill logits and two decode steps (four rows, so the decode tick's
    capacity binds) against the JAX package."""
    mesh, jcfg, cfg, jparams, params = smoke[arch]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size - 1, size=(4, 20)).astype(np.int32)
    with mesh_context(mesh):
        want, jcaches = JTransformer.prefill(
            jcfg, jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    got, caches = Transformer.prefill(cfg, params,
                                      {"tokens": torch.from_numpy(tokens)},
                                      MAX_LEN)
    _close(got, want, ATOL_LOGITS)
    pos = np.array([20, 20, 20, 20], np.int32)
    for _ in range(2):
        token = rng.integers(0, cfg.vocab_size - 1, size=(4, 1)).astype(np.int32)
        with mesh_context(mesh):
            want, jcaches = JTransformer.decode_step(
                jcfg, jparams, jcaches, jnp.asarray(token), jnp.asarray(pos))
        got, caches = Transformer.decode_step(cfg, params, caches,
                                              torch.from_numpy(token),
                                              torch.from_numpy(pos))
        _close(got, want, ATOL_LOGITS)
        pos = pos + 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(smoke, arch, paged):
    """Greedy serving of one bursty stream with a shared prompt prefix, token
    by token against the same JAX engine; 4 slots, so decode ticks drop
    tokens at capacity and idle slots take part in the routing."""
    mesh, jcfg, cfg, jparams, params = smoke[arch]
    kw = dict(slots=4, max_len=MAX_LEN, min_bucket=32, paged=paged,
              page_size=8)
    reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size, seed=21,  # noqa: E731
                                prompt_max=24, out_max=8, shared_prefix=8)
    with mesh_context(mesh):
        jengine = JServeEngine(jcfg, jparams, **kw)
        want = {r.rid: r.out for r in jengine.run(reqs(), log=None)}
    engine = ServeEngine(cfg, params, device="cpu", **kw)
    assert {r.rid: r.out for r in engine.run(reqs(), log=None)} == want
    assert engine.ticks == jengine.ticks


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_each_moe_arch_on_cpu(arch, capsys):
    for extra in ([], ["--paged"]):
        finished = serve_cli.main(["--device", "cpu", "--arch", arch,
                                   "--requests", "2", "--slots", "2",
                                   "--max-len", "48", "--out-max", "4",
                                   *extra])
        assert len(finished) == 2
    assert "prefix hits" in capsys.readouterr().out


def test_serve_and_prefill_steps_match_jax(smoke):
    """``make_prefill_step`` then ``make_serve_step`` (re-exported by
    ``launch/steps.py``, as in the JAX package) at one scalar position for
    the whole batch: the same greedy tokens as the JAX steps; ``simulate``
    serves a stream like the engine and refuses a mesh."""
    from repro.launch import steps as JSt
    from repro_torch.launch import steps as St
    from repro_torch.serve import simulate
    mesh, jcfg, cfg, jparams, params = smoke["kimi-k2-1t-a32b"]
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size - 1, size=(3, 12)).astype(np.int32)
    with mesh_context(mesh):
        jtok, jcache = JSt.make_prefill_step(jcfg, 20)(
            jparams, {"tokens": jnp.asarray(prompt)})
        want = [np.asarray(jtok)]
        for i in range(4):
            jtok, jcache = JSt.make_serve_step(jcfg)(jparams, jcache, jtok,
                                                     jnp.int32(12 + i))
            want.append(np.asarray(jtok))
    tok, cache = St.make_prefill_step(cfg, 20)(
        params, {"tokens": torch.from_numpy(prompt)})
    got = [tok.numpy()]
    for i in range(4):
        tok, cache = St.make_serve_step(cfg)(params, cache, tok, 12 + i)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    reqs = lambda: build_stream("poisson", 3, vocab=cfg.vocab_size, seed=2,  # noqa: E731
                                prompt_max=12, out_max=4)
    finished = simulate(cfg, params, reqs(), 2, 32, log=None, device="cpu")
    engine = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    assert [r.out for r in finished] == [r.out for r in engine.run(reqs())]
    with pytest.raises(NotImplementedError, match="slice 9"):
        simulate(cfg, params, reqs(), 2, 32, mesh=object(), device="cpu")


def test_serve_decode_example_runs_each_moe_arch_on_cpu(capsys):
    from repro_torch.examples import serve_decode
    for arch in ARCHS:
        out = serve_decode.main(["--arch", arch, "--device", "cpu", "-n", "3",
                                 "--batch", "2", "--prompt-len", "8"])
        assert out.shape == (2, 3)
    assert "cache=kv" in capsys.readouterr().out
