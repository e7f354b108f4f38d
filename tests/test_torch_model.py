"""The PyTorch port's layers, paged attention and Transformer against the
JAX package, on the CPU in f32.

The same numpy inputs (and parameters, carried over by
``repro_torch.interop``) go through both packages.  Layer outputs agree
within 1e-5 (f32 sums in another order); whole-model logits on Granite
SMOKE within 1e-4, above the ~1e-6 drift the reference itself shows across
batch shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import rope as jrope  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.nn import attention, layers, rope  # noqa: E402

ATOL_LAYER = 1e-5
ATOL_LOGITS = 1e-4

# jitted once: op-by-op JAX dispatch would dominate these tests' time
_jprefill = jax.jit(jattn.paged_prefill, static_argnums=(1, 8, 9))
_jdecode = jax.jit(jattn.paged_decode_step, static_argnums=(1,),
                   static_argnames=("page_size", "use_pallas"))
_jmodel_prefill = jax.jit(JTransformer.paged_prefill, static_argnums=(0, 7, 8))
_jmodel_decode = jax.jit(JTransformer.paged_decode_step, static_argnums=(0,),
                         static_argnames=("page_size",))


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


def _close(got, want, atol=ATOL_LAYER, rows=None):
    got, want = got.detach().numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _attn_cfg(**kw):
    return jattn.AttnConfig(d_model=64, num_heads=4, kv_heads=2, head_dim=16,
                            q_chunk=4, **kw)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(attention.AttnConfig)}
    return attention.AttnConfig(**{k: v for k, v in
                                   dataclasses.asdict(jcfg).items()
                                   if k in fields})


def _attn_params(rng, cfg):
    d, h, n, k = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32)  # noqa: E731
    p = {"wq": w(d, h, k), "wk": w(d, n, k), "wv": w(d, n, k),
         "wo": w(h, k, d)}
    if cfg.qkv_bias:
        p.update(bq=w(h, k), bk=w(n, k), bv=w(n, k))
    if cfg.qk_norm:
        p.update(q_norm=1 + w(k), k_norm=1 + w(k))
    return p


def test_rmsnorm_and_layernorm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {"scale": scale, "bias": bias}
    _close(layers.layernorm(params_from_numpy(p, "cpu"), torch.from_numpy(x)),
           jlayers.layernorm(p, jnp.asarray(x)))


def test_activations_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(layers.gelu(tx), jlayers.gelu(jx))
    _close(layers.swiglu(tx, tx * 2), jlayers.swiglu(jx, jx * 2))
    _close(layers.squared_relu(tx), jlayers.squared_relu(jx))


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    positions = rng.integers(0, 600, size=(2, 5)).astype(np.int32)
    _close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(positions)),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(positions)))


@pytest.mark.parametrize("extra", [{}, {"qk_norm": True, "qkv_bias": True}])
def test_project_qkv_matches_jax(extra):
    jcfg = _attn_cfg(**extra)
    rng = np.random.default_rng(3)
    p = _attn_params(rng, jcfg)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    positions = np.tile(np.arange(6, dtype=np.int32) + 7, (2, 1))
    got = attention._project_qkv(params_from_numpy(p, "cpu"), _port_cfg(jcfg),
                                 torch.from_numpy(x),
                                 torch.from_numpy(positions))
    want = jattn._project_qkv(p, jcfg, jnp.asarray(x), jnp.asarray(positions))
    for g, w in zip(got, want):
        _close(g, w)


def _pool_case(rng, cfg, num_pages, ps):
    shape = (num_pages, ps, cfg.kv_heads, cfg.head_dim)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _close_pools(got, want):
    """Pools equal except the trash page 0, whose colliding redirected
    writes land in an unspecified order in both packages."""
    for key in ("k", "v"):
        _close(got[key][1:], np.asarray(want[key])[1:])


@pytest.mark.parametrize("npp", [0, 2])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_prefill_matches_jax(npp, window):
    jcfg = _attn_cfg(window=window)
    rng = np.random.default_rng(4 + npp)
    ps, pp, b, length = 4, 6, 3, 8
    p = _attn_params(rng, jcfg)
    pool = _pool_case(rng, jcfg, 1 + b * pp, ps)
    pt = (1 + np.arange(b * pp, dtype=np.int32)).reshape(b, pp)
    pt[1, :npp] = pt[0, :npp]            # slot 1 shares slot 0's prefix pages
    lengths = np.array([8, 5, 1], np.int32)
    fill = np.array([True, True, False])
    x = rng.standard_normal((b, length, 64)).astype(np.float32)
    positions = np.tile(npp * ps + np.arange(length, dtype=np.int32), (b, 1))
    tpool = params_from_numpy(pool, "cpu")
    got, tpool = attention.paged_prefill(
        params_from_numpy(p, "cpu"), _port_cfg(jcfg), torch.from_numpy(x),
        torch.from_numpy(positions), tpool, torch.from_numpy(pt),
        torch.from_numpy(lengths), torch.from_numpy(fill), npp, ps)
    want, jpool = _jprefill(
        p, jcfg, jnp.asarray(x), jnp.asarray(positions),
        jax.tree.map(jnp.asarray, pool),
        jnp.asarray(pt), jnp.asarray(lengths), jnp.asarray(fill), npp, ps)
    _close(got, want)
    _close_pools(tpool, jpool)


def test_paged_decode_step_matches_jax():
    jcfg = _attn_cfg()
    rng = np.random.default_rng(6)
    ps, pp, b = 4, 5, 3
    p = _attn_params(rng, jcfg)
    pool = _pool_case(rng, jcfg, 1 + b * pp, ps)
    pt = (1 + np.arange(b * pp, dtype=np.int32)).reshape(b, pp)
    pt[2, 3:] = 0                        # trash entries past the allocation
    pos = np.array([9, 19, 11], np.int32)
    active = np.array([True, False, True])
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    tpool = params_from_numpy(pool, "cpu")
    got, tpool = attention.paged_decode_step(
        params_from_numpy(p, "cpu"), _port_cfg(jcfg), tpool,
        torch.from_numpy(pt), torch.from_numpy(x), torch.from_numpy(pos),
        active=torch.from_numpy(active), page_size=ps)
    want, jpool = _jdecode(
        p, jcfg, jax.tree.map(jnp.asarray, pool), jnp.asarray(pt),
        jnp.asarray(x), jnp.asarray(pos), active=jnp.asarray(active),
        page_size=ps, use_pallas=False)
    _close(got, want)
    _close_pools(tpool, jpool)


@pytest.fixture(scope="module")
def smoke():
    """Granite SMOKE in both packages and the JAX init's parameters.
    (``remat`` only changes what JAX's backward pass keeps; turning it off
    shortens the compile of the jitted forward calls.)"""
    jcfg = dataclasses.replace(jregistry.get_smoke_config("granite-3-2b"),
                               remat="none")
    init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
    params = _np(init(jax.random.key(0)))
    return jcfg, registry.get_smoke_config("granite-3-2b"), params


def test_transformer_paged_prefill_and_decode_logits_match_jax(smoke):
    """Two admissions (a prefix miss, then a prefix hit reading the pages
    the first wrote) and three decode ticks with one slot inactive.  Only
    the rows the engine keeps are compared: an idle row's table points at
    the trash page, whose contents depend on the order of colliding
    redirected writes in either package."""
    jcfg, cfg, params = smoke
    tparams = params_from_numpy(params, "cpu")
    rng = np.random.default_rng(7)
    ps, b, pp = 8, 3, 4
    pt = np.zeros((b, pp), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :3] = [1, 4, 5]                 # shares logical page 0 with slot 0
    jpools = JTransformer.init_paged_cache(jcfg, 1 + b * pp, ps)
    tpools = Transformer.init_paged_cache(cfg, 1 + b * pp, ps, device="cpu")

    def both_prefill(tokens, lengths, fill, npp):
        nonlocal jpools, tpools
        positions = np.tile(npp * ps + np.arange(tokens.shape[1],
                                                 dtype=np.int32), (b, 1))
        batch = {"tokens": tokens, "positions": positions}
        want, jpools = _jmodel_prefill(
            jcfg, params, jax.tree.map(jnp.asarray, batch), jpools,
            jnp.asarray(pt), jnp.asarray(lengths), jnp.asarray(fill), npp, ps)
        got, tpools = Transformer.paged_prefill(
            cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            tpools, torch.from_numpy(pt), torch.from_numpy(lengths),
            torch.from_numpy(fill), npp, ps)
        # rows the engine keeps; an unfilled row may read the trash page
        _close(got, want, ATOL_LOGITS, rows=fill)

    prompt0 = rng.integers(0, cfg.vocab_size - 1, size=13)
    tokens = np.zeros((b, 16), np.int32)
    tokens[0, :13] = prompt0
    both_prefill(tokens, np.array([13, 1, 1], np.int32),
                 np.array([True, False, False]), 0)
    tokens = np.zeros((b, 8), np.int32)
    tokens[1, :4] = rng.integers(0, cfg.vocab_size - 1, size=4)
    both_prefill(tokens, np.array([1, 4, 1], np.int32),
                 np.array([False, True, False]), 1)

    pos = np.array([13, ps + 4, 0], np.int32)
    active = np.array([True, True, False])
    for _ in range(3):
        token = rng.integers(0, cfg.vocab_size - 1, size=(b, 1)).astype(np.int32)
        want, jpools = _jmodel_decode(
            jcfg, params, jpools, jnp.asarray(pt), jnp.asarray(token),
            jnp.asarray(pos), jnp.asarray(active), page_size=ps)
        got, tpools = Transformer.paged_decode_step(
            cfg, tparams, tpools, torch.from_numpy(pt),
            torch.from_numpy(token), torch.from_numpy(pos),
            torch.from_numpy(active), page_size=ps)
        _close(got, want, ATOL_LOGITS, rows=active)
        assert (got[..., cfg.vocab_size:] == -1e30).all()
        pos = pos + active


def test_init_has_the_jax_tree_shapes_and_dtypes(smoke):
    jcfg, cfg, params = smoke
    tparams = params_to_numpy(Transformer.init(cfg, 0, device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tparams)[0]
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert a.shape == t.shape and a.dtype == t.dtype
    # the draw is the JAX one in distribution: truncated at 2 std
    wq = tparams["blocks"]["b0"]["mixer"]["wq"]
    assert np.abs(wq).max() <= 2 / np.sqrt(cfg.d_model) + 1e-7
    assert 0.7 < wq.std() * np.sqrt(cfg.d_model) < 1.0


def test_interop_round_trip_is_bit_exact(smoke):
    _, _, params = smoke
    back = params_to_numpy(params_from_numpy(params, "cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    tflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert a.dtype == t.dtype and a.tobytes() == t.tobytes()


def test_interop_bf16_keeps_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(8).standard_normal(
        (4, 5)), jnp.bfloat16))
    t = params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == a.view(np.int16).tobytes()
    back = params_to_numpy({"w": t})["w"]
    np.testing.assert_array_equal(back, a.astype(np.float32))
