"""The PyTorch port's dense serving engine (the default) against the JAX
package.

The Transformer's dense prefill and decode step are held against the JAX
package's on Granite SMOKE in f32 (logits 1e-4, caches 1e-5, as in
``tests/test_torch_model.py``).  Greedy serving is compared token by token:
the port's ``ServeEngine(device="cpu")`` and the JAX ``ServeEngine`` serve
the same numpy-seeded streams from the same parameters (carried over by
``repro_torch.interop``), with full caches and with ``--ring``'s config
(window 32, ``ring_cache=True``); the port's dense engine against its
paged one; a hot-swap committed before every tick offset of a short
stream, dense and paged, against the JAX engine under the same schedule;
and the serving CLI's cache options.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.swa_decode import swa_decode  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine, build_stream  # noqa: E402

ATOL_LOGITS = 1e-4
ATOL_CACHE = 1e-5
RING = dict(sliding_window=32, ring_cache=True)   # launch/serve.py --ring
SLOTS, MAX_LEN, PAGE = 3, 64, 8

_jprefill = jax.jit(JTransformer.prefill, static_argnums=(0, 3))
_jdecode = jax.jit(JTransformer.decode_step, static_argnums=(0,))


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


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def smoke():
    """Granite SMOKE in both packages and two JAX-initialised weight sets.
    (``remat`` only changes what JAX's backward pass keeps.)"""
    jcfg = dataclasses.replace(jregistry.get_smoke_config("granite-3-2b"),
                               remat="none")
    init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
    mesh = make_test_mesh()
    with mesh_context(mesh):
        jparams = [init(jax.random.key(s)) for s in (0, 1)]
    return (mesh, jcfg, registry.get_smoke_config("granite-3-2b"), jparams,
            [params_from_numpy(_np(p), "cpu") for p in jparams])


@pytest.mark.parametrize("ring", [False, True])
def test_transformer_prefill_and_decode_match_jax(smoke, ring):
    """A right-padded prefill of three prompts (one longer than the ring,
    one shorter) and four decode ticks at per-slot positions, past the ring's
    first wrap; logits and every layer's cache are compared."""
    _, jcfg, cfg, jparams, params = smoke
    if ring:
        jcfg = dataclasses.replace(jcfg, **RING)
        cfg = dataclasses.replace(cfg, **RING)
    rng = np.random.default_rng(11)
    lengths = np.array([40, 9, 31], np.int32)
    tokens = np.zeros((3, 64), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(0, cfg.vocab_size - 1, size=n)
    want, jcaches = _jprefill(jcfg, jparams[0], {"tokens": jnp.asarray(tokens)},
                              MAX_LEN, jnp.asarray(lengths))
    got, caches = Transformer.prefill(cfg, params[0],
                                      {"tokens": torch.from_numpy(tokens)},
                                      MAX_LEN, torch.from_numpy(lengths))
    for b, n in enumerate(lengths):   # pad rows' logits are never read
        _close(got[b, :n], want[b, :n], ATOL_LOGITS)
    assert caches["blocks"]["b0"]["k"].shape == (
        cfg.num_layers, 3, 32 if ring else MAX_LEN, cfg.kv_heads, cfg.hd)
    pos = lengths.copy()
    for _ in range(4):
        token = rng.integers(0, cfg.vocab_size - 1, size=(3, 1)).astype(np.int32)
        want, jcaches = _jdecode(jcfg, jparams[0], jcaches, jnp.asarray(token),
                                 jnp.asarray(pos))
        got, caches = Transformer.decode_step(cfg, params[0], caches,
                                              torch.from_numpy(token),
                                              torch.from_numpy(pos))
        _close(got, want, ATOL_LOGITS)
        assert (got[..., cfg.vocab_size:] == -1e30).all()
        pos = pos + 1
    for key in ("k", "v"):
        _close(caches["blocks"]["b0"][key], jcaches["blocks"]["b0"][key],
               ATOL_CACHE)


@pytest.fixture(scope="module")
def engines(smoke):
    """JAX and port engines on Granite SMOKE from the same weights: dense
    with full caches, dense with ``--ring``'s config, and paged.  Reset
    between streams, prefill buckets of 32 and 64 only, so the JAX side
    compiles few executables (bucket padding is invisible to the tokens)."""
    mesh, jcfg, cfg, jparams, params = smoke
    kw = dict(slots=SLOTS, max_len=MAX_LEN, min_bucket=32)
    out = {}
    for name, extra, paged in (("full", {}, False), ("ring", RING, False),
                               ("paged", {}, True)):
        with mesh_context(mesh):
            jeng = JServeEngine(dataclasses.replace(jcfg, **extra), jparams[0],
                                paged=paged, page_size=PAGE, **kw)
        eng = ServeEngine(dataclasses.replace(cfg, **extra), params[0],
                          paged=paged, page_size=PAGE, device="cpu", **kw)
        out[name] = (jeng, eng)
    return mesh, cfg, out


def _stream(cfg, name, **kw):
    """8 requests with prompts up to 40 tokens and up to 12 new ones, so
    ring slots wrap (positions up to 51 in a 32-slot ring)."""
    return build_stream(name, 8, vocab=cfg.vocab_size, seed=17,
                        prompt_max=40, out_max=12, **kw)


@pytest.mark.parametrize("cache", ["full", "ring"])
@pytest.mark.parametrize("stream", ["poisson", "bursty", "diurnal",
                                    "heavy_tail"])
def test_dense_engine_tokens_match_jax(engines, stream, cache):
    mesh, cfg, eng = engines
    jengine, engine = eng[cache]
    with mesh_context(mesh):
        jengine.reset()
        want = {r.rid: r.out for r in jengine.run(_stream(cfg, stream),
                                                  log=None)}
    engine.reset()
    finished = engine.run(_stream(cfg, stream), log=None)
    assert {r.rid: r.out for r in finished} == want
    assert engine.ticks == jengine.ticks
    assert engine.prefix_stats() == jengine.prefix_stats()
    assert engine.resident_cache_bytes() == jengine.resident_cache_bytes()
    assert engine.cache_page_bytes() == 0
    if cache == "ring" and stream != "heavy_tail":
        # slots wrapped round the ring (heavy_tail's lognormal lengths,
        # mostly short, stay inside it)
        assert max(len(r.prompt) + len(r.out) for r in finished) > 32


@pytest.mark.parametrize("stream,shared_prefix", [("poisson", 0),
                                                  ("bursty", 16)])
def test_dense_engine_matches_paged_engine(engines, stream, shared_prefix):
    _, cfg, eng = engines
    outs = {}
    for name in ("full", "paged"):
        engine = eng[name][1]
        engine.reset()
        outs[name] = {r.rid: r.out for r in engine.run(
            _stream(cfg, stream, shared_prefix=shared_prefix))}
    assert outs["full"] == outs["paged"]
    if shared_prefix:
        assert eng["paged"][1].prefix_stats()["hits"] > 0


@pytest.mark.parametrize("cache", ["full", "paged"])
def test_hot_swap_at_every_tick_offset_matches_jax(engines, smoke, cache):
    """One short schedule (two requests sharing a 10-token prompt prefix, the
    second arriving at tick 2), a hot-swap to the second weight set
    committed before tick ``off`` for every ``off`` in [0, T] (T: the swap
    never fires).  The port must emit the JAX engine's tokens and swap log
    at every offset; on the paged engine the swap also drops the prefix
    cache, so the hit counts must agree too."""
    mesh, cfg, eng = engines
    jparams, params = smoke[3], smoke[4]
    jengine, engine = eng[cache]
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size - 1, size=10)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size - 1,
                                                    size=n)]) for n in (3, 5)]

    def reqs(cls):
        return [cls(rid=0, arrival=0, prompt=prompts[0], max_new=6),
                cls(rid=1, arrival=2, prompt=prompts[1], max_new=5)]

    def serve(e, cls, ps, off):
        e.reset()
        e.params = ps[0]
        e.begin(reqs(cls), log=None)
        while e.pending():
            if e.swaps == 0 and e.ticks == off:
                e.hot_swap(ps[1])
            e.tick()
        return ({r.rid: r.out for r in e._finished}, list(e.swap_log),
                e.prefix_stats())

    with mesh_context(mesh):
        serve(jengine, JRequest, jparams, -1)
        total = jengine.ticks
        assert total > 2
        seen = set()
        for off in range(total + 1):
            want = serve(jengine, JRequest, jparams, off)
            got = serve(engine, Request, params, off)
            assert got == want, f"off={off}"
            assert got[1] == ([off] if off < total else [])
            seen.add(repr(got[0]))
        assert len(seen) > 2     # the swap offset changes what is served
        jengine.params, engine.params = jparams[0], params[0]


def test_swap_counters_and_reset(smoke):
    _, _, cfg, _, params = smoke
    engine = ServeEngine(cfg, params[0], slots=1, max_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="stage_params"):
        engine.commit_swap()
    engine.stage_params(params[1])
    assert engine.params is params[0]            # nothing served changes yet
    staged = engine._standby["embed"]["table"]
    assert torch.equal(staged, params[1]["embed"]["table"])
    assert staged.data_ptr() != params[1]["embed"]["table"].data_ptr()
    engine.commit_swap()
    assert engine.swaps == 1 and engine.swap_log == [0]
    with pytest.raises(RuntimeError, match="stage_params"):
        engine.commit_swap()
    engine.stage_params(params[0])
    engine.reset()
    assert engine.swaps == 0 and engine.swap_log == [] and \
        engine._standby is None


def test_serve_cli_cache_options(capsys):
    common = ["--device", "cpu", "--requests", "3", "--slots", "2",
              "--max-len", "48"]
    before = swa_decode.launches
    finished = serve_cli.main(common)                 # dense is the default
    out = capsys.readouterr().out
    assert len(finished) == 3 and "full cache" in out
    assert "prefix hits" not in out
    finished = serve_cli.main(common + ["--ring"])
    assert len(finished) == 3 and "ring cache" in capsys.readouterr().out
    finished = serve_cli.main(common + ["--paged", "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and "paged cache" in out and "prefix hits" in out
    with pytest.raises(SystemExit, match="exclusive"):
        serve_cli.main(common + ["--ring", "--paged"])
    assert swa_decode.launches == before          # the CPU runs the plain path
