"""The four dense archs the port serves on its existing layers, against the
JAX package, on the CPU in f32: ``qwen3-14b`` (qk-norm), ``qwen1.5-4b``
(QKV bias), ``nemotron-4-340b`` (squared-ReLU MLP, LayerNorm) and
``qwen2-vl-72b`` (M-RoPE, QKV bias, vision embeddings scattered into the
sequence).

Each arch's ``SMOKE`` config is initialised by the JAX package, its biases
and norm parameters redrawn away from their 0 / 1 init (so that every one
of them changes the result), and carried over (``repro_torch.interop``).
Prefill logits agree within 1e-4 and caches within 1e-5 (f32 sums in
another order, as in ``tests/test_torch_model.py``); M-RoPE within 1e-4
on three different position streams (angles up to 900 rad); the dense and
paged ``ServeEngine`` emit the JAX engine's greedy tokens.
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
from repro.nn import rope as jrope  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.nn import rope  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402

ARCHS = ("qwen3-14b", "qwen1.5-4b", "nemotron-4-340b", "qwen2-vl-72b")
ATOL_LOGITS = 1e-4
ATOL_CACHE = 1e-5
MAX_LEN = 64
# Rotary angles up to 900 rad: one f32 ulp of such an angle is 6e-5 rad,
# and the two packages' theta ** (-2i / D) may differ in the last bit.
ATOL_ROPE = 1e-4

_jinit = jax.jit(lambda cfg, key: JTransformer.init(cfg, key)[0],
                 static_argnums=(0,))
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


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _redraw(tree, rng, path=()):
    """Biases drawn around 0 and norm scales around 1 (JAX inits them at 0
    and 1, where a missing bias or scale would go unseen)."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, path + (k,)) for k, v in tree.items()}
    name, parent = path[-1], path[-2]
    noise = (0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    if name in ("bq", "bk", "bv") or (name == "bias" and parent != "mixer"):
        return noise
    if name in ("q_norm", "k_norm", "scale"):
        return 1 + noise
    return tree


@pytest.fixture(scope="module")
def smoke():
    """arch -> (mesh, JAX SMOKE config, port SMOKE config, JAX params, port
    params); ``remat`` only changes what JAX's backward pass keeps."""
    mesh = make_test_mesh()
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                                   remat="none")
        with mesh_context(mesh):
            weights = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.key(i)))
        weights = _redraw(weights, np.random.default_rng(100 + i))
        out[arch] = (mesh, jcfg, registry.get_smoke_config(arch),
                     jax.tree.map(jnp.asarray, weights),
                     params_from_numpy(weights, "cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_originals(arch):
    """Every field the port's LMConfig has equals the JAX config's, in
    CONFIG and SMOKE, and so do the attention configs and the family."""
    for get in ("get_config", "get_smoke_config"):
        mine, theirs = getattr(registry, get)(arch), getattr(jregistry, get)(arch)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        a, b = mine.attn_cfg(False), theirs.attn_cfg(False)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert registry.get_family(arch) == jregistry.get_family(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_jax_tree_shapes_and_dtypes(smoke, arch):
    """The port's random init has the JAX tree, so interop carries every
    arch's biases, q/k norms and LayerNorm biases across unchanged."""
    _, _, cfg, jparams, _ = smoke[arch]
    mine = params_to_numpy(Transformer.init(cfg, 0, device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert a.shape == t.shape and a.dtype == t.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(smoke, arch):
    mesh, jcfg, cfg, jparams, params = smoke[arch]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size - 1, size=(2, 24)).astype(np.int32)
    with mesh_context(mesh):
        want, jcaches = _jprefill(jcfg, jparams,
                                  {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    got, caches = Transformer.prefill(cfg, params,
                                      {"tokens": torch.from_numpy(tokens)},
                                      MAX_LEN)
    _close(got, want, ATOL_LOGITS)
    for key in ("k", "v"):
        _close(caches["blocks"]["b0"][key], jcaches["blocks"]["b0"][key],
               ATOL_CACHE)


@pytest.mark.parametrize("sections,theta", [((8, 12, 12), 10000.0),
                                            ((16, 24, 24), 1e6)])
def test_apply_mrope_matches_jax_on_three_streams(sections, theta):
    """(B, 3, S) positions whose t, h and w streams all differ, at SMOKE's
    and CONFIG's sections; with one stream broadcast, M-RoPE is RoPE."""
    d = 2 * sum(sections)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    positions = rng.integers(0, 900, size=(2, 3, 7)).astype(np.int32)
    assert all((positions[:, i] != positions[:, j]).any()
               for i, j in ((0, 1), (0, 2), (1, 2)))
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(positions),
                           sections, theta)
    _close(got, jrope.apply_mrope(jnp.asarray(x), jnp.asarray(positions),
                                  sections, theta), ATOL_ROPE)
    text = np.repeat(positions[:, :1], 3, axis=1)
    _close(rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                            sections, theta),
           rope.apply_rope(torch.from_numpy(x), torch.from_numpy(text[:, 0]),
                           theta), 0.0)
    with pytest.raises(ValueError, match="sum to"):
        rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(positions),
                         (8, 8, 8), theta)


def _vision_batch(cfg, rng):
    """Two prompts of 20 tokens, each with a 2 x 3 patch grid (one frame)
    at rows 4-9 of the first and 10-15 of the second; Qwen2-VL's positions:
    text before the grid at its index on all three streams, the grid at
    (start, start + h, start + w), text after it resuming past the grid's
    largest position."""
    b, s, grid = 2, 20, (2, 3)
    tokens = rng.integers(0, cfg.vocab_size - 1, size=(b, s)).astype(np.int32)
    n_patch = grid[0] * grid[1]
    vpos = np.zeros((b, n_patch), np.int32)
    positions = np.zeros((b, 3, s), np.int32)
    for row, start in enumerate((4, 10)):
        vpos[row] = start + np.arange(n_patch)
        positions[row, :, :start] = np.arange(start)
        hh, ww = np.meshgrid(np.arange(grid[0]), np.arange(grid[1]),
                             indexing="ij")
        positions[row, 0, start:start + n_patch] = start
        positions[row, 1, start:start + n_patch] = start + hh.ravel()
        positions[row, 2, start:start + n_patch] = start + ww.ravel()
        nxt = start + max(grid)
        rest = s - start - n_patch
        positions[row, :, start + n_patch:] = nxt + np.arange(rest)
    embeds = rng.standard_normal((b, n_patch, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "vision_embeds": embeds,
            "vision_positions": vpos, "positions": positions}


def test_vlm_prefill_with_vision_embeds_and_decode_match_jax(smoke):
    """``Transformer.prefill`` with ``vision_embeds`` and a vision grid's
    three position streams, then two decode steps at M-RoPE positions past
    the grid (not the cache index), against the JAX package; the grid's
    streams change the logits, so M-RoPE is exercised and not RoPE."""
    mesh, jcfg, cfg, jparams, params = smoke["qwen2-vl-72b"]
    rng = np.random.default_rng(9)
    batch = _vision_batch(cfg, rng)
    with mesh_context(mesh):
        want, jcaches = _jprefill(jcfg, jparams,
                                  jax.tree.map(jnp.asarray, batch), MAX_LEN)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, caches = Transformer.prefill(cfg, params, tbatch, MAX_LEN)
    _close(got, want, ATOL_LOGITS)
    for key in ("k", "v"):
        _close(caches["blocks"]["b0"][key], jcaches["blocks"]["b0"][key],
               ATOL_CACHE)
    text = Transformer.prefill(cfg, params, {
        k: v for k, v in tbatch.items() if k != "positions"}, MAX_LEN)[0]
    assert (text - got).abs().max() > 1e-2
    no_vision = Transformer.prefill(cfg, params, {
        k: v for k, v in tbatch.items() if not k.startswith("vision")},
        MAX_LEN)[0]
    assert (no_vision - got).abs().max() > 1e-2

    pos = np.array([20, 20], np.int32)
    rope_pos = batch["positions"][:, :, -1:] + 1
    for _ in range(2):
        token = rng.integers(0, cfg.vocab_size - 1, size=(2, 1)).astype(np.int32)
        with mesh_context(mesh):
            want, jcaches = _jdecode(jcfg, jparams, jcaches, jnp.asarray(token),
                                     jnp.asarray(pos), jnp.asarray(rope_pos))
        got, caches = Transformer.decode_step(
            cfg, params, caches, torch.from_numpy(token),
            torch.from_numpy(pos), torch.from_numpy(rope_pos))
        _close(got, want, ATOL_LOGITS)
        pos, rope_pos = pos + 1, rope_pos + 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(smoke, arch, paged):
    """Greedy serving of one bursty stream with a shared prompt prefix
    (prefix hits on the paged engine), token by token; prefill buckets of
    32 and 64 only, so the JAX side compiles few executables."""
    mesh, jcfg, cfg, jparams, params = smoke[arch]
    kw = dict(slots=3, max_len=MAX_LEN, min_bucket=32, paged=paged,
              page_size=8)
    reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size, seed=21,  # noqa: E731
                                prompt_max=24, out_max=8, shared_prefix=8)
    with mesh_context(mesh):
        jengine = JServeEngine(jcfg, jparams, **kw)
        want = {r.rid: r.out for r in jengine.run(reqs(), log=None)}
    engine = ServeEngine(cfg, params, device="cpu", **kw)
    assert {r.rid: r.out for r in engine.run(reqs(), log=None)} == want
    assert engine.ticks == jengine.ticks
    assert engine.prefix_stats() == jengine.prefix_stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_cpu(arch, capsys):
    for extra in ([], ["--paged", "--shared-prefix", "8"]):
        finished = serve_cli.main(["--device", "cpu", "--arch", arch,
                                   "--requests", "2", "--slots", "2",
                                   "--max-len", "48", "--out-max", "4",
                                   *extra])
        assert len(finished) == 2
    assert "prefix hits" in capsys.readouterr().out
