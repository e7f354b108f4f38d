"""Recurrent serving in the PyTorch port (Mamba-2 and RecurrentGemma)
against the JAX package.

On the two SMOKE configs in f32: the registry entries; ``Transformer.init``'s
tree, shapes and per-leaf dtypes (f32 ``A_log``/``D``/``dt_bias`` and
``b_a``/``b_x``/``lam`` in a bf16 model too); an exact-length prefill's
logits and caches and three decode steps against the JAX package's (the
recurrent state must advance in the stacked caches); prefill->decode
consistency; padded prefill and the paged engine refused; the dense
``ServeEngine``'s greedy tokens against the JAX engine's on a stream with
same-tick arrivals of different and of equal lengths and prompts longer
than ``ssm_chunk`` (prime lengths included, so the SSD chunk falls to 1),
with and without a hot-swap at a fixed tick; and the serving CLI.
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
from repro.serve import build_stream as jbuild_stream  # noqa: E402
from repro_torch.checkpoint import save_tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import LMConfig, Transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine, build_stream  # noqa: E402

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
# f32 logits through 2-5 recurrent/attention layers and a 512-way unembed:
# sums in another order than XLA's, ~1e-6 apart (tests/test_torch_model.py
# holds the attention-only model at the same bounds).
ATOL_LOGITS = 1e-4
# Caches: K/V and conv windows of order 1, SSM state up to ~3: 1e-5
# absolute plus 1e-5 relative.
TOL_CACHE = 1e-5
SLOTS, MAX_LEN = 3, 96

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


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


_SMOKE = {}


def _smoke(arch):
    """The arch's SMOKE config in both packages and two JAX-initialised
    weight sets, carried across.  (``remat`` only changes what JAX's
    backward pass keeps.)"""
    if arch not in _SMOKE:
        jcfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                                   remat="none")
        init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
        mesh = make_test_mesh()
        with mesh_context(mesh):
            jparams = [init(jax.random.key(s)) for s in (0, 1)]
        _SMOKE[arch] = (mesh, jcfg, registry.get_smoke_config(arch), jparams,
                        [params_from_numpy(_np(p), "cpu") for p in jparams])
    return _SMOKE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_resolves_recurrent_archs(arch):
    for get in ("get_config", "get_smoke_config"):
        cfg, jcfg = getattr(registry, get)(arch), getattr(jregistry, get)(arch)
        for f in dataclasses.fields(LMConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert registry.get_family(arch) == jregistry.get_family(arch)
    assert arch in registry.list_archs()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_shapes_and_dtypes_match_jax(arch, dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), **kw)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), **kw)
    want = dict(_leaves(jax.eval_shape(
        lambda k: JTransformer.init(jcfg, k)[0], jax.random.key(0))))
    got = dict(_leaves(Transformer.init(cfg, 0, device="cpu")))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
    mixer = "blocks/b0/mixer/"
    f32 = (("A_log", "D", "dt_bias") if arch == "mamba2-370m"
           else ("b_a", "b_x", "lam"))
    for key in f32:
        assert got[mixer + key].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keeps_mixed_dtypes(arch):
    """A JAX-initialised bf16 tree with f32 leaves crosses over with every
    leaf's own dtype and value (no ``dtype=``, which would cast them all)."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), **kw)
    init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
    jparams = _np(init(jax.random.key(3)))
    got = dict(_leaves(params_from_numpy(jparams, "cpu")))
    want = dict(_leaves(jparams))
    assert {str(t.dtype).split(".")[-1] for t in got.values()} == {
        "float32", "bfloat16"}
    for name, t in got.items():
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      want[name].astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """An exact-length prefill of three 37-token prompts (chunk 1 at
    ``ssm_chunk`` 32), then three decode steps at per-row positions through
    the prefill's own caches: logits and every cache leaf are compared, so
    a state that is not written back into the stacked caches fails."""
    mesh, jcfg, cfg, jparams, params = _smoke(arch)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size - 1, size=(3, 37)).astype(np.int32)
    max_len = 48
    with mesh_context(mesh):
        want, jcaches = _jprefill(jcfg, jparams[0],
                                  {"tokens": jnp.asarray(tokens)}, max_len)
    got, caches = Transformer.prefill(cfg, params[0],
                                      {"tokens": torch.from_numpy(tokens)},
                                      max_len)
    _close(got, want, ATOL_LOGITS)
    jleaves = dict(_leaves(_np(jcaches)))
    assert sorted(jleaves) == sorted(n for n, _ in _leaves(caches))
    for name, c in _leaves(caches):
        j = jleaves[name]
        assert tuple(c.shape) == j.shape, name
        assert str(c.dtype).split(".")[-1] == j.dtype.name, name
        _close(c, j, TOL_CACHE, TOL_CACHE)
    pos = np.array([37, 37, 37], np.int32)
    first = {n: c.clone() for n, c in _leaves(caches)}
    for _ in range(3):
        token = rng.integers(0, cfg.vocab_size - 1, size=(3, 1)).astype(np.int32)
        with mesh_context(mesh):
            want, jcaches = _jdecode(jcfg, jparams[0], jcaches,
                                     jnp.asarray(token), jnp.asarray(pos))
        got, caches = Transformer.decode_step(cfg, params[0], caches,
                                              torch.from_numpy(token),
                                              torch.from_numpy(pos))
        _close(got, want, ATOL_LOGITS)
        pos = pos + 1
    jleaves = dict(_leaves(_np(jcaches)))
    for name, c in _leaves(caches):
        _close(c, jleaves[name], TOL_CACHE, TOL_CACHE)
        if name.endswith(("ssm", "h", "conv", "conv_x")):
            assert not torch.equal(c, first[name]), f"{name} never advanced"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == prefill(prompt + token) logits at
    that position (``tests/test_models_smoke.py``'s check, rtol 5e-4)."""
    _, _, cfg, _, params = _smoke(arch)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size - 1, size=(2, 33)).astype(np.int32))
    nxt = torch.zeros((2, 1), dtype=torch.int32)
    full, _ = Transformer.prefill(cfg, params[0],
                                  {"tokens": torch.cat([toks, nxt], 1)}, 40)
    _, caches = Transformer.prefill(cfg, params[0], {"tokens": toks}, 40)
    lg, _ = Transformer.decode_step(cfg, params[0], caches, nxt, 33)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 33].numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_and_paged_engine_raise(arch, tmp_path):
    _, _, cfg, _, params = _smoke(arch)
    with pytest.raises(ValueError, match="recurrent"):
        Transformer.prefill(cfg, params[0], {"tokens": torch.zeros(
            (2, 8), dtype=torch.int32)}, 16, lengths=torch.tensor([8, 5]))
    with pytest.raises(ValueError, match="recurrent"):
        ServeEngine(cfg, params[0], slots=2, max_len=32, paged=True,
                    device="cpu")
    # The engine's carry/restore is ported (slice 6): a recurrent engine
    # saved mid-stream (f32 state and conv windows in the carry) resumes
    # to the uninterrupted run's tokens.
    def mk():
        return ServeEngine(cfg, params[0], slots=2, max_len=80, device="cpu")

    want = {r.rid: r.out for r in mk().run(_requests(Request,
                                                      cfg.vocab_size))}
    engine = mk()
    engine.begin(_requests(Request, cfg.vocab_size))
    for _ in range(3):
        engine.tick()
    tree, meta = engine.carry()
    path = str(tmp_path / "recurrent_engine.npz")
    save_tree(path, {"engine": tree}, meta)
    resumed, reqs = mk(), _requests(Request, cfg.vocab_size)
    resumed.restore(path, meta, reqs)
    while resumed.pending():
        resumed.tick()
    assert {r.rid: r.out for r in resumed._finished} == want


# (rid, arrival, prompt length, max_new): three arrivals at tick 0 with two
# equal lengths and one prime length above ssm_chunk (32), then two more at
# tick 1 (64: two chunks of 32; 41: prime) that wait for free slots, and a
# late short one.
SCHEDULE = ((0, 0, 37, 6), (1, 0, 12, 5), (2, 0, 12, 7), (3, 1, 64, 4),
            (4, 1, 41, 5), (5, 4, 12, 3))


def _requests(cls, vocab):
    rng = np.random.default_rng(17)
    return [cls(rid=r, arrival=a, prompt=rng.integers(0, vocab - 1, size=n),
                max_new=m) for r, a, n, m in SCHEDULE]


def _serve(engine, cls, weights, vocab, swap_at=None):
    """Serve the schedule from ``weights[0]``; with ``swap_at``, hot-swap to
    ``weights[1]`` before that tick.  Returns ({rid: tokens}, swap log,
    admission log)."""
    engine.reset()
    engine.params = weights[0]
    lines = []
    engine.begin(_requests(cls, vocab), log=lines.append)
    while engine.pending():
        if swap_at is not None and engine.swaps == 0 and \
                engine.ticks == swap_at:
            engine.hot_swap(weights[1])
        engine.tick()
    admits = [ln for ln in lines if "admit" in ln]
    return ({r.rid: r.out for r in engine._finished}, list(engine.swap_log),
            admits)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_tokens_match_jax(arch):
    """Exact-length admission, shortest group first, then decode; with no
    swap and with a swap committed before tick 3 (mid-decode for some
    slots, before admission for others)."""
    mesh, jcfg, cfg, jparams, params = _smoke(arch)
    kw = dict(slots=SLOTS, max_len=MAX_LEN)
    with mesh_context(mesh):
        jengine = JServeEngine(jcfg, jparams[0], **kw)
    engine = ServeEngine(cfg, params[0], device="cpu", **kw)
    assert not engine._bucketed
    launches = (ssd.launches, rglru.launches)
    outs = []
    for swap_at in (None, 3):
        with mesh_context(mesh):
            want = _serve(jengine, JRequest, jparams, cfg.vocab_size, swap_at)
        got = _serve(engine, Request, params, cfg.vocab_size, swap_at)
        assert got == want
        assert engine.ticks == jengine.ticks
        assert engine.resident_cache_bytes() == jengine.resident_cache_bytes()
        outs.append(got[0])
        assert {r: len(o) for r, o in got[0].items()} == {
            r: m for r, _, _, m in SCHEDULE}
    # same-tick arrivals: the two 12-token prompts share one prefill, run
    # before the 37-token one
    assert [ln.split("(")[1] for ln in got[2][:3]] == [
        "prompt 12 pad 12)", "prompt 12 pad 12)", "prompt 37 pad 37)"]
    assert outs[0] != outs[1]                 # the swap changed the tokens
    assert got[1] == [3]
    for name, t in engine.caches["blocks"]["b0"].items():
        if name in ("ssm", "h", "conv", "conv_x"):
            assert t.dtype == torch.float32, name
    assert (ssd.launches, rglru.launches) == launches  # plain path on the CPU


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_recurrent_archs(arch, capsys):
    common = ["--arch", arch, "--device", "cpu", "--requests", "3",
              "--slots", "2", "--max-len", "48"]
    finished = serve_cli.main(common)
    assert len(finished) == 3 and "full cache" in capsys.readouterr().out
    with pytest.raises(ValueError, match="recurrent"):
        serve_cli.main(common + ["--paged"])


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_bursty_stream_matches_jax(arch):
    """The named ``bursty`` stream (bursts of 2-6 same-tick arrivals,
    prompts up to 40 tokens) served by both engines."""
    mesh, jcfg, cfg, jparams, params = _smoke(arch)
    kw = dict(slots=SLOTS, max_len=MAX_LEN)

    def stream(build):
        return build("bursty", 6, vocab=cfg.vocab_size, seed=3, prompt_max=40,
                     out_max=8)

    with mesh_context(mesh):
        jengine = JServeEngine(jcfg, jparams[0], **kw)
        want = {r.rid: r.out for r in jengine.run(stream(jbuild_stream))}
    engine = ServeEngine(cfg, params[0], device="cpu", **kw)
    assert {r.rid: r.out for r in engine.run(stream(build_stream))} == want
    assert engine.ticks == jengine.ticks
