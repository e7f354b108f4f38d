"""The encoder front end (hubert-xlarge) of the PyTorch port against the
JAX package, on the CPU in f32.

hubert SMOKE's init tree (``in_proj`` with a bias and ``mask_embed`` in
place of the embedding table) has the JAX package's keys, shapes and
dtypes.  From carried-over weights (``repro_torch.interop``), the logits of
a batch of feature frames, with and without a frame mask, agree with
``JTransformer.apply`` within 1e-4 absolute, and the masked pretrain step's
loss within 1e-5 and its gradients within 1e-4 of each leaf's largest
gradient (``tests/test_torch_train.py``'s tolerances: f32 sums in another
order through two bidirectional layers).  The serving engine, the serving
CLI and the LLM trainer refuse the encoder as the JAX package's do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as JSt  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim.optimizers import Optimizer as JOptimizer  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import Optimizer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "hubert-xlarge"
ATOL_LOGITS = 1e-4
ATOL_LOSS = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 24

_japply = jax.jit(JTransformer.apply, static_argnums=0)

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
    """(mesh, JAX SMOKE config, port SMOKE config, numpy weights with a
    non-zero ``mask_embed`` and ``in_proj`` bias, so both reach the
    logits)."""
    mesh = make_test_mesh()
    jcfg = jregistry.get_smoke_config(ARCH)
    init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
    with mesh_context(mesh):
        weights = jax.tree.map(np.asarray, init(jax.random.key(3)))
    rng = np.random.default_rng(0)
    weights["mask_embed"] = rng.standard_normal(
        weights["mask_embed"].shape).astype(np.float32)
    weights["in_proj"]["b"] = 0.1 * rng.standard_normal(
        weights["in_proj"]["b"].shape).astype(np.float32)
    return mesh, jcfg, registry.get_smoke_config(ARCH), weights


def _batch(cfg, seed, mask=True):
    """Feature frames from the seed; every 4th frame masked, labels from
    the 504-entry codebook."""
    rng = np.random.default_rng(seed)
    batch = {"features": rng.standard_normal(
                 (B, S, cfg.feat_dim)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    if mask:
        m = np.zeros((B, S), bool)
        m[:, ::4] = True
        batch["mask"] = m
    return batch


def test_init_tree_equals_the_jax_tree(smoke):
    _, jcfg, cfg, weights = smoke
    got = params_to_numpy(Transformer.init(cfg, 0, device="cpu"))
    want = jax.tree_util.tree_flatten_with_path(weights)[0]
    mine = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in mine] == [k for k, _ in want]
    for (path, a), (_, b) in zip(mine, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert "embed" not in got and got["in_proj"]["w"].shape == (64, 256)
    assert not got["mask_embed"].any() and not got["in_proj"]["b"].any()
    # Encoders attend bidirectionally without rotary positions.
    for c in (cfg, jcfg):
        a = c.attn_cfg(False)
        assert a.rope == "none" and not a.causal


@pytest.mark.parametrize("mask", [False, True])
def test_logits_match_jax(smoke, mask):
    mesh, jcfg, cfg, weights = smoke
    batch = _batch(cfg, 1, mask=mask)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with mesh_context(mesh):
        want, _ = _japply(jcfg, jax.tree.map(jnp.asarray, weights),
                          jax.tree.map(jnp.asarray, inputs))
    with torch.no_grad():
        got, aux = Transformer.apply(
            cfg, params_from_numpy(weights, "cpu"),
            {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_LOGITS)
    if mask:   # the masked frames really changed what the encoder saw
        with torch.no_grad():
            plain, _ = Transformer.apply(
                cfg, params_from_numpy(weights, "cpu"),
                {"features": torch.from_numpy(batch["features"])})
        assert float((plain - got).abs().max()) > 1e-2


@pytest.mark.parametrize("chunk", [24, 8])
def test_masked_pretrain_step_matches_jax(smoke, chunk):
    """The plain masked CE (the fused KD kernel has no token mask), one
    loss chunk and then three under checkpoint."""
    mesh, jcfg, cfg, weights = smoke
    batch = _batch(cfg, 2)
    with mesh_context(mesh):
        jstep = jax.jit(JSt.make_pretrain_step(jcfg, JGRAD, loss_chunk=chunk))
        want, _, jm = jstep(jax.tree.map(jnp.asarray, weights), {},
                            jax.tree.map(jnp.asarray, batch), jnp.int32(0))
    step = St.make_pretrain_step(cfg, GRAD, loss_chunk=chunk)
    got, _, m = step(params_from_numpy(weights, "cpu"), {},
                     {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0,
                               atol=ATOL_LOSS)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = jax.tree_util.tree_flatten_with_path(params_to_numpy(got))[0]
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (path, w), (_, g) in zip(jflat, tflat):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, path
        assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale, path


def test_encoder_refusals_match_the_reference(smoke, capsys):
    mesh, jcfg, cfg, weights = smoke
    with pytest.raises(ValueError, match="encoder-only arch has no decode"):
        JServeEngine(jcfg, jax.tree.map(jnp.asarray, weights), slots=1,
                     max_len=16)
    with pytest.raises(ValueError, match="encoder-only arch has no decode"):
        ServeEngine(cfg, params_from_numpy(weights, "cpu"), slots=1,
                    max_len=16, device="cpu")
    for main, extra in ((jserve.main, []), (serve.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="encoder-only arch has no "
                                             "decode step"):
            main(["--arch", ARCH] + extra)
    for main, extra in ((jtrain.main, []), (train.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="train.py drives token-LM FL"):
            main(["--arch", ARCH] + extra)
