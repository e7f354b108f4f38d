"""Training the recurrent archs (Mamba-2's SSD blocks, RecurrentGemma's
RG-LRU blocks) in the PyTorch port against the JAX package, on the CPU.

The JAX model's full-sequence forward never sets ``use_kernel`` (its
``nn/ssm.py::forward`` and ``nn/rglru.py::forward`` default to the plain
scans ``ssd_reference`` and ``rglru_scan_reference``), so every reference
training step runs the plain scans.  The port routes the same way by the
same named argument: ``apply_hidden`` (training) passes
``use_kernel=False`` and autograd runs through its own plain scans, on a
card too; the serving prefill passes ``use_kernel=True`` (the ``ssd`` and
``rglru`` kernels on a CUDA tensor).

From carried-over weights, one SMOKE pretrain step of each arch agrees with
the JAX step: the loss within 1e-5 and the gradients within 1e-4 of each
leaf's largest gradient (``tests/test_torch_train.py``'s tolerances).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import steps as JSt  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim.optimizers import Optimizer as JOptimizer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import Optimizer  # noqa: E402

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
ATOL_LOSS = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 24

_jinit = jax.jit(lambda cfg, key: JTransformer.init(cfg, key)[0],
                 static_argnums=(0,))

JGRAD = JOptimizer(init=lambda p: {}, update=lambda g, s, p, step: (g, s))
GRAD = Optimizer(init=lambda p: {},
                 update=lambda g, s, p, step, lr=None: (g, s))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, key):
    mesh = make_test_mesh()
    jcfg = jregistry.get_smoke_config(arch)
    with mesh_context(mesh):
        weights = jax.tree.map(np.asarray, _jinit(jcfg, jax.random.key(key)))
    return mesh, jcfg, registry.get_smoke_config(arch), weights


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size - 1,
                        size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_pretrain_step_loss_and_grads_match_jax(arch):
    mesh, jcfg, cfg, weights = _smoke(arch, 5)
    assert any(k in ("ssd", "rglru") for k in cfg.block_pattern)
    batch = _batch(cfg, 1)
    with mesh_context(mesh):
        jstep = jax.jit(JSt.make_pretrain_step(jcfg, JGRAD, loss_chunk=S))
        want, _, jm = jstep(jax.tree.map(jnp.asarray, weights), {},
                            jax.tree.map(jnp.asarray, batch), jnp.int32(0))
    step = St.make_pretrain_step(cfg, GRAD, loss_chunk=S)
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
        if scale == 0:   # a leaf the loss does not reach: zero in both
            assert not g.any(), jax.tree_util.keystr(path)
            continue
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, (jax.tree_util.keystr(path), err,
                                          scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_takes_the_plain_scans_and_prefill_the_kernels(
        arch, monkeypatch):
    """Routing by the named argument: ``apply_hidden`` never calls
    ``ops.ssd``/``ops.rglru`` (the kernels' wrappers), the prefill calls
    them once a recurrent layer."""
    _, _, cfg, weights = _smoke(arch, 6)
    calls = []
    for name in ("ssd", "rglru"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    params = params_from_numpy(weights, "cpu")
    tokens = torch.from_numpy(_batch(cfg, 2)["tokens"])
    Transformer.apply_hidden(cfg, params, {"tokens": tokens})
    assert calls == []
    with torch.no_grad():
        Transformer.prefill(cfg, params, {"tokens": tokens}, 32)
    recurrent = sum(k in ("ssd", "rglru") for k in cfg.block_pattern)
    assert len(calls) == recurrent * cfg.n_super + sum(
        cfg.block_pattern[j % len(cfg.block_pattern)] in ("ssd", "rglru")
        for j in range(cfg.n_tail))
