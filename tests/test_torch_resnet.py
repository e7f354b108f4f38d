"""The PyTorch port's ResNet against the JAX package's.

Weights are initialised by the JAX package and carried over
(``repro_torch.interop``); inputs are numpy arrays from a seed.  Covers the
two conventions where PyTorch's defaults differ from the reference: JAX's
``"SAME"`` padding at stride 2 (pads (0, 1) on an even size) and the
biased-variance BatchNorm with ``0.9 * old + 0.1 * new`` running stats.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fl as jfl  # noqa: E402
from repro.nn import resnet as jresnet  # noqa: E402
from repro.optim import sgd_momentum as jsgd  # noqa: E402
from repro.optim import step_decay as jstep_decay  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.nn import resnet  # noqa: E402
from repro_torch.optim import sgd_momentum, step_decay  # noqa: E402

# Convolutions summed in another order than XLA's through up to 32 layers
# of unit-scale activations: ~1e-6 apart; forward within 1e-4.
FWD_TOL = 1e-4
# One SGD step moves parameters by lr * grad; their difference is ~1e-7.
STEP_TOL = 1e-5


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


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("depth", [8, 32])
def test_forward_and_bn_state_match_jax(depth, train):
    cfg = resnet.ResNetConfig(depth=depth, num_classes=100, width=16)
    jparams, jbn = jresnet.init(jax.random.key(depth), jresnet.ResNetConfig(
        depth=depth, num_classes=100, width=16))
    # Non-trivial running stats, so eval mode normalises with them.
    rng = np.random.default_rng(depth)
    jbn = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), jbn)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    want, want_bn = jresnet.apply(jparams, jbn, jresnet.ResNetConfig(
        depth=depth, num_classes=100, width=16), jnp.asarray(x), train)
    got, got_bn = resnet.apply(params_from_numpy(_np(jparams), "cpu"),
                               params_from_numpy(_np(jbn), "cpu"), cfg,
                               torch.from_numpy(x), train)
    _assert_tree_close(got.numpy(), np.asarray(want), FWD_TOL)
    _assert_tree_close(params_to_numpy(got_bn), _np(want_bn), FWD_TOL)


def test_init_has_the_reference_layout_and_scale():
    cfg = resnet.ResNetConfig(depth=32)
    jparams, jbn = jresnet.init(jax.random.key(0), jresnet.ResNetConfig())
    params, bn = resnet.init(torch.Generator().manual_seed(0), cfg)
    for got, want in ((params, _np(jparams)), (bn, _np(jbn))):
        flat_got = {k: v for k, v in _flatten(params_to_numpy(got))}
        flat_want = dict(_flatten(want))
        assert {k: v.shape for k, v in flat_got.items()} == {
            k: v.shape for k, v in flat_want.items()}
        for k, w in flat_want.items():
            g = flat_got[k]
            assert g.dtype == np.float32
            if w.size > 1000:  # He-normal scale of the large conv weights
                assert abs(g.std() / w.std() - 1) < 0.1, k


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("size", [7, 8, 9, 16])
def test_same_padding_matches_jax_on_odd_and_even_sizes(size, kernel, stride):
    rng = np.random.default_rng(size * 10 + kernel + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 6)).astype(np.float32)
    want = jresnet._conv(jnp.asarray(w), jnp.asarray(x), stride)
    got = resnet._conv(torch.from_numpy(w),
                       torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    _assert_tree_close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                       1e-5)


def test_one_sgd_momentum_step_matches_jax():
    """One SGD-momentum step of ResNet-8 on a batch of 16 at lr 0.1.

    The reference's step is taken in float64: XLA's float32 CPU gradient
    of this network is up to 1.2e-4 away from its own float64 gradient
    (the port's float32 gradient is within 3e-8 of it), which lr 0.1 turns
    into parameter differences above the 1e-5 this test holds."""
    cfg = resnet.ResNetConfig(depth=8, num_classes=10)
    jcfg = jresnet.ResNetConfig(depth=8, num_classes=10)
    jadapter = jfl.resnet_adapter(jcfg)
    adapter = fl.resnet_adapter(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int64)
    jstate32 = _np(jadapter.init(jax.random.key(3)))
    with jax.enable_x64(True):
        jopt = jsgd(jstep_decay(0.1, [1, 2]), weight_decay=1e-4)
        jstep = jfl._make_train_step(jadapter, jopt, None)
        jstate = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jstate32)
        jopt_state = jax.tree.map(lambda a: a.astype(jnp.float64),
                                  jopt.init(jadapter.params(jstate)))
        jstate, jopt_state, _ = jstep(jstate, jopt_state,
                                      jnp.asarray(x, jnp.float64),
                                      jnp.asarray(y), jnp.asarray(0))
        jstate, jopt_state = _np(jstate), _np(jopt_state)
    opt = sgd_momentum(step_decay(0.1, [1, 2]), weight_decay=1e-4)
    step = fl.grad_step(adapter, opt)
    state = params_from_numpy(jstate32, "cpu")
    opt_state = opt.init(adapter.params(state))
    state, opt_state = step(state, opt_state, torch.from_numpy(x),
                            torch.from_numpy(y), 0)
    _assert_tree_close(params_to_numpy(state), jstate, STEP_TOL)
    _assert_tree_close(params_to_numpy(opt_state), jopt_state, STEP_TOL)
