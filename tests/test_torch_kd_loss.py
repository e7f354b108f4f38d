"""The fused buffered-KD loss of the PyTorch port against the JAX package.

On the CPU the port's ``ops.kd_loss`` runs its autograd function over the
plain versions of the two kernels (``kd_stats_ref``, ``kd_grad_ref``); the
JAX side runs its Pallas kernels in interpret mode.  Inputs are numpy
arrays from a seed, handed to both.  The CUDA kernels themselves are held
against the same plain versions on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import methods as jmethods  # noqa: E402
from repro.core.fl import FLConfig as JFLConfig  # noqa: E402
from repro.kernels import kd_loss as jkd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.core.fl import FLConfig  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# f32 sums and exponentials in another order than XLA's: ~1e-7 relative on
# logits of unit scale x 3; 1e-5 relative to the largest reference value.
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(rows, v, seed, pad=0):
    """Labels and s, t, b logits of unit scale x 3; the last ``pad``
    columns are -1e30 (vocabulary padding) and no label falls there."""
    rng = np.random.default_rng(seed)
    s, t, b = (3 * rng.standard_normal((rows, v)).astype(np.float32)
               for _ in range(3))
    for a in (s, t, b):
        if pad:
            a[:, v - pad:] = -1e30
    y = rng.integers(0, v - pad, size=rows).astype(np.int64)
    return y, s, t, b


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_pad(a, v):
    """The JAX kernels take vocabularies that are multiples of 128 (its
    ``ops`` pads with -1e30 columns, which contribute nothing)."""
    pad = (-v) % 128
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, pad)), constant_values=-1e30)


@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("v", [100, 128, 129, 256])
@pytest.mark.parametrize("rows", [8, 24])
def test_stats_ref_matches_jax_kernel_column_by_column(rows, v, buffer, tau):
    y, s, t, b = _case(rows, v, seed=rows + v, pad=v // 8)
    want = np.asarray(jkd.kd_stats_fwd(
        jnp.asarray(y, jnp.int32), _jax_pad(s, v), _jax_pad(t, v),
        _jax_pad(b, v) if buffer else None, tau, interpret=True))
    got = ref.kd_stats_ref(_t(y), _t(s), _t(t), _t(b) if buffer else None,
                           tau).numpy()
    assert got.shape == want.shape == (rows, kd.N_STATS)
    for col in range(kd.N_STATS):
        _close(got[:, col], want[:, col])


@pytest.mark.parametrize("pad", [0, 20])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("v", [100, 129])
@pytest.mark.parametrize("rows", [8, 24])
def test_kd_loss_value_and_grad_match_jax(rows, v, buffer, pad):
    tau = 2.0
    y, s, t, b = _case(rows, v, seed=3 * rows + v + pad, pad=pad)
    jb = jnp.asarray(b) if buffer else None

    def jloss(ss):
        return jops.kd_loss(jnp.asarray(y, jnp.int32), ss, jnp.asarray(t), jb,
                            tau, use_pallas=True, interpret=True)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(s))
    st = _t(s).requires_grad_()
    tt = _t(t).requires_grad_()
    bt = _t(b).requires_grad_() if buffer else None
    loss = ops.kd_loss(_t(y), st, tt, bt, tau)
    loss.backward()
    _close(loss.item(), float(want))
    _close(st.grad.numpy(), np.asarray(want_g))
    # Teacher and buffer are frozen: no gradient reaches them.
    assert tt.grad is None and (bt is None or bt.grad is None)
    _close(loss.item(), ref.kd_loss_mean_ref(_t(y), _t(s), _t(t),
                                             _t(b) if buffer else None,
                                             tau).item())


@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
def test_kd_grad_ref_matches_jax_kernel(tau):
    rows, v = 16, 256
    y, s, t, b = _case(rows, v, seed=7, pad=30)
    g = np.random.default_rng(8).uniform(0.5, 2.0, rows).astype(np.float32)
    stats = jkd.kd_stats_fwd(jnp.asarray(y, jnp.int32), jnp.asarray(s),
                             jnp.asarray(t), jnp.asarray(b), tau,
                             interpret=True)
    want = jkd.kd_grad_bwd(jnp.asarray(y, jnp.int32), jnp.asarray(g), stats,
                           jnp.asarray(s), jnp.asarray(t), jnp.asarray(b),
                           tau, 1.0 / rows, interpret=True)
    got = ref.kd_grad_ref(_t(y), _t(g), _t(stats), _t(s), _t(t), _t(b), tau,
                          1.0 / rows)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("buffer", [False, True])
def test_ensemble_of_two_teachers_enters_the_kernel_as_tau_log_af(buffer):
    """R=2: ``kd_terms`` on the kernel backend feeds t_eff = tau*log(A_f);
    the JAX and port compositions agree, and both equal the plain Eq. 3/4
    losses."""
    rows, v, tau = 8, 100, 2.0
    rng = np.random.default_rng(11)
    tls = 3 * rng.standard_normal((2, rows, v)).astype(np.float32)
    y, s, _, b = _case(rows, v, seed=12)
    jctx = jmethods.MethodContext(adapter=None, cfg=JFLConfig(tau=tau),
                                  backend="pallas")
    ctx = methods.MethodContext(adapter=None, cfg=FLConfig(tau=tau),
                                backend="pallas")
    jb = jnp.asarray(b) if buffer else None
    want, want_g = jax.value_and_grad(lambda ss: jmethods.kd_terms(
        jctx, ss, jnp.asarray(tls), jb, jnp.asarray(y, jnp.int32)))(
            jnp.asarray(s))
    st = _t(s).requires_grad_()
    before = kd.kd_stats_fwd.launches
    loss = methods.kd_terms(ctx, st, _t(tls), _t(b) if buffer else None,
                            _t(y))
    loss.backward()
    assert kd.kd_stats_fwd.launches == before  # the CPU takes the plain path
    _close(loss.item(), float(want))
    _close(st.grad.numpy(), np.asarray(want_g))
    ctx.backend = "jnp"
    _close(methods.kd_terms(ctx, _t(s), _t(tls), _t(b) if buffer else None,
                            _t(y)).item(), float(want))
