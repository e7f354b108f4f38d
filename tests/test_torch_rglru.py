"""The RG-LRU recurrence and block in the PyTorch port against the JAX
package.

On the CPU: the port's ``ops.rglru`` (its plain version ``rglru_ref``, a
log-step scan) against the JAX ``rglru_scan_reference`` (an associative
scan) and the JAX kernel ``rglru_pallas`` in interpret mode, at the JAX
kernel tests' shapes (D = 130 included) and with a start state ``h0``;
and the port's ``rglru.forward(return_cache=True)`` and three
``decode_step``s against the JAX package's, in f32 and bf16, from
JAX-initialised parameters.  The CUDA kernel is held against the plain
version on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru as rglru_mod  # noqa: E402
from repro_torch.nn import rglru  # noqa: E402

# The JAX kernel test's tolerance: the two scans multiply and add in other
# orders, ~1e-7 apart on values of order 1-5.
TOL_SCAN = 1e-5
# The block in f32: gates from f32 matmuls, the scan, the output matmul.
TOL_F32 = 1e-5
# The block in bf16: each side rounds its bf16 matmuls, GeLU and output
# (8 bits of mantissa) on values of order 1.
TOL_BF16 = 3e-2

_jref = jax.jit(jrglru.rglru_scan_reference)
_jkernel = jax.jit(lambda a, b: jops.rglru(a, b, use_pallas=True,
                                           interpret=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, s, d):
    """The JAX kernel test's distributions: a in (0, 1), b standard normal."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(
        np.float32)
    return a, rng.standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("b,s,d", [(1, 64, 128), (4, 96, 256), (2, 128, 130),
                                   (2, 384, 128), (3, 1, 5), (2, 37, 130)])
def test_ops_rglru_matches_jax(b, s, d):
    a, x = _scan_inputs(b * s + d, b, s, d)
    before = rglru_mod.rglru.launches
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    for want in (_jref(jnp.asarray(a), jnp.asarray(x)),
                 _jkernel(jnp.asarray(a), jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_SCAN, atol=TOL_SCAN)
    assert rglru_mod.rglru.launches == before  # the CPU runs the plain version


def test_scan_with_h0_matches_jax():
    a, x = _scan_inputs(3, 2, 50, 130)
    h0 = np.random.default_rng(4).standard_normal((2, 130)).astype(np.float32)
    got = rglru.rglru_scan_reference(torch.from_numpy(a), torch.from_numpy(x),
                                     torch.from_numpy(h0))
    want = jrglru.rglru_scan_reference(jnp.asarray(a), jnp.asarray(x),
                                       jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_SCAN,
                               atol=TOL_SCAN)
    # ... and it is the recurrence, step by step, from h0
    h = torch.from_numpy(h0)
    for t in range(a.shape[1]):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(x[:, t])
        np.testing.assert_allclose(got[:, t].numpy(), h.numpy(),
                                   rtol=TOL_SCAN, atol=TOL_SCAN)


def test_kernel_wrapper_refuses_cpu_tensors():
    a, x = (torch.from_numpy(t) for t in _scan_inputs(0, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_mod.rglru(a, x)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, TOL_F32),
                                       (jnp.bfloat16, TOL_BF16)])
def test_block_forward_and_decode_match_jax(dtype, tol):
    """A 29-token prompt, its cache, and three decode steps from it."""
    cfg = jrglru.RGLRUConfig(d_model=64, d_rnn=96)
    jparams, _ = jrglru.init(jax.random.key(1), cfg, dtype=dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for key in ("b_a", "b_x", "lam"):
        assert params[key].dtype == torch.float32
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 29, cfg.d_model)).astype(np.float32)
    tdt = params["w_in_x"].dtype
    want, jcache = jrglru.forward(jparams, cfg, jnp.asarray(x, dtype),
                                  return_cache=True)
    got, cache = rglru.forward(params, cfg, torch.from_numpy(x).to(tdt),
                               return_cache=True)
    assert got.dtype == tdt and cache["h"].dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for key in jcache:
        assert cache[key].shape == jcache[key].shape
        assert str(cache[key].dtype).split(".")[-1] == jcache[key].dtype.name
        np.testing.assert_allclose(_np(cache[key]),
                                   np.asarray(jcache[key], np.float32),
                                   rtol=tol, atol=tol)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jrglru.decode_step(jparams, cfg, jcache,
                                          jnp.asarray(xt, dtype))
        got, cache = rglru.decode_step(params, cfg, cache,
                                       torch.from_numpy(xt).to(tdt))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=f"step {step}")
        for key in jcache:
            np.testing.assert_allclose(_np(cache[key]),
                                       np.asarray(jcache[key], np.float32),
                                       rtol=tol, atol=tol,
                                       err_msg=f"step {step} {key}")
