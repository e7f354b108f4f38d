"""The Mamba-2 SSD scan and block in the PyTorch port against the JAX package.

On the CPU: the port's ``ops.ssd`` (its plain version ``ssd_ref``) against
the JAX ``ssd_reference`` and the JAX kernel ``ssd_pallas`` in interpret
mode, at the JAX kernel test's shapes, with more than one B/C group and at
lengths whose chunk falls to 1 (the chunk rule); and the port's
``ssm.forward(return_cache=True)`` and three ``decode_step``s against the
JAX package's, in f32 and bf16, from JAX-initialised parameters.  The CUDA
kernel is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402

# The scan in f32 with sums in another order than XLA's; the JAX kernel
# test holds its own kernel to its reference at 3e-4, and the two plain
# versions are far closer (errors are printed by the assertion if not).
TOL_SCAN = 1e-4
# The block in f32: projections and the gated RMSNorm around the scan
# (measured ~1.5e-6 apart on outputs and states of order 1-4).
TOL_F32 = 1e-5
# The block in bf16: each side rounds its bf16 matmuls and activations
# itself (8 bits of mantissa), on outputs of order 4 and an f32 state fed
# by bf16 activations (measured up to 0.054 apart after three steps).
TOL_BF16 = 6e-2

_jref = jax.jit(jssm.ssd_reference, static_argnums=(5,))
_jkernel = jax.jit(lambda x, dt, A, B, C, chunk: jops.ssd(
    x, dt, A, B, C, chunk, use_pallas=True, interpret=True),
    static_argnums=(5,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, s, h, p, n, g):
    """The JAX kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (2, 256, 4, 32, 16, 1, 64),     # the JAX kernel test's shapes
    (1, 128, 2, 64, 32, 1, 128),
    (2, 192, 8, 16, 8, 1, 64),
    (2, 96, 4, 16, 8, 2, 32),       # two B/C groups
    (1, 37, 2, 8, 4, 1, 32),        # prime length: chunk 1
    (1, 131, 2, 8, 4, 1, 128),      # prime length above the chunk: chunk 1
    (1, 150, 2, 8, 4, 1, 128),      # chunk 75
])
def test_ops_ssd_matches_jax(b, s, h, p, n, g, chunk):
    args = _scan_inputs(s + h, b, s, h, p, n, g)
    before = ssd_mod.ssd.launches
    y, state = ops.ssd(*(torch.from_numpy(a) for a in args), chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    want = _jref(*(jnp.asarray(a) for a in args), chunk)
    for got, ref in zip((y, state), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=TOL_SCAN, atol=TOL_SCAN)
    kernel = _jkernel(*(jnp.asarray(a) for a in args), chunk)
    for got, ref in zip((y, state), kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=TOL_SCAN, atol=TOL_SCAN)
    assert ssd_mod.ssd.launches == before   # the CPU runs the plain version


@pytest.mark.parametrize("s,chunk,q", [(256, 128, 128), (224, 128, 112),
                                       (151, 128, 1), (37, 32, 1),
                                       (20, 128, 20), (96, 32, 32)])
def test_chunk_rule(s, chunk, q):
    assert ssd_mod.chunk_size(chunk, s) == q


def test_reference_takes_a_resolved_chunk():
    """The plain scan cuts at the chunk it is given; the chunk rule runs once,
    in ``ops.ssd``, so a chunk that does not divide s is refused."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _scan_inputs(0, 1, 37, 2, 4, 4, 1))
    with pytest.raises(ValueError, match="divide"):
        ssm.ssd_reference(x, dt, A, B, C, 32)
    y, state = ssm.ssd_reference(x, dt, A, B, C, 1)
    assert y.shape == (1, 37, 2, 4) and state.shape == (1, 2, 4, 4)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _scan_inputs(0, 1, 8, 2, 4, 4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd(x, dt, A, B, C, 8)


def _block(dtype, seed=0):
    """An SSD block (d_model 64, two heads of 32, d_state 16, chunk 16) and
    its input, initialised by the JAX package and carried across."""
    cfg = jssm.SSDConfig(d_model=64, d_state=16, head_dim=32, chunk=16)
    jparams, _ = jssm.init(jax.random.key(seed), cfg, dtype=dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, params


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, TOL_F32),
                                       (jnp.bfloat16, TOL_BF16)])
def test_block_forward_and_decode_match_jax(dtype, tol):
    """A 37-token prompt (chunk 1 at chunk 16), its cache, and three decode
    steps from it; the state advances by the port's own steps."""
    cfg, jparams, params = _block(dtype)
    assert params["A_log"].dtype == params["D"].dtype == \
        params["dt_bias"].dtype == torch.float32
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(params["in_proj"].dtype)
    want, jcache = jssm.forward(jparams, cfg, jx, return_cache=True)
    got, cache = ssm.forward(params, cfg, tx, return_cache=True)
    assert got.dtype == tx.dtype and cache["ssm"].dtype == torch.float32
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
        want, jcache = jssm.decode_step(jparams, cfg, jcache,
                                        jnp.asarray(xt, dtype))
        got, cache = ssm.decode_step(params, cfg, cache,
                                     torch.from_numpy(xt).to(tx.dtype))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=f"step {step}")
        for key in jcache:
            np.testing.assert_allclose(_np(cache[key]),
                                       np.asarray(jcache[key], np.float32),
                                       rtol=tol, atol=tol,
                                       err_msg=f"step {step} {key}")


def test_softplus_is_jax_softplus():
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))
