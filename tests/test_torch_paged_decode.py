"""Paged decode attention in the PyTorch port.

On the CPU: the port's plain version (``repro_torch.kernels.ref``) against
the JAX kernel ``paged_decode`` in interpret mode and its jnp oracle, on
page tables with shared prefix pages and trash entries, windowed and not.
The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_decode import paged_decode as jax_paged_decode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode  # noqa: E402

# f32 sums in another order than XLA's: ~1e-7 apart on unit-scale inputs.
ATOL_F32 = 1e-5
# bf16 output rounding (8 bits of mantissa) on values of magnitude < 4.
ATOL_BF16 = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, *, b=3, n=2, g=4, d=32, ps=8, pp=4):
    """Slots 0 and 1 share physical prefix pages 1 and 2; rows end in trash
    entries (page 0, filled with garbage that the mask must hide); pos sits
    mid-page, at a page's last row and at 0."""
    rng = np.random.default_rng(seed)
    num_pages = 2 * pp + 2
    q = rng.standard_normal((b, n, g, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, n, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, n, d)).astype(np.float32)
    pt = np.zeros((b, pp), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :] = [1, 2, 4, 5]
    pt[2, :1] = [6]
    pos = np.array([2 * ps + ps // 2, pp * ps - 1, 0], np.int32)
    return q, kp, vp, pt, pos


def _random_case(seed, *, b=4, n=2, g=2, d=32, ps=16, pp=5):
    rng = np.random.default_rng(seed)
    num_pages = b * pp + 1
    q = rng.standard_normal((b, n, g, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, n, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, n, d)).astype(np.float32)
    pt = rng.integers(0, num_pages, size=(b, pp)).astype(np.int32)
    pos = rng.integers(0, pp * ps, size=(b,)).astype(np.int32)
    return q, kp, vp, pt, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 5, 24])
@pytest.mark.parametrize("ps,pp", [(8, 4), (16, 4)])
def test_ref_matches_jax_kernel_and_oracle(window, ps, pp):
    case = _case(ps + pp, ps=ps, pp=pp)
    got = ref.paged_decode_ref(*_torch(*case), window=window).numpy()
    jcase = [jnp.asarray(a) for a in case]
    want_kernel = np.asarray(jax_paged_decode(*jcase, window=window,
                                              interpret=True))
    want_ref = np.asarray(jref.paged_decode_ref(*jcase, window=window))
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("seed", range(6))
def test_ref_matches_jax_oracle_on_random_tables(seed):
    case = _random_case(seed)
    window = [None, 7][seed % 2]
    got = ref.paged_decode_ref(*_torch(*case), window=window).numpy()
    want = np.asarray(jref.paged_decode_ref(*[jnp.asarray(a) for a in case],
                                            window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def test_ref_bf16_matches_jax_oracle():
    q, kp, vp, pt, pos = _case(1)
    tq, tk, tv, tpt, tpos = _torch(q, kp, vp, pt, pos)
    got = ref.paged_decode_ref(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                               tpt, tpos)
    assert got.dtype == torch.bfloat16
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jref.paged_decode_ref(bf(q), bf(kp), bf(vp), jnp.asarray(pt),
                                 jnp.asarray(pos))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=ATOL_BF16)


def test_ops_takes_plain_version_for_cpu_tensors():
    args = _torch(*_case(2))
    before = paged_decode.launches
    got = ops.paged_decode_attn(*args, window=5)
    assert torch.equal(got, ref.paged_decode_ref(*args, window=5))
    assert paged_decode.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(*_torch(*_case(3)))
