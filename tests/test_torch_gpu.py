"""The PyTorch port on the card: run with ``python -m pytest -m gpu
tests/test_torch_*.py`` on a machine with a CUDA card and ``nvcc``.

Every test here needs the card and skips without one.  The file imports no
JAX (the GPU machine has none): the hand-written ``paged_decode`` kernel is
held against the port's plain PyTorch version (f32 within 1e-5, bf16
within 1e-2), and the paged engine on the card against the same engine on
the CPU (greedy tokens equal, f32 with TF32 off).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, device, *, b=4, n=2, g=4, d=64, ps=16, pp=5):
    """Random tables over a pool whose trash page holds garbage; slots 0
    and 1 share their first two pages; pos covers 0 and the last row."""
    rng = np.random.default_rng(seed)
    num_pages = b * pp + 1
    arrays = [rng.standard_normal((b, n, g, d)),
              rng.standard_normal((num_pages, ps, n, d)),
              rng.standard_normal((num_pages, ps, n, d))]
    pt = rng.integers(0, num_pages, size=(b, pp)).astype(np.int32)
    pt[1, :2] = pt[0, :2]
    pos = rng.integers(0, pp * ps, size=(b,)).astype(np.int32)
    pos[:2] = [0, pp * ps - 1]
    q, kp, vp = (torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in arrays)
    return q, kp, vp, torch.from_numpy(pt).to(device), \
        torch.from_numpy(pos).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5, 24])
@pytest.mark.parametrize("shape", [dict(), dict(g=2, d=32, ps=8, pp=9),
                                   dict(n=8, g=4, d=64, ps=16, pp=32),
                                   dict(g=1, ps=64, pp=3),
                                   dict(g=8, d=128, ps=12, pp=7)])
def test_kernel_matches_ref(cuda, dtype, window, shape):
    q, kp, vp, pt, pos = _case(3, cuda, **shape)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_decode.launches
    got = ops.paged_decode_attn(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    want = ref.paged_decode_ref(q, kp, vp, pt, pos, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernel_wrapper_checks_inputs(cuda):
    q, kp, vp, pt, pos = _case(4, cuda)
    with pytest.raises(TypeError):
        paged_decode(q.double(), kp, vp, pt, pos)
    with pytest.raises(TypeError):
        paged_decode(q, kp, vp, pt.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode(q.transpose(1, 2).contiguous().transpose(1, 2), kp, vp,
                     pt, pos)
    with pytest.raises(ValueError, match="window"):
        paged_decode(q, kp, vp, pt, pos, window=0)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode(q, torch.cat([kp.view(-1), kp.view(-1)[:1]])[1:].view(
            kp.shape), vp, pt, pos)
    with pytest.raises(ValueError, match="G <= 32"):
        paged_decode(q[..., :48].contiguous(), kp[..., :48].contiguous(),
                     vp[..., :48].contiguous(), pt, pos)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_engine_on_card_matches_cpu_and_runs_the_kernel(cuda):
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 1, device="cpu")
    reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size, seed=4,  # noqa: E731
                                prompt_max=24, out_max=8, shared_prefix=16)
    outs, launches = {}, {}
    for device in ("cpu", "cuda"):
        engine = ServeEngine(cfg, _to(params, device), slots=3, max_len=64,
                             paged=True, page_size=8, device=device)
        before = paged_decode.launches
        outs[device] = {r.rid: r.out for r in engine.run(reqs())}
        launches[device] = paged_decode.launches - before
    assert outs["cpu"] == outs["cuda"]
    assert launches["cpu"] == 0
    assert launches["cuda"] == cfg.num_layers * engine.decode_ticks > 0
