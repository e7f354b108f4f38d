"""The PyTorch port on the card: run with ``python -m pytest -m gpu
tests/test_torch_*.py`` on a machine with a CUDA card and ``nvcc``.

Every test here needs the card and skips without one.  The file imports no
JAX (the GPU machine has none): the hand-written ``paged_decode``,
``swa_decode``, ``kd_stats_fwd``, ``kd_grad_bwd``, ``kd_quant_stats_fwd``,
``kd_quant_grad_bwd``, ``ssd`` and ``rglru`` kernels are held against the
port's plain PyTorch versions (f32 within 1e-5, bf16 within 1e-2; the SSD
scan within 3e-4), the paged and dense engines on the card against the same
engines on the CPU (greedy tokens equal, f32 with TF32 off; the recurrent
archs too, and the MoE archs), federated rounds on the card (with and
without int8 uplink transport) against the same rounds on the CPU, and the
MoE forward and an LLM Phase-2 step on the card against the CPU, and the
engine's and the live system's checkpoints resumed on the card against an
uninterrupted run (bit for bit).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode  # noqa: E402
from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.kernels.ssd import chunk_size, ssd  # noqa: E402
from repro_torch.kernels.swa_decode import swa_decode  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402
from repro_torch.transport import codecs  # noqa: E402

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
                                   dict(g=8, d=128, ps=12, pp=7),
                                   dict(g=16, d=32, ps=8, pp=3),
                                   dict(n=1, g=16, d=256, ps=16, pp=32),
                                   dict(g=12, d=192, ps=16, pp=9)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 512])
def test_kernel_takes_a_table_past_the_old_cap(cuda, dtype, window):
    """A 16,384-page table (the old kernel staged the whole table in 48 KiB
    of shared memory and refused more than 9,888 pages at this shape),
    cycling over a 600-page pool, at a position near its end."""
    rng = np.random.default_rng(16)
    pp, ps, pool = 16_384, 16, 600
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(cuda, dtype)
                 for s in ((1, 2, 4, 64), (pool, ps, 2, 64), (pool, ps, 2, 64)))
    pt = torch.from_numpy((np.arange(pp) % (pool - 1) + 1).astype(np.int32)
                          )[None].to(cuda)
    pos = torch.tensor([pp * ps - 5], dtype=torch.int32, device=cuda)
    got = paged_decode(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(q, kp, vp, pt, pos, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(want.float().abs().max().item(), 1.0), err


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
    with pytest.raises(ValueError, match="G <= 16"):
        paged_decode(q[..., :48].contiguous(), kp[..., :48].contiguous(),
                     vp[..., :48].contiguous(), pt, pos)
    # 32 query groups (1,024 threads) would fail to launch: refused up front
    with pytest.raises(ValueError, match="G <= 16"):
        paged_decode(q.repeat(1, 1, 8, 1).contiguous(), kp, vp, pt, pos)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_paged_engine_takes_a_long_table(cuda):
    """ServeEngine(paged=True) at a max_len whose table (16,384 pages of 8)
    the old kernel refused (at most 11,104 at SMOKE's D=64, G=2): the
    greedy tokens equal a short table's."""
    cfg = registry.get_smoke_config("granite-3-2b")
    params = _to(Transformer.init(cfg, 1, device="cpu"), "cuda")
    reqs = lambda: build_stream("bursty", 4, vocab=cfg.vocab_size, seed=5,  # noqa: E731
                                prompt_max=24, out_max=8)
    outs = {}
    for max_len in (64, 131_072):
        engine = ServeEngine(cfg, params, slots=2, max_len=max_len,
                             paged=True, page_size=8, num_pages=64,
                             device="cuda")
        assert engine.pages_per_slot == max_len // 8
        outs[max_len] = {r.rid: r.out for r in engine.run(reqs())}
    assert outs[64] == outs[131_072]


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


# -- dense / ring / windowed decode attention --------------------------------


def _swa_case(seed, device, *, b=4, w=512, n=8, g=4, d=64, pos=None):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, n, g, d)),
              rng.standard_normal((b, w, n, d)),
              rng.standard_normal((b, w, n, d))]
    if pos is None:
        pos = rng.integers(0, w, size=b)
    q, kc, vc = (torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in arrays)
    return q, kc, vc, torch.as_tensor(np.asarray(pos, np.int32)).to(device)


# chip_smoke.py's cases (the serving shape with pos 0..W-1, a window of 128
# on it, the --ring cache wrapped, the long-context ring at B=1), odd W,
# every G the kernel takes, D up to 256, and rows with no valid slot.
SWA_CASES = [
    dict(pos=[0, 170, 341, 511]),
    dict(pos=[0, 100, 300, 511], window=128),
    dict(w=32, pos=[32, 95, 1000, 31], window=32, ring=True),
    dict(b=1, w=8192, pos=[500_000], window=8192, ring=True),
    dict(w=37, pos=[0, 36, 20, 5]),
    dict(w=300, pos=[299, 5000, 301, 7], window=57, ring=True),
    dict(w=1, pos=[0, 3, 9, 1], ring=True),
    dict(w=100, n=2, g=1, pos=[99, 0, 50, 64], window=10),
    dict(w=65, n=1, g=16, d=32, pos=[64, 0, 63, 33]),
    dict(w=70, n=2, g=8, d=128, pos=[69, 1, 40, 68], window=33),
    dict(w=40, n=2, g=2, d=256, pos=[39, 12, 0, 27], ring=True),
    dict(n=1, g=16, d=256, pos=[0, 170, 341, 511], window=2048),  # RG-9B
    dict(w=16, n=2, pos=[-1, 5, 200, 15]),
    dict(w=16, n=2, pos=[-1, 5, 200, 15], ring=True, window=3),
    dict(w=1000, pos=[999, 500, 0, 777]),  # W not a multiple of R = 64
    dict(w=700, n=2, g=12, d=192, pos=[699, 3, 650, 100], window=300),
    dict(w=512, n=1, g=16, d=256, pos=[-1, 511, 3000, 200], window=100,
         ring=True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SWA_CASES, ids=lambda c: str(sorted(c.items())))
def test_swa_kernel_matches_ref(cuda, dtype, case):
    case = dict(case)
    window, ring = case.pop("window", None), case.pop("ring", False)
    q, kc, vc, pos = _swa_case(5, cuda, **case)
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    before = swa_decode.launches
    got = ops.swa_decode_attn(q, kc, vc, pos, window=window, ring=ring)
    torch.cuda.synchronize()
    assert swa_decode.launches == before + 1
    want = ref.swa_decode_ref(q, kc, vc, pos, window=window, ring=ring)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(want.float().abs().max().item(), 1.0), err


# The four dense archs the engines serve on the decode kernels, at their
# (N KV heads, G query groups, D): qwen3-14b (8, 5, 128), qwen1.5-4b (20,
# 1, 128), nemotron-4-340b (8, 12, 192), qwen2-vl-72b (8, 8, 128).
DENSE_ARCHS = ("qwen3-14b", "qwen1.5-4b", "nemotron-4-340b", "qwen2-vl-72b")


def _decode_heads(arch):
    cfg = registry.get_config(arch)
    return cfg.kv_heads, cfg.num_heads // cfg.kv_heads, cfg.hd


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_kernels_at_the_dense_archs_heads(cuda, arch, dtype, window):
    """Both decode kernels on a 4-slot x 512-position cache at each arch's
    heads, against their plain versions."""
    n, g, d = _decode_heads(arch)
    q, kc, vc, pos = _swa_case(7, cuda, n=n, g=g, d=d, pos=[0, 170, 341, 511])
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    got = ops.swa_decode_attn(q, kc, vc, pos, window=window)
    want = ref.swa_decode_ref(q, kc, vc, pos, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(want.float().abs().max().item(), 1.0), err
    q, kp, vp, pt, pos = _case(8, cuda, n=n, g=g, d=d, ps=16, pp=32)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_decode.launches
    got = ops.paged_decode_attn(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    want = ref.paged_decode_ref(q, kp, vp, pt, pos, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def _capture(fn):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_wrappers_replay_from_a_cuda_graph(cuda, dtype):
    """Neither wrapper reads pos on the host: a graph captured once replays
    each call (split kernel and combine) to the eager result, also after pos
    and the cache change in place."""
    q, kc, vc, pos = _swa_case(8, cuda, b=1, w=8192, pos=[524_287])
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    pq, kp, vp, pt, ppos = _case(9, cuda, n=8, pp=32)
    pq, kp, vp = pq.to(dtype), kp.to(dtype), vp.to(dtype)
    calls = [lambda: swa_decode(q, kc, vc, pos, window=8192, ring=True),
             lambda: paged_decode(pq, kp, vp, pt, ppos)]
    for fn in calls:
        fn()  # first calls (and any shared-memory opt-in) outside capture
    torch.cuda.synchronize()
    graphs = [_capture(fn) for fn in calls]
    for step in range(2):
        if step:
            pos.add_(1000)
            ppos.copy_(torch.tensor([3, 511, 77, 200], dtype=torch.int32))
            kc.mul_(0.5)
            vp.add_(1.0)
        for (graph, out), fn in zip(graphs, calls):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, fn())


def test_plan_shared_memory_matches_the_kernels(cuda):
    """The wrappers' plans ask for exactly the shared memory the compiled
    kernels lay out (decode_attn_smem_bytes of csrc/decode_attn.cuh)."""
    import ctypes

    from repro_torch.kernels import build, paged_decode as pd_mod
    from repro_torch.kernels import swa_decode as swa_mod

    for name in ("swa_decode", "paged_decode"):
        fn = build.load(name).decode_attn_smem_bytes
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for d in range(32, 257, 32):
            for dtype, bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
                want = fn(d, bf16)
                assert swa_mod.plan(4, 8, d, 512, dtype).smem == want
                assert pd_mod.plan(4, 8, d, 16, 32, None, dtype).smem == want


def test_swa_kernel_takes_a_scalar_pos(cuda):
    q, kc, vc, _ = _swa_case(6, cuda, w=48)
    got = ops.swa_decode_attn(q, kc, vc, 30, window=20)
    want = ref.swa_decode_ref(q, kc, vc, 30, window=20)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


def test_swa_kernel_wrapper_checks_inputs(cuda):
    q, kc, vc, pos = _swa_case(7, cuda, w=32)
    with pytest.raises(TypeError):
        swa_decode(q.double(), kc, vc, pos)
    with pytest.raises(TypeError):
        swa_decode(q, kc.to(torch.bfloat16), vc, pos)
    with pytest.raises(TypeError):
        swa_decode(q, kc, vc, pos.long())
    with pytest.raises(ValueError, match="contiguous"):
        swa_decode(q, kc.transpose(0, 1).contiguous().transpose(0, 1), vc,
                   pos)
    with pytest.raises(ValueError, match="window"):
        swa_decode(q, kc, vc, pos, window=0)
    with pytest.raises(ValueError, match="aligned"):
        swa_decode(q, torch.cat([kc.view(-1), kc.view(-1)[:1]])[1:].view(
            kc.shape), vc, pos)
    with pytest.raises(ValueError, match="G <= 16"):
        swa_decode(q[..., :48].contiguous(), kc[..., :48].contiguous(),
                   vc[..., :48].contiguous(), pos)
    with pytest.raises(ValueError, match="G <= 16"):
        swa_decode(q.repeat(1, 1, 5, 1)[:, :, :17].contiguous(), kc, vc, pos)
    with pytest.raises(ValueError, match="pos"):
        swa_decode(q, kc, vc, pos[:2].contiguous())
    with pytest.raises(ValueError, match="does not match"):
        swa_decode(q, kc[:, :, :1].contiguous(), vc[:, :, :1].contiguous(),
                   pos)
    with pytest.raises(ValueError, match="CUDA"):
        swa_decode(q.cpu(), kc.cpu(), vc.cpu(), pos.cpu())


@pytest.mark.parametrize("ring", [False, True])
def test_dense_engine_on_card_matches_cpu_and_runs_the_kernel(cuda, ring):
    """The dense engine's greedy tokens on the card equal the CPU's, and
    every decode tick launched ``swa_decode`` once per layer."""
    import dataclasses

    cfg = registry.get_smoke_config("granite-3-2b")
    if ring:
        cfg = dataclasses.replace(cfg, sliding_window=32, ring_cache=True)
    params = Transformer.init(cfg, 1, device="cpu")
    reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size, seed=4,  # noqa: E731
                                prompt_max=40, out_max=16)
    outs, launches, ticks = {}, {}, {}
    for device in ("cpu", "cuda"):
        engine = ServeEngine(cfg, _to(params, device), slots=3, max_len=64,
                             device=device)
        before = swa_decode.launches
        outs[device] = {r.rid: r.out for r in engine.run(reqs())}
        launches[device] = swa_decode.launches - before
        ticks[device] = engine.decode_ticks
    assert outs["cpu"] == outs["cuda"]
    assert launches["cpu"] == 0
    assert launches["cuda"] == cfg.num_layers * ticks["cuda"] > 0


def test_dense_decode_step_launches_the_kernel_once_per_layer(cuda):
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 2, device="cuda")
    caches = Transformer.init_cache(cfg, 2, 32, device=cuda)
    token = torch.tensor([[3], [7]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    before = swa_decode.launches
    logits, _ = Transformer.decode_step(cfg, params, caches, token, pos)
    torch.cuda.synchronize()
    assert swa_decode.launches - before == cfg.num_layers
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


# -- the fused KD loss kernels ----------------------------------------------


def _kd_case(device, rows, v, dtype, buffer, seed=0):
    """Logits of unit scale x 3 with the last ``min(125, v // 4)`` columns
    at -1e30 (the vocabulary padding of LLM logits); labels avoid them."""
    rng = np.random.default_rng(seed)
    pad = min(125, v // 4)
    arrays = [3 * rng.standard_normal((rows, v)) for _ in range(3)]
    for a in arrays:
        if pad:
            a[:, v - pad:] = -1e30
    s, t, b = (torch.from_numpy(a.astype(np.float32)).to(device, dtype)
               for a in arrays)
    labels = torch.from_numpy(
        rng.integers(0, v - pad, size=rows).astype(np.int64)).to(device)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, rows).astype(np.float32)).to(
        device)
    return labels, s, t, (b if buffer else None), g


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [100, 128, 129, 49155])
@pytest.mark.parametrize("rows", [1, 7, 128, 513])
def test_kd_kernels_match_ref(cuda, rows, v, dtype, buffer):
    labels, s, t, b, g = _kd_case(cuda, rows, v, dtype, buffer)
    tau = 2.0
    before = (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches)
    stats = kd.kd_stats_fwd(labels, s, t, b, tau)
    ds = kd.kd_grad_bwd(labels, g, stats, s, t, b, tau, 1.0 / rows)
    torch.cuda.synchronize()
    assert (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = ref.kd_stats_ref(labels, s, t, b, tau)
    assert stats.shape == (rows, kd.N_STATS) and stats.dtype == torch.float32
    assert torch.isfinite(stats).all()
    assert _rel(stats, want) <= TOL[dtype]
    want_ds = ref.kd_grad_ref(labels, g, want, s, t, b, tau, 1.0 / rows)
    assert ds.dtype == dtype and ds.shape == s.shape
    assert torch.isfinite(ds.float()).all()
    assert _rel(ds, want_ds) <= TOL[dtype]


@pytest.mark.parametrize("buffer", [False, True])
def test_kd_loss_autograd_matches_plain(cuda, buffer):
    labels, s, t, b, _ = _kd_case(cuda, 128, 100, torch.float32, buffer, 1)
    s1 = s.clone().requires_grad_()
    loss = ops.kd_loss(labels, s1, t, b, 2.0)
    loss.backward()
    s2 = s.clone().requires_grad_()
    want = ref.kd_loss_mean_ref(labels, s2, t, b, 2.0)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert _rel(s1.grad, s2.grad) <= 1e-5


def test_kd_loss_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain path taken on a CUDA tensor")

    monkeypatch.setattr(ref, "kd_stats_ref", refuse)
    monkeypatch.setattr(ref, "kd_grad_ref", refuse)
    labels, s, t, b, _ = _kd_case(cuda, 8, 129, torch.float32, True, 2)
    before = (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches)
    s = s.requires_grad_()
    ops.kd_loss(labels, s, t, b, 2.0).backward()
    torch.cuda.synchronize()
    assert (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(s.grad).all()


def test_kd_kernel_wrappers_check_inputs(cuda):
    labels, s, t, b, g = _kd_case(cuda, 8, 100, torch.float32, True, 3)
    stats = kd.kd_stats_fwd(labels, s, t, b, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        kd.kd_stats_fwd(labels.cpu(), s.cpu(), t.cpu(), b.cpu(), 2.0)
    with pytest.raises(TypeError):
        kd.kd_stats_fwd(labels, s.half(), t.half(), b.half(), 2.0)
    with pytest.raises(TypeError, match="one dtype"):
        kd.kd_stats_fwd(labels, s, t.bfloat16(), b, 2.0)
    with pytest.raises(TypeError, match="int64"):
        kd.kd_stats_fwd(labels.int(), s, t, b, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        kd.kd_stats_fwd(labels, s.t().contiguous().t(), t, b, 2.0)
    with pytest.raises(ValueError, match="rows"):
        kd.kd_stats_fwd(labels[:4], s, t, b, 2.0)
    with pytest.raises(ValueError):
        kd.kd_stats_fwd(labels, s, t[:, :50].contiguous(), b, 2.0)
    with pytest.raises(ValueError, match="float32"):
        kd.kd_grad_bwd(labels, g.double(), stats, s, t, b, 2.0, 0.125)
    with pytest.raises(ValueError, match="stats"):
        kd.kd_grad_bwd(labels, g, stats[:, :9].contiguous(), s, t, b, 2.0,
                       0.125)


def test_kd_loss_rejects_out_of_range_labels(cuda):
    """The device-side label check poisons the CUDA context when it fires,
    so it runs in a child process."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import ops\n"
        "s = torch.zeros(4, 100, device='cuda')\n"
        "y = torch.tensor([0, 1, 100, 3], device='cuda')\n"
        "ops.kd_loss(y, s, s, None, 2.0)\n"
        "torch.cuda.synchronize()\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "assert" in proc.stderr.lower()


# -- Algorithm 1 on the card -------------------------------------------------


@pytest.mark.parametrize("method", ["kd", "bkd"])
def test_federated_round_on_card_matches_cpu_and_runs_the_kernels(
        cuda, method):
    """One quickstart round of an MLP, f32 with TF32 off, from one carried
    initial state: the first Phase-2 loss agrees within 1e-5 relative and
    the test accuracy within 0.02 (as the CPU tests hold the port against
    the JAX package); every Phase-2 step ran both kernels."""
    import dataclasses

    from repro_torch.core.fl import FederatedKD
    from repro_torch.examples import quickstart
    from repro_torch.interop import params_from_numpy, params_to_numpy

    torch.backends.cudnn.allow_tf32 = False
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    cfg = quickstart.config(method, rounds=1)
    first, acc, launches = {}, {}, {}
    for device in ("cpu", "cuda"):
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        state = fl.pretrain_core(0)
        teachers = fl.train_round_edges([state], [0], seed=cfg.seed)
        stepper = fl.distill_stepper(state, teachers, 0, edge_ids=[0])
        stepper.step(max_steps=1)
        first[device] = stepper.losses[0].item()
        before = (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches)
        _, hist = FederatedKD(adapter, cfg, core, edges, test,
                              device=device).run(0, log=None)
        launches[device] = (kd.kd_stats_fwd.launches - before[0],
                            kd.kd_grad_bwd.launches - before[1])
        acc[device] = hist[0]["test_acc"]
    assert abs(first["cuda"] - first["cpu"]) <= 1e-5 * abs(first["cpu"])
    assert abs(acc["cuda"] - acc["cpu"]) <= 0.02
    steps = cfg.kd_epochs * (len(core) // cfg.batch_size)
    assert launches == {"cpu": (0, 0), "cuda": (steps, steps)}


# -- the dequant-fused KD loss kernels ---------------------------------------


def _kdq_case(device, rows, v, dtype, buffer, bits, seed=0):
    """Student and buffer logits of unit scale x 3 and a teacher payload:
    the teacher's logits through the port's int8 or int4 codec (int4
    unpacked to its int8 container, as the transport hands it over)."""
    rng = np.random.default_rng(seed)
    s, t, b = (torch.from_numpy(3 * rng.standard_normal((rows, v)).astype(
        np.float32)) for _ in range(3))
    codec = codecs.parse_codec(f"int{bits}").transform
    p = codec.encode(t)
    codes = codec.unpack_codes(p["codes"], v)
    labels = torch.from_numpy(rng.integers(0, v, size=rows).astype(np.int64))
    g = torch.from_numpy(rng.uniform(0.5, 2.0, rows).astype(np.float32))
    return (labels.to(device), s.to(device, dtype), codes.to(device),
            p["scale"].to(device), p["zero"].to(device),
            b.to(device, dtype) if buffer else None, g.to(device))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [100, 128, 129, 49155])
@pytest.mark.parametrize("rows", [1, 7, 128, 513])
def test_kd_quant_kernels_match_ref(cuda, rows, v, dtype, buffer, bits):
    labels, s, codes, scale, zero, b, g = _kdq_case(cuda, rows, v, dtype,
                                                    buffer, bits)
    tau = 2.0
    before = (kd.kd_quant_stats_fwd.launches, kd.kd_quant_grad_bwd.launches)
    stats = kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau)
    ds = kd.kd_quant_grad_bwd(labels, g, stats, s, codes, scale, zero, b, tau,
                              1.0 / rows)
    torch.cuda.synchronize()
    assert (kd.kd_quant_stats_fwd.launches, kd.kd_quant_grad_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    want = ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau)
    assert stats.shape == (rows, kd.N_STATS) and stats.dtype == torch.float32
    assert torch.isfinite(stats).all()
    assert _rel(stats, want) <= TOL[dtype]
    want_ds = ref.kd_quant_grad_ref(labels, g, want, s, codes, scale, zero, b,
                                    tau, 1.0 / rows)
    assert ds.dtype == dtype and ds.shape == s.shape
    assert torch.isfinite(ds.float()).all()
    assert _rel(ds, want_ds) <= TOL[dtype]


@pytest.mark.parametrize("buffer", [False, True])
def test_kd_loss_quant_autograd_matches_plain(cuda, buffer):
    labels, s, codes, scale, zero, b, _ = _kdq_case(cuda, 128, 100,
                                                    torch.float32, buffer, 8, 1)
    s1 = s.clone().requires_grad_()
    loss = ops.kd_loss_quant(labels, s1, codes, scale, zero, b, 2.0)
    loss.backward()
    s2 = s.clone().requires_grad_()
    want = ref.kd_loss_mean_ref(labels, s2, ref.dequantize(codes, scale, zero),
                                b, 2.0)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert _rel(s1.grad, s2.grad) <= 1e-5


def test_kd_loss_quant_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain path taken on a CUDA tensor")

    for name in ("kd_quant_stats_ref", "kd_quant_grad_ref", "dequantize",
                 "kd_stats_ref", "kd_grad_ref"):
        monkeypatch.setattr(ref, name, refuse)
    labels, s, codes, scale, zero, b, _ = _kdq_case(cuda, 8, 129,
                                                    torch.float32, True, 4, 2)
    before = (kd.kd_quant_stats_fwd.launches, kd.kd_quant_grad_bwd.launches)
    s = s.requires_grad_()
    ops.kd_loss_quant(labels, s, codes, scale, zero, b, 2.0).backward()
    torch.cuda.synchronize()
    assert (kd.kd_quant_stats_fwd.launches, kd.kd_quant_grad_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(s.grad).all()


def test_kd_quant_kernel_wrappers_check_inputs(cuda):
    labels, s, codes, scale, zero, b, g = _kdq_case(cuda, 8, 100,
                                                    torch.float32, True, 8, 3)
    stats = kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        kd.kd_quant_stats_fwd(labels.cpu(), s.cpu(), codes.cpu(),
                              scale.cpu(), zero.cpu(), b.cpu(), 2.0)
    with pytest.raises(TypeError, match="int8"):
        kd.kd_quant_stats_fwd(labels, s, codes.to(torch.uint8), scale, zero,
                              b, 2.0)
    with pytest.raises(TypeError, match="float32"):
        kd.kd_quant_stats_fwd(labels, s, codes, scale.double(), zero, b, 2.0)
    with pytest.raises(ValueError, match="rows"):
        kd.kd_quant_stats_fwd(labels, s, codes, scale[:4].contiguous(), zero,
                              b, 2.0)
    with pytest.raises(ValueError, match="codes"):
        kd.kd_quant_stats_fwd(labels, s, codes[:, :50].contiguous(), scale,
                              zero, b, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        kd.kd_quant_stats_fwd(labels, s, codes.t().contiguous().t(), scale,
                              zero, b, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        kd.kd_quant_stats_fwd(labels, s, codes, torch.stack(
            [scale, scale], 1)[:, 0], zero, b, 2.0)
    with pytest.raises(ValueError, match="cpu"):
        kd.kd_quant_stats_fwd(labels, s, codes.cpu(), scale, zero, b, 2.0)
    with pytest.raises(ValueError, match="cpu"):
        kd.kd_quant_stats_fwd(labels, s, codes, scale, zero.cpu(), b, 2.0)
    with pytest.raises(TypeError, match="one dtype"):
        kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b.bfloat16(),
                              2.0)
    with pytest.raises(ValueError, match="stats"):
        kd.kd_quant_grad_bwd(labels, g, stats[:, :9].contiguous(), s, codes,
                             scale, zero, b, 2.0, 0.125)
    with pytest.raises(TypeError, match="int8"):
        kd.kd_quant_grad_bwd(labels, g, stats, s, codes.long(), scale, zero,
                             b, 2.0, 0.125)


# -- the forward pair's plans: alignment, edges, graph replay ---------------

# A row past WARP_MAX_V that gives every warp of the block path three
# chunks and a ragged last one.
LONG_V = 3 * kd.CHUNK * kd.BLOCK_WARPS + 5


def _shifted(x, off):
    """x's values in a view at storage offset ``off`` elements of a larger
    buffer, ending where the buffer ends: contiguous, its data pointer moved
    by off * itemsize bytes, NaN (codes: 127) in the elements before it."""
    fill = 127 if x.dtype == torch.int8 else float("nan")
    flat = torch.full((off + x.numel(),), fill, dtype=x.dtype,
                      device=x.device)
    flat[off:] = x.reshape(-1)
    return flat[off:].view(x.shape)


def _fwd_case(device, rows, v, dtype, buffer, seed):
    """Exact and quant forward inputs of one draw: labels, s, t, b (b None
    without buffer) and the int8 payload of t."""
    labels, s, t, b, _ = _kd_case(device, rows, v, dtype, buffer, seed)
    p = codecs.parse_codec("int8").transform.encode(t.float())
    codes = codecs.parse_codec("int8").transform.unpack_codes(p["codes"], v)
    return labels, s, t, b, codes, p["scale"], p["zero"]


def _check_fwd(labels, s, t, b, codes, scale, zero, tau=2.0, path=None):
    """Both forward kernels against their plain versions, on the planned
    path or on ``path``."""
    got = kd.kd_stats_fwd(labels, s, t, b, tau, path=path)
    got_q = kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau,
                                  path=path)
    torch.cuda.synchronize()
    tol = TOL[s.dtype]
    for have, want in ((got, ref.kd_stats_ref(labels, s, t, b, tau)),
                       (got_q, ref.kd_quant_stats_ref(labels, s, codes, scale,
                                                      zero, b, tau))):
        assert torch.isfinite(have).all()
        assert _rel(have, want) <= tol


@pytest.mark.parametrize("offsets", [(1, 5, 11, 13), (15, 2, 7, 3),
                                     (8, 14, 1, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,v", [(129, 100), (3, kd.WARP_MAX_V + 1),
                                    (2, 49155)])
def test_kd_forward_reads_views_at_any_storage_offset(cuda, rows, v, dtype,
                                                      offsets):
    """s, t, b and codes each start 1-15 elements into their storage, so
    every tensor's rows are misaligned in their own way; elements before a
    view are NaN."""
    labels, s, t, b, codes, scale, zero = _fwd_case(cuda, rows, v, dtype,
                                                    True, seed=rows + v)
    os_, ot, ob, oc = offsets
    s, t, b, codes = (_shifted(s, os_), _shifted(t, ot), _shifted(b, ob),
                      _shifted(codes, oc))
    assert s.is_contiguous() and s.storage_offset() == os_
    _check_fwd(labels, s, t, b, codes, scale, zero)


@pytest.mark.parametrize("path", [None, "warp", "block"])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("v", [1, 7, 33, kd.WARP_MAX_V, kd.WARP_MAX_V + 1,
                               LONG_V])
@pytest.mark.parametrize("rows", [1, 6, 133])
def test_kd_forward_plans_at_the_edges(cuda, rows, v, buffer, path):
    """V = 1, V either side of WARP_MAX_V and past several block rounds,
    rows not a multiple of the warp path's rows a block; each shape on its
    planned path and forced onto either path."""
    dtype = torch.float32
    inputs = _fwd_case(cuda, rows, v, dtype, buffer, seed=3 * rows + v)
    planned = kd.plan(rows, v)
    assert planned.path == ("warp" if v <= kd.WARP_MAX_V else "block")
    assert planned.blocks * planned.rows_per_block >= rows
    _check_fwd(*inputs, path=path)


def test_kd_forward_wrappers_reject_tau_at_or_below_zero(cuda):
    labels, s, t, b, codes, scale, zero = _fwd_case(cuda, 4, 100,
                                                    torch.float32, True, 1)
    for tau in (0.0, -1.0):
        with pytest.raises(ValueError, match="tau > 0"):
            kd.kd_stats_fwd(labels, s, t, b, tau)
        with pytest.raises(ValueError, match="tau > 0"):
            kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau)


@pytest.mark.parametrize("v", [100, kd.WARP_MAX_V + 1, 49155])
def test_kd_forward_wrappers_replay_from_a_cuda_graph(cuda, v):
    """The plan comes from the shapes alone: a graph captured once (after
    each plan's first eager call) replays both wrappers on new values
    copied into the same tensors and equals eager launches bit for bit."""
    rows, tau = 24, 2.0
    first = list(_fwd_case(cuda, rows, v, torch.bfloat16, True, 1))
    second = _fwd_case(cuda, rows, v, torch.bfloat16, True, 2)
    labels, s, t, b, codes, scale, zero = first

    def both():
        return (kd.kd_stats_fwd(labels, s, t, b, tau),
                kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau))

    before = both()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    for have, new in zip(first, second):
        have.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    want = both()
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not any(torch.equal(o, w) for o, w in zip(out, before))


# -- the backward pair's flat pass: offsets, edges, launches, graph replay --


def _bwd_case(device, rows, v, dtype, buffer, seed):
    """Backward inputs of one draw: labels, g, s, t, b (None without
    buffer) and the int8 payload (codes, scale, zero) of t."""
    labels, s, t, b, g = _kd_case(device, rows, v, dtype, buffer, seed)
    codec = codecs.parse_codec("int8").transform
    # a payload cannot carry the -1e30 pad columns (their affine would
    # swamp the row's): the teacher's pad columns are encoded as 0
    p = codec.encode(torch.where(t.float() > -1e29, t.float(), 0.0))
    return (labels, g, s, t, b, codec.unpack_codes(p["codes"], v), p["scale"],
            p["zero"])


def _bwd_pair(labels, g, s, t, b, codes, scale, zero, tau=2.0, **kw):
    """Both backward wrappers and their plain versions, each from its
    plain stats: ((got, want), (got_q, want_q))."""
    ms = 1.0 / s.shape[0]
    st = ref.kd_stats_ref(labels, s, t, b, tau)
    st_q = ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau)
    return ((kd.kd_grad_bwd(labels, g, st, s, t, b, tau, ms, **kw),
             ref.kd_grad_ref(labels, g, st, s, t, b, tau, ms)),
            (kd.kd_quant_grad_bwd(labels, g, st_q, s, codes, scale, zero, b,
                                  tau, ms, **kw),
             ref.kd_quant_grad_ref(labels, g, st_q, s, codes, scale, zero, b,
                                   tau, ms)))


def _bwd_into(ds, labels, g, s, t, b, codes, scale, zero, quant, width,
              tau=2.0):
    """A backward C entry point, called as its wrapper calls it with
    ``width``, writing into ``ds`` (a view anywhere in a larger buffer);
    returns the plain version's gradient."""
    rows, v = s.shape
    lib = kd._library()
    bp = b.data_ptr() if b is not None else None
    tail = (rows, v, tau, 1.0 / tau, 1.0 / rows, kd._DTYPES[s.dtype],
            width or 0, torch.cuda.current_stream().cuda_stream)
    if quant:
        st = ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau)
        err = lib.kd_quant_grad_bwd(
            labels.data_ptr(), g.data_ptr(), st.data_ptr(), s.data_ptr(),
            codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), bp,
            ds.data_ptr(), *tail)
        want = ref.kd_quant_grad_ref(labels, g, st, s, codes, scale, zero, b,
                                     tau, 1.0 / rows)
    else:
        st = ref.kd_stats_ref(labels, s, t, b, tau)
        err = lib.kd_grad_bwd(labels.data_ptr(), g.data_ptr(), st.data_ptr(),
                              s.data_ptr(), t.data_ptr(), bp, ds.data_ptr(),
                              *tail)
        want = ref.kd_grad_ref(labels, g, st, s, t, b, tau, 1.0 / rows)
    assert err == 0
    return want


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("offsets", [(1, 5, 11, 13, 7), (15, 2, 7, 3, 9),
                                     (8, 14, 1, 6, 0), (3, 3, 3, 3, 3),
                                     (4, 4, 4, 4, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,v", [(129, 100), (3, kd.WARP_MAX_V + 1),
                                    (2, 49155)])
def test_kd_backward_reads_and_writes_views_at_any_storage_offset(
        cuda, rows, v, dtype, offsets):
    """s, t, b, codes and ds each start 1-15 elements into their storage
    (NaN, codes 127, before each view), planned and with 16-byte vectors
    asked for: the body runs on vectors where every tensor shares s's skew
    (peeling a head; the wrappers' ds takes s's skew), one logit a thread
    where not; ds's guard bands, before it and after, stay unwritten."""
    labels, g, s, t, b, codes, scale, zero = _bwd_case(cuda, rows, v, dtype,
                                                       True, seed=rows + v)
    os_, ot, ob, oc, od = offsets
    s, t, b, codes = (_shifted(s, os_), _shifted(t, ot), _shifted(b, ob),
                      _shifted(codes, oc))
    assert s.storage_offset() == os_ and codes.storage_offset() == oc
    tol = TOL[dtype]
    n, guard = rows * v, 40
    for width in (None, 16 // s.element_size()):
        for got, want in _bwd_pair(labels, g, s, t, b, codes, scale, zero,
                                   width=width):
            assert torch.isfinite(got.float()).all()
            assert _rel(got, want) <= tol
        for quant in (False, True):
            buf = torch.full((od + n + guard,), float("nan"), dtype=dtype,
                             device=cuda)
            before = buf.clone()
            ds = buf[od:od + n].view(rows, v)
            want = _bwd_into(ds, labels, g, s, t, b, codes, scale, zero,
                             quant, width)
            torch.cuda.synchronize()
            assert _rel(ds, want) <= tol
            assert torch.equal(_bits(buf[:od]), _bits(before[:od]))
            assert torch.equal(_bits(buf[od + n:]), _bits(before[od + n:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("v", [1, 7, 33, 100, 1024, 1025, 49155])
@pytest.mark.parametrize("rows", [1, 6, 133])
def test_kd_backward_at_the_edges(cuda, rows, v, buffer, dtype):
    """V below a vector's width (rows end several times inside a vector),
    V = 100 (bf16 vectors cross every other row end), V on either side of
    1,024 and the LLM vocabulary; each wrapper launches once a call."""
    inputs = _bwd_case(cuda, rows, v, dtype, buffer, seed=5 * rows + v)
    before = (kd.kd_grad_bwd.launches, kd.kd_quant_grad_bwd.launches)
    pairs = _bwd_pair(*inputs)
    torch.cuda.synchronize()
    assert (kd.kd_grad_bwd.launches, kd.kd_quant_grad_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in pairs:
        assert got.dtype == dtype and got.shape == (rows, v)
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,v", [(133, 100), (6, kd.WARP_MAX_V + 1),
                                    (3, 7), (512, 1024)])
def test_kd_backward_launches_agree_bit_for_bit(cuda, rows, v, dtype):
    """Every logit is computed alone, so either width (16 bytes of logits
    or one) writes the same bits as the planned launch; a width the C side
    cannot run is refused."""
    inputs = _bwd_case(cuda, rows, v, dtype, True, seed=rows)
    planned = [got for got, _ in _bwd_pair(*inputs)]
    w = 16 // torch.empty(0, dtype=dtype).element_size()
    for width in (1, w):
        got = [g for g, _ in _bwd_pair(*inputs, width=width)]
        assert all(torch.equal(a, b) for a, b in zip(got, planned)), width
    for width in (2, 2 * w, -1):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _bwd_pair(*inputs, width=width)


@pytest.mark.parametrize("v", [100, kd.WARP_MAX_V + 1, 49155])
def test_kd_backward_wrappers_replay_from_a_cuda_graph(cuda, v):
    """The launch is decided from shapes and pointers alone: a graph
    captured once replays both wrappers on new values copied into the same
    tensors and equals eager launches bit for bit."""
    rows, tau = 24, 2.0
    first = list(_bwd_case(cuda, rows, v, torch.bfloat16, True, 1))
    second = _bwd_case(cuda, rows, v, torch.bfloat16, True, 2)
    labels, g, s, t, b, codes, scale, zero = first
    st = ref.kd_stats_ref(labels, s, t, b, tau)
    st_q = ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau)

    def both():
        return (kd.kd_grad_bwd(labels, g, st, s, t, b, tau, 0.5),
                kd.kd_quant_grad_bwd(labels, g, st_q, s, codes, scale, zero, b,
                                     tau, 0.5))

    before = both()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    for have, new in zip(first, second):
        have.copy_(new)
    st.copy_(ref.kd_stats_ref(labels, s, t, b, tau))
    st_q.copy_(ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau))
    graph.replay()
    torch.cuda.synchronize()
    want = both()
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not any(torch.equal(o, w) for o, w in zip(out, before))


def test_int8_federated_round_on_card_matches_cpu_and_runs_the_quant_kernels(
        cuda):
    """One quickstart bkd round with int8 uplink transport, f32 with TF32
    off, from one carried initial state: the round-0 payloads differ only
    in codes on a rounding tie (teacher logits ~1e-6 apart), so the first
    Phase-2 loss is held within 1e-5 relative with the CPU stepper given
    the card's payload; the test accuracy within 0.02 and the uplink log
    exactly; every Phase-2 step ran the quant pair and not the exact one."""
    import dataclasses

    from repro_torch.core.fl import FederatedKD
    from repro_torch.examples import quickstart
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.transport.method import PAYLOAD_KEY

    torch.backends.cudnn.allow_tf32 = False
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    cfg = quickstart.config("bkd", rounds=1, transport="int8")
    counters = (kd.kd_quant_stats_fwd, kd.kd_quant_grad_bwd, kd.kd_stats_fwd,
                kd.kd_grad_bwd)
    first, acc, launches, logs, payload = {}, {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        state = fl.pretrain_core(0)
        teachers = fl.train_round_edges([state], [0], seed=cfg.seed)
        stepper = fl.distill_stepper(state, teachers, 0, edge_ids=[0])
        payload[device] = stepper.mstate["cache"][PAYLOAD_KEY]
        if device == "cpu":
            stepper.mstate["cache"][PAYLOAD_KEY] = {
                k: v.cpu() for k, v in payload["cuda"].items()}
        stepper.step(max_steps=1)
        first[device] = stepper.losses[0].item()
        before = [c.launches for c in counters]
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        _, hist = fl.run(0, log=None)
        launches[device] = tuple(c.launches - n
                                 for c, n in zip(counters, before))
        acc[device] = hist[0]["test_acc"]
        logs[device] = fl.distill_engine.uplink_log
    codes = [payload[d]["codes"].cpu().int() for d in ("cuda", "cpu")]
    assert (codes[0] - codes[1]).abs().max() <= 1
    assert abs(first["cuda"] - first["cpu"]) <= 1e-5 * abs(first["cpu"])
    assert abs(acc["cuda"] - acc["cpu"]) <= 0.02
    assert logs["cuda"] == logs["cpu"]
    steps = cfg.kd_epochs * (len(core) // cfg.batch_size)
    assert launches == {"cpu": (0, 0, 0, 0),
                        "cuda": (steps, steps, 0, 0)}


# -- the recurrent scans and recurrent serving --------------------------------

# The JAX kernel test's tolerance for its SSD kernel against its reference:
# the kernel sums q-long dot products in another order than the einsums.
TOL_SSD = 3e-4

# (b, s, h, p, n, g, chunk): chip_smoke.py's cases (Mamba-2 370m's serving
# shape at s = 32, 224 (q 112), 151 (q 1) and 2048, SMOKE's p = n = 32),
# two B/C groups, and a short prime length; Mamba-2's heads at one slot
# (chunk 112 and chunk 1); ragged tiles: p = 24 (one p tile of 32), p = 72
# (two tiles of 64) with n = 10 (a ragged k step, 4-byte copies) at q = 37,
# and the row kernel at p = 24, n = 10; p = n = 256 at chunk 64 (the
# largest state a chunk kernel takes).
SSD_CASES = [(4, 32, 32, 64, 128, 1, 128), (4, 224, 32, 64, 128, 1, 128),
             (4, 151, 32, 64, 128, 1, 128), (4, 2048, 32, 64, 128, 1, 128),
             (2, 96, 16, 32, 32, 1, 32), (2, 96, 4, 16, 8, 2, 32),
             (1, 37, 2, 8, 4, 1, 32), (1, 224, 32, 64, 128, 1, 128),
             (1, 151, 32, 64, 128, 1, 128), (2, 80, 4, 24, 32, 1, 40),
             (2, 74, 2, 72, 10, 1, 37), (1, 37, 2, 24, 10, 1, 32),
             (1, 128, 1, 256, 256, 1, 64)]


def _ssd_case(device, b, s, h, p, n, g, seed=0):
    """The JAX kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0)
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, s, g, n)) * 0.5
    C = rng.standard_normal((b, s, g, n)) * 0.5
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, dt, A, B, C)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_ref(cuda, case):
    *shape, chunk = case
    args = _ssd_case(cuda, *shape)
    before = ssd.launches
    y, state = ops.ssd(*args, chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    wy, ws = ref.ssd_ref(*args, chunk_size(chunk, shape[1]))
    for got, want in ((y, wy), (state, ws)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=TOL_SSD, atol=TOL_SSD)


def test_ssd_kernel_wrapper_checks_inputs(cuda):
    x, dt, A, B, C = _ssd_case(cuda, 1, 16, 4, 8, 8, 2)
    with pytest.raises(TypeError):
        ssd(x.to(torch.bfloat16), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, B, C, 5)
    with pytest.raises(ValueError, match="groups"):
        ssd(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(),
            A[:3].contiguous(), B, C, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd(x.transpose(2, 3), dt, A, B, C, 16)
    # A plan over a block's shared memory: the C side's opt-in fails, the
    # wrapper raises its CUDA error, and the next launch is not affected.
    big = _ssd_case(cuda, 1, 128, 1, 256, 256, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd(*big, 128)
    ssd(x, dt, A, B, C, 16)
    torch.cuda.synchronize()
    # A state wider than the kernels' registers and rows take.
    wide = _ssd_case(cuda, 1, 16, 1, 8, 264, 1)
    with pytest.raises(ValueError, match="d_state"):
        ssd(*wide, 16)


def test_ssd_tf32_fragments_and_denormals(cuda):
    """The chunk kernel's 3xTF32 MMA fragments (``ssd_tf32_probe`` of
    csrc/ssd.cu, which the wrapper does not bind) give an f32-accurate
    16x8x8 product; a denormal TF32 product comes out exact or flushed to
    0, and either way moves a sum by less than 2^-126 (far inside TOL_SSD).
    Prints which, and the 3xTF32 product's error (``pytest -rP``)."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.load("ssd").ssd_tf32_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def tf32_probe(a, b, split3=True):
        d = torch.empty((16, 8), dtype=torch.float32, device=cuda)
        assert fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), int(split3),
                  torch.cuda.current_stream(cuda).cuda_stream) == 0
        return d

    gen = torch.Generator().manual_seed(5)
    a = torch.randn((16, 8), generator=gen)
    b = torch.randn((8, 8), generator=gen)
    got = tf32_probe(a.to(cuda), b.to(cuda)).double().cpu()
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    rel = ((got - want).abs() / scale).max().item()
    assert rel < 1e-6
    one = tf32_probe(a.to(cuda), b.to(cuda), split3=False).double().cpu()
    assert ((one - want).abs() / scale).max().item() > 1e-5  # TF32 alone
    tiny = torch.zeros((16, 8))
    tiny[0, 0] = 2.0 ** -130
    d = tf32_probe(tiny.to(cuda), torch.eye(8).to(cuda), split3=False)
    out = d[0, 0].item()
    assert out in (0.0, 2.0 ** -130)
    assert torch.count_nonzero(d[1:]).item() == 0
    print(f"3xTF32 16x8x8 product within {rel:.3g} of f64 (relative to sum "
          f"|a||b|); 2^-130 x 1 in TF32 gives {out!r}: denormal inputs "
          f"{'kept' if out else 'flushed'} on {torch.cuda.get_device_name(cuda)}")


def test_scan_wrappers_replay_from_a_cuda_graph(cuda):
    """Neither scan wrapper synchronises or keeps state: a graph captured
    once replays the chunk kernel, the row kernel and rglru to the eager
    result, also after the inputs change in place."""
    chunk_args = _ssd_case(cuda, 2, 224, 4, 64, 128, 1, seed=3)
    row_args = _ssd_case(cuda, 2, 151, 4, 64, 128, 1, seed=4)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.1, 0.99, (2, 224, 4096))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((2, 224, 4096))
                         .astype(np.float32)).to(cuda)
    calls = [lambda: ssd(*chunk_args, 112), lambda: ssd(*row_args, 1),
             lambda: rglru(a, b)]
    for fn in calls:
        fn()  # first calls (and any shared-memory opt-in) outside capture
    torch.cuda.synchronize()
    graphs = [_capture(fn) for fn in calls]
    for step in range(2):
        if step:
            for t in (*chunk_args, *row_args, b):
                t.mul_(0.5)
            a.sqrt_()
        for (graph, out), fn in zip(graphs, calls):
            graph.replay()
            torch.cuda.synchronize()
            want = fn()
            if isinstance(out, tuple):
                assert all(torch.equal(o, w) for o, w in zip(out, want))
            else:
                assert torch.equal(out, want)


@pytest.mark.parametrize("shape", [(4, 32, 4096), (4, 2048, 4096),
                                   (2, 128, 130), (1, 384, 128), (3, 17, 5),
                                   (1, 224, 4096), (2, 300, 4099)],
                         ids=str)
def test_rglru_kernel_matches_ref(cuda, shape):
    rng = np.random.default_rng(1)
    a = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal(shape))))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    before = rglru.launches
    got = ops.rglru(a, b)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    torch.testing.assert_close(got, ref.rglru_ref(a, b), rtol=1e-5, atol=1e-5)


def test_rglru_kernel_wrapper_checks_inputs(cuda):
    a = torch.rand((2, 8, 16), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    with pytest.raises(TypeError):
        rglru(a.double(), a.double())
    with pytest.raises(TypeError):
        rglru(a.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="shape"):
        rglru(a, a[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru(a.transpose(0, 1), a.transpose(0, 1))


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_engine_on_card_matches_cpu_and_runs_the_kernels(cuda, arch):
    """Greedy tokens on the card equal the CPU's (f32, TF32 off) over
    exact-length admissions, and every prefill launched the scan kernel once
    per recurrent layer, every decode tick ``swa_decode`` once per local
    attention layer."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import count_prefills   # the script's prefill counter

    cfg = registry.get_smoke_config(arch)
    params = Transformer.init(cfg, 1, device="cpu")
    reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size, seed=4,  # noqa: E731
                                prompt_max=40, out_max=8)
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)]
    outs = {}
    for device in ("cpu", "cuda"):
        engine = ServeEngine(cfg, _to(params, device), slots=3, max_len=64,
                             device=device)
        prefills = count_prefills(engine)
        before = (ssd.launches, rglru.launches, swa_decode.launches)
        outs[device] = {r.rid: r.out for r in engine.run(reqs())}
        launches = [n - m for n, m in zip(
            (ssd.launches, rglru.launches, swa_decode.launches), before)]
    assert outs["cpu"] == outs["cuda"]
    assert launches == [kinds.count("ssd") * len(prefills),
                        kinds.count("rglru") * len(prefills),
                        kinds.count("local") * engine.decode_ticks]
    assert len(prefills) > 0 and engine.decode_ticks > 0


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"])
def test_moe_forward_and_engines_on_card_match_cpu(cuda, arch):
    """``moe.forward`` on a 4-row decode tick (capacity binds) and a
    prefill-sized batch, card against CPU within 1e-5 (f32, TF32 off); the
    dense and paged engines serve the arch's SMOKE config with the card's
    greedy tokens equal to the CPU's, through their decode kernels."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.nn import moe
    cfg = registry.get_smoke_config(arch)
    weights = params_to_numpy(Transformer.init(cfg, 3, device="cpu"))
    mlp = {k: v[0] for k, v in weights["blocks"]["b0"]["mlp"].items()
           if k != "shared"}
    rng = np.random.default_rng(4)
    for shape in ((4, 1, cfg.d_model), (2, 40, cfg.d_model)):
        x = rng.standard_normal(shape).astype(np.float32)
        out = {dev: moe.forward(params_from_numpy(mlp, dev), cfg.moe_cfg(),
                                torch.from_numpy(x).to(dev))
               for dev in ("cpu", "cuda")}
        assert (out["cuda"][0].cpu() - out["cpu"][0]).abs().max() <= 1e-5
        assert abs(float(out["cuda"][1]) - float(out["cpu"][1])) <= 1e-6
    for paged in (False, True):
        reqs = lambda: build_stream("bursty", 6, vocab=cfg.vocab_size,  # noqa: E731
                                    seed=5, prompt_max=24, out_max=8,
                                    shared_prefix=8)
        outs = {}
        for dev in ("cpu", "cuda"):
            engine = ServeEngine(cfg, params_from_numpy(weights, dev),
                                 slots=4, max_len=64, paged=paged,
                                 page_size=8, device=dev)
            outs[dev] = {r.rid: r.out for r in engine.run(reqs())}
        assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b"])
def test_phase2_step_on_card_matches_cpu_through_the_kd_pair(cuda, arch):
    """One buffered-KD Phase-2 step (two loss chunks) of the SMOKE config on
    the card, where 'pallas' is the kd kernel pair, against the same step
    on the CPU (the pair's plain versions), f32 with TF32 off: loss within
    1e-5 and each gradient leaf within 1e-4 of its largest CPU gradient
    (read through an optimizer that returns the gradient); after one AdamW
    step (lr 3e-4), parameters within 1e-6 where the CPU gradient is at
    least 1e-6 in magnitude and within 2·lr below (AdamW's first step is
    lr·g/(|g| + 1e-8)).  The card launches ``kd_stats_fwd`` 2 x 2 times
    (each chunk's forward and its recompute) and ``kd_grad_bwd`` 2 times."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch import steps as St
    from repro_torch.optim import Optimizer, adamw
    grad_opt = Optimizer(init=lambda p: {},
                         update=lambda g, s, p, step, lr=None: (g, s))
    cfg = registry.get_smoke_config(arch)
    weights = [params_to_numpy(Transformer.init(cfg, s, device="cpu"))
               for s in (1, 2, 3)]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size - 1,
                                             size=(2, 33))
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        res = []
        for opt in (grad_opt, adamw(3e-4)):
            student, teacher, buf = (params_from_numpy(w, dev)
                                     for w in weights)
            step = St.make_phase2_step(cfg, opt, loss_chunk=16,
                                       loss_backend="pallas")
            kd.kd_stats_fwd.launches = kd.kd_grad_bwd.launches = 0
            p, _, m = step(student, teacher, buf, opt.init(student), batch, 0)
            res.append((list(_leaves(params_to_numpy(p))), float(m["loss"])))
            if dev == "cuda":
                assert (kd.kd_stats_fwd.launches,
                        kd.kd_grad_bwd.launches) == (4, 2)
        out[dev] = res
    (g_cpu, loss_cpu), (p_cpu, _) = out["cpu"]
    (g_card, loss_card), (p_card, _) = out["cuda"]
    assert abs(loss_card - loss_cpu) <= 1e-5
    for got, want in zip(g_card, g_cpu):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for got, want, g in zip(p_card, p_cpu, g_cpu):
        err, tiny = np.abs(got - want), np.abs(g) < 1e-6
        assert err[~tiny].max(initial=0) <= 1e-6
        assert err[tiny].max(initial=0) <= 2 * 3e-4


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("scenario", ["async_heavy_tail", "hier_uniform"])
def test_async_and_hierarchical_runs_launch_the_kd_pair_per_step(cuda,
                                                                 scenario):
    """The quickstart's MLP federation (bkd, 2 core rounds at R = 2) under
    an emergent-staleness timeline and a two-level fleet, on the card and
    on the CPU from one initial state: the kd pair launches once a Phase-2
    step of every distill round the plan stream holds (region rounds
    included), ``history`` has one entry a core round, and the test
    accuracy agrees within 0.02."""
    import dataclasses

    from repro_torch.core.fl import FederatedKD
    from repro_torch.core.scheduler import build_scenario
    from repro_torch.examples import quickstart
    from repro_torch.interop import params_from_numpy, params_to_numpy

    torch.backends.cudnn.allow_tf32 = False
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    cfg = dataclasses.replace(quickstart.config("bkd", rounds=2),
                              num_edges=len(edges), aggregation_r=2)
    plans = build_scenario(scenario, len(edges), aggregation_r=2).plans(2)
    steps = len(plans) * cfg.kd_epochs * (len(core) // cfg.batch_size)
    acc = {}
    for device in ("cuda", "cpu"):
        kd.kd_stats_fwd.launches = kd.kd_grad_bwd.launches = 0
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device,
                         scheduler=build_scenario(scenario, len(edges),
                                                  aggregation_r=2))
        _, hist = fl.run(0, log=None)
        launches = (kd.kd_stats_fwd.launches, kd.kd_grad_bwd.launches)
        assert launches == ((steps, steps) if device == "cuda" else (0, 0))
        assert len(hist) == 2
        acc[device] = [h["test_acc"] for h in hist]
    assert max(abs(a - b) for a, b in zip(acc["cuda"], acc["cpu"])) <= 0.02


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_training_on_card_takes_the_plain_scans(cuda, arch):
    """A SMOKE pretrain step on the card (f32, TF32 off) launches neither
    scan kernel and agrees with the CPU step: loss within 1e-5, each
    gradient leaf within 1e-4 of its largest CPU gradient.  The kernels
    themselves are forward-only: ``use_kernel=True`` under autograd on a
    CUDA tensor raises."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels import rglru as rglru_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.launch import steps as St
    from repro_torch.models.transformer import _recurrent
    from repro_torch.optim import Optimizer
    from repro_torch.tree import tree_map

    grad_opt = Optimizer(init=lambda p: {},
                         update=lambda g, s, p, step, lr=None: (g, s))
    cfg = registry.get_smoke_config(arch)
    weights = params_to_numpy(Transformer.init(cfg, 4, device="cpu"))
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size - 1,
                                             size=(2, 41))
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        ssd_mod.ssd.launches = rglru_mod.rglru.launches = 0
        step = St.make_pretrain_step(cfg, grad_opt, loss_chunk=20)
        p, _, m = step(params_from_numpy(weights, dev), {}, batch, 0)
        out[dev] = (list(_leaves(params_to_numpy(p))), float(m["loss"]))
        assert ssd_mod.ssd.launches == rglru_mod.rglru.launches == 0
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                       1e-30)
    kind = next(k for k in cfg.block_pattern if k in ("ssd", "rglru"))
    lib, sub = _recurrent(cfg, kind)
    block = Transformer.init(cfg, 4, device="cuda")["blocks"]
    layer = tree_map(lambda v: v[0].detach().requires_grad_(),
                     block[f"b{cfg.block_pattern.index(kind)}"]["mixer"])
    x = torch.randn(2, 16, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    with pytest.raises(NotImplementedError, match="forward-only"):
        lib.forward(layer, sub, x, use_kernel=True)
    lib.forward(layer, sub, x, use_kernel=False).sum().backward()
    with torch.no_grad():
        lib.forward(layer, sub, x, use_kernel=True)


def _granite_attn3():
    import dataclasses
    cfg = registry.get_smoke_config("granite-3-2b")
    return dataclasses.replace(cfg, block_pattern=("attn",) * 3)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_carry_restore_on_card_resumes_bit_identical(cuda, paged,
                                                            tmp_path):
    """Engine carry/restore on the card (dense caches through swa_decode,
    or the page pool through paged_decode): saved mid-stream with live
    slots and a non-empty queue, restored into a fresh engine and resumed,
    it emits the uninterrupted run's tokens at its clock (paged: the same
    allocator books and host page table)."""
    from repro_torch.checkpoint import save_tree
    cfg = _granite_attn3()
    params = Transformer.init(cfg, 0, device=cuda)
    mk_reqs = lambda: build_stream("bursty", 8, vocab=cfg.vocab_size,  # noqa: E731
                                   seed=13, prompt_max=18, out_max=6,
                                   shared_prefix=10)
    kw = dict(paged=True, page_size=8) if paged else {}
    mk = lambda: ServeEngine(cfg, params, slots=2, max_len=64,  # noqa: E731
                             device=cuda, **kw)
    eng_a = mk()
    done_a = eng_a.run(mk_reqs())
    eng_b = mk()
    eng_b.begin(mk_reqs())
    while not (any(r is not None for r in eng_b._host_active)
               and eng_b._queue):
        eng_b.tick()
    tree, meta = eng_b.carry()
    path = str(tmp_path / "engine.npz")
    save_tree(path, {"engine": tree}, meta)
    kernel = paged_decode if paged else swa_decode
    before = kernel.launches
    eng_c = mk()
    eng_c.restore(path, meta, mk_reqs())
    assert eng_c.caches is not None and tree["pos"].device.type == "cuda"
    while eng_c.pending():
        eng_c.tick()
    assert kernel.launches > before
    assert {r.rid: r.out for r in eng_c._finished} == \
        {r.rid: r.out for r in done_a}
    assert eng_c.ticks == eng_a.ticks
    if paged:
        assert eng_c._alloc.snapshot() == eng_a._alloc.snapshot()
        assert np.array_equal(eng_c._pt_host, eng_a._pt_host)


def test_live_checkpoint_on_card_resumes_bit_identical(cuda, tmp_path):
    """The fused live checkpoint on the card (Granite SMOKE, three attention
    layers, f32, 2 bkd rounds): saved mid-round and mid-epoch, restored
    into a fresh system and resumed, it ends bit-identical to the
    uninterrupted run (state, history, tokens, clock, swaps); the kd pair
    ran every Phase-2 step."""
    from repro_torch.core.fl import FederatedKD, FLConfig
    from repro_torch.live import LiveSystem, LiveTrainer, lm_adapter, lm_fl_data
    cfg = _granite_attn3()
    core, edges, test, _ = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                      n_seqs=96, seed=0)
    flcfg = FLConfig(num_edges=2, rounds=2, method="bkd", core_epochs=1,
                     edge_epochs=1, kd_epochs=2, batch_size=8, seed=0)
    stream = lambda: build_stream("poisson", 5, vocab=cfg.vocab_size,  # noqa: E731
                                  seed=3, prompt_max=10, out_max=4)

    def mk():
        fl = FederatedKD(lm_adapter(cfg), flcfg, core, edges, test,
                         device=cuda)
        trainer = LiveTrainer(fl, 0, log=None)
        return LiveSystem(trainer, ServeEngine(cfg, trainer.state, slots=2,
                                               max_len=32, device=cuda),
                          quantum=1)

    kd.kd_stats_fwd.launches = kd.kd_grad_bwd.launches = 0
    sys_a = mk()
    done_a = sys_a.run(stream(), log=None)
    # rounds x kd_epochs x (18 core windows // batch 8) Phase-2 steps
    steps = flcfg.rounds * flcfg.kd_epochs * (len(core) // flcfg.batch_size)
    assert kd.kd_stats_fwd.launches == kd.kd_grad_bwd.launches == steps
    sys_b = mk()
    eng, tr = sys_b.engine, sys_b.trainer
    eng.begin(stream(), log=None)
    path = str(tmp_path / "live.npz")
    for _ in range(1000):
        if eng.pending():
            eng.tick()
        sys_b._train_quantum()
        st = tr._stepper
        if tr.mid_round and st is not None and st.i > 0 \
                and st._idx is not None:
            sys_b.save(path)
            break
    else:
        pytest.fail("no mid-epoch save point")
    sys_c = mk()
    reqs = stream()
    sys_c.restore(path, reqs)
    done_c = sys_c.run(reqs, log=None, resume=True)
    for x, y in zip(_tree_leaves(sys_c.trainer.state),
                    _tree_leaves(sys_a.trainer.state)):
        assert torch.equal(x, y)
    assert [h.as_dict() for h in sys_c.trainer.fl.history] == \
        [h.as_dict() for h in sys_a.trainer.fl.history]
    assert {r.rid: r.out for r in done_c} == {r.rid: r.out for r in done_a}
    assert sys_c.engine.ticks == sys_a.engine.ticks
    assert sys_c.swap_records == sys_a.swap_records


def _tree_leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_meshed_serving_on_card_launches_the_kernels_through_local_map(
        cuda, paged, monkeypatch):
    """Granite SMOKE in f32 served through ``simulate(mesh=...)`` on a
    one-rank NCCL mesh: the tokens of ``mesh=None``, every decode attention
    through the hand-written kernel, called by ``local_map`` on the local
    shards."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import simulate
    from repro_torch.sharding import local as sharding_local
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cuda")
    kw = dict(paged=True, page_size=8) if paged else {}
    kernel = paged_decode if paged else swa_decode
    stream = lambda: build_stream("poisson", 5, vocab=cfg.vocab_size,  # noqa: E731
                                  seed=4, prompt_max=14, out_max=6)
    engine = ServeEngine(cfg, params, slots=3, max_len=48, device="cuda",
                         **kw)
    want = engine.run(stream())
    calls = []
    run_local = sharding_local.run_local
    monkeypatch.setattr(sharding_local, "run_local", lambda fn, *a, **k: (
        calls.append(1), run_local(fn, *a, **k))[1])
    mesh = make_test_mesh(device="cuda")
    try:
        kernel.launches = 0
        got = simulate(cfg, params, stream(), 3, 48, mesh=mesh, log=None,
                       device="cuda", **kw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert kernel.launches == cfg.num_layers * engine.decode_ticks > 0
    assert len(calls) >= kernel.launches


# -- the flash attention pair --------------------------------------------------

from repro_torch.kernels import flash_attn as fa  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# (B, S, T, H, N, D, causal, window, q_offset): Granite-3-2B's Phase 2 and
# Qwen3-14B's prefill, then the other head dims of the port's attention
# archs (HuBERT 80 bidirectional, Nemotron 192, RecurrentGemma's local 256
# with a window), a prefix (the paged prefill: q_offset, T > S) with a
# window, and ragged S and T.
FLASH_CASES = [
    (4, 2048, 2048, 32, 8, 64, True, None, 0),
    (8, 2048, 2048, 40, 8, 128, True, None, 0),
    (2, 300, 300, 16, 16, 80, False, None, 0),
    (2, 256, 256, 24, 2, 192, True, None, 0),
    (2, 320, 320, 16, 1, 256, True, 100, 0),
    (2, 77, 333, 8, 2, 64, True, 150, 256),
    (3, 131, 131, 10, 2, 128, True, None, 0),
]


def _flash_case(case, dtype, device, seed=0):
    b, s, t, h, n, d = case[:6]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *sh: torch.randn(*sh, generator=gen,  # noqa: E731
                                   device=device).to(dtype)
    return (draw(b, s, h, d), draw(b, t, n, d), draw(b, t, n, d),
            draw(b, s, h, d), dict(causal=case[6], window=case[7],
                                   q_offset=case[8]))


def _grads(attend, q, k, v, w, kw):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attend(*leaves, **kw)
    (out.float() * w.float()).sum().backward()
    return [out.detach()] + [x.grad for x in leaves]


def _row_scale(want, floor):
    """Each row's (the last dim's) RMS in ``want``, floored at ``floor``
    times the whole tensor's RMS and at 1e-30."""
    want = want.float()
    rms = want.square().mean(-1).sqrt()
    return rms.clamp_min(floor * want.square().mean().sqrt()).clamp_min(1e-30)


def _row_err(got, want, floor):
    """Each row's largest error over that row's scale (``_row_scale``),
    flat."""
    return ((got.float() - want.float()).abs().amax(-1)
            / _row_scale(want, floor)).flatten()


def _quality(errs):
    """(99.9th percentile, largest) of the rows' errors."""
    return torch.quantile(errs, 0.999).item(), errs.max().item()


def _dq_of_output_delta(q, k, w, o, want, kw):
    """The f32 dq of the function the pair's backward differentiates
    (FlashAttention-2's): delta = rowsum(dO * O) taken from the bf16
    output ``o``, not from the f32 version's output O.  delta_i moves by
    dO_i . (o_i - O_i), so dq_i moves by that times -sum_j P_ij k_j /
    sqrt(D), sum_j P_ij k_j being the f32 attention with k as its values.
    In the first query rows, whose few terms nearly cancel, this is most
    of the row."""
    q32, k32 = q.float(), k.float()
    pk = ref.attend_full_ref(q32, k32, k32, **kw)
    dd = ((o.float() - want[0]) * w.float()).sum(-1, keepdim=True)
    return want[1] - dd * pk / q.shape[-1] ** 0.5


def _emulated(q, k, v, w, kw):
    """The pair's tiling in plain PyTorch (``ref.flash_fwd_tiled`` /
    ``flash_bwd_tiled``) with the plan's tiles, on the same inputs: the
    kernels' casts (P and dS rounded to the inputs' dtype), summed in
    another order."""
    p = fa.plan(q.shape[-1], q.dtype)
    o, lse = ref.flash_fwd_tiled(q, k, v, block_m=p.fwd.block_m,
                                 block_n=p.fwd.block_n, **kw)
    grads = ref.flash_bwd_tiled(w, q, k, v, o, lse, **kw,
                                dkdv_blocks=(p.dkdv.block_m, p.dkdv.block_n),
                                dq_blocks=(p.dq.block_m, p.dq.block_n))
    return [o, *grads], lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_pair_matches_plain(cuda, case, dtype):
    """Output and gradients against the plain version's, computed in f32
    from the same inputs.  f32: to float error (relative to the largest
    entry).  bf16, row by row: each row's largest error over its RMS
    (floored at 1% of the tensor's, for rows that are 0), its 99.9th
    percentile and its largest no larger than the plain version's in bf16
    (scores rounded to bf16), each against the exact f32 version of what
    it computes (for the pair's dq, ``_dq_of_output_delta``)."""
    q, k, v, w, kw = _flash_case(case, dtype, cuda)
    got = _grads(ops.flash_attention, q, k, v, w, kw)
    want = _grads(ref.attend_full_ref, *(x.float() for x in (q, k, v, w)),
                  kw)
    if dtype == torch.float32:
        errs = [_rel(a, e) for a, e in zip(got, want)]
        assert errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4, errs
        return
    plain = _grads(ref.attend_full_ref, q, k, v, w, kw)
    mine = list(want)
    mine[1] = _dq_of_output_delta(q, k, w, got[0], want, kw)
    for name, a, e, p, e0 in zip(("o", "dq", "dk", "dv"), got, mine, plain,
                                 want):
        kq = _quality(_row_err(a, e, 1e-2))
        pq = _quality(_row_err(p, e0, 1e-2))
        assert kq[0] <= pq[0] and kq[1] <= pq[1], (name, kq, pq)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bf16_pair_matches_its_emulation(cuda, case):
    """The bf16 kernels against their tiling emulated on the same bf16
    inputs, which rounds P and dS where the kernels do.  Each entry lies
    within one bf16 rounding of the emulation's (2^-7 of it) plus one
    rounding of a weight (2^-8) on its row's RMS, floored at the tensor's
    (a row of dq whose terms cancel is small beside them), but for at most
    1e-5 of the entries: there the f32 sums, run in another order (and
    with the hardware's exp2), tipped the rounding of a large weight of P
    or dS, and the entry still lies within 2^-4 of its row's scale.  The
    log-sum-exp to f32 error."""
    q, k, v, w, kw = _flash_case(case, torch.bfloat16, cuda)
    got = _grads(ops.flash_attention, q, k, v, w, kw)
    want, want_lse = _emulated(q, k, v, w, kw)
    for name, a, e in zip(("o", "dq", "dk", "dv"), got, want):
        a, e = a.float(), e.float()
        scale = _row_scale(e, 1.0)[..., None]
        err = (a - e).abs() - 2 ** -7 * e.abs()
        tipped = int((err > 2 ** -8 * scale).sum())
        assert tipped <= 1e-5 * e.numel(), (name, tipped, e.numel())
        assert (err <= 2 ** -4 * scale).all(), (
            name, _row_err(a, e, 1.0).max().item())
    _, lse = fa.flash_fwd(q, k, v, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128, 192, 256])
def test_flash_plan_matches_the_library(cuda, d, dtype):
    """The wrapper's plan is the tiles the built library runs."""
    assert fa.library_plan(d, dtype) == fa.plan(d, dtype)


def test_flash_gradient_repeats_bit_for_bit(cuda):
    """No float atomics: every sum is taken inside one program."""
    q, k, v, w, kw = _flash_case(FLASH_CASES[0], torch.bfloat16, cuda, 1)
    first = _grads(ops.flash_attention, q, k, v, w, kw)
    second = _grads(ops.flash_attention, q, k, v, w, kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_pair_replays_from_a_cuda_graph(cuda):
    q, k, v, w, kw = _flash_case(FLASH_CASES[5], torch.bfloat16, cuda, 2)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    fa.flash_bwd(w, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    graph, out = _capture(lambda: (fa.flash_fwd(q, k, v, **kw),
                                   fa.flash_bwd(w, q, k, v, o, lse, **kw)))
    q.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    (o2, lse2), grads = fa.flash_fwd(q, k, v, **kw), fa.flash_bwd(
        w, q, k, v, o, lse, **kw)
    assert torch.equal(out[0][0], o2) and torch.equal(out[0][1], lse2)
    assert all(torch.equal(a, b) for a, b in zip(out[1], grads))


def test_flash_attention_on_cuda_never_takes_the_plain_path(cuda,
                                                           monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain path taken on a CUDA tensor")

    monkeypatch.setattr(ref, "attend_full_ref", refuse)
    q, k, v, w, kw = _flash_case(FLASH_CASES[6], torch.bfloat16, cuda, 3)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    grads = _grads(ops.flash_attention, q, k, v, w, kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(g).all() for g in grads)


def test_flash_wrappers_check_inputs(cuda):
    q, k, v, w, kw = _flash_case(FLASH_CASES[6], torch.bfloat16, cuda, 4)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_fwd(q[:, :, :9], k, v)
    with pytest.raises(ValueError, match="keeps no key"):
        fa.flash_fwd(q, k[:, :40], v[:, :40], window=8, q_offset=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd(q[..., :60], k[..., :60], v[..., :60])
    o, lse = fa.flash_fwd(q, k, v)
    # an operand in another layout is copied, not refused
    k_t = k.transpose(1, 3).contiguous().transpose(1, 3)
    o_t, lse_t = fa.flash_fwd(q, k_t, v)
    assert torch.equal(o_t, o) and torch.equal(lse_t, lse)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_bwd(w[:, :5], q, k, v, o, lse)


def test_attention_layers_launch_the_pair(cuda):
    """A SMOKE Granite step's forward, backward (block remat) and a
    prefill: one forward launch a layer a forward (the remat recompute
    included), one backward launch a layer, none in the prefill."""
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cuda")
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    logits, _ = Transformer.apply(cfg, params, {"tokens": tokens})
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    layers = cfg.num_layers
    remat = 2 if cfg.remat == "block" else 1
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (
        remat * layers, layers)
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    with torch.inference_mode():
        Transformer.prefill(cfg, params, {"tokens": tokens}, 80)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (layers, 0)
