"""The split plan of the port's decode-attention kernels, on the CPU.

``swa_decode`` and ``paged_decode`` cut the rows one (row, KV head) attends
into S runs of R rows (split-K), score each run in its own block and merge
the partials as a log-sum-exp.  The plan (S, R) comes from the shapes
alone, never from ``pos``.  Here: every attended row falls in exactly one
run, for any position; the shared memory a plan asks for fits the H100;
a plain-PyTorch emulation of split-then-merge over the plan (the kernels'
row ranges, masks, empty and all-masked partials) equals the port's plain
versions and the JAX kernels in interpret mode; and the plain paged version
takes a table far past the old kernel's 48 KiB cap.  The CUDA kernels
themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import inspect
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.swa_decode import paged_decode as jax_paged_decode  # noqa: E402
from repro.kernels.swa_decode import swa_decode as jax_swa_decode  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_decode as pd_mod  # noqa: E402
from repro_torch.kernels import swa_decode as swa_mod  # noqa: E402

# The emulation sums in another order than the plain version: ~1e-7 apart
# on unit-scale f32 inputs.
ATOL = 1e-6
NEG = -1e30

_jswa = jax.jit(jax_swa_decode,
                static_argnames=("window", "ring", "tile", "interpret"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the kernels' row ranges, in Python --------------------------------------


def dense_rows(pos, w, window, ring):
    """(slots, valid) a dense row visits, in order (csrc/swa_decode.cu): its
    valid absolute positions lo..hi as slots (a mod W for a ring), or, when
    none is valid, every slot, all masked."""
    lo = max(pos - w + 1, 0) if ring else 0
    hi = pos if ring else min(pos, w - 1)
    if window is not None:
        lo = max(lo, pos - window + 1)
    if hi - lo + 1 <= 0:
        return list(range(w)), False
    return [(a % w if ring else a) for a in range(lo, hi + 1)], True


def paged_rows(pos, ps, pp, window):
    """(absolute positions, valid flags) a paged slot visits
    (csrc/paged_decode.cu): from the first page holding a valid position
    to pos."""
    lo = max(pos - window + 1, 0) if window is not None else 0
    first = lo // ps * ps
    hi = min(pos, pp * ps - 1)
    rows = list(range(first, hi + 1)) if pos >= 0 else []
    return rows, [lo <= a <= pos for a in rows]


def _partial(q, k, v, valid, scale):
    """One run's (m, l, acc) as a split block forms it: f32 scores, masked
    to -1e30, the running max started at -1e30."""
    g, d = q.shape
    if k.shape[0] == 0:
        return (torch.full((g,), NEG), torch.zeros(g), torch.zeros(g, d))
    s = (q @ k.T) * scale
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG))
    m = torch.clamp(s.max(dim=1).values, min=NEG)
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=1), p @ v


def _merge(parts):
    m = torch.stack([p[0] for p in parts])            # (S, G)
    big = m.max(dim=0).values
    w = torch.exp(m - big)
    l = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
    acc = (w[:, :, None] * torch.stack([p[2] for p in parts])).sum(dim=0)
    return acc / torch.clamp(l, min=1e-30)[:, None]


def emulate_swa(q, kc, vc, pos, window, ring, splits, rows):
    """Split-then-merge over a plan, in plain PyTorch, f32."""
    b, n, g, d = q.shape
    w = kc.shape[1]
    out = torch.empty(b, n, g, d)
    for i in range(b):
        slots, ok = dense_rows(int(pos[i]), w, window, ring)
        assert len(slots) <= splits * rows
        for h in range(n):
            parts = []
            for s in range(splits):
                run = slots[s * rows:(s + 1) * rows]
                valid = torch.full((len(run),), ok)
                parts.append(_partial(q[i, h], kc[i, run, h], vc[i, run, h],
                                      valid, d ** -0.5))
            out[i, h] = _merge(parts)
    return out


def emulate_paged(q, kp, vp, pt, pos, window, splits, rows):
    b, n, g, d = q.shape
    ps, pp = kp.shape[1], pt.shape[1]
    out = torch.empty(b, n, g, d)
    for i in range(b):
        apos, ok = paged_rows(int(pos[i]), ps, pp, window)
        assert len(apos) <= splits * rows
        pages = [min(max(int(pt[i, a // ps]), 0), kp.shape[0] - 1)
                 for a in apos]
        for h in range(n):
            parts = []
            for s in range(splits):
                sl = slice(s * rows, (s + 1) * rows)
                pg = torch.tensor(pages[sl], dtype=torch.long)
                off = torch.tensor([a % ps for a in apos[sl]],
                                   dtype=torch.long)
                parts.append(_partial(q[i, h], kp[pg, off, h], vp[pg, off, h],
                                      torch.tensor(ok[sl], dtype=torch.bool),
                                      d ** -0.5))
            out[i, h] = _merge(parts)
    return out


# -- the plans ----------------------------------------------------------------


def test_plans_take_no_position():
    for fn in (swa_mod.plan, pd_mod.plan, swa_mod.split_plan):
        assert "pos" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("w", [1, 37, 65, 300, 512, 8192])
@pytest.mark.parametrize("window,ring", [(None, False), (None, True),
                                         (7, False), (7, True),
                                         (128, True), (5000, False)])
@pytest.mark.parametrize("b,n,d", [(1, 8, 64), (4, 8, 64), (4, 1, 256)])
def test_dense_plan_covers_every_row_once(w, window, ring, b, n, d):
    """Runs [s R, (s+1) R) of the visited rows cover each row once, for
    positions before the cache fills, at its end, far past it (a ring
    wrapped many times), at -1 (no valid slot) and at random."""
    p = swa_mod.plan(b, n, d, w, torch.bfloat16)
    assert p.rows % p.chunk == 0 and p.blocks == b * n * p.splits
    assert (p.splits - 1) * p.rows < w <= p.splits * p.rows
    rng = np.random.default_rng(w)
    for pos in [-1, 0, 1, w // 2, w - 1, w, 3 * w + 5, 524_287,
                *rng.integers(0, 4 * w + 10, size=20)]:
        slots, _ = dense_rows(int(pos), w, window, ring)
        runs = [slots[s * p.rows:(s + 1) * p.rows] for s in range(p.splits)]
        assert sum(runs, []) == slots
        assert len(slots) == len(set(slots))  # no slot twice


@pytest.mark.parametrize("pp", [1, 5, 32, 9_888, 12_000, 32_768])
@pytest.mark.parametrize("ps", [1, 12, 16, 64])
@pytest.mark.parametrize("window", [None, 100, 8192])
def test_paged_plan_covers_every_row_once(pp, ps, window):
    p = pd_mod.plan(1, 8, 64, ps, pp, window, torch.bfloat16)
    assert p.rows % ps == 0 and p.rows >= p.chunk
    rng = np.random.default_rng(pp + ps)
    for pos in [0, ps - 1, ps, pp * ps - 1, *rng.integers(0, pp * ps, 20)]:
        pos = min(int(pos), pp * ps - 1)  # a slot's table holds its pos
        apos, ok = paged_rows(int(pos), ps, pp, window)
        assert len(apos) <= p.splits * p.rows
        assert apos == list(range(apos[0], apos[0] + len(apos)))
        assert apos[0] % ps == 0           # runs start on a page
        assert ok[-1] and sum(ok) == min(int(pos) + 1, window or pp * ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(32, 257, 32))
def test_plan_shared_memory_fits_the_card(dtype, d):
    """Every head dim the kernels take asks for no more than an H100 block
    may have; bf16 stays under the 48 KiB that needs no opt-in up to
    D = 64 (the Granite serving shape)."""
    p = swa_mod.plan(4, 8, d, 512, dtype)
    assert p.smem <= swa_mod.SMEM_LIMIT
    assert p.smem == pd_mod.plan(4, 8, d, 16, 32, None, dtype).smem
    if dtype == torch.bfloat16 and d <= 64:
        assert p.smem <= 48 * 1024


def test_plans_at_the_measured_shapes():
    """The block counts PERF.md quotes."""
    bf16 = torch.bfloat16
    assert swa_mod.plan(4, 8, 64, 512, bf16)[:4] == (8, 64, 64, 256)
    assert swa_mod.plan(1, 8, 64, 8192, bf16)[:4] == (32, 256, 64, 256)
    assert swa_mod.plan(4, 1, 256, 512, bf16)[:4] == (16, 32, 32, 64)
    assert swa_mod.plan(4, 8, 64, 32, bf16)[:4] == (1, 64, 64, 32)
    assert pd_mod.plan(4, 8, 64, 16, 32, None, bf16)[:4] == (8, 64, 64, 256)
    assert pd_mod.plan(1, 8, 64, 16, 32_768, 8192, bf16)[:4] == (
        33, 256, 64, 264)


# -- split-then-merge against the plain versions and the JAX kernels --------


def _dense_case(seed, b, w, n=2, g=3, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, g, d), (b, w, n, d), (b, w, n, d))]


# (W, pos, window, ring, forced R or None for the wrapper's plan): ring
# wraps, a window cutting a run, rows with no valid slot (all-masked: the
# mean of V), runs past a row's end (empty partials), W not a multiple of
# R, and the plan's own runs.
DENSE = [
    (40, [0, 17, 39], None, False, 8),
    (40, [5, 30, 39], 13, False, 8),
    (16, [100, 47, 16], None, True, 4),
    (16, [3, 15, 0], None, True, 5),
    (16, [100, 47, 16], 6, True, 4),
    (300, [299, 123, 0], None, False, None),
    (300, [1000, 301, 77], 120, True, None),
    (300, [1000, 301, 77], 120, True, 32),
    (16, [-1, 5, 200], None, False, 3),
    (16, [-1, 5, 200], 3, True, 3),
]


@pytest.mark.parametrize("w,pos,window,ring,rows", DENSE)
def test_dense_split_merge_matches_plain_and_jax(w, pos, window, ring, rows):
    q, kc, vc = _dense_case(w + len(pos), 3, w)
    pos_np = np.asarray(pos, np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc)]
    if rows is None:
        p = swa_mod.plan(3, 2, 32, w, torch.float32)
        splits, rows = p.splits, p.rows
    else:
        splits = -(-w // rows)
    got = emulate_swa(*t, pos_np, window, ring, splits, rows)
    want = ref.swa_decode_ref(*t, torch.from_numpy(pos_np), window=window,
                              ring=ring)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    jwant = _jswa(*(jnp.asarray(a) for a in (q, kc, vc)), jnp.asarray(pos_np),
                  window=window, ring=ring, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                               atol=ATOL)


def test_all_masked_partials_merge_to_the_mean_of_v():
    """A row with no valid slot, split into runs of 3 over W = 16 (the last
    run short): its partials carry l = their row count and the merge gives
    the mean of V over all 16 slots."""
    q, kc, vc = (torch.from_numpy(a) for a in _dense_case(9, 1, 16))
    got = emulate_swa(q, kc, vc, [-1], None, False, 6, 3)
    mean_v = vc[0].mean(dim=0)[:, None, :].expand(2, 3, 32)
    np.testing.assert_allclose(got[0].numpy(), mean_v.numpy(), rtol=0,
                               atol=ATOL)


def _paged_case(seed, *, b=3, n=2, g=4, d=32, ps=8, pp=6):
    rng = np.random.default_rng(seed)
    num_pages = b * pp + 1
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, n, g, d), (num_pages, ps, n, d),
                        (num_pages, ps, n, d))]
    pt = rng.integers(0, num_pages, size=(b, pp)).astype(np.int32)
    pt[1, :2] = pt[0, :2]  # a shared prefix
    return arrays + [pt]


# (pos, window, forced R or None): runs past the slot's end, a window
# starting mid-page and cutting a run, the plan's own runs.
PAGED = [
    ([20, 47, 0], None, 8),
    ([20, 47, 0], None, None),
    ([20, 47, 3], 5, 8),
    ([44, 47, 30], 13, 16),
    ([44, 47, 30], 13, None),
]


@pytest.mark.parametrize("pos,window,rows", PAGED)
def test_paged_split_merge_matches_plain_and_jax(pos, window, rows):
    q, kp, vp, pt = _paged_case(len(pos) + (window or 0) + (rows or 0))
    pos_np = np.asarray(pos, np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt)]
    ps, pp = kp.shape[1], pt.shape[1]
    if rows is None:
        p = pd_mod.plan(3, 2, 32, ps, pp, window, torch.float32)
        splits, rows = p.splits, p.rows
    else:
        span = pp * ps if window is None else min(pp * ps, window + ps - 1)
        splits = -(-span // rows)
    got = emulate_paged(*t, pos_np, window, splits, rows)
    want = ref.paged_decode_ref(*t, torch.from_numpy(pos_np), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    jwant = jax_paged_decode(*(jnp.asarray(a) for a in (q, kp, vp, pt)),
                             jnp.asarray(pos_np), window=window,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("window", [None, 512])
def test_plain_paged_takes_a_table_past_the_old_cap(window):
    """A 12,000-page table (the old kernel's 48 KiB held at most 9,888 at
    Granite's shape) cycling over a 40-page pool: the port's plain version
    equals the JAX package's pure path at the slot's last position."""
    rng = np.random.default_rng(12)
    pp, ps, pool = 12_000, 4, 40
    q = rng.standard_normal((1, 1, 2, 32)).astype(np.float32)
    kp, vp = (rng.standard_normal((pool, ps, 1, 32)).astype(np.float32)
              for _ in range(2))
    pt = (np.arange(pp, dtype=np.int32) % (pool - 1) + 1)[None, :]
    pos = np.array([pp * ps - 2], np.int32)
    got = ref.paged_decode_ref(*(torch.from_numpy(a)
                                 for a in (q, kp, vp, pt, pos)),
                               window=window)
    want = jops.paged_decode_attn(*(jnp.asarray(a)
                                    for a in (q, kp, vp, pt, pos)),
                                  window=window, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- the build tag ------------------------------------------------------------


def test_build_tag_covers_the_shared_header(tmp_path):
    """An edited header rebuilds the kernels that include it: the tag in
    the library's name hashes every header under csrc/ with the source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {n: build.source_tag(n, csrc) for n in ("swa_decode",
                                                     "paged_decode")}
    assert before["swa_decode"] == build.source_tag("swa_decode")
    header = csrc / "decode_attn.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    for name, tag in before.items():
        assert build.source_tag(name, csrc) != tag
    (csrc / "swa_decode.cu").write_bytes(b"// another source\n")
    assert build.source_tag("swa_decode", csrc) != before["swa_decode"]
