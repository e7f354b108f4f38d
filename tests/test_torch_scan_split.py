"""The recurrent-scan kernels' designs, emulated on the CPU.

``csrc/ssd.cu`` and ``csrc/rglru.cu`` run only on the card; here their
arithmetic and index ranges run in numpy and are held against the JAX
kernels in interpret mode and the JAX references.  What the emulation
mirrors, line for line:

- ``ssd_chunk_kernel`` (``csrc/ssd.cu:332-577``, q >= 2): p tiles of 32 (p
  <= 32) or 64 columns; the chunk walk with H carried in f32; warp 0's scan
  in f64 (four rows a lane, then a Hillis-Steele scan over 32 lanes);
  strips of 16 rows, one a warp; y_off = C_strip H^T over k steps of 8,
  scaled by exp(csum_i) after the product; score tiles j < 16 (w + 1) for
  strip w, masked by a select (j <= i) before exp is formed and decayed
  (differences of the f64 csum rounded to f32 for exp), then y_diag tile by
  tile; the state update H = exp(total) H + (x dt exp(total - csum))^T B
  over k steps of 8; every product in 3xTF32 (hi rounded to TF32, lo = x -
  hi truncated to TF32 by the MMA; al bh + ah bl + ah bh into f32 sums, one
  rounding an MMA).
- ``ssd_row_kernel`` (``csrc/ssd.cu:582-704``, q == 1): lane l owns columns
  l + 32 i of n (KI = n rounded up to 32, 64, 128, 256, over 32), warp w
  rows 8w..8w+7 of its p tile of 64; C.B reduced by a butterfly; C.H_{t-1}
  by the reduce-scatter (xor 16, 8, 4, then 2 and 1), after which the lanes
  with lane % 4 == 0 hold row 8w + 4 b4 + 2 b3 + b2 (b4, b3, b2 the lane's
  bits 4, 3, 2); y_t = (C.B) xb + exp(dA) (C.H); H = fma(H, exp(dA), xb B).
- ``rglru_kernel`` (``csrc/rglru.cu:60-109``): slabs of 32 channels, tiles
  of 32 steps through a ring of four stages filled three tiles ahead, the
  carry an FMA chain.

If the kernels' tiling, lane maps or split change, change the emulation
with them (``.claude/skills/verify/SKILL.md`` says so too).  The kernels
themselves are held against the plain versions on the card in
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
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402

# tests/test_torch_ssd.py's tolerance for the port's scan against JAX.
TOL_SCAN = 1e-4
# The RG-LRU scans: the same FMA chain against the JAX kernel's mul + add.
TOL_RGLRU = 1e-5
F32 = np.float32

_jref = jax.jit(jssm.ssd_reference, static_argnums=(5,))
_jkernel = jax.jit(lambda x, dt, A, B, C, chunk: jops.ssd(
    x, dt, A, B, C, chunk, use_pallas=True, interpret=True),
    static_argnums=(5,))
_jrglru = jax.jit(lambda a, b: jops.rglru(a, b, use_pallas=True,
                                          interpret=True))


# -- 3xTF32 ------------------------------------------------------------------


def tf32(v):
    """Round to TF32's 10 mantissa bits, ties away from zero (the kernel's
    integer rounding: half a TF32 ulp added, 13 low bits cleared)."""
    u = np.asarray(v, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def truncate(v):
    """A TF32 operand as the tensor cores read it: its 13 low bits dropped."""
    u = np.asarray(v, F32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(F32)


def split(v):
    """The kernel's split: hi rounded to TF32, lo = v - hi as the MMA reads
    it (truncated)."""
    hi = tf32(v)
    return hi, truncate(v - hi)


def mma3(d, a, b):
    """d += a @ b as the kernel's mma3: al bh, ah bl, ah bh, each one MMA
    rounded once into the f32 sums.  a (..., M, 8), b (..., 8, N)."""
    ah, al = split(a)
    bh, bl = split(b)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        d = (d.astype(np.float64) + np.matmul(x.astype(np.float64),
                                              y.astype(np.float64))).astype(F32)
    return d


def _up(a, m):
    return -(-a // m) * m


# -- the chunk kernel --------------------------------------------------------


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _scan(dts, a_h, q):
    """Warp 0's scan of the f32 dA in f64: csum (f64), exp(csum) and
    dt exp(total - csum) (f32, each exponent rounded to f32 first) and total
    (f64) over qp rows (rows past q: dA = 0, weight 0).  dts (..., qp)."""
    qp = dts.shape[-1]
    j = np.arange(128)
    d = np.zeros(dts.shape[:-1] + (128,), F32)
    d[..., :qp] = dts * a_h[..., None]
    d[..., q:] = 0
    local = np.cumsum(d.reshape(d.shape[:-1] + (32, 4)).astype(np.float64),
                      axis=-1)
    run = local[..., 3]
    incl = run.copy()
    for off in (1, 2, 4, 8, 16):
        nxt = incl.copy()
        nxt[..., off:] = incl[..., off:] + incl[..., :-off]
        incl = nxt
    total = incl[..., 31]
    cs = ((incl - run)[..., None] + local).reshape(d.shape)[..., :qp]
    ecs = np.exp(cs.astype(F32))
    w = np.where(j[:qp] < q, dts * np.exp((total[..., None] - cs).astype(F32)),
                 0).astype(F32)
    return cs, ecs, w, total


def emulate_chunk_kernel(x, dt, A, B, C, q):
    """``ssd_chunk_kernel`` in numpy, every (batch, head) at once."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pt = 32 if p <= 32 else 64
    npad, qp = _up(n, 8), _up(q, 16)
    jsteps = -(-q // 8)
    Bh = np.repeat(B, hg, axis=2).transpose(0, 2, 1, 3)  # (b, h, s, n)
    Ch = np.repeat(C, hg, axis=2).transpose(0, 2, 1, 3)
    xh = x.transpose(0, 2, 1, 3)                         # (b, h, s, p)
    dth = dt.transpose(0, 2, 1)                          # (b, h, s)
    a_h = np.broadcast_to(A[None, :], (b, h))
    y = np.zeros((b, h, s, p), F32)
    state = np.zeros((b, h, p, n), F32)
    for p0 in range(0, p, pt):
        cols = min(pt, p - p0)
        H = np.zeros((b, h, pt, npad), F32)  # hacc, and Hs after a chunk
        for c in range(s // q):
            t0 = c * q
            Bs = np.zeros((b, h, qp, npad), F32)
            Cs = np.zeros((b, h, qp, npad), F32)
            Xs = np.zeros((b, h, qp, pt), F32)
            dts = np.zeros((b, h, qp), F32)
            Bs[..., :q, :n] = Bh[:, :, t0:t0 + q]
            Cs[..., :q, :n] = Ch[:, :, t0:t0 + q]
            Xs[..., :q, :cols] = xh[:, :, t0:t0 + q, p0:p0 + cols]
            dts[..., :q] = dth[:, :, t0:t0 + q]
            cs, ecs, wts, total = _scan(dts, a_h, q)
            for w in range(qp // 16):                     # strips
                i0 = 16 * w
                cstrip = Cs[..., i0:i0 + 16, :]
                acc = np.zeros((b, h, 16, pt), F32)
                for ks in range(npad // 8):               # y_off
                    k = slice(8 * ks, 8 * ks + 8)
                    acc = mma3(acc, cstrip[..., k],
                               H[..., k].swapaxes(-1, -2))
                acc = (acc * ecs[..., i0:i0 + 16, None]).astype(F32)
                jt_end = 2 * w + 2                        # rows < qp
                jw = 8 * jt_end
                sc = np.zeros((b, h, 16, jw), F32)
                for ks in range(npad // 8):               # scores
                    k = slice(8 * ks, 8 * ks + 8)
                    sc = mma3(sc, cstrip[..., k],
                              Bs[..., :jw, k].swapaxes(-1, -2))
                i = i0 + np.arange(16)[:, None]
                j = np.arange(jw)[None, :]
                causal = j <= i
                expo = np.where(causal, cs[..., i0:i0 + 16, None]  # f64
                                - cs[..., None, :jw], 0).astype(F32)
                m = np.where(causal, sc * np.exp(expo) * dts[..., None, :jw],
                             0).astype(F32)
                for jt in range(jt_end):                  # y_diag
                    jj = slice(8 * jt, 8 * jt + 8)
                    acc = mma3(acc, m[..., jj], Xs[..., jj, :])
                rows = min(16, q - i0)
                y[:, :, t0 + i0:t0 + i0 + rows, p0:p0 + cols] = \
                    acc[..., :rows, :cols]
            H = (H * np.exp(total.astype(F32))[..., None, None]).astype(F32)
            for ks in range(jsteps):                      # state update
                jj = slice(8 * ks, 8 * ks + 8)
                a_op = (Xs[..., jj, :] * wts[..., jj, None]).astype(F32)
                H = mma3(H, a_op.swapaxes(-1, -2), Bs[..., jj, :])
        state[:, :, p0:p0 + cols] = H[..., :cols, :n]
    return y.transpose(0, 2, 1, 3), state


# -- the row kernel (q == 1) -------------------------------------------------


def emulate_row_kernel(x, dt, A, B, C):
    """``ssd_row_kernel`` in numpy: lanes, warps and the reduce-scatter."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    ki = 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else 8
    nk = 32 * ki
    pp = _up(p, 64)                                      # p tiles of 64
    lanes = np.arange(32)
    b4, b3, b2 = (lanes >> 4) & 1, (lanes >> 3) & 1, (lanes >> 2) & 1
    esel = 4 * b4 + 2 * b3 + b2
    # h[e, lane, i] = H[e, lane + 32 i]; e = 8 warp + m
    hreg = np.zeros((b, h, pp, 32, ki), F32)
    y = np.zeros((b, s, h, p), F32)
    for t in range(s):
        dtv = dt[:, t].astype(F32)                        # (b, h)
        decay = np.exp((dtv * A[None, :]).astype(F32))
        bk = np.zeros((b, h, nk), F32)
        ck = np.zeros((b, h, nk), F32)
        bk[..., :n] = np.repeat(B[:, t], hg, axis=1)
        ck[..., :n] = np.repeat(C[:, t], hg, axis=1)
        bk = bk.reshape(b, h, ki, 32).swapaxes(-1, -2)   # [lane, i]
        ck = ck.reshape(b, h, ki, 32).swapaxes(-1, -2)
        cb = np.zeros((b, h, 32), F32)
        for i in range(ki):
            cb = _fma(ck[..., i], bk[..., i], cb)
        for off in (16, 8, 4, 2, 1):
            cb = (cb + cb[..., lanes ^ off]).astype(F32)
        part = np.zeros((b, h, pp, 32), F32)
        for i in range(ki):
            part = _fma(ck[..., None, :, i], hreg[..., i], part)
        part = part.reshape(b, h, pp // 8, 8, 32)         # [warp, m, lane]
        r4 = [part[..., i + 4 * b4, lanes] + part[..., i + 4 * b4, lanes ^ 16]
              for i in range(4)]
        r4 = np.stack(r4, axis=-2).astype(F32)            # [warp, i, lane]
        r2 = [r4[..., i + 2 * b3, lanes] + r4[..., i + 2 * b3, lanes ^ 8]
              for i in range(2)]
        r2 = np.stack(r2, axis=-2).astype(F32)
        ch = (r2[..., b2, lanes] + r2[..., b2, lanes ^ 4]).astype(F32)
        ch = (ch + ch[..., lanes ^ 2]).astype(F32)
        ch = (ch + ch[..., lanes ^ 1]).astype(F32)        # [warp, lane]
        xp = np.zeros((b, h, pp), F32)
        xp[..., :p] = x[:, t]
        xb = (xp * dtv[..., None]).astype(F32)
        for lane in range(0, 32, 4):                      # the writers
            e = np.arange(pp // 8) * 8 + esel[lane]
            val = (cb[..., lane, None] * xb[..., e]
                   + decay[..., None] * ch[..., lane]).astype(F32)
            keep = e < p
            y[:, t][..., e[keep]] = val[..., keep]
        hreg = _fma(hreg, decay[..., None, None, None],
                    (xb[..., None, None] * bk[..., None, :, :]).astype(F32))
    hfull = hreg.swapaxes(-1, -2).reshape(b, h, pp, nk)
    return y, hfull[:, :, :p, :n]


# -- the tests ---------------------------------------------------------------


def _scan_inputs(seed, b, s, h, p, n, g):
    """The JAX kernel test's distributions, drawn with numpy (as in
    tests/test_torch_ssd.py)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(F32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(F32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(F32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(F32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(F32)
    return x, dt, A, B, C


# tests/test_torch_ssd.py's shapes and Mamba-2's heads at a prime length.
SSD_SHAPES = [
    (2, 256, 4, 32, 16, 1, 64),
    (1, 128, 2, 64, 32, 1, 128),
    (2, 192, 8, 16, 8, 1, 64),
    (2, 96, 4, 16, 8, 2, 32),
    (1, 37, 2, 8, 4, 1, 32),
    (1, 131, 2, 8, 4, 1, 128),
    (1, 150, 2, 8, 4, 1, 128),
    (2, 151, 4, 16, 32, 1, 128),
]


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SSD_SHAPES, ids=str)
def test_ssd_emulation_matches_jax(b, s, h, p, n, g, chunk):
    args = _scan_inputs(s + h, b, s, h, p, n, g)
    q = ssd_mod.chunk_size(chunk, s)
    if q == 1:  # csrc/ssd.cu launches the row kernel at chunk 1
        y, state = emulate_row_kernel(*args)
    else:
        y, state = emulate_chunk_kernel(*args, q)
    jargs = [jnp.asarray(a) for a in args]
    for want in (_jref(*jargs, q), _jkernel(*jargs, chunk)):
        for got, ref in zip((y, state), want):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL_SCAN,
                                       atol=TOL_SCAN)


@pytest.mark.parametrize("shape", [(1, 40, 2, 24, 12, 1, 20),
                                   (1, 40, 1, 72, 12, 1, 20)], ids=str)
def test_ssd_chunk_emulation_takes_ragged_tiles(shape):
    """p = 24 and 72 (one and two ragged p tiles), n = 12 (a ragged k
    step), q = 20 (a ragged strip and k step of the chunk's rows)."""
    b, s, h, p, n, g, q = shape
    args = _scan_inputs(7, b, s, h, p, n, g)
    y, state = emulate_chunk_kernel(*args, q)
    want = _jref(*(jnp.asarray(a) for a in args), q)
    for got, ref in zip((y, state), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL_SCAN,
                                   atol=TOL_SCAN)


def test_tf32_split_keeps_f32_accuracy():
    """hi + lo reproduces an f32 operand to ~2^-21, and a 3xTF32 dot of 128
    terms is within 1e-6 relative of f64, where one TF32 product is not."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(4096).astype(F32)
    hi, lo = split(v)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    assert np.max(np.abs(hi.astype(np.float64) + lo - v) / np.abs(v)) < 2 ** -20
    a = rng.standard_normal((16, 128)).astype(F32)
    bm = rng.standard_normal((128, 8)).astype(F32)
    exact = a.astype(np.float64) @ bm
    d = np.zeros((16, 8), F32)
    for ks in range(16):
        k = slice(8 * ks, 8 * ks + 8)
        d = mma3(d, a[:, k], bm[k])
    scale = np.abs(a).astype(np.float64) @ np.abs(bm)
    assert np.max(np.abs(d - exact) / scale) < 1e-6
    one = tf32(a).astype(np.float64) @ tf32(bm)
    assert np.max(np.abs(one - exact) / scale) > 1e-4


# -- rglru -------------------------------------------------------------------

LANES, STEPS, STAGES = 32, 32, 4


def emulate_rglru_kernel(a, b):
    """``rglru_kernel`` in numpy: slabs of 32 channels (lanes past D idle),
    tiles of 32 steps copied into a ring of four stages three tiles ahead of
    the carry, which reads its tile back from the ring."""
    bsz, s, d = a.shape
    slabs = -(-d // LANES)
    dp = slabs * LANES
    ap = np.zeros((bsz, s, dp), F32)
    bp = np.zeros((bsz, s, dp), F32)
    ap[..., :d], bp[..., :d] = a, b
    ring = np.full((STAGES, 2, STEPS, bsz, dp), np.nan, F32)
    ntiles = -(-s // STEPS)
    h = np.zeros((bsz, s, dp), F32)

    def issue(tile):
        if tile < ntiles:
            t0 = tile * STEPS
            rows = min(STEPS, s - t0)
            ring[tile % STAGES, 0, :rows] = ap[:, t0:t0 + rows].swapaxes(0, 1)
            ring[tile % STAGES, 1, :rows] = bp[:, t0:t0 + rows].swapaxes(0, 1)

    for tile in range(STAGES - 1):
        issue(tile)
    carry = np.zeros((bsz, dp), F32)
    for tile in range(ntiles):
        issue(tile + STAGES - 1)
        st, t0 = tile % STAGES, tile * STEPS
        for r in range(min(STEPS, s - t0)):
            carry = _fma(ring[st, 0, r], carry, ring[st, 1, r])
            h[:, t0 + r] = carry
    return h[..., :d]


@pytest.mark.parametrize("shape", [(2, 128, 130), (1, 384, 128), (3, 17, 5),
                                   (2, 100, 64), (1, 224, 96)], ids=str)
def test_rglru_emulation_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(F32)
    b = rng.standard_normal(shape).astype(F32)
    got = emulate_rglru_kernel(a, b)
    assert np.isfinite(got).all()   # every step read a filled ring slot
    want = np.asarray(_jrglru(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=TOL_RGLRU, atol=TOL_RGLRU)
