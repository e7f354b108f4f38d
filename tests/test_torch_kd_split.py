"""The forward KD-stats kernels' design, emulated on the CPU.

``csrc/kd_loss.cu``'s forward kernels run only on the card; here their
partition and arithmetic run in torch f32 and are held against the JAX
kernels ``kd_stats_fwd`` and ``kd_quant_stats_fwd`` in interpret mode and
against the port's plain versions.  What the emulation mirrors:

- ``push_tile``: a tile's maxes first (s and b raw, t/tau), one rescale of
  the running sums (none on a fresh state), then exp(s - m_s),
  exp(fma(s, 1/tau, -m_s/tau)), exp(t/tau - m_t) and exp(fma(b, 1/tau,
  -m_b)) added in slot order, slots past the row selected to 0; the
  numerators weighted by t/tau, raw s and raw b, scaled by 1/tau once in
  ``write_stats``.  The quant teacher is fma(code, scale/tau, zero/tau).
- ``warp_merge``: the maxes over the whole warp (one ``redux.sync``; lanes
  outside a merge's groups hold the initial state), one rescale, the sums by
  xor shuffles (16, 8, 4, 2, 1 over a warp; 4, 2, 1 over the block's eight
  warps).
- the warp path: lane l holds columns c0 + l + 32 k (k < plan.tile) each
  pass; s[y] from lane y % 32 on a single pass.
- the block path: warp w streams chunks w, w + 8, ... of ``CHUNK`` columns,
  lane l holding columns l + 32 j (j < plan.tile) of each; each tensor's
  chunk is staged as ``Span::stage`` copies it: the 16-byte words of its
  aligned span, the word crossing the tensor's end zero-filled past it, the
  word crossing its start copied byte by byte; column c at the span's skew +
  c * itemsize.  The emulated copy asserts that no byte outside the tensor
  is read; stage bytes no copy wrote hold NaN.

If the kernels' partition, merge order or staging change, change this file
with them.  The kernels themselves are held against the plain versions on
the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kd_loss as jkd  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_torch_kd_loss.py's tolerance: f32 sums and exponentials in
# another order, relative to the largest reference value (at least 1).
TOL = 1e-5
NEG = -1e30
F32 = torch.float32
WARPS = kd.BLOCK_WARPS
ROWS = 6  # not a multiple of the warp path's four rows a block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the kernels' arithmetic -------------------------------------------------


def fma(x, y, z):
    """f32 fma: the product is exact in f64, one rounding to f32 after."""
    return (x.double() * y + z.double()).float()


def f32(v):
    return torch.tensor(v, dtype=F32)


def fresh(shape):
    """RowState::init for every thread of ``shape``."""
    st = {k: torch.full(shape, NEG) for k in ("ms", "mt", "mb")}
    st.update({k: torch.zeros(shape) for k in
               ("ds", "dst", "dt", "nt0", "nt1", "db", "nb0", "nb1")})
    return st


def push_tile(a, xs, tt, xb, ok, inv_tau, buffer, is_fresh=False):
    """push_tile over the last axis (the tile's slots); a's tensors have the
    other axes.  Returns the new state."""
    k_slots = xs.shape[-1]
    ms, mt, mb = a["ms"], a["mt"], torch.full_like(a["mb"], NEG)
    for k in range(k_slots):
        o = ok[..., k]
        ms = torch.where(o, torch.maximum(ms, xs[..., k]), ms)
        mt = torch.where(o, torch.maximum(mt, tt[..., k]), mt)
        if buffer:
            mb = torch.where(o, torch.maximum(mb, xb[..., k]), mb)
    mb = torch.maximum(a["mb"], mb * inv_tau)
    mst = ms * inv_tau
    sums = {k: torch.zeros_like(ms) for k in
            ("es", "est", "et", "et0", "et1", "eb", "eb0", "eb1")}
    for k in range(k_slots):
        o = ok[..., k]
        zero = torch.zeros_like(ms)
        u_s = torch.where(o, torch.exp(xs[..., k] - ms), zero)
        u_st = torch.where(o, torch.exp(fma(xs[..., k], inv_tau, -mst)), zero)
        u_t = torch.where(o, torch.exp(tt[..., k] - mt), zero)
        sums["es"] = sums["es"] + u_s
        sums["est"] = sums["est"] + u_st
        sums["et"] = sums["et"] + u_t
        sums["et0"] = fma(u_t, tt[..., k], sums["et0"])
        sums["et1"] = fma(u_t, xs[..., k], sums["et1"])
        if buffer:
            u_b = torch.where(o, torch.exp(fma(xb[..., k], inv_tau, -mb)),
                              zero)
            sums["eb"] = sums["eb"] + u_b
            sums["eb0"] = fma(u_b, xb[..., k], sums["eb0"])
            sums["eb1"] = fma(u_b, xs[..., k], sums["eb1"])
    one = torch.ones_like(ms)
    cs = one if is_fresh else torch.exp(a["ms"] - ms)
    cst = one if is_fresh else torch.exp(a["ms"] * inv_tau - mst)
    ct = one if is_fresh else torch.exp(a["mt"] - mt)
    out = dict(a)
    out.update(ds=fma(a["ds"], cs, sums["es"]),
               dst=fma(a["dst"], cst, sums["est"]),
               dt=fma(a["dt"], ct, sums["et"]),
               nt0=fma(a["nt0"], ct, sums["et0"]),
               nt1=fma(a["nt1"], ct, sums["et1"]), ms=ms, mt=mt)
    if buffer:
        cb = one if is_fresh else torch.exp(a["mb"] - mb)
        out.update(db=fma(a["db"], cb, sums["eb"]),
                   nb0=fma(a["nb0"], cb, sums["eb0"]),
                   nb1=fma(a["nb1"], cb, sums["eb1"]), mb=mb)
    return out


def xor_reduce(x, op, width):
    """An xor-shuffle butterfly over the last axis in groups of ``width``
    lanes: every lane ends with op over its group."""
    idx = torch.arange(x.shape[-1])
    off = width // 2
    while off:
        x = op(x, x[..., idx ^ off])
        off //= 2
    return x


def warp_max(x):
    return x.amax(-1, keepdim=True).expand_as(x)


def warp_merge(a, inv_tau, buffer, width):
    ms, mt, mb = warp_max(a["ms"]), warp_max(a["mt"]), warp_max(a["mb"])
    cs, ct = torch.exp(a["ms"] - ms), torch.exp(a["mt"] - mt)
    cst = torch.exp(a["ms"] * inv_tau - ms * inv_tau)
    out = dict(ds=a["ds"] * cs, dst=a["dst"] * cst, dt=a["dt"] * ct,
               nt0=a["nt0"] * ct, nt1=a["nt1"] * ct, ms=ms, mt=mt,
               mb=a["mb"], db=a["db"], nb0=a["nb0"], nb1=a["nb1"])
    if buffer:
        cb = torch.exp(a["mb"] - mb)
        out.update(db=a["db"] * cb, nb0=a["nb0"] * cb, nb1=a["nb1"] * cb,
                   mb=mb)
    for k in ("ds", "dst", "dt", "nt0", "nt1") + (
            ("db", "nb0", "nb1") if buffer else ()):
        out[k] = xor_reduce(out[k], torch.add, width)
    return out


def write_stats(a, sy, inv_tau, buffer):
    zero = torch.zeros_like(sy)
    cols = [torch.log(a["ds"]) + a["ms"], sy,
            torch.log(a["dst"]) + a["ms"] * inv_tau,
            torch.log(a["dt"]) + a["mt"], a["nt0"] / a["dt"],
            a["nt1"] * inv_tau / a["dt"]]
    if buffer:
        cols += [torch.log(a["db"]) + a["mb"], a["nb0"] * inv_tau / a["db"],
                 a["nb1"] * inv_tau / a["db"]]
    else:
        cols += [zero, zero, zero]
    return torch.stack(cols + [zero, zero], dim=-1)


# -- the two paths -------------------------------------------------------------


class Tensors:
    """A case's tensors as the kernels read them: student s, the teacher as
    stored (t, or int8 codes with scale and zero), buffer b; each tensor
    also as bytes placed at its own storage offset in a NaN-filled memory."""

    def __init__(self, s, teacher, b, offsets, quant, scale=None, zero=None):
        self.s, self.t, self.b = s, teacher, b
        self.quant, self.scale, self.zero = quant, scale, zero
        self.mem = {name: _memory(x, off) for (name, x), off in
                    zip((("s", s), ("t", teacher), ("b", b)), offsets)
                    if x is not None}

    def t_over_tau(self, stored, rows, inv_tau):
        """Row.over_tau on stored teacher elements (rows leading)."""
        if not self.quant:
            return stored * inv_tau
        shape = (-1,) + (1,) * (stored.dim() - 1)
        sc = (self.scale * inv_tau)[rows].reshape(shape)
        ze = (self.zero * inv_tau)[rows].reshape(shape)
        return fma(stored, sc, ze)


def _memory(x, off):
    """(bytes, beg, end, itemsize): a memory of 64 + off * itemsize bytes of
    NaN, the tensor's bytes, 64 more bytes of NaN; beg is 16-aligned plus
    off elements (the view's data pointer)."""
    raw = _raw_bytes(x)
    isz = raw.size // x.numel()
    beg = 64 + off * isz
    mem = np.full(beg + raw.size + 64, 0xFF, np.uint8)
    mem[beg:beg + raw.size] = raw
    return mem, beg, beg + raw.size, isz


def _raw_bytes(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint8).reshape(-1)
    return x.contiguous().numpy().view(np.uint8).reshape(-1)


def _from_bytes(raw, like):
    """Elements of ``like``'s dtype from raw bytes, as f32 (int8 codes as
    their integer value)."""
    if like.dtype == torch.bfloat16:
        bits = raw.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32).copy())
    if like.dtype == torch.int8:
        return torch.from_numpy(raw.view(np.int8).astype(np.float32))
    return torch.from_numpy(raw.view(np.float32).copy())


def stage(mem, row_first_byte, c0, n, chunk):
    """Span::stage: the region (chunk * isz + 16 bytes) holding columns
    [c0, c0 + n) of a row, and the skew at which column c0 lands."""
    buf, beg, end, isz = mem
    region = np.full(chunk * isz + 16, 0xFF, np.uint8)
    lo = row_first_byte + c0 * isz
    a0 = lo & ~15
    words = (lo + n * isz - a0 + 15) >> 4
    for j in range(words):
        w = a0 + 16 * j
        if w >= beg and w + 16 <= end:
            lo_read, hi_read = w, w + 16
        elif w >= beg:  # crosses the end: zero fill after it
            lo_read, hi_read = w, end
            region[16 * j + (end - w):16 * j + 16] = 0
        else:  # crosses the start: byte by byte from beg
            lo_read, hi_read = beg, min(w + 16, end)
        assert beg <= lo_read < hi_read <= end  # never outside the tensor
        region[16 * j + lo_read - w:16 * j + hi_read - w] = \
            buf[lo_read:hi_read]
    return region, row_first_byte & 15


def staged_chunk(x, mem, row, v, c0, n, chunk):
    """Columns [c0, c0 + chunk) of ``row`` read back from the staged
    region (NaN, or garbage codes, past what was copied)."""
    region, skew = stage(mem, mem[1] + row * v * mem[3], c0, n, chunk)
    raw = region[skew:skew + chunk * mem[3]]
    return _from_bytes(raw, x)


def emulate_warp(case, p, inv_tau, buffer):
    """kd_stats_warp_kernel under plan ``p``: every row is one warp."""
    x = case
    rows, v = x.s.shape
    k_slots = p.tile
    lane = torch.arange(32)
    a = fresh((rows, 32))
    first_cols = None
    for c0 in range(0, v, 32 * k_slots):
        cols = c0 + lane[:, None] + 32 * torch.arange(k_slots)[None, :]
        ok = (cols < v).expand(rows, 32, k_slots)
        idx = cols.clamp(max=v - 1)
        xs = torch.where(ok, x.s.float()[:, idx], torch.zeros(()))
        tt = torch.where(ok, x.t_over_tau(x.t.float()[:, idx],
                                          torch.arange(rows), inv_tau),
                         torch.zeros(()))
        xb = (torch.where(ok, x.b.float()[:, idx], torch.zeros(()))
              if buffer else torch.zeros_like(xs))
        a = push_tile(a, xs, tt, xb, ok, inv_tau, buffer, is_fresh=c0 == 0)
        if first_cols is None:
            first_cols = xs
    a = warp_merge(a, inv_tau, buffer, 32)
    lane0 = {k: t[:, 0] for k, t in a.items()}
    return write_stats(lane0, _sy(x, first_cols, v, k_slots), inv_tau,
                       buffer)


def _sy(x, first_cols, v, k_slots):
    """s[y]: from lane y % 32's slot y / 32 of the first pass when one pass
    covers the row, else read from s."""
    y = x.labels
    hit = (y >= 0) & (y < v)
    if v <= 32 * k_slots:
        got = first_cols[torch.arange(len(y)), (y % 32).clamp(min=0),
                         (y // 32).clamp(0, k_slots - 1)]
    else:
        got = x.s.float()[torch.arange(len(y)), y.clamp(0, v - 1)]
    return torch.where(hit, got, torch.zeros(()))


def emulate_block(case, p, inv_tau, buffer):
    """kd_stats_block_kernel under plan ``p``: a row a block of eight
    warps, each staging its chunks of every tensor through shared memory."""
    x = case
    rows, v = x.s.shape
    chunk = kd.CHUNK
    assert p.tile * 32 == chunk
    chunks = -(-v // chunk)
    a = fresh((rows, WARPS, 32))
    lane = torch.arange(32)
    for i in range(-(-chunks // WARPS)):
        xs = torch.zeros(rows, WARPS, 32, p.tile)
        tt, xb = torch.zeros_like(xs), torch.zeros_like(xs)
        ok = torch.zeros(rows, WARPS, 32, p.tile, dtype=torch.bool)
        active = torch.zeros(WARPS, dtype=torch.bool)
        for w in range(WARPS):
            c0 = (w + WARPS * i) * chunk
            if c0 >= v:
                continue
            active[w] = True
            n = min(chunk, v - c0)
            cols = lane[:, None] + 32 * torch.arange(p.tile)[None, :]
            ok[:, w] = (c0 + cols < v)
            for r in range(rows):
                vals = {name: staged_chunk(getattr(x, name), x.mem[name], r,
                                           v, c0, n, chunk)[cols]
                        for name in x.mem}
                okr = ok[r, w]
                xs[r, w] = torch.where(okr, vals["s"], torch.zeros(()))
                tt[r, w] = torch.where(okr, x.t_over_tau(
                    vals["t"][None], torch.tensor([r]), inv_tau)[0],
                    torch.zeros(()))
                if buffer:
                    xb[r, w] = torch.where(okr, vals["b"], torch.zeros(()))
        new = push_tile(a, xs, tt, xb, ok, inv_tau, buffer)
        keep = active[None, :, None]
        a = {k: torch.where(keep, new[k], a[k]) for k in a}
    a = warp_merge(a, inv_tau, buffer, 32)
    part = {k: t[:, :, 0] for k, t in a.items()}  # lane 0 of each warp
    lanes = fresh((rows, 32))
    for k in lanes:
        lanes[k][:, :WARPS] = part[k]
    a = warp_merge(lanes, inv_tau, buffer, WARPS)
    lane0 = {k: t[:, 0] for k, t in a.items()}
    y = x.labels
    hit = (y >= 0) & (y < v)
    sy = torch.where(hit, x.s.float()[torch.arange(rows), y.clamp(0, v - 1)],
                     torch.zeros(()))
    return write_stats(lane0, sy, inv_tau, buffer)


def emulate(case, p, tau, buffer):
    inv_tau = float(f32(1.0 / tau))
    return (emulate_warp if p.path == "warp" else emulate_block)(
        case, p, inv_tau, buffer)


# -- cases -----------------------------------------------------------------------


def _case(rows, v, seed, pad, quant, dtype=F32, offsets=(0, 0, 0)):
    """Labels and logits of unit scale x 3 (the last ``pad`` columns -1e30
    in s and b, and in t unless quant), the teacher as int8 codes through
    the port's codec when ``quant``."""
    rng = np.random.default_rng(seed)
    s, t, b = (3 * rng.standard_normal((rows, v)).astype(np.float32)
               for _ in range(3))
    for a in (s, b) if quant else (s, t, b):
        if pad:
            a[:, v - pad:] = -1e30
    y = rng.integers(0, max(v - pad, 1), size=rows).astype(np.int64)
    st, bt = (torch.from_numpy(a).to(dtype) for a in (s, b))
    if quant:
        from repro_torch.transport import codecs
        codec = codecs.parse_codec("int8").transform
        pl = codec.encode(torch.from_numpy(t))
        codes = codec.unpack_codes(pl["codes"], v)
        case = Tensors(st, codes, bt, offsets, True, pl["scale"], pl["zero"])
    else:
        case = Tensors(st, torch.from_numpy(t).to(dtype), bt, offsets, False)
    case.labels = torch.from_numpy(y)
    return case


def _jax_pad(a, v, value=-1e30):
    pad = (-v) % 128
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, pad)), constant_values=value)


def _jax_stats(case, tau, buffer):
    rows, v = case.s.shape
    y = jnp.asarray(case.labels.numpy(), jnp.int32)
    s = _jax_pad(case.s.float().numpy(), v)
    b = _jax_pad(case.b.float().numpy(), v) if buffer else None
    if case.quant:
        return np.asarray(jkd.kd_quant_stats_fwd(
            y, s, _jax_pad(case.t.numpy(), v, 0), jnp.asarray(case.scale),
            jnp.asarray(case.zero), b, tau, v, interpret=True))
    return np.asarray(jkd.kd_stats_fwd(y, s, _jax_pad(case.t.float().numpy(),
                                                       v), b, tau,
                                       interpret=True))


def _ref_stats(case, tau, buffer):
    b = case.b if buffer else None
    if case.quant:
        return ref.kd_quant_stats_ref(case.labels, case.s, case.t, case.scale,
                                      case.zero, b, tau).numpy()
    return ref.kd_stats_ref(case.labels, case.s, case.t, b, tau).numpy()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for col in range(want.shape[1]):
        scale = max(1.0, float(np.abs(want[:, col]).max()))
        err = np.abs(got[:, col] - want[:, col]).max()
        assert err <= tol * scale, (col, err, scale)


V_CASES = (1, 7, 100, 129, kd.WARP_MAX_V - 1, kd.WARP_MAX_V + 1)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("v", V_CASES)
def test_emulated_forward_matches_jax_and_plain(v, tau, buffer, quant):
    """Both paths, the planned one and the other, on ROWS rows (not a
    multiple of the warp path's rows a block) with -1e30 pad columns and
    tensors at their own storage offsets."""
    pad = v // 8
    case = _case(ROWS, v, seed=v + int(10 * tau) + 3 * quant, pad=pad,
                 quant=quant, offsets=(1, 3, 2))
    want = _jax_stats(case, tau, buffer)
    _close(_ref_stats(case, tau, buffer), want)
    planned = kd.plan(ROWS, v)
    assert planned.path == ("warp" if v <= kd.WARP_MAX_V else "block")
    for path in ("warp", "block"):
        p = kd.plan(ROWS, v, path=path)
        _close(emulate(case, p, tau, buffer).numpy(), want)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 5, 11), (15, 2, 7),
                                     (3, 13, 9)])
def test_block_path_stages_misaligned_rows_and_several_rounds(offsets, dtype):
    """A row of three rounds of the eight warps' chunks and a ragged one
    (V odd, so no row of any dtype starts on 16 bytes), at storage offsets
    that put each tensor's start and end inside a 16-byte word: the staged
    values equal the tensors' and the stats the plain version's."""
    v = 3 * kd.CHUNK * WARPS + 5
    for quant in (False, True):
        case = _case(3, v, seed=sum(offsets), pad=40, quant=quant,
                     dtype=dtype, offsets=offsets)
        for name in case.mem:
            x = getattr(case, name)
            row = 2  # the last row: its last word crosses the tensor's end
            got = staged_chunk(x, case.mem[name], row, v, v - 5, 5, kd.CHUNK)
            want = x[row, v - 5:].float()
            assert torch.equal(got[:5], want)
            got = staged_chunk(x, case.mem[name], 0, v, 0, kd.CHUNK,
                               kd.CHUNK)
            assert torch.equal(got, x[0, :kd.CHUNK].float())
        p = kd.plan(3, v)
        assert p.path == "block"
        _close(emulate(case, p, 2.0, True).numpy(),
               _ref_stats(case, 2.0, True))


def test_plan_depends_only_on_shapes():
    """The plan is a function of (rows, V) alone, the same for both
    dtypes, a buffer or none and either teacher, and for any values, so
    the wrapper replays from a CUDA graph; the two emulated value sets
    below share it."""
    import inspect
    assert list(inspect.signature(kd.plan).parameters) == [
        "rows", "v", "path"]
    plans = {(r, v): kd.plan(r, v)
             for r in (1, 6, 128, 512) for v in (1, 100, kd.WARP_MAX_V,
                                                 kd.WARP_MAX_V + 1, 49155)}
    for (r, v), p in plans.items():
        assert p == kd.plan(r, v)
        if p.path == "warp":
            assert v <= kd.WARP_MAX_V and p.rows_per_block == kd.WARP_ROWS
            assert p.tile in (1, 2, 4, 8) and p.tile * 32 >= min(v, 256)
            assert p.blocks == -(-r // p.rows_per_block)
        else:
            assert v > kd.WARP_MAX_V and p.tile * 32 == kd.CHUNK
            assert p.rows_per_block == 1 and p.blocks == r
    one = _case(ROWS, 100, seed=1, pad=0, quant=False)
    other = _case(ROWS, 100, seed=2, pad=100, quant=False)
    other.s[:] = NEG
    p = kd.plan(ROWS, 100)
    for case in (one, other):
        assert kd.plan(*case.s.shape) == p
        _close(emulate(case, p, 2.0, True).numpy(),
               _ref_stats(case, 2.0, True))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tau", [0.0, -1.0])
def test_loss_refuses_tau_at_or_below_zero_on_the_cpu(tau, quant):
    """The kernels' shared max needs tau > 0, and ``ops`` checks it before
    it picks a device, so a CPU call refuses what a CUDA call refuses."""
    case = _case(4, 100, seed=7, pad=0, quant=quant)
    with pytest.raises(ValueError, match="tau > 0"):
        if quant:
            ops.kd_loss_quant(case.labels, case.s, case.t, case.scale,
                              case.zero, case.b, tau=tau)
        else:
            ops.kd_loss(case.labels, case.s, case.t, case.b, tau=tau)
