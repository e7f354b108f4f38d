"""The backward KD-gradient kernels' flat pass, emulated on the CPU.

``csrc/kd_loss.cu``'s ``kd_grad_kernel`` (behind ``kd_grad_bwd`` and
``kd_quant_grad_bwd``) runs only on the card; here its partition and its
arithmetic run in numpy and torch f32 and are held against the JAX kernels
``kd_grad_bwd`` and ``kd_quant_grad_bwd`` in interpret mode and against the
port's plain versions.  What the emulation mirrors:

- ``launch_bwd_plan``: the n = rows x V logits are one flat array, cut into
  vectors of W logits: W = 1 while n / (16 / itemsize) would give the
  card's SMs fewer than ``BWD_FILL_THREADS`` threads each, else W = 16 /
  itemsize, and then a head of scalar elements takes s to its 16-byte
  boundary and the vectors are read and written as one access each when
  every tensor (the teacher's codes: W bytes) is on its boundary there;
  tensors whose skews differ take W = 1.  The tail past the last vector
  is scalar.
- ``kd_grad_kernel``: thread x of block z takes vector z T + x (T threads
  a block); it divides the vector's flat index by V (the high 64 bits of i
  times a magic number); inside a vector the column steps by one and the
  row by one where it reaches V (several times when V < W), the next
  row's data read with the vector's and any further row's then; threads
  0 .. 2W - 1 of block 0 take the head and the tail.  ds = g mean_scale [exp(s - lse_s) - onehot +
  tau (exp(fma(s, 1/tau, -lse_st)) - exp(fma(t, 1/tau, -lse_tt))) (+ tau
  (... - exp(fma(b, 1/tau, -lse_bt))))], the quant teacher fma(code,
  scale, zero), rounded once to s's dtype.

Every tensor lives in its own byte memory at its own storage offset with
NaN bytes around it; the emulated loads assert that no byte outside a
tensor is read (and that every access is on its own boundary), the stores
that no byte outside ds is written and every byte of ds exactly once.  If
the kernel's partition changes, change this file with it.  The kernels
themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kd_loss as jkd  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# tests/test_torch_kd_loss.py's tolerance: f32 sums and exponentials in
# another order, relative to the largest reference value.
TOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
ROWS = 5   # n = ROWS x V is a multiple of no vector width for odd V
GUARD = 64  # NaN bytes before and after every tensor (a multiple of 16)
CU = Path(kd.__file__).resolve().parent / "csrc" / "kd_loss.cu"


# -- memories ----------------------------------------------------------------


class Memory:
    """A tensor's bytes at ``skew`` bytes past a 16-byte boundary, NaN
    (0xFF) bytes around them.  Loads and stores take the first element of
    each access and the elements an access (one access of up to 16
    bytes); they assert that every byte lies inside the tensor and that
    the access is on its boundary."""

    def __init__(self, raw, itemsize, skew):
        self.isz = itemsize
        self.beg = GUARD + skew
        self.end = self.beg + raw.size
        self.buf = np.full(self.end + GUARD, 0xFF, np.uint8)
        self.buf[self.beg:self.end] = raw
        self.writes = np.zeros(self.buf.size, np.int64)

    @property
    def ptr(self):
        return self.beg

    def _span(self, first, count):
        addr = self.beg + np.asarray(first, np.int64) * self.isz
        nbytes = count * self.isz
        assert (addr >= self.beg).all() and (addr + nbytes <= self.end).all(), \
            "an access outside the tensor"
        assert (addr % nbytes == 0).all(), "an access off its boundary"
        return addr[:, None] + np.arange(nbytes)

    def load(self, first, count):
        return self.buf[self._span(first, count)]

    def store(self, first, raw):
        span = self._span(first, raw.shape[1] // self.isz)
        self.buf[span] = raw
        np.add.at(self.writes, span.reshape(-1), 1)


def _raw(x):
    if x.dtype == BF16:
        return x.contiguous().view(torch.int16).numpy().view(np.uint8).ravel()
    return x.contiguous().numpy().view(np.uint8).ravel()


def _values(raw, dtype):
    """f32 values of raw bytes (rows of accesses) of ``dtype``."""
    if dtype == BF16:
        bits = raw.copy().view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32))
    if dtype == torch.int8:
        return torch.from_numpy(raw.copy().view(np.int8).astype(np.float32))
    return torch.from_numpy(raw.copy().view(np.float32))


def divide(i, v):
    """GradArgs::row_col for i < 2^32: the high 64 bits of i * magic, magic
    = floor(2^64 / V) + 1, from two 32 x 32-bit products (V = 1: i itself),
    and the column i - r V."""
    i = np.asarray(i, np.int64)
    if v == 1:
        return i, np.zeros_like(i)
    magic = (1 << 64) // v + 1
    x = i.astype(np.uint64)
    lo = x * np.uint64(magic & 0xFFFFFFFF)
    hi = x * np.uint64(magic >> 32)
    r = ((hi + (lo >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)
    return r, i - r * v


def fma(x, y, z):
    """f32 fma: the product is exact in f64, one rounding to f32 after."""
    return (x.double() * y + z.double()).float()


# -- the plan and the kernel ------------------------------------------------


SMS = 132  # the H100's SMs, for the planned width


class BwdPlan(NamedTuple):
    w: int        # logits a vector
    head: int     # scalar elements before the first vector
    nvec: int     # vectors
    tail: int     # scalar elements after the last
    blocks: int


def bwd_plan(ptrs, n, isz, tisz, width=0, sms=SMS):
    """launch_bwd_plan from the tensors' first bytes (``ptrs``: s, t, b or
    None, ds), the width asked for (0: the plan's) and the card's SM
    count."""
    w = 16 // isz
    if width == 0:
        width = 1 if n // w < sms * kd.BWD_FILL_THREADS else w
    assert width in (1, w)
    head = 0
    if width == w:
        head = min((16 - ptrs["s"] % 16) % 16 // isz, n)
        if not ((ptrs["s"] + head * isz) % 16 == 0
                and (ptrs["t"] + head * tisz) % (w * tisz) == 0
                and (ptrs["b"] is None or (ptrs["b"] + head * isz) % 16 == 0)
                and (ptrs["ds"] + head * isz) % 16 == 0):
            width, head = 1, 0  # the skews differ
    nvec = (n - head) // width
    blocks = max(1, -(-nvec // kd.BWD_THREADS))
    return BwdPlan(width, head, nvec, n - head - nvec * width, blocks)


class Case:
    """Labels, g, the stats and the logits of one draw (the teacher as int8
    codes with scale and zero when ``quant``), each logit tensor in its own
    memory at ``offsets`` elements (s, t, b, ds)."""

    def __init__(self, rows, v, seed, dtype, buffer, quant, tau=2.0,
                 offsets=(0, 0, 0, 0)):
        rng = np.random.default_rng(seed)
        pad = v // 8
        s, t, b = (3 * rng.standard_normal((rows, v)).astype(np.float32)
                   for _ in range(3))
        for a in (s, b) if quant else (s, t, b):
            if pad:
                a[:, v - pad:] = -1e30
        self.labels = torch.from_numpy(
            rng.integers(0, max(v - pad, 1), size=rows).astype(np.int64))
        self.g = torch.from_numpy(rng.uniform(0.5, 2.0, rows).astype(
            np.float32))
        self.s = torch.from_numpy(s).to(dtype)
        self.b = torch.from_numpy(b).to(dtype) if buffer else None
        self.quant, self.tau, self.dtype = quant, tau, dtype
        self.mean_scale = 1.0 / rows
        if quant:
            from repro_torch.transport import codecs
            codec = codecs.parse_codec("int8").transform
            pl = codec.encode(torch.from_numpy(t))
            self.t = codec.unpack_codes(pl["codes"], v)
            self.scale, self.zero = pl["scale"], pl["zero"]
            teacher = ref.dequantize(self.t, self.scale, self.zero)
        else:
            self.t = torch.from_numpy(t).to(dtype)
            teacher = self.t.float()
        self.stats = ref.kd_stats_ref(
            self.labels, self.s.float(), teacher,
            self.b.float() if buffer else None, tau)
        isz = self.s.element_size()
        o_s, o_t, o_b, o_ds = offsets
        self.mem = {"s": Memory(_raw(self.s), isz, o_s * isz),
                    "t": Memory(_raw(self.t), self.t.element_size(),
                                o_t * self.t.element_size()),
                    "ds": Memory(np.full(self.s.numel() * isz, 0xFF, np.uint8),
                                 isz, o_ds * isz)}
        if buffer:
            self.mem["b"] = Memory(_raw(self.b), isz, o_b * isz)

    @property
    def shape(self):
        return tuple(self.s.shape)

    def ptrs(self):
        return {"s": self.mem["s"].ptr, "t": self.mem["t"].ptr,
                "b": self.mem["b"].ptr if "b" in self.mem else None,
                "ds": self.mem["ds"].ptr}


def emulate(case, width=0, sms=SMS):
    """kd_grad_kernel over the case's memories.  Returns (ds as stored, ds
    in f32 before the rounding, the plan)."""
    rows, v = case.shape
    n = rows * v
    p = bwd_plan(case.ptrs(), n, case.s.element_size(),
                 case.t.element_size(), width, sms)
    w = p.w
    # (first element, elements, rows and columns of each)
    accesses = []
    vi = np.arange(p.blocks * kd.BWD_THREADS, dtype=np.int64)
    vi = vi[vi < p.nvec]
    first = p.head + vi * w
    rr, cc = divide(first, v)
    er, ec = [], []
    for _ in range(w):  # the row steps inside a vector
        wrap = cc == v
        cc, rr = np.where(wrap, 0, cc), rr + wrap
        er.append(rr)
        ec.append(cc)
        cc = cc + 1
    accesses.append((first, w, np.stack(er, 1), np.stack(ec, 1)))
    # threads 0 .. 2W - 1 of block 0: the head and the tail, one element each
    ends = np.concatenate([np.arange(p.head),
                           p.head + p.nvec * w + np.arange(p.tail)])
    assert len(ends) <= 2 * w <= kd.BWD_THREADS
    accesses.append((ends, 1, (ends // v)[:, None], (ends % v)[:, None]))

    out32 = torch.full((n,), float("nan"))
    for first, count, er, ec in accesses:
        if not len(first):
            continue
        assert (er >= 0).all() and (er < rows).all()  # row data in bounds
        x = _values(case.mem["s"].load(first, count), case.dtype)
        t = _values(case.mem["t"].load(first, count), case.t.dtype)
        rows_t = torch.from_numpy(er.reshape(x.shape))
        cols_t = torch.from_numpy(ec.reshape(x.shape))
        st = case.stats[rows_t]
        if case.quant:
            t = fma(t, case.scale[rows_t], case.zero[rows_t])
        inv_tau = float(torch.tensor(1.0 / case.tau, dtype=F32))
        tau = case.tau
        hit = (cols_t == case.labels[rows_t]).float()
        p_s = torch.exp(x - st[..., 0])
        p_st = torch.exp(fma(x, inv_tau, -st[..., 2]))
        p_tt = torch.exp(fma(t, inv_tau, -st[..., 3]))
        d = fma(torch.full_like(x, tau), p_st - p_tt, p_s - hit)
        if "b" in case.mem:
            xb = _values(case.mem["b"].load(first, count), case.dtype)
            p_bt = torch.exp(fma(xb, inv_tau, -st[..., 6]))
            d = fma(torch.full_like(x, tau), p_st - p_bt, d)
        gs = case.g[rows_t] * torch.tensor(case.mean_scale, dtype=F32)
        val = gs * d
        flat = torch.from_numpy(first[:, None] + np.arange(count))
        out32[flat.reshape(-1)] = val.reshape(-1)
        case.mem["ds"].store(first, _raw(val.to(case.dtype)).reshape(
            len(first), -1))
    ds_mem = case.mem["ds"]
    assert (ds_mem.writes[ds_mem.beg:ds_mem.end] == 1).all()  # each once
    assert not ds_mem.writes[:ds_mem.beg].any()
    assert not ds_mem.writes[ds_mem.end:].any()
    assert (ds_mem.buf[:ds_mem.beg] == 0xFF).all()
    assert (ds_mem.buf[ds_mem.end:] == 0xFF).all()
    stored = _values(ds_mem.buf[ds_mem.beg:ds_mem.end][None], case.dtype)
    return stored.reshape(rows, v), out32.reshape(rows, v), p


# -- references --------------------------------------------------------------


def _jax_pad(a, v, value=-1e30):
    pad = (-v) % 128
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, pad)), constant_values=value)


def _jax_grad(case):
    """The JAX kernel in interpret mode on the case's values in f32, V
    padded to its 128-lane tile (-1e30 logits, codes 0 masked by index)."""
    rows, v = case.shape
    y = jnp.asarray(case.labels.numpy(), jnp.int32)
    g = jnp.asarray(case.g.numpy())
    stats = jnp.asarray(case.stats.numpy())
    s = _jax_pad(case.s.float().numpy(), v)
    b = _jax_pad(case.b.float().numpy(), v) if case.b is not None else None
    if case.quant:
        out = jkd.kd_quant_grad_bwd(
            y, g, stats, s, _jax_pad(case.t.numpy(), v, 0),
            jnp.asarray(case.scale.numpy()), jnp.asarray(case.zero.numpy()),
            b, case.tau, v, case.mean_scale, interpret=True)
    else:
        out = jkd.kd_grad_bwd(y, g, stats, s,
                              _jax_pad(case.t.float().numpy(), v), b,
                              case.tau, case.mean_scale, interpret=True)
    return torch.from_numpy(np.array(out)[:, :v])


def _ref_grad(case):
    """The port's plain version on the case's values in f32."""
    b = case.b.float() if case.b is not None else None
    if case.quant:
        return ref.kd_quant_grad_ref(case.labels, case.g, case.stats,
                                     case.s.float(), case.t, case.scale,
                                     case.zero, b, case.tau, case.mean_scale)
    return ref.kd_grad_ref(case.labels, case.g, case.stats, case.s.float(),
                           case.t.float(), b, case.tau, case.mean_scale)


def _close(got, want, tol=TOL):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max())


def _check(case, want, **plan):
    stored, out32, p = emulate(case, **plan)
    _close(out32, want)
    assert torch.equal(stored, out32.to(case.dtype).float())  # one rounding
    return p


# -- tests -------------------------------------------------------------------

V_CASES = (1, 3, 7, 100, 129, 1025)


def _launches(dtype):
    """The planned launch (one logit a thread at these sizes on 132 SMs),
    the planned one on a 1-SM card (16-byte vectors from 128 of them) and
    either width asked for."""
    w = 16 // torch.empty(0, dtype=dtype).element_size()
    return [{}, {"sms": 1}, {"width": w}, {"width": 1}]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("v", V_CASES)
def test_emulated_backward_matches_jax_and_plain(v, dtype, buffer, quant):
    """Every launch of ``_launches`` on ROWS rows: V below the vector width
    (several row ends a vector), V = 100 (bf16 vectors cross every other
    row end), odd V."""
    seed = v + 10 * buffer + 20 * quant
    case = Case(ROWS, v, seed=seed, dtype=dtype, buffer=buffer, quant=quant)
    want = _jax_grad(case)
    _close(_ref_grad(case), want)
    for launch in _launches(dtype):
        p = _check(Case(ROWS, v, seed=seed, dtype=dtype, buffer=buffer,
                        quant=quant), want, **launch)
        assert p.head == 0 and p.blocks >= 1
        if not launch:
            assert p.w == 1  # 5 x 1025 logits are far from filling the card


@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("which", ["s", "t", "b", "ds"])
def test_each_tensor_at_its_own_storage_offset(which, offset):
    """One tensor 1-15 elements into its storage, the others at 0, 16-byte
    vectors asked for: the body runs on vectors only where every tensor
    shares s's boundary, otherwise one logit a thread, which (the plan
    here) never minds the skews.  No byte outside any tensor is
    touched.  Both dtypes and teachers, V = 129 (no row starts on a
    boundary)."""
    pos = {"s": 0, "t": 1, "b": 2, "ds": 3}[which]
    offsets = tuple(offset if k == pos else 0 for k in range(4))
    for dtype in (F32, BF16):
        w = 16 // torch.empty(0, dtype=dtype).element_size()
        for quant in (False, True):
            case = Case(3, 129, seed=offset, dtype=dtype, buffer=True,
                        quant=quant, offsets=offsets)
            want = _ref_grad(case)
            p = _check(case, want, width=w)
            isz, tisz = case.s.element_size(), case.t.element_size()
            skews = [o * sz % (16 if k != 1 else w * tisz)
                     for k, (o, sz) in enumerate(zip(
                         offsets, (isz, tisz, isz, isz)))]
            if which == "s":
                # the head peels s; the rest must share its skew
                assert p.w == (w if offset % w == 0 else 1)
            else:
                assert p.w == (w if skews[pos] == 0 else 1)
            assert p.head + p.nvec * p.w + p.tail == case.s.numel()
            case = Case(3, 129, seed=offset, dtype=dtype, buffer=True,
                        quant=quant, offsets=offsets)
            p = _check(case, want)
            assert p.w == 1 and p.head == p.tail == 0


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("offset", [0, 1, 3, 6])
def test_wrappers_allocate_ds_at_the_students_skew(offset, dtype):
    """``_ds_like``: ds's first byte lies as far past a 16-byte boundary as
    s's, so a student, teacher and buffer at one offset keep vectors."""
    base = torch.zeros(offset + 40, dtype=dtype)
    s = base[offset:].view(5, 8)
    ds = kd._ds_like(s)
    assert ds.shape == s.shape and ds.dtype == dtype and ds.is_contiguous()
    assert ds.data_ptr() % 16 == s.data_ptr() % 16
    assert base.data_ptr() % 16 == 0  # the allocator's boundary


@pytest.mark.parametrize("offset", [1, 3, 6])
def test_shared_skew_peels_a_head_and_keeps_vectors(offset):
    """Every tensor at one offset: a head of W - offset (mod W) scalar
    elements, then vectors on every tensor's boundary, then a tail."""
    for dtype in (F32, BF16):
        for quant in (False, True):
            w = 16 // torch.empty(0, dtype=dtype).element_size()
            case = Case(ROWS, 100, seed=offset, dtype=dtype, buffer=True,
                        quant=quant, offsets=(offset,) * 4)
            p = _check(case, _ref_grad(case), width=w)
            assert p.w == w and p.head == (w - offset % w) % w
            assert p.tail == (case.s.numel() - p.head) % w


def test_partition_covers_every_logit_once_at_any_skew():
    """Values aside: for V 1-40, rows 1-4, every skew of s and ds and both
    widths, the head, the vectors and the tail cover the n logits once
    (``emulate`` asserts every ds byte written once and nothing outside)."""
    for v in range(1, 41):
        for rows in range(1, 5):
            for o in range(0, 16, 5):
                for width in (8, 1):
                    case = Case(rows, v, seed=v, dtype=BF16, buffer=False,
                                quant=False, offsets=(o, o, 0, o % 3))
                    _check(case, _ref_grad(case), width=width)


def test_planned_width_switches_where_vectors_fill_the_card():
    """One logit a thread below SMS x BWD_FILL_THREADS vector-threads, 16
    bytes from there: the FL main path's 128 x 100 takes one logit a
    thread, 512 x 1,024 and the LLM shape vectors."""
    ptrs = {"s": 0, "t": 0, "b": 0, "ds": 0}
    for isz, w in ((4, 4), (2, 8)):
        edge = SMS * kd.BWD_FILL_THREADS * w
        for n, want in ((128 * 100, 1), (edge - 1, 1), (edge, w),
                        (512 * 1024, w), (512 * 49155, w)):
            p = bwd_plan(ptrs, n, isz, 1)
            assert p.w == want, (isz, n)


def test_row_division_by_multiply_is_exact():
    """GradArgs::row_col's multiply gives floor(i / V) for every i < 2^32
    and V < 2^31 (checked at each V's multiples and their neighbours)."""
    rng = np.random.default_rng(0)
    vs = [1, 2, 3, 7, 100, 1025, 49155, 2 ** 20 + 1, 2 ** 31 - 1] + list(
        rng.integers(2, 2 ** 31, 20))
    for v in vs:
        ks = np.unique(np.concatenate([rng.integers(0, 2 ** 32 // v, 50),
                                       [0, 1, 2 ** 32 // v - 1]]))
        i = np.concatenate([ks * v, ks * v + v - 1, ks * v - 1,
                            rng.integers(0, 2 ** 32, 50),
                            [2 ** 32 - 1]]).astype(np.int64)
        i = i[(i >= 0) & (i < 2 ** 32)]
        r, c = divide(i, int(v))
        assert np.array_equal(r, i // v) and np.array_equal(c, i % v), v


def test_launch_constants_mirror_the_kernel_file():
    """BWD_THREADS and BWD_FILL_THREADS, which this emulation runs, are
    the .cu file's kBwdThreads and kBwdFillThreads."""
    src = CU.read_text()
    for name, value in (("kBwdThreads", kd.BWD_THREADS),
                        ("kBwdFillThreads", kd.BWD_FILL_THREADS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
