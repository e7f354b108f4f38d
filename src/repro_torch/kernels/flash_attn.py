"""Hand-written Hopper kernel pair for full-sequence attention: a fused,
tiled, online-softmax forward and its backward (FlashAttention-2's
algorithm), in CUDA C++.

``csrc/flash_attn.cu`` is built at first use by ``repro_torch.kernels.build``
(one library a padded head dim, ``-DFLASH_D_PAD``) and bound with
``ctypes``; nothing is built or loaded when this module is imported.  The
source's note says what the pair replaces (no TPU kernel: the JAX package
leaves ``repro/nn/attention.py::attend_full`` to XLA), what bounds it (the
QK^T and PV products on the tensor cores) and what its design does about
that: no (S, T) tensor in device memory, key blocks outside the mask never
loaded and only the mask's edge blocks masked, ``mma.sync`` bf16 products
with f32 sums, a backward of three kernels without float atomics.

The tiles are compile-time constants of the padded head dim; :func:`plan`
holds the same numbers (``flash_attn_plan`` in the library reports them).
The block ranges a kernel block visits are :func:`key_segments` and
:func:`query_segments`, one device function each in the ``.cu`` file.

The scores stay in f32 from q . k^T to the softmax; the JAX function
rounds its scores to bf16 first.  The kernel's is the closer number to an
f32 reference (a deliberate deviation, ROADMAP queue 3).  The CPU tests
hold a plain-PyTorch emulation of this tiling (``kernels/ref.py``:
``flash_fwd_tiled``, ``flash_bwd_tiled``) against the plain version, and
the card tests hold the kernels against the emulation; change them with
the kernels.
"""

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build as _build

_DTYPES = (torch.float32, torch.bfloat16)
# The most dynamic shared memory an H100 block may ask for.
SMEM_LIMIT = 232_448
LOG2E = 1.4426950408889634
# A masked score, in the kernels' log2 units: finite, so that a row whose
# first visited block is all masked rescales to nothing once a kept score
# arrives (every row keeps at least one: :func:`_check`).
NEG = -1.0e30


class Tiles(NamedTuple):
    """One kernel's launch: ``block_m`` query rows and ``block_n`` key rows
    a tile, and the dynamic shared bytes a block asks for."""
    block_m: int
    block_n: int
    smem: int


class Plan(NamedTuple):
    """The pair's launches for one head dim and dtype: the padded head dim
    (the next multiple of 32, the pad zero-filled) and the forward's, the
    dK/dV kernel's and the dQ kernel's tiles."""
    d_pad: int
    fwd: Tiles
    dkdv: Tiles
    dq: Tiles


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype) -> Plan:
    """The pair's tiles for head dim ``d`` in ``dtype``, from the shape
    alone (``csrc/flash_attn.cu``'s constants).  bf16: a warp owns 16-row
    ``mma.sync`` tiles of query rows, two of them in the forward up to
    d_pad 128 and in dQ up to 64 (each K or V fragment read from shared
    memory then feeds two products), one past that, where the f32
    accumulators fill the registers; 4 warps a block; key blocks of 64 or
    32, whichever the registers leave room for.  The dK/dV block owns 64
    key rows (32 past d_pad 128, two warps sharing each 16 with half the
    head dim each) and streams query blocks of 64 (32 past d_pad 64).
    Tiles are staged in shared memory as rows of d_pad + 8 bf16, two
    stages of the streamed ones.  f32 runs on the CUDA cores, eight lanes
    a row: 16 rows a block, 32-row tiles of the other side, one stage (the
    f32 path holds the port against f32 references; it is not a speed
    path)."""
    d_pad = _ceil_to(max(d, 1), 32)
    if dtype == torch.bfloat16:
        ld = 2 * (d_pad + 8)
        fwd_m, fwd_n = (128 if d_pad <= 128 else 64), (64 if d_pad <= 64
                                                        else 32)
        kv_n, kv_m = (64 if d_pad <= 128 else 32), (64 if d_pad <= 64
                                                     else 32)
        dq_m = 128 if d_pad <= 64 else 64
        dq_n = 64 if 64 < d_pad <= 128 else 32
        return Plan(d_pad, Tiles(fwd_m, fwd_n, (fwd_m + 4 * fwd_n) * ld),
                    Tiles(kv_m, kv_n,
                          (2 * kv_n + 4 * kv_m) * ld + 4 * kv_m * 4),
                    Tiles(dq_m, dq_n, (2 * dq_m + 4 * dq_n) * ld))
    rows, tile, two = 16, 32, 2 * 32 * d_pad * 4
    return Plan(d_pad, Tiles(rows, tile, two),
                Tiles(tile, rows, two + 2 * tile * 4), Tiles(rows, tile, two))


# -- the block ranges a kernel block visits (the kernels' arithmetic) --------


def _ceil_to(x, m):
    return (x + m - 1) // m * m


def _clamp(x, lo, hi):
    return min(max(x, lo), hi)


def key_segments(m0, s, t, q_offset, causal, window, block_m, block_n):
    """The key ranges the block of query rows [m0, m0 + block_m) visits, as
    three (start, end, masked) segments stepped by ``block_n``: the
    window's edge (masked), the blocks every valid row of the block attends
    whole (unmasked), the causal diagonal and T's ragged end (masked).
    Blocks outside them hold no kept pair and are skipped.  The forward
    and dQ kernels take the same numbers from ``key_segments`` in
    ``csrc/flash_attn.cu``."""
    p_lo = q_offset + m0
    p_hi = q_offset + min(m0 + block_m, s) - 1
    lo = max(p_lo - window + 1, 0) if window is not None else 0
    a = lo // block_n * block_n
    d = min(t, p_hi + 1) if causal else t
    full_lo = (_ceil_to(max(p_hi - window + 1, 0), block_n)
               if window is not None else 0)
    full_hi = (min(t, p_lo + 1) if causal else t) // block_n * block_n
    b = _clamp(full_lo, a, d)
    c = _clamp(full_hi, b, d)
    return [(a, b, True), (b, c, False), (c, d, True)]


def query_segments(n0, s, t, q_offset, causal, window, block_m, block_n):
    """The query ranges the dK/dV block of key rows [n0, n0 + block_n)
    visits, as three (start, end, masked) segments stepped by ``block_m``:
    the causal diagonal (masked), the blocks whose rows all attend every
    key of the block (unmasked), the window's far edge and S's ragged end
    (masked); ``query_segments`` in ``csrc/flash_attn.cu``."""
    n_last = min(n0 + block_n, t) - 1
    m_lo = max(n0 - q_offset, 0) if causal else 0
    a = m_lo // block_m * block_m
    d = max(min(s, n_last + window - q_offset) if window is not None else s,
            a)
    full_lo = _ceil_to(max(n0 + block_n - 1 - q_offset, 0),
                       block_m) if causal else 0
    full_hi = (max(min(s, n0 + window - q_offset), 0)
               if window is not None else s) // block_m * block_m
    if n0 + block_n > t:
        full_hi = 0
    b = _clamp(full_lo, a, d)
    c = _clamp(full_hi, b, d)
    return [(a, b, True), (b, c, False), (c, d, True)]


# -- the library ---------------------------------------------------------------


def _defines(d_pad: int):
    return (f"FLASH_D_PAD={d_pad}",)


def build(d: int, verbose: bool = False) -> Path:
    """Compile the library for head dim ``d`` (its padded head dim) if this
    source has not been built yet; returns its path (see
    ``repro_torch.kernels.build.build``)."""
    return _build.build("flash_attn", verbose,
                        _defines(plan(d, torch.bfloat16).d_pad))


@functools.lru_cache(maxsize=None)
def _library(d_pad: int):
    lib = _build.load("flash_attn", _defines(d_pad))
    lib.flash_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                              + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                              + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.flash_bwd.restype = ctypes.c_int
    lib.flash_attn_plan.argtypes = [ctypes.c_void_p]
    lib.flash_attn_plan.restype = None
    return lib


def library_plan(d: int, dtype) -> Plan:
    """The tiles the built library for head dim ``d`` runs in ``dtype``
    (``flash_attn_plan``): :func:`plan` must equal it."""
    out = (ctypes.c_int * 19)()
    _library(plan(d, dtype).d_pad).flash_attn_plan(ctypes.addressof(out))
    at = 1 if dtype == torch.bfloat16 else 10
    return Plan(out[0], Tiles(*out[at:at + 3]), Tiles(*out[at + 3:at + 6]),
                Tiles(*out[at + 6:at + 9]))


# -- the wrappers --------------------------------------------------------------


def _check(q, k, v, window, q_offset):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA tensors, got "
                         f"{q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q {q.dtype}: one dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: q (B, S, H, D), k and v "
                         f"(B, T, N, D)")
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q's (B, D) = "
                         f"{(b, d)}")
    if n < 1 or h % n:
        raise ValueError(f"{h} query heads are not a multiple of {n} kv "
                         f"heads")
    vec = 16 // q.element_size()  # rows are copied 16 bytes at a time
    if not (1 <= d <= 256 and d % vec == 0 and s >= 1 and t >= 1):
        raise ValueError(f"flash attention needs D a multiple of {vec} up to "
                         f"256 and S, T >= 1, got D={d}, S={s}, T={t}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1 or None, got {window}")
        # every query row must keep at least one key
        if q_offset + s - window >= t:
            raise ValueError(f"the last query row (position {q_offset + s - 1}"
                             f") keeps no key of {t} under window {window}")


def _operand(x):
    """``x`` contiguous and 16-byte aligned (a copy only where it is not)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _mask(causal, window, q_offset):
    return q_offset, int(bool(causal)), window or 0


def flash_fwd(q, k, v, *, causal=True, window: Optional[int] = None,
              q_offset: int = 0):
    """Attention forward.  q (B, S, H, D), k and v (B, T, N, D) of one dtype
    (f32 or bf16, D a multiple of 16 bytes up to 256; non-contiguous or
    unaligned operands are copied), GQA head ``n * G + g``; query row i
    sits at position ``q_offset + i``, key j at j.  Returns O (B, S, H, D)
    in q's dtype and the per-row log-sum-exp (B, H, S) f32 of the scaled,
    masked scores.  Launches on the current stream without synchronising;
    every call adds one to ``flash_fwd.launches``."""
    _check(q, k, v, window, q_offset)
    q, k, v = (_operand(x) for x in (q, k, v))
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _library(plan(d, q.dtype).d_pad).flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, t, h, n, d, *_mask(causal, window, q_offset),
        int(q.dtype == torch.bfloat16), LOG2E / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd(do, q, k, v, o, lse, *, causal=True,
              window: Optional[int] = None, q_offset: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_fwd`'s O given dO (the
    shape of O), from q, k, v, O and the log-sum-exp it returned: the delta
    pre-pass, the dK/dV kernel and the dQ kernel, on one stream.  Returns
    contiguous tensors of q's, k's and v's dtype and shapes.  Every call
    adds one to ``flash_bwd.launches``."""
    _check(q, k, v, window, q_offset)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} and O "
                         f"{tuple(o.shape)} {o.dtype} must have q's shape "
                         f"and dtype")
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"{(b, h, s)} float32")
    do, q, k, v, o, lse = (_operand(x) for x in (do, q, k, v, o, lse))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _library(plan(d, q.dtype).d_pad).flash_bwd(
        do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, t, h, n, d,
        *_mask(causal, window, q_offset), int(q.dtype == torch.bfloat16),
        LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_bwd.launches = 0
