"""Hand-written Hopper kernel for decode attention over a dense, ring or
sliding-window KV cache.

``csrc/swa_decode.cu`` (the counterpart of the TPU kernel
``repro/kernels/swa_decode.py::swa_decode``, on the split-K machinery of
``csrc/decode_attn.cuh``) is built at first use by
``repro_torch.kernels.build`` and bound with ``ctypes``.  Nothing is built
or loaded when this module is imported.  The wrapper plans the split
(:func:`plan`, shared with ``paged_decode``) from the shapes alone, so it
never reads ``pos`` on the host and a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The most dynamic shared memory an H100 block may ask for.
SMEM_LIMIT = 232_448
# Blocks a call aims for: two on each of the H100's 132 SMs.
TARGET_BLOCKS = 264
_ROWS = 16  # the MMA's rows (csrc/decode_attn.cuh: kRows), q's staging


class Plan(NamedTuple):
    """How a call is split: ``splits`` runs of ``rows`` visited rows for
    every (row, KV head), staged ``chunk`` rows at a time; ``blocks`` in
    the split kernel's grid; ``smem`` dynamic shared bytes a block."""
    splits: int
    rows: int
    chunk: int
    blocks: int
    smem: int


def chunk_rows(d: int) -> int:
    """Rows of K and V staged per pipeline step (``chunk_rows`` in
    ``csrc/decode_attn.cuh``)."""
    return 64 if d <= 128 else 32


def smem_bytes(d: int, itemsize: int) -> int:
    """A split block's dynamic shared memory (``smem_bytes`` in
    ``csrc/decode_attn.cuh``): two stages of K and V chunks and q's 16 rows
    in the cache's type, rows padded by 16 bytes; the chunk's f32 scores;
    16 running maxes, denominators and rescale factors."""
    ch, dp = chunk_rows(d), d + 16 // itemsize
    return 2 * 2 * ch * dp * itemsize + _ROWS * dp * itemsize \
        + _ROWS * (ch + 4) * 4 + 3 * _ROWS * 4


def split_plan(bn: int, span: int, chunk: int, quantum: int):
    """(S, R): runs of R rows (a multiple of ``quantum``) covering ``span``
    visited rows, S = ceil(span / R), with S * bn near ``TARGET_BLOCKS``
    and no run shorter than a chunk.  From shapes alone, never from pos."""
    span = max(span, 1)
    s = max(1, min(_ceil(span, chunk), _ceil(TARGET_BLOCKS, max(bn, 1))))
    r = _ceil(_ceil(span, s), quantum) * quantum
    return _ceil(span, r), r


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, d: int, w: int, dtype) -> Plan:
    """The split of a call over a (B, W, N, D) cache: a (row, head) visits
    at most W slots (all of them when none is valid)."""
    ch = chunk_rows(d)
    s, r = split_plan(b * n, w, ch, ch)
    return Plan(s, r, ch, b * n * s, smem_bytes(d, dtype.itemsize))


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("swa_decode", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    fn = _build.load("swa_decode").swa_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_cache, v_cache, pos, window):
    if q.device.type != "cuda":
        raise ValueError(f"swa_decode runs on CUDA tensors, got {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swa_decode takes float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"caches ({k_cache.dtype}, {v_cache.dtype}) must "
                        f"match q's dtype {q.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}")
    b, n, g, d = q.shape
    if (k_cache.shape[0], *k_cache.shape[2:]) != (b, n, d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"(B, N, D) = {(b, n, d)}")
    if k_cache.shape[1] < 1:
        raise ValueError("the cache must hold at least one slot")
    if pos.shape != (b,):
        raise ValueError(f"pos {tuple(pos.shape)} does not match batch {b}")
    # The query groups are the 16 rows of the score MMA.
    if not 1 <= g <= 16 or d % 32 or d > 256:
        raise ValueError(f"kernel needs 1 <= G <= 16 and D a multiple of 32 "
                         f"up to 256, got G={g}, D={d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("q and the caches must be 16-byte aligned (rows "
                         "are copied 16 bytes at a time)")


def swa_decode(q, k_cache, v_cache, pos, *, window=None, ring=False):
    """Decode attention of one token per row over a dense cache.

    q (B, N, G, D) in f32 or bf16, GQA head ``n * G + g``; k/v_cache
    (B, W, N, D) of q's dtype; pos (B,) int32.  With ``ring`` the cache is
    a ring buffer (slot j holds absolute position pos - ((pos - j) mod W)),
    and ``window`` masks positions at or before pos - window.  Returns
    (B, N, G, D) in q's dtype.  Launches on the current stream without
    synchronising and never reads pos on the host, so a CUDA graph can
    capture it; every call adds one to ``swa_decode.launches`` (it
    launches the split kernel and, with more than one split, the
    combine)."""
    _check(q, k_cache, v_cache, pos, window)
    b, n, g, d = q.shape
    w = k_cache.shape[1]
    p = plan(b, n, d, w, q.dtype)
    out = torch.empty_like(q)
    part = scratch(p, b, n, g, d, q.device)
    err = _library()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None, b, n,
        g, d, w, window or 0, int(ring), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], p.splits, p.rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"swa_decode launch failed: CUDA error {err}")
    swa_decode.launches += 1
    return out


swa_decode.launches = 0


def scratch(p: Plan, b, n, g, d, device):
    """The f32 partials of a split call ((B*N, S, G) maxes and denominators,
    then (B*N, S, G, D) sums), or None when one split writes the output."""
    if p.splits == 1:
        return None
    return torch.empty(b * n * p.splits * g * (d + 2), dtype=torch.float32,
                       device=device)
