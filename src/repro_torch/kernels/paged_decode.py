"""Hand-written Hopper kernel for block-paged decode attention.

``csrc/paged_decode.cu`` (the counterpart of the TPU kernel
``repro/kernels/swa_decode.py::paged_decode``, on the split-K machinery of
``csrc/decode_attn.cuh``) is built at first use by
``repro_torch.kernels.build`` and bound with ``ctypes``.  Nothing is built
or loaded when this module is imported.  The page table may have any
length: a block reads only the ids of the pages it visits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.swa_decode import (Plan, chunk_rows, scratch,
                                            smem_bytes, split_plan)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, d: int, ps: int, pp: int, window, dtype) -> Plan:
    """The split of a call over a (P, ps, N, D) pool through a (B, PP)
    table: a slot visits the rows from the first page holding a valid
    position to pos, at most PP*ps, and with a window at most
    window + ps - 1; runs are whole pages."""
    ch = chunk_rows(d)
    span = pp * ps if window is None else min(pp * ps, window + ps - 1)
    s, r = split_plan(b * n, span, ch, math.ceil(ch / ps) * ps)
    return Plan(s, r, ch, b * n * s, smem_bytes(d, dtype.itemsize))


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("paged_decode", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    fn = _build.load("paged_decode").paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, pt, pos, window):
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on CUDA tensors, got {q.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("pt", pt),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode takes float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must match "
                        f"q's dtype {q.dtype}")
    if pt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"pt and pos must be int32, got {pt.dtype}, {pos.dtype}")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    b, n, g, d = q.shape
    if k_pool.shape[2:] != (n, d):
        raise ValueError(f"pool rows {tuple(k_pool.shape[2:])} != (N, D) "
                         f"{(n, d)}")
    if pt.dim() != 2 or pt.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"pt {tuple(pt.shape)} / pos {tuple(pos.shape)} do "
                         f"not match batch {b}")
    # The query groups are the 16 rows of the score MMA.
    if not 1 <= g <= 16 or d % 32 or d > 256:
        raise ValueError(f"kernel needs 1 <= G <= 16 and D a multiple of 32 "
                         f"up to 256, got G={g}, D={d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pt", pt), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned (rows "
                         "are copied 16 bytes at a time)")


def paged_decode(q, k_pool, v_pool, pt, pos, *, window=None):
    """Decode attention of one token per slot over a block-paged pool.

    q (B, N, G, D) in f32 or bf16; k/v_pool (P, ps, N, D) of q's dtype; pt
    (B, PP) int32 page table; pos (B,) int32 positions, each >= 0.  Returns
    (B, N, G, D) in q's dtype.  Launches on the current stream without
    synchronising and never reads pos on the host, so a CUDA graph can
    capture it; every call adds one to ``paged_decode.launches``."""
    _check(q, k_pool, v_pool, pt, pos, window)
    b, n, g, d = q.shape
    ps, pp = k_pool.shape[1], pt.shape[1]
    p = plan(b, n, d, ps, pp, window, q.dtype)
    out = torch.empty_like(q)
    part = scratch(p, b, n, g, d, q.device)
    err = _library()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, b, n, g, d,
        k_pool.shape[0], ps, pp, window or 0, 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], p.splits, p.rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
