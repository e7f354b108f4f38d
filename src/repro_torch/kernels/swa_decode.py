"""Hand-written Hopper kernel for decode attention over a dense, ring or
sliding-window KV cache.

``csrc/swa_decode.cu`` (the counterpart of the TPU kernel
``repro/kernels/swa_decode.py::swa_decode``) is built at first use by
``repro_torch.kernels.build`` and bound with ``ctypes``.  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("swa_decode", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    fn = _build.load("swa_decode").swa_decode
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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
    # At most 16 warps a block: the kernel's registers (72-80 a thread)
    # do not fit 32 warps on an SM.
    if not 1 <= g <= 16 or d % 32 or d > 256:
        raise ValueError(f"kernel needs 1 <= G <= 16 and D a multiple of 32 "
                         f"up to 256, got G={g}, D={d}")
    if 4 * (2 * (d + 1) + g * d + g) > _SMEM_LIMIT:
        raise ValueError(f"G={g} x D={d} query rows do not fit the 48 KiB "
                         f"of shared memory the kernel asks for")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must be 16-byte aligned (rows are read "
                         "with 16-byte loads)")


def swa_decode(q, k_cache, v_cache, pos, *, window=None, ring=False):
    """Decode attention of one token per row over a dense cache.

    q (B, N, G, D) in f32 or bf16, GQA head ``n * G + g``; k/v_cache
    (B, W, N, D) of q's dtype; pos (B,) int32.  With ``ring`` the cache is
    a ring buffer (slot j holds absolute position pos - ((pos - j) mod W)),
    and ``window`` masks positions at or before pos - window.  Returns
    (B, N, G, D) in q's dtype.  Launches on the current stream without
    synchronising; every launch adds one to ``swa_decode.launches``."""
    _check(q, k_cache, v_cache, pos, window)
    b, n, g, d = q.shape
    out = torch.empty_like(q)
    err = _library()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, n, g, d, k_cache.shape[1], window or 0, int(ring),
        1.0 / math.sqrt(d), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"swa_decode launch failed: CUDA error {err}")
    swa_decode.launches += 1
    return out


swa_decode.launches = 0
