"""Hand-written Hopper kernel for the RG-LRU linear recurrence.

``csrc/rglru.cu`` (the counterpart of the TPU kernel
``repro/kernels/rglru.py::rglru_pallas``) is built at first use by
``repro_torch.kernels.build`` and bound with ``ctypes``.  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("rglru", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    fn = _build.load("rglru").rglru
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    if a.device.type != "cuda":
        raise ValueError(f"rglru runs on CUDA tensors, got {a.device}")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one (B, S, D) shape")


def rglru(a, b):
    """h_t = a_t h_{t-1} + b_t along S from zero, on the card.

    a, b (B, S, D) float32, contiguous, on one CUDA device; any S and D.
    Returns h (B, S, D) float32.  Launches on the current stream without
    synchronising; every launch adds one to ``rglru.launches``."""
    _check(a, b)
    bsz, s, d = a.shape
    h = torch.empty_like(a)
    err = _library()(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, d,
                     torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru launch failed: CUDA error {err}")
    rglru.launches += 1
    return h


rglru.launches = 0
