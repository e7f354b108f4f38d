"""Hand-written Hopper kernel for the Mamba-2 SSD chunk scan.

``csrc/ssd.cu`` (the counterpart of the TPU kernel
``repro/kernels/ssd.py::ssd_pallas``) is built at first use by
``repro_torch.kernels.build`` and bound with ``ctypes``.  Nothing is built
or loaded when this module is imported.  The C side picks the kernel (the
row kernel at chunk 1, else the chunk kernel) and its shared memory
(``ssd_smem_bytes``) from the shapes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

MAX_CHUNK = 128
MAX_STATE = 256  # d_state (n) the kernels take


def chunk_size(chunk, s):
    """The chunk a length-``s`` scan uses: ``min(chunk, s)``, lowered until
    it divides ``s`` (the JAX rule; a prime s above the chunk gives 1)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("ssd", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    fn = _build.load("ssd").ssd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, chunk):
    tensors = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on CUDA tensors, got {x.device}")
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    b, s, h, _ = x.shape
    g = B.shape[2]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not match x {tuple(x.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"{g} B/C groups do not divide {h} heads")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must divide s={s} and lie in "
                         f"[1, {MAX_CHUNK}]")
    if not 1 <= B.shape[3] <= MAX_STATE:
        raise ValueError(f"d_state {B.shape[3]} outside [1, {MAX_STATE}]")


def ssd(x, dt, A, B, C, chunk):
    """Mamba-2 SSD chunk scan on the card.

    x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n): float32,
    contiguous, on one CUDA device; head ``hd`` reads B/C group
    ``hd // (h // g)``; n at most 256.  ``chunk`` must divide s
    (``chunk_size`` gives the JAX rule's chunk).  Returns (y (b, s, h, p),
    final state (b, h, p, n)), float32.  A call whose shared memory does not
    fit a block raises the CUDA error of opting into it.  Launches on the
    current stream without synchronising; every launch adds one to
    ``ssd.launches``."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _library()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, g, p, n, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, state


ssd.launches = 0
