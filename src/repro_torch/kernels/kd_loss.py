"""Hand-written Hopper kernels for the fused buffered-KD loss.

``csrc/kd_loss.cu`` holds the counterparts of the TPU kernels
``repro/kernels/kd_loss.py::kd_stats_fwd`` (one pass of online logsumexp
giving 11 stats per row) and ``::kd_grad_bwd`` (the student gradient from
those stats), and of their quant variants ``::kd_quant_stats_fwd`` and
``::kd_quant_grad_bwd``, which read the teacher as a transport payload
(int8 codes and a per-row f32 scale and zero) and dequantize it in
registers.  It is built at first use by ``repro_torch.kernels.build`` and
bound with ``ctypes``; nothing is built or loaded when this module is
imported.  The forward pair runs one of two paths, planned from the shapes
alone (:func:`plan`: a warp a row up to ``WARP_MAX_V`` columns, a block a
row above); the backward pair is one flat pass over the logits, in 16-byte
vectors or one logit a thread, its split decided by the C side from the
shapes, the card and the pointers; so a CUDA graph replays the wrappers.
``assemble_loss`` turns the stats into the per-row loss, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

N_STATS = 11  # [lse_s, s_y, lse_st, lse_tt, E_t[t/tau], E_t[s/tau], lse_bt, E_b[b/tau], E_b[s/tau], 0, 0]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The backward's launch (``csrc/kd_loss.cu``'s kBwdThreads and
# kBwdFillThreads): one flat pass over rows x V, a block of BWD_THREADS
# threads, each taking one vector of 16 bytes of s (4 f32 or 8 bf16
# logits), or one logit while vectors would give the card's SMs fewer than
# BWD_FILL_THREADS threads each (the C side decides, from the pointers too).
BWD_THREADS = 128
BWD_FILL_THREADS = 128

# The forward's plan (``csrc/kd_loss.cu``).  Up to WARP_MAX_V columns a row
# takes one warp, WARP_ROWS rows a block; above, one block of BLOCK_WARPS
# warps, each streaming chunks of CHUNK columns through its own ring of
# shared-memory stages (their count and bytes are the C side's).
WARP_MAX_V = 1024
WARP_ROWS = 4  # kWarpRows
BLOCK_WARPS = 8
_BLOCK_TILE = 16  # kTile
CHUNK = 32 * _BLOCK_TILE  # a warp's chunk: 32 lanes x a tile of 16 columns
_WARP_TILE_MAX = 8


class Plan(NamedTuple):
    """How a forward call runs: ``path`` "warp" (a warp a row,
    ``rows_per_block`` rows a block, lane l holding columns l + 32 k for k
    < ``tile`` each pass) or "block" (a block a row, warp w streaming
    chunks w, w + 8, ... of CHUNK columns, lane l holding columns l + 32 j
    for j < ``tile`` of each); ``blocks`` in the grid."""
    path: str
    rows_per_block: int
    tile: int
    blocks: int


def plan(rows: int, v: int, path: str | None = None) -> Plan:
    """The forward's plan for (rows, V) logits, from the shapes alone: the
    same for both dtypes, with or without a buffer and for the quant pair.
    ``path`` forces one path (for timing both across ``WARP_MAX_V``)."""
    path = path or ("warp" if v <= WARP_MAX_V else "block")
    if path == "warp":
        tile = 1
        while tile < min(_WARP_TILE_MAX, _ceil(v, 32)):
            tile *= 2
        return Plan("warp", WARP_ROWS, tile, _ceil(rows, WARP_ROWS))
    if path != "block":
        raise ValueError(f"path must be 'warp' or 'block', got {path!r}")
    return Plan("block", 1, _BLOCK_TILE, rows)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (see ``repro_torch.kernels.build.build``)."""
    return _build.build("kd_loss", verbose)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("kd_loss")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kd_stats_fwd.argtypes = [ptr] * 5 + [i32, i32, f32, i32, i32, i32,
                                             ptr]
    lib.kd_stats_fwd.restype = i32
    lib.kd_grad_bwd.argtypes = [ptr] * 7 + [i32, i32, f32, f32, f32, i32,
                                            i32, ptr]
    lib.kd_grad_bwd.restype = i32
    lib.kd_quant_stats_fwd.argtypes = [ptr] * 7 + [i32, i32, f32, i32, i32,
                                                   i32, ptr]
    lib.kd_quant_stats_fwd.restype = i32
    lib.kd_quant_grad_bwd.argtypes = [ptr] * 9 + [i32, i32, f32, f32, f32,
                                                  i32, i32, ptr]
    lib.kd_quant_grad_bwd.restype = i32
    return lib


def _check(labels, s, t, b, name):
    """Checks of the labels, the student and the logits that share its
    dtype and shape (teacher ``t``, None for the quant pair, and buffer
    ``b``)."""
    if s.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {s.device}")
    if any(hasattr(x, "device_mesh") for x in (labels, s, t, b)):
        raise TypeError(f"{name} reads the local shards of a DTensor, not "
                        f"the DTensor: ops.kd_loss runs the kernels on each "
                        f"rank's shards")
    named = [("labels", labels)] + (
        [("teacher", t)] if t is not None else []) + (
        [("buffer", b)] if b is not None else [])
    for what, x in named:
        if x.device != s.device:
            raise ValueError(f"{what} on {x.device}, student on {s.device}")
    if s.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 logits, got "
                        f"{s.dtype}")
    for what, x in named[1:]:
        if x.dtype != s.dtype:
            raise TypeError(f"{what} logits are {x.dtype}, student {s.dtype}: "
                            f"the kernel reads one dtype")
    if labels.dtype != torch.int64:
        raise TypeError(f"labels must be int64, got {labels.dtype}")
    if s.dim() != 2 or s.shape[1] < 1:
        raise ValueError(f"logits must be (rows, V) with V >= 1, got "
                         f"{tuple(s.shape)}")
    for what, x in named[1:]:
        if x.shape != s.shape:
            raise ValueError(f"{what} logits {tuple(x.shape)} != student "
                             f"{tuple(s.shape)}")
    if labels.shape != (s.shape[0],):
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"{s.shape[0]} rows")
    rows, v = s.shape
    if rows >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"({rows}, {v}) logits exceed the kernels' int "
                         f"rows and columns")
    for what, x in [("labels", labels), ("student", s)] + named[1:]:
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _check_payload(s, codes, scale, zero):
    """The quant pair's teacher: codes int8 of the student's shape, scale
    and zero float32 (rows,), all contiguous on the student's device."""
    rows = s.shape[0]
    for what, x in (("codes", codes), ("scale", scale), ("zero", zero)):
        if hasattr(x, "device_mesh"):
            raise TypeError(f"{what} is a DTensor: the kernels read local "
                            f"shards (ops.kd_loss_quant)")
        if x.device != s.device:
            raise ValueError(f"{what} on {x.device}, student on {s.device}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if codes.shape != s.shape:
        raise ValueError(f"codes {tuple(codes.shape)} != student "
                         f"{tuple(s.shape)}")
    for what, x in (("scale", scale), ("zero", zero)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {x.dtype}")
        if x.shape != (rows,):
            raise ValueError(f"{what} {tuple(x.shape)} does not match "
                             f"{rows} rows")
    for what, x in (("codes", codes), ("scale", scale), ("zero", zero)):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _check_grad_inputs(s, g, stats):
    rows = s.shape[0]
    for what, x, shape in (("g", g, (rows,)), ("stats", stats, (rows, N_STATS))):
        if x.device != s.device or x.dtype != torch.float32 \
                or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be a contiguous float32 {shape} "
                             f"tensor on {s.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def check_tau(tau, name):
    """Refuses tau <= 0: the kernels share one max between s and s/tau,
    exact only for tau > 0 (``ops`` checks it on both devices)."""
    if not float(tau) > 0:
        raise ValueError(f"{name} needs tau > 0, got {tau}")


def _plan_args(p: Plan):
    return (0 if p.path == "warp" else 1, p.tile)


def kd_stats_fwd(labels, s, t, b, tau, path=None):
    """Per-row stats (rows, 11) f32 of student ``s``, teacher ``t`` and
    buffer ``b`` logits (rows, V), f32 or bf16 of one dtype, ``b`` None for
    plain KD; labels (rows,) int64, each in [0, V) (``ops.kd_loss`` checks
    the range on the device); tau > 0.  Runs :func:`plan`'s plan; ``path``
    forces one path (for timing both across the threshold).  Launches on
    the current stream without synchronising; every launch adds one to
    ``kd_stats_fwd.launches``."""
    _check(labels, s, t, b, "kd_stats_fwd")
    check_tau(tau, "kd_stats_fwd")
    rows, v = s.shape
    p = plan(rows, v, path)
    stats = torch.empty((rows, N_STATS), dtype=torch.float32, device=s.device)
    err = _library().kd_stats_fwd(
        labels.data_ptr(), s.data_ptr(), t.data_ptr(),
        b.data_ptr() if b is not None else None, stats.data_ptr(), rows, v,
        1.0 / float(tau), _DTYPES[s.dtype], *_plan_args(p),
        torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"kd_stats_fwd launch failed: CUDA error {err}")
    kd_stats_fwd.launches += 1
    return stats


def _ds_like(s):
    """An empty tensor like ``s`` whose first byte lies as far past a
    16-byte boundary as ``s``'s does, so that a student, teacher and buffer
    that share a skew keep the backward's 16-byte vectors."""
    skew = s.data_ptr() % 16 // s.element_size()
    return torch.empty(skew + s.numel(), dtype=s.dtype,
                       device=s.device)[skew:].view(s.shape)


def kd_grad_bwd(labels, g, stats, s, t, b, tau, mean_scale, width=None):
    """Student gradient (rows, V) in ``s``'s dtype from the forward's
    ``stats`` and the per-row cotangent ``g`` (rows,) f32, scaled by
    ``mean_scale``; one flat pass over the logits (views at any storage
    offset are taken).  ``width`` (1, or 16 bytes of logits) overrides the
    C side's choice of logits a thread, for tests and timing; tensors whose
    skews differ still take one.  Every launch adds one to
    ``kd_grad_bwd.launches``."""
    _check(labels, s, t, b, "kd_grad_bwd")
    _check_grad_inputs(s, g, stats)
    rows, v = s.shape
    ds = _ds_like(s)
    err = _library().kd_grad_bwd(
        labels.data_ptr(), g.data_ptr(), stats.data_ptr(), s.data_ptr(),
        t.data_ptr(), b.data_ptr() if b is not None else None, ds.data_ptr(),
        rows, v, float(tau), 1.0 / float(tau), float(mean_scale),
        _DTYPES[s.dtype], width or 0,
        torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"kd_grad_bwd launch failed: CUDA error {err}")
    kd_grad_bwd.launches += 1
    return ds


def kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau, path=None):
    """The stats of :func:`kd_stats_fwd` with the teacher given as a
    payload: ``codes`` (rows, V) int8, ``scale`` and ``zero`` (rows,) f32,
    teacher = codes * scale[:, None] + zero[:, None], dequantized in the
    kernel; ``path`` as in :func:`kd_stats_fwd`.  Every launch adds one
    to ``kd_quant_stats_fwd.launches``."""
    _check(labels, s, None, b, "kd_quant_stats_fwd")
    _check_payload(s, codes, scale, zero)
    check_tau(tau, "kd_quant_stats_fwd")
    rows, v = s.shape
    p = plan(rows, v, path)
    stats = torch.empty((rows, N_STATS), dtype=torch.float32, device=s.device)
    err = _library().kd_quant_stats_fwd(
        labels.data_ptr(), s.data_ptr(), codes.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), b.data_ptr() if b is not None else None,
        stats.data_ptr(), rows, v, 1.0 / float(tau), _DTYPES[s.dtype],
        *_plan_args(p), torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"kd_quant_stats_fwd launch failed: CUDA error "
                           f"{err}")
    kd_quant_stats_fwd.launches += 1
    return stats


def kd_quant_grad_bwd(labels, g, stats, s, codes, scale, zero, b, tau,
                      mean_scale, width=None):
    """The student gradient of :func:`kd_grad_bwd` with the teacher given
    as in :func:`kd_quant_stats_fwd`; ``width`` as in :func:`kd_grad_bwd`.
    Every launch adds one to ``kd_quant_grad_bwd.launches``."""
    _check(labels, s, None, b, "kd_quant_grad_bwd")
    _check_payload(s, codes, scale, zero)
    _check_grad_inputs(s, g, stats)
    rows, v = s.shape
    ds = _ds_like(s)
    err = _library().kd_quant_grad_bwd(
        labels.data_ptr(), g.data_ptr(), stats.data_ptr(), s.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        b.data_ptr() if b is not None else None, ds.data_ptr(), rows, v,
        float(tau), 1.0 / float(tau), float(mean_scale), _DTYPES[s.dtype],
        width or 0, torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"kd_quant_grad_bwd launch failed: CUDA error "
                           f"{err}")
    kd_quant_grad_bwd.launches += 1
    return ds


kd_stats_fwd.launches = 0
kd_grad_bwd.launches = 0
kd_quant_stats_fwd.launches = 0
kd_quant_grad_bwd.launches = 0


def assemble_loss(stats, tau, with_buffer):
    """Per-row loss from the stats.

    CE = lse_s - s_y
    tau^2 KL(t||s) = tau^2 * (E_t[t/tau] - lse_tt - E_t[s/tau] + lse_st)
    """
    lse_s, sy = stats[:, 0], stats[:, 1]
    lse_st, lse_tt = stats[:, 2], stats[:, 3]
    et_tt, et_ts = stats[:, 4], stats[:, 5]
    ce = lse_s - sy
    kl_t = (tau ** 2) * (et_tt - lse_tt - et_ts + lse_st)
    loss = ce + kl_t
    if with_buffer:
        lse_bt, eb_bb, eb_bs = stats[:, 6], stats[:, 7], stats[:, 8]
        loss = loss + (tau ** 2) * (eb_bb - lse_bt - eb_bs + lse_st)
    return loss
