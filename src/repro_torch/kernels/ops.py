"""Public wrappers around the port's kernels: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the hand-written kernel.  A ``meta`` tensor
(shapes only: the mesh dry-run's) also takes the plain version, so that
shapes and operation counts propagate."""

from __future__ import annotations

import torch

from repro_torch.kernels import kd_loss as _kd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.rglru import rglru as rglru_kernel
from repro_torch.kernels.ssd import chunk_size
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.swa_decode import swa_decode

# Devices whose tensors take a kernel's plain version.
PLAIN = ("cpu", "meta")


def paged_decode_attn(q, k_pool, v_pool, pt, pos, *, window=None):
    """Block-paged decode attention (the paged ServeEngine's tick hot spot).
    q: (B, N, G, D); k/v_pool: (P, page_size, N, D); pt: (B, PP) int32 page
    table; pos: (B,) int32."""
    if q.device.type in PLAIN:
        return _ref.paged_decode_ref(q, k_pool, v_pool, pt, pos, window=window)
    return paged_decode(q, k_pool, v_pool, pt, pos, window=window)


def swa_decode_attn(q, k_cache, v_cache, pos, *, window=None, ring=False):
    """Decode attention over a dense (ring) cache (the dense ServeEngine's
    tick hot spot).  q: (B, N, G, D); k/v_cache: (B, W, N, D); pos: a
    scalar or (B,) int, broadcast to (B,) int32."""
    b = q.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device).expand(b)
    if q.device.type in PLAIN:
        return _ref.swa_decode_ref(q, k_cache, v_cache, pos, window=window,
                                   ring=ring)
    return swa_decode(q, k_cache, v_cache, pos.contiguous(), window=window,
                      ring=ring)


def _forward_only(name, *tensors):
    """The ``ssd`` and ``rglru`` kernels have no backward (nor has the JAX
    package: its model trains through the plain scans), so a CUDA call
    that autograd would have to differentiate raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"ops.{name} on a CUDA tensor is forward-only (the {name} kernel "
            f"has no backward); train through the plain scan "
            f"(use_kernel=False), as the model's full-sequence forward does")


def ssd(x, dt, A, B, C, chunk):
    """The Mamba-2 SSD chunk scan (every SSD layer's prefill).  x (b, s, h,
    p), B and C (b, s, g, n) are cast to f32 as the JAX ``ops.ssd`` does;
    dt (b, s, h) and A (h,) are f32.  The chunk follows the JAX rule
    (``min(chunk, s)``, lowered until it divides s), so the kernel and the
    plain version cut the sequence at the same places.  Returns y (b, s, h,
    p) f32 and the final state (b, h, p, n) f32."""
    q = chunk_size(chunk, x.shape[1])
    x, B, C = x.float(), B.float(), C.float()
    if x.device.type in PLAIN:
        return _ref.ssd_ref(x, dt, A, B, C, q)
    _forward_only("ssd", x, dt, A, B, C)
    return ssd_kernel(x.contiguous(), dt.contiguous(), A.contiguous(),
                      B.contiguous(), C.contiguous(), q)


def rglru(a, b):
    """The RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (every RG-LRU
    layer's prefill).  a, b (B, S, D) f32 -> h (B, S, D) f32."""
    if a.device.type in PLAIN:
        return _ref.rglru_ref(a, b)
    _forward_only("rglru", a, b)
    return rglru_kernel(a.contiguous(), b.contiguous())


def kd_stats(labels, s, t, b, tau):
    """The fused KD loss's forward stats (rows, 11): ``kd_stats_fwd`` on a
    CUDA tensor, ``kd_stats_ref`` on a CPU one; tau > 0 on both."""
    _kd.check_tau(tau, "kd_stats")
    if s.device.type in PLAIN:
        return _ref.kd_stats_ref(labels, s, t, b, tau)
    return _kd.kd_stats_fwd(labels, s, t, b, tau)


def kd_grad(labels, g, stats, s, t, b, tau, mean_scale):
    """The fused KD loss's student gradient: ``kd_grad_bwd`` on a CUDA
    tensor, ``kd_grad_ref`` on a CPU one."""
    if s.device.type in PLAIN:
        return _ref.kd_grad_ref(labels, g, stats, s, t, b, tau, mean_scale)
    return _kd.kd_grad_bwd(labels, g, stats, s, t, b, tau, mean_scale)


class _KDLoss(torch.autograd.Function):
    """mean(CE + tau^2 KL(t||s) [+ tau^2 KL(b||s)]) with the forward stats
    and the student gradient from the kernel pair.  Teacher and buffer are
    frozen: they get no gradient."""

    @staticmethod
    def forward(ctx, labels, s, t, b, tau):
        stats = kd_stats(labels, s, t, b, tau)
        ctx.save_for_backward(labels, stats, s, t, b)
        ctx.tau = tau
        return torch.mean(_kd.assemble_loss(stats, tau, b is not None))

    @staticmethod
    def backward(ctx, g):
        labels, stats, s, t, b = ctx.saved_tensors
        rows = s.shape[0]
        gv = g.float().expand(rows).contiguous()
        ds = kd_grad(labels, gv, stats, s, t, b, ctx.tau, 1.0 / rows)
        return None, ds, None, None, None


def kd_loss(labels, student_logits, teacher_logits, buffer_logits=None,
            tau=2.0):
    """Mean buffered-KD loss over rows through the kernel pair (forward
    ``kd_stats_fwd``, backward ``kd_grad_bwd``); differentiable w.r.t. the
    student logits only.  labels (R,) integers in [0, V); logits (R, V) of
    one dtype, any V.  On a CUDA tensor the label range is asserted on the
    device (no host sync): a label outside [0, V) raises at the next
    synchronise."""
    s = student_logits.contiguous()
    t = teacher_logits.detach().contiguous()
    b = (buffer_logits.detach().contiguous()
         if buffer_logits is not None else None)
    labels = labels.long().contiguous()
    if s.device.type == "cuda":
        v = s.shape[-1]
        torch._assert_async(((labels >= 0) & (labels < v)).all(),
                            f"kd_loss: a label is outside [0, {v})")
    return _KDLoss.apply(labels, s, t, b, float(tau))


# -- the dequant-fused KD loss: the teacher arrives as a transport payload ---


def kd_quant_stats(labels, s, codes, scale, zero, b, tau):
    """The dequant-fused loss's forward stats (rows, 11):
    ``kd_quant_stats_fwd`` on a CUDA tensor, ``kd_quant_stats_ref`` on a CPU
    one; tau > 0 on both."""
    _kd.check_tau(tau, "kd_quant_stats")
    if s.device.type in PLAIN:
        return _ref.kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau)
    return _kd.kd_quant_stats_fwd(labels, s, codes, scale, zero, b, tau)


def kd_quant_grad(labels, g, stats, s, codes, scale, zero, b, tau,
                  mean_scale):
    """The dequant-fused loss's student gradient: ``kd_quant_grad_bwd`` on a
    CUDA tensor, ``kd_quant_grad_ref`` on a CPU one."""
    if s.device.type in PLAIN:
        return _ref.kd_quant_grad_ref(labels, g, stats, s, codes, scale, zero,
                                      b, tau, mean_scale)
    return _kd.kd_quant_grad_bwd(labels, g, stats, s, codes, scale, zero, b,
                                 tau, mean_scale)


class _KDLossQuant(torch.autograd.Function):
    """:class:`_KDLoss` with the teacher given as codes, scale and zero.
    Codes, scale, zero and buffer are frozen: they get no gradient."""

    @staticmethod
    def forward(ctx, labels, s, codes, scale, zero, b, tau):
        stats = kd_quant_stats(labels, s, codes, scale, zero, b, tau)
        ctx.save_for_backward(labels, stats, s, codes, scale, zero, b)
        ctx.tau = tau
        return torch.mean(_kd.assemble_loss(stats, tau, b is not None))

    @staticmethod
    def backward(ctx, g):
        labels, stats, s, codes, scale, zero, b = ctx.saved_tensors
        rows = s.shape[0]
        gv = g.float().expand(rows).contiguous()
        ds = kd_quant_grad(labels, gv, stats, s, codes, scale, zero, b,
                           ctx.tau, 1.0 / rows)
        return None, ds, None, None, None, None, None


def kd_loss_quant(labels, student_logits, codes, scale, zero,
                  buffer_logits=None, tau=2.0):
    """Mean buffered-KD loss with the teacher given as a per-row affine
    payload, ``teacher = codes * scale[:, None] + zero[:, None]`` (int8
    codes; the int4 codec unpacks its [-8, 7] grid into this container per
    batch before the call), through the kernel pair ``kd_quant_stats_fwd``
    / ``kd_quant_grad_bwd``; differentiable w.r.t. the student logits only.
    labels (R,) integers in [0, V); student and buffer (R, V) of one dtype;
    codes (R, V); scale, zero (R,).  On a CUDA tensor the kernels dequantize
    in registers, so no f32 (R, V) teacher is made, and the label range is
    asserted on the device as in :func:`kd_loss`.

    The JAX package pads to its kernel's 128-lane tile (codes with 0) and
    masks the pad columns by index against the true vocabulary; these
    kernels read exactly V columns, so the codes go in unpadded and the
    value on the true columns is the same without either step."""
    s = student_logits.contiguous()
    codes = codes.contiguous()
    scale = scale.detach().contiguous()
    zero = zero.detach().contiguous()
    b = (buffer_logits.detach().contiguous()
         if buffer_logits is not None else None)
    labels = labels.long().contiguous()
    if s.device.type == "cuda":
        v = s.shape[-1]
        torch._assert_async(((labels >= 0) & (labels < v)).all(),
                            f"kd_loss_quant: a label is outside [0, {v})")
    return _KDLossQuant.apply(labels, s, codes, scale, zero, b, float(tau))
