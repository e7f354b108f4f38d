"""Public wrappers around the port's kernels: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the hand-written kernel.  A ``meta`` tensor
(shapes only: the mesh dry-run's) also takes the plain version, so that
shapes and operation counts propagate.  Under a mesh the fused KD losses
run on each rank's local shards (:func:`_mean_on_shards`); the decode and
scan wrappers are called on local shards by their callers
(``repro_torch.sharding.local.run_local``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import kd_loss as _kd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.rglru import rglru as rglru_kernel
from repro_torch.kernels.ssd import chunk_size
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.swa_decode import swa_decode
from repro_torch.sharding import local as _local

# Devices whose tensors take a kernel's plain version.
PLAIN = ("cpu", "meta")


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    q_chunk=512):
    """Exact full-sequence attention (every attention arch's training
    forward and serving prefill).  q (B, S, H, D), k/v (B, T, N, D), GQA
    head ``n * G + g``; query row i sits at position ``q_offset + i``, key
    j at j (``causal`` keeps j <= i's position, ``window`` j > it -
    window).  A CPU or ``meta`` tensor takes the plain version, chunked by
    ``q_chunk`` queries (``ref.attend_full_ref``); a CUDA tensor the flash
    kernel pair (``flash_fwd``, and ``flash_bwd`` under autograd,
    ``torch.func`` transforms included), which raises on a shape or dtype
    it does not take."""
    if q.device.type in PLAIN:
        return _ref.attend_full_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, q_chunk=q_chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)[0]


def _fold(x, dim, size):
    """``x`` with its vmapped dimension ``dim`` (None: not mapped, so
    expanded to ``size``) merged into its batch dimension."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:])


def _unfold(x, size):
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])


class _FlashAttention(torch.autograd.Function):
    """O and the log-sum-exp from ``flash_fwd``; dq, dk, dv from
    ``flash_bwd``.  Saves q, k, v, O and the log-sum-exp only.  Under
    ``torch.func.vmap`` the mapped dimension folds into the batch, so the
    kernels see plain tensors at every transform level."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        return _fa.flash_fwd(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionGrad.apply(do, q, k, v, o, lse,
                                               *ctx.mask)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset):
        n = info.batch_size
        q, k, v = (_fold(x, dim, n) for x, dim in zip((q, k, v), in_dims))
        o, lse = _FlashAttention.apply(q, k, v, causal, window, q_offset)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionGrad(torch.autograd.Function):
    """``flash_bwd`` as a function of its own, so that a backward run under
    ``torch.func.vmap`` reaches the kernels with plain tensors.  It has no
    backward of its own (no double backward through the kernels)."""

    @staticmethod
    def forward(do, q, k, v, o, lse, causal, window, q_offset):
        return _fa.flash_bwd(do, q, k, v, o, lse, causal=causal,
                             window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the flash attention kernels have no "
                                  "double backward")

    @staticmethod
    def vmap(info, in_dims, do, q, k, v, o, lse, causal, window, q_offset):
        n = info.batch_size
        args = (_fold(x, dim, n)
                for x, dim in zip((do, q, k, v, o, lse), in_dims))
        grads = _FlashAttentionGrad.apply(*args, causal, window, q_offset)
        return tuple(_unfold(x, n) for x in grads), (0, 0, 0)


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
    """The per-row losses CE + tau^2 KL(t||s) [+ tau^2 KL(b||s)] with the
    forward stats and the student gradient from the kernel pair; a mean
    taken outside hands the backward its 1/rows per row.  Teacher and
    buffer are frozen: they get no gradient."""

    @staticmethod
    def forward(ctx, labels, s, t, b, tau):
        stats = kd_stats(labels, s, t, b, tau)
        ctx.save_for_backward(labels, stats, s, t, b)
        ctx.tau = tau
        return _kd.assemble_loss(stats, tau, b is not None)

    @staticmethod
    def backward(ctx, g):
        labels, stats, s, t, b = ctx.saved_tensors
        ds = kd_grad(labels, g.float().contiguous(), stats, s, t, b, ctx.tau,
                     1.0)
        return None, ds, None, None, None


def _check_labels(labels, s, name):
    """On a CUDA tensor, asserts on the device (no host sync) that every
    label lies in [0, V): one outside raises at the next synchronise."""
    if s.device.type == "cuda":
        v = s.shape[-1]
        torch._assert_async(((labels >= 0) & (labels < v)).all(),
                            f"{name}: a label is outside [0, {v})")


def _mean_on_shards(rows_fn, mesh, labels, s, others, tau):
    """The mean over rows of ``rows_fn(labels, s, *others, tau)``'s
    per-row losses under a mesh: each rank runs ``rows_fn`` on whole
    vocabulary rows of its own block of rows (``run_local``; a vocabulary
    sharded over "model" is gathered first, the rows keep their shards over
    "data"), so a CUDA shard launches the kernel pair.  Each rank's
    student gradient is whole for its rows; the None entries of
    ``others`` stay None."""
    row = _local.keep_shards(s, mesh, (0,))
    given = [o for o in others if o is not None]

    def rows(y, s_, *rest):
        it = iter(rest)
        return rows_fn(y, s_, *(None if o is None else next(it)
                                for o in others), tau)

    args = (labels, s, *given)
    # the gradient placements: each rank's student gradient is whole for
    # its rows (ranks that hold the same rows compute the same gradient)
    per_row = _local.run_local(rows, mesh, row, args, (row,) * len(args),
                               (row,) * len(args))
    return torch.mean(per_row)


def _kd_rows(labels, s, t, b, tau):
    s = s.contiguous()
    t = t.detach().contiguous()
    b = b.detach().contiguous() if b is not None else None
    labels = labels.long().contiguous()
    _check_labels(labels, s, "kd_loss")
    return _KDLoss.apply(labels, s, t, b, float(tau))


def kd_loss(labels, student_logits, teacher_logits, buffer_logits=None,
            tau=2.0):
    """Mean buffered-KD loss over rows through the kernel pair (forward
    ``kd_stats_fwd``, backward ``kd_grad_bwd``); differentiable w.r.t. the
    student logits only.  labels (R,) integers in [0, V); logits (R, V) of
    one dtype, any V.  On a CUDA tensor the label range is asserted on the
    device (no host sync): a label outside [0, V) raises at the next
    synchronise.  DTensor inputs run on each rank's shards of the rows
    (:func:`_mean_on_shards`)."""
    mesh = _local.mesh_of(labels, student_logits, teacher_logits,
                          buffer_logits)
    if mesh is not None:
        return _mean_on_shards(_kd_rows, mesh, labels, student_logits,
                               (teacher_logits, buffer_logits), tau)
    return torch.mean(_kd_rows(labels, student_logits, teacher_logits,
                               buffer_logits, tau))


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
        return _kd.assemble_loss(stats, tau, b is not None)

    @staticmethod
    def backward(ctx, g):
        labels, stats, s, codes, scale, zero, b = ctx.saved_tensors
        ds = kd_quant_grad(labels, g.float().contiguous(), stats, s, codes,
                           scale, zero, b, ctx.tau, 1.0)
        return None, ds, None, None, None, None, None


def _kd_quant_rows(labels, s, codes, scale, zero, b, tau):
    s = s.contiguous()
    codes = codes.contiguous()
    scale = scale.detach().contiguous()
    zero = zero.detach().contiguous()
    b = b.detach().contiguous() if b is not None else None
    labels = labels.long().contiguous()
    _check_labels(labels, s, "kd_loss_quant")
    return _KDLossQuant.apply(labels, s, codes, scale, zero, b, float(tau))


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
    asserted on the device as in :func:`kd_loss`; DTensor inputs run on
    each rank's shards of the rows, as there.

    The JAX package pads to its kernel's 128-lane tile (codes with 0) and
    masks the pad columns by index against the true vocabulary; these
    kernels read exactly V columns, so the codes go in unpadded and the
    value on the true columns is the same without either step."""
    mesh = _local.mesh_of(labels, student_logits, codes, scale, zero,
                          buffer_logits)
    if mesh is not None:
        return _mean_on_shards(_kd_quant_rows, mesh, labels, student_logits,
                               (codes, scale, zero, buffer_logits), tau)
    return torch.mean(_kd_quant_rows(labels, student_logits, codes, scale,
                                     zero, buffer_logits, tau))
