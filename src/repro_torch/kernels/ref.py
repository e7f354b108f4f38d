"""Plain PyTorch versions of the port's kernels: the CPU path, and what
``chip_smoke.py`` holds each kernel against on the card."""

from __future__ import annotations

import math

import torch


def paged_decode_ref(q, k_pool, v_pool, pt, pos, window=None):
    """Paged-cache decode attention: gather every slot's pages into a dense
    (B, PP*ps, N, D) view and run the masked softmax.  q: (B, N, G, D);
    pools (P, ps, N, D); pt (B, PP) int; pos (B,) int.  Positions past
    ``pos`` (trash-page placeholders included) are masked to -1e30."""
    b, n, g, d = q.shape
    ps = k_pool.shape[1]
    pp = pt.shape[1]
    pt = pt.long()
    kc = k_pool[pt].reshape(b, pp * ps, n, d)
    vc = v_pool[pt].reshape(b, pp * ps, n, d)
    p_col = torch.as_tensor(pos, device=q.device).long().expand(b)[:, None]
    j = torch.arange(pp * ps, device=q.device)[None, :]
    valid = j <= p_col
    if window is not None:
        valid = valid & (j > p_col - window)
    s = torch.einsum("bngd,bwnd->bngw", q.float(), kc.float()) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngw,bwnd->bngd", p, vc.float()).to(q.dtype)


def swa_decode_ref(q, k_cache, v_cache, pos, window=None, ring=False):
    """Decode attention of one token per row over a dense (ring) cache.
    q: (B, N, G, D); caches (B, W, N, D); pos: scalar or (B,) int.  With
    ``ring`` slot j holds absolute position a_j = pos - ((pos - j) mod W),
    else a_j = j; a slot is valid when 0 <= a_j <= pos (and a_j > pos -
    window).  Scores, softmax and the weighted sum in f32, masked to
    -1e30; returned in q's dtype."""
    b, n, g, d = q.shape
    w = k_cache.shape[1]
    p_col = torch.as_tensor(pos, device=q.device).long().expand(b)[:, None]
    j = torch.arange(w, device=q.device)[None, :]
    a = p_col - torch.remainder(p_col - j, w) if ring else j.expand(b, w)
    valid = (a >= 0) & (a <= p_col)
    if window is not None:
        valid = valid & (a > p_col - window)
    s = torch.einsum("bngd,bwnd->bngw", q.float(),
                     k_cache.float()) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngw,bwnd->bngd", p, v_cache.float()).to(q.dtype)


def ssd_ref(x, dt, A, B, C, chunk):
    """The Mamba-2 chunked SSD scan (``nn/ssm.py::ssd_reference``): x (b, s,
    h, p), dt (b, s, h), A (h,), B and C (b, s, g, n) per group, f32.
    Returns y (b, s, h, p) and the final state (b, h, p, n)."""
    from repro_torch.nn.ssm import ssd_reference
    return ssd_reference(x, dt, A, B, C, chunk)


def rglru_ref(a, b):
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along axis 1 of (B, S, D)
    (``nn/rglru.py::rglru_scan_reference``)."""
    from repro_torch.nn.rglru import rglru_scan_reference
    return rglru_scan_reference(a, b)


def kd_loss_ref(labels, s, t, b, tau):
    """Per-row buffered-KD loss: CE + tau^2 KL(t||s) [+ tau^2 KL(b||s)].
    s, t, b: (rows, V) logits (b may be None); labels (rows,) int."""
    s = s.float()
    lse_s = torch.logsumexp(s, dim=-1)
    ce = lse_s - s.gather(-1, labels.long()[:, None])[:, 0]
    ls = torch.log_softmax(s / tau, dim=-1)

    def kl(teacher):
        lt = torch.log_softmax(teacher.float() / tau, dim=-1)
        return (tau ** 2) * torch.sum(torch.exp(lt) * (lt - ls), dim=-1)

    loss = ce + kl(t)
    if b is not None:
        loss = loss + kl(b)
    return loss


def kd_loss_mean_ref(labels, s, t, b, tau):
    return torch.mean(kd_loss_ref(labels, s, t, b, tau))


def kd_stats_ref(labels, s, t, b, tau):
    """The (rows, 11) f32 stats of ``kd_stats_fwd`` in plain PyTorch:
    [lse_s, s_y, lse_st, lse_tt, E_t[t/tau], E_t[s/tau], lse_bt, E_b[b/tau],
    E_b[s/tau], 0, 0], with E_t and E_b weighted by softmax(t/tau) and
    softmax(b/tau); the buffer columns are 0 when ``b`` is None."""
    s = s.float()
    st = s / tau
    zero = torch.zeros_like(s[:, 0])

    def soft(x):
        xt = x.float() / tau
        p = torch.softmax(xt, dim=-1)
        return (torch.logsumexp(xt, dim=-1), torch.sum(p * xt, dim=-1),
                torch.sum(p * st, dim=-1))

    lse_tt, et_tt, et_ts = soft(t)
    lse_bt, eb_bb, eb_bs = soft(b) if b is not None else (zero, zero, zero)
    sy = s.gather(-1, labels.long()[:, None])[:, 0]
    return torch.stack([torch.logsumexp(s, dim=-1), sy,
                        torch.logsumexp(st, dim=-1), lse_tt, et_tt, et_ts,
                        lse_bt, eb_bb, eb_bs, zero, zero], dim=-1)


def kd_grad_ref(labels, g, stats, s, t, b, tau, mean_scale):
    """``kd_grad_bwd`` in plain PyTorch: g*mean_scale*[softmax(s) - onehot(y)
    + tau*(softmax(s/tau) - softmax(t/tau)) (+ tau*(softmax(s/tau) -
    softmax(b/tau)))], the softmaxes normalised by the stats' lse columns;
    returned in ``s``'s dtype."""
    sf = s.float()
    p_st = torch.exp(sf / tau - stats[:, 2:3])
    ds = torch.exp(sf - stats[:, 0:1])
    ds = ds - torch.nn.functional.one_hot(labels.long(), s.shape[-1]).float()
    ds = ds + tau * (p_st - torch.exp(t.float() / tau - stats[:, 3:4]))
    if b is not None:
        ds = ds + tau * (p_st - torch.exp(b.float() / tau - stats[:, 6:7]))
    return ((g.float() * mean_scale)[:, None] * ds).to(s.dtype)


def dequantize(codes, scale, zero):
    """The teacher of a per-row affine payload: ``codes * scale + zero`` in
    f32 (codes (rows, V) int8, scale and zero (rows,) f32)."""
    return codes.float() * scale[:, None] + zero[:, None]


def kd_quant_stats_ref(labels, s, codes, scale, zero, b, tau):
    """``kd_quant_stats_fwd`` in plain PyTorch: the stats of
    :func:`kd_stats_ref` with the teacher dequantized from its payload."""
    return kd_stats_ref(labels, s, dequantize(codes, scale, zero), b, tau)


def kd_quant_grad_ref(labels, g, stats, s, codes, scale, zero, b, tau,
                      mean_scale):
    """``kd_quant_grad_bwd`` in plain PyTorch: :func:`kd_grad_ref` with the
    teacher dequantized from its payload."""
    return kd_grad_ref(labels, g, stats, s, dequantize(codes, scale, zero), b,
                       tau, mean_scale)
