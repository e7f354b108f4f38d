"""Plain PyTorch versions of the port's kernels: the CPU path, and what
``chip_smoke.py`` holds each kernel against on the card."""

from __future__ import annotations

import math

import torch

# A masked score of the plain attention.
NEG_INF = -1e30


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


def attend_chunk(q, k, v, q_pos, k_pos, *, causal, window):
    """q: (B, Q, N, G, D); k/v: (B, T, N, D); positions 1-D per side."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqngd,btnd->bngqt", q, k) * scale
    scores = scores.float()
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bngqt,btnd->bqngd", probs, v)


def attend_full_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                    q_chunk=512):
    """Exact attention, chunked over queries (the JAX function's
    arithmetic: scores from a product in q's dtype, softmax in f32,
    probabilities cast back for PV).  q: (B, S, H, D), k/v (B, T, N, D),
    GQA head ``n * G + g``; query row i at position ``q_offset + i``."""
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, n, h // n, d)
    chunk = min(q_chunk, s)
    if s % chunk != 0:
        chunk = s  # no chunking for ragged sizes
    k_pos = torch.arange(t, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        q_pos = q_offset + start + torch.arange(chunk, device=q.device)
        outs.append(attend_chunk(qg[:, start:start + chunk], k, v, q_pos,
                                 k_pos, causal=causal, window=window))
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def _keep(rows, cols, s, t, q_offset, causal, window):
    """(rows, cols) bool: query row i (position q_offset + i) keeps key j;
    rows past S and keys past T are dropped."""
    pos = q_offset + rows[:, None]
    keep = (rows[:, None] < s) & (cols[None, :] < t)
    if causal:
        keep = keep & (cols[None, :] <= pos)
    if window is not None:
        keep = keep & (cols[None, :] > pos - window)
    return keep


def flash_fwd_tiled(q, k, v, *, causal=True, window=None, q_offset=0,
                    block_m, block_n):
    """The flash forward's tiling in plain PyTorch (``kernels/flash_attn.py``
    ``flash_attn_fwd_kernel``): for each block of ``block_m`` query rows,
    the key blocks of ``key_segments`` in ``block_n`` steps, an online
    softmax in log2 units with masked scores at ``NEG`` on the masked
    segments only, P cast to q's dtype for PV, O normalised once.  Returns
    (O in q's dtype, the per-row log-sum-exp (B, H, S) f32)."""
    from repro_torch.kernels import flash_attn as fa
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2)                                   # (B, H, S, D)
    kh = k.transpose(1, 2).repeat_interleave(h // n, dim=1)  # (B, H, T, D)
    vh = v.transpose(1, 2).repeat_interleave(h // n, dim=1)
    scale = fa.LOG2E / math.sqrt(d)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for m0 in range(0, s, block_m):
        rows = torch.arange(m0, min(m0 + block_m, s), device=q.device)
        qb = qh[:, :, rows].float()
        m_i = torch.full((b, h, len(rows)), fa.NEG, device=q.device)
        l_i = torch.zeros((b, h, len(rows)), device=q.device)
        acc = torch.zeros((b, h, len(rows), d), device=q.device)
        for start, end, masked in fa.key_segments(m0, s, t, q_offset, causal,
                                                  window, block_m, block_n):
            for n0 in range(start, end, block_n):
                cols = torch.arange(n0, min(n0 + block_n, t), device=q.device)
                sc = qb @ kh[:, :, cols].float().transpose(-1, -2) * scale
                if masked:
                    sc = torch.where(_keep(rows, cols, s, t, q_offset, causal,
                                           window), sc, fa.NEG)
                m_new = torch.maximum(m_i, sc.amax(-1))
                alpha = torch.exp2(m_i - m_new)
                p = torch.exp2(sc - m_new[..., None])
                l_i = l_i * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + (
                    p.to(q.dtype).float() @ vh[:, :, cols].float())
                m_i = m_new
        out[:, :, rows] = acc / l_i[..., None]
        lse[:, :, rows] = (m_i + torch.log2(l_i)) / fa.LOG2E
    return out.transpose(1, 2).to(q.dtype), lse


def flash_bwd_tiled(do, q, k, v, o, lse, *, causal=True, window=None,
                    q_offset=0, dkdv_blocks, dq_blocks):
    """The flash backward's tiling in plain PyTorch (``kernels/
    flash_attn.py``): delta = rowsum(dO * O); for each block of key rows
    (``dkdv_blocks`` = (block_m, block_n)), dK and dV summed over the G
    query heads of its kv head and the query blocks of ``query_segments``;
    for each block of query rows (``dq_blocks``), dQ over the key blocks of
    ``key_segments``.  P = exp2(scores - lse / ln 2), zeroed where masked;
    P and dS cast to the inputs' dtype for their products.  Returns
    (dq, dk, dv) in the inputs' dtype."""
    from repro_torch.kernels import flash_attn as fa
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    g = h // n
    dt = q.dtype
    dev = q.device
    qh, doh = q.transpose(1, 2).float(), do.transpose(1, 2).float()
    kh, vh = k.transpose(1, 2).float(), v.transpose(1, 2).float()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # (B, H, S)
    lse2 = lse.float() * fa.LOG2E
    scale = fa.LOG2E / math.sqrt(d)
    dk = torch.zeros((b, n, t, d), device=dev)
    dv = torch.zeros((b, n, t, d), device=dev)
    bm, bn = dkdv_blocks
    for n0 in range(0, t, bn):
        cols = torch.arange(n0, min(n0 + bn, t), device=dev)
        kb, vb = kh[:, :, cols], vh[:, :, cols]               # (B, N, C, D)
        segs = fa.query_segments(n0, s, t, q_offset, causal, window, bm, bn)
        for gi in range(g):
            heads = torch.arange(n, device=dev) * g + gi
            for start, end, masked in segs:
                for m0 in range(start, end, bm):
                    rows = torch.arange(m0, min(m0 + bm, s), device=dev)
                    qb = qh[:, heads][:, :, rows]              # (B, N, R, D)
                    dob = doh[:, heads][:, :, rows]
                    st = kb @ qb.transpose(-1, -2) * scale      # (B, N, C, R)
                    pt = torch.exp2(st - lse2[:, heads][:, :, None, rows])
                    if masked:
                        pt = torch.where(_keep(rows, cols, s, t, q_offset,
                                               causal, window).T, pt, 0.0)
                    dv[:, :, cols] += pt.to(dt).float() @ dob
                    dpt = vb @ dob.transpose(-1, -2)
                    dst = pt * (dpt - delta[:, heads][:, :, None, rows])
                    dk[:, :, cols] += dst.to(dt).float() @ qb
    dk = dk / math.sqrt(d)
    dq = torch.zeros((b, h, s, d), device=dev)
    khh, vhh = kh.repeat_interleave(g, dim=1), vh.repeat_interleave(g, dim=1)
    bm, bn = dq_blocks
    for m0 in range(0, s, bm):
        rows = torch.arange(m0, min(m0 + bm, s), device=dev)
        for start, end, masked in fa.key_segments(m0, s, t, q_offset, causal,
                                                  window, bm, bn):
            for n0 in range(start, end, bn):
                cols = torch.arange(n0, min(n0 + bn, t), device=dev)
                sc = qh[:, :, rows] @ khh[:, :, cols].transpose(-1, -2) * scale
                p = torch.exp2(sc - lse2[:, :, rows, None])
                if masked:
                    p = torch.where(_keep(rows, cols, s, t, q_offset, causal,
                                          window), p, 0.0)
                dp = doh[:, :, rows] @ vhh[:, :, cols].transpose(-1, -2)
                ds = p * (dp - delta[:, :, rows, None])
                dq[:, :, rows] += ds.to(dt).float() @ khh[:, :, cols]
    dq = dq / math.sqrt(d)
    return (dq.transpose(1, 2).to(dt), dk.transpose(1, 2).to(dt),
            dv.transpose(1, 2).to(dt))


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
