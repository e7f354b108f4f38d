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
