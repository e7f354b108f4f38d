"""GQA attention with RoPE, qk-norm and sliding windows over a block-paged
KV pool (the paged-serving half of ``repro.nn.attention``).

Layouts follow the JAX package: ``wq`` (d, H, D), ``wk``/``wv`` (d, N, D),
``wo`` (H, D, d); pools (P, page_size, N, D).  Pools are updated in place
(the JAX functions return new arrays): a pool is the largest tensor a layer
owns, and every caller replaces its pool with the returned one anyway.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # sliding window (None = full)
    qk_norm: bool = False                 # qwen3-style per-head RMS norm
    qkv_bias: bool = False                # qwen1.5-style bias
    rope: str = "rope"                    # "rope" | "none" (M-RoPE not ported)
    rope_theta: float = 10000.0
    q_chunk: int = 512

    @property
    def q_groups(self):
        if self.num_heads % self.kv_heads:
            raise ValueError(f"{self.num_heads} heads not divisible by "
                             f"{self.kv_heads} kv heads")
        return self.num_heads // self.kv_heads


def _headwise_rms(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _project_qkv(params, cfg: AttnConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dnk->bsnk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnk->bsnk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _headwise_rms(q, params["q_norm"])
        k = _headwise_rms(k, params["k_norm"])
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")
    return q, k, v


def _attend_chunk(q, k, v, q_pos, k_pos, cfg: AttnConfig):
    """q: (B, Q, N, G, D); k/v: (B, T, N, D); positions 1-D per side."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = torch.einsum("bqngd,btnd->bngqt", q, k) * scale
    scores = scores.float()
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if cfg.causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if cfg.window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - cfg.window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bngqt,btnd->bqngd", probs, v)


def attend_full(q, k, v, cfg: AttnConfig, q_offset=0):
    """Exact attention, chunked over queries.  q: (B, S, H, D), k/v
    (B, T, N, D)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    n, g = cfg.kv_heads, cfg.q_groups
    qg = q.reshape(b, s, n, g, d)
    chunk = min(cfg.q_chunk, s)
    if s % chunk != 0:
        chunk = s  # no chunking for ragged sizes
    k_pos = torch.arange(t, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        q_pos = q_offset + start + torch.arange(chunk, device=q.device)
        outs.append(_attend_chunk(qg[:, start:start + chunk], k, v, q_pos,
                                  k_pos, cfg))
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def init_paged_cache(cfg: AttnConfig, num_pages, page_size, *, dtype, device,
                     stack=None):
    """One block-paged KV pool (a leading ``stack`` axis for stacked
    layers).  Page 0 is the trash page (never attended)."""
    shape = (num_pages, page_size, cfg.kv_heads, cfg.head_dim)
    if stack is not None:
        shape = (stack, *shape)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_prefill(params, cfg: AttnConfig, x, positions, pool, pt, lengths,
                  fill, n_prefix_pages, page_size):
    """Prompt-suffix forward against a block-paged pool.

    ``x`` (B, L, D) embeds the right-padded prompt suffixes of one admission
    group; every row shares ``n_prefix_pages`` of prefix-cache hits, so its
    suffix starts at absolute position ``start = n_prefix_pages *
    page_size``.  The suffix K/V is scattered into the pool first (rows past
    ``lengths`` or with ``fill`` False go to the trash page, where their
    colliding writes are harmless because page 0 is never attended), then
    the prefix pages are gathered back and attention runs over [prefix,
    suffix] at absolute positions.  Scatter before gather lets a deeper
    prefix group admitted later in the same tick see pages this one wrote."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    b, s_len = x.shape[0], x.shape[1]
    start = n_prefix_pages * page_size
    dev = x.device
    apos = start + torch.arange(s_len, device=dev)
    valid = fill[:, None] & (torch.arange(s_len, device=dev)[None, :]
                             < lengths[:, None])
    # Pad columns of a capped bucket may run past the table: clamp them (they
    # are redirected to the trash page below either way).
    cols = (apos // page_size).clamp(max=pt.shape[1] - 1)
    page = torch.where(valid, pt.long()[:, cols], 0)
    off = (apos % page_size)[None, :].expand(b, s_len)
    pool["k"][page, off] = k.to(pool["k"].dtype)
    pool["v"][page, off] = v.to(pool["v"].dtype)
    if n_prefix_pages:
        def gather(p):
            g = p[pt[:, :n_prefix_pages].long()]           # (B, npp, ps, N, D)
            return g.reshape(b, start, cfg.kv_heads, cfg.head_dim).to(q.dtype)
        kc = torch.cat([gather(pool["k"]), k], dim=1)
        vc = torch.cat([gather(pool["v"]), v], dim=1)
        # key j of the concat sits at absolute position j; q_offset aligns q
        out = attend_full(q, kc, vc, cfg, q_offset=start)
    else:
        out = attend_full(q, k, v, cfg)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, pool


def paged_decode_step(params, cfg: AttnConfig, pool, pt, x, pos,
                      positions=None, active=None, *, page_size):
    """One token against the block-paged pool.  x: (B, 1, D); pos: (B,)
    int32 per-slot positions; pt: (B, PP) int32 page table.  Rows with
    ``active`` False write their K/V to the trash page: a freed slot's stale
    table may point at pages since granted to another slot.  Attention runs
    through :func:`repro_torch.kernels.ops.paged_decode_attn`."""
    b = x.shape[0]
    if positions is None:
        positions = pos[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    rows = torch.arange(b, device=x.device)
    page = pt.long()[rows, (pos // page_size).long()]
    if active is not None:
        page = torch.where(active, page, 0)
    off = (pos % page_size).long()
    pool["k"][page, off] = k[:, 0].to(pool["k"].dtype)
    pool["v"][page, off] = v[:, 0].to(pool["v"].dtype)
    qg = q[:, 0].reshape(b, cfg.kv_heads, cfg.q_groups,
                         cfg.head_dim).contiguous()
    out = ops.paged_decode_attn(qg, pool["k"], pool["v"], pt, pos,
                                window=cfg.window)
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, pool
