"""GQA attention with RoPE or M-RoPE, qk-norm, QKV bias and sliding windows:
the full-sequence forward (training) and the serving paths over a dense
(full or ring) KV cache or a block-paged KV pool, of ``repro.nn.attention``.

Layouts follow the JAX package: ``wq`` (d, H, D), ``wk``/``wv`` (d, N, D),
``wo`` (H, D, d); dense caches (B, W, N, D); pools (P, page_size, N, D).
Decode steps update caches and pools in place (the JAX functions return new
arrays): they are the largest tensors a layer owns, and every caller
replaces its cache with the returned one anyway.

Activations and caches are placed by the JAX function's logical axes
(``constrain``, a no-op without an active mesh).  Under a mesh the cache
writes and the decode kernels run on every rank's local shards
(``repro_torch.sharding.local.run_local``): a dense cache is written where
each rank holds it, and the kernels see whole kv-head groups (the kv-head
dimension sharded where the kv heads divide the mesh axis, replicated
where they do not; a sequence-sharded cache is gathered for them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.nn.rope import apply_mrope, apply_rope
from repro_torch.sharding import local as _local
from repro_torch.sharding.rules import constrain, logical_to_spec, placements

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
    rope: str = "rope"                    # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    q_chunk: int = 512
    ring_cache: bool = False              # windowed decode: cache only the
                                          # last `window` K/V in a ring buffer

    @property
    def q_groups(self):
        if self.num_heads % self.kv_heads:
            raise ValueError(f"{self.num_heads} heads not divisible by "
                             f"{self.kv_heads} kv heads")
        return self.num_heads // self.kv_heads


def specs(cfg: AttnConfig):
    """Logical axes of the attention parameters (``wq``/``wk``/``wv``
    (d, heads, D), ``wo`` (heads, D, d), the biases and qk-norm scales)."""
    s = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        s.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return s


def cache_specs():
    return {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None)}


def paged_cache_specs():
    return {"k": (None, None, "kv_heads", None),
            "v": (None, None, "kv_heads", None)}


def _headwise_rms(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _heads(x, w, axis):
    """``einsum("bsd,dhk->bshk", x, w)``.  Under a mesh every rank projects
    its batch rows onto its block of heads (the heads sharded as the
    logical ``axis`` resolves, column-parallel; the weight gathered over
    its FSDP axis): DTensor's own einsum flattens (h, k) and then cannot
    split a dimension sharded over more ranks than ``h`` divides."""
    mesh = _local.mesh_of(x, w)
    if mesh is None:
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Partial, Shard
    b, s, _ = x.shape
    out = placements(logical_to_spec(("batch", None, axis, None),
                                     (b, s, *w.shape[1:]), mesh), mesh)
    xpl = _local.follow(out, {0: Shard(0)})
    wpl = _local.follow(out, {2: Shard(1)})
    # a rank's part of a gradient: summed over the other ranks' batch rows
    # (the weight) or heads (the input)
    xgrad = tuple(Partial() if p == Shard(2) else q for p, q in zip(out, xpl))
    wgrad = tuple(Partial() if p == Shard(0) else q for p, q in zip(out, wpl))
    return _local.run_local(
        lambda xl, wl: torch.einsum("bsd,dhk->bshk", xl, wl), mesh, out,
        (x, w), (xpl, wpl), (xgrad, wgrad))


def _project_qkv(params, cfg: AttnConfig, x, positions):
    q = _heads(x, params["wq"].to(x.dtype), "heads")
    k = _heads(x, params["wk"].to(x.dtype), "kv_heads")
    v = _heads(x, params["wv"].to(x.dtype), "kv_heads")
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
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


def write_slots(cache, value, slot):
    """``cache[b, slot[b]] = value[b]`` for every row b: cache (B, W, N, D),
    value (B, N, D), slot (B,).  Under a mesh every rank writes the rows it
    holds: the rows whose slot falls in its block of a sequence-sharded
    cache (the others keep their value)."""
    if not _local.is_dtensor(cache):
        value, slot = _local.full(value), _local.full(slot)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot.long()] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Shard
    mesh, have = cache.device_mesh, tuple(cache.placements)
    vpl = _local.follow(have, {0: Shard(0), 2: Shard(1)})
    spl = _local.follow(have, {0: Shard(0)})
    off = _local.shard_offset(mesh, have, 1, cache.to_local().shape[1])

    def write(c, v, s):
        rows = torch.arange(c.shape[0], device=c.device)
        s = s.long() - off
        i = s.clamp(0, c.shape[1] - 1)
        keep = ((s >= 0) & (s < c.shape[1]))[:, None, None]
        c[rows, i] = torch.where(keep, v.to(c.dtype), c[rows, i])

    _local.run_local(write, mesh, None, (cache, value, slot), (have, vpl, spl))


def write_pages(pool, page, off, value):
    """``pool[page, off] = value``: pool (P, ps, N, D), page and off index
    tensors of one shape, value (*that shape, N, D).  Under a mesh every
    rank writes its kv heads of every row (the page axes are never
    sharded)."""
    if not _local.is_dtensor(pool):
        pool[page, off] = _local.full(value).to(pool.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, have = pool.device_mesh, tuple(pool.placements)
    vpl = _local.follow(have, {2: Shard(value.dim() - 2)})
    rep = (Replicate(),) * mesh.ndim

    def write(p, pg, o, v):
        p[pg, o] = v.to(p.dtype)

    _local.run_local(write, mesh, None, (pool, page, off, value),
                     (have, rep, rep, vpl))


def _kernel_layout(mesh, cache_leaf, spec_axes):
    """Placements a decode kernel takes a cache or pool at: the rule-
    resolved ``spec_axes`` (whole kv-head groups: the kv-head dimension
    sharded only where the kv heads divide the axis; the sequence never),
    except on a mesh axis of size one, where a DTensor leaf's own placement
    stands (it places nothing)."""
    want = placements(logical_to_spec(spec_axes, cache_leaf.shape, mesh),
                      mesh)
    if not _local.is_dtensor(cache_leaf):
        return want
    have = tuple(cache_leaf.placements)
    return tuple(h if mesh.size(i) == 1 else w
                 for i, (h, w) in enumerate(zip(have, want)))


def decode_positions(rope: str, pos):
    """A decode step's rotary positions from its (B,) ``pos``: (B, 1), or
    (B, 3, 1) under M-RoPE (a text token: every stream at ``pos``)."""
    positions = pos[:, None]
    if rope == "mrope":
        positions = positions[:, None, :].expand(-1, 3, -1)
    return positions


def attend_full(q, k, v, cfg: AttnConfig, q_offset=0):
    """Exact attention (:func:`_attend_full`).  q: (B, S, H, D), k/v
    (B, T, N, D).  Under a mesh on every rank's batch rows and whole
    kv-head groups (as k is placed; the sequence gathered), autograd
    included."""
    mesh = _local.mesh_of(q, k, v)
    if mesh is None:
        return _attend_full(q, k, v, cfg, q_offset)
    pl = _local.keep_shards(k, mesh, (0, 2))

    def local(ql, kl, vl):
        sub = dataclasses.replace(cfg, num_heads=ql.shape[2],
                                  kv_heads=kl.shape[2])
        return _attend_full(ql, kl, vl, sub, q_offset)

    return _local.run_local(local, mesh, pl, (q, k, v), (pl, pl, pl))


def _attend_full(q, k, v, cfg: AttnConfig, q_offset=0):
    """``ops.flash_attention``: the flash kernel pair on a CUDA tensor, the
    plain chunk loop (``cfg.q_chunk`` queries a chunk) on a CPU one.  One
    ``attention`` span a call: every forward, and every remat recompute in
    a backward pass."""
    with spans.span("attention"):
        return ops.flash_attention(q, k, v, causal=cfg.causal,
                                   window=cfg.window, q_offset=q_offset,
                                   q_chunk=cfg.q_chunk)


def forward(params, cfg: AttnConfig, x, positions):
    """Training / encoding forward.  x: (B, S, D); positions (B, S) or
    (B, 3, S)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = attend_full(q, k, v, cfg)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def cache_len(cfg: AttnConfig, max_len):
    if cfg.ring_cache and cfg.window is not None:
        return min(max_len, cfg.window)
    return max_len


def init_cache(cfg: AttnConfig, batch, max_len, *, dtype, device, stack=None):
    """A zeroed dense cache (B, cache_len, N, D) for K and V (a leading
    ``stack`` axis for stacked layers)."""
    shape = (batch, cache_len(cfg, max_len), cfg.kv_heads, cfg.head_dim)
    if stack is not None:
        shape = (stack, *shape)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pad_seq(t, n):
    """``t`` (B, S, N, D) zero-padded by ``n`` positions at the end of S;
    under a mesh on every rank's shards (the sequence gathered): DTensor's
    ``pad`` fails to plan its redistribution on torch 2.11."""
    pad = lambda u: torch.nn.functional.pad(u, (0, 0, 0, 0, 0, n))  # noqa: E731
    mesh = _local.mesh_of(t)
    if mesh is None:
        return pad(t)
    pl = _local.keep_shards(t, mesh, (0, 2, 3))
    return _local.run_local(pad, mesh, pl, (t,), (pl,))


def prefill(params, cfg: AttnConfig, x, positions, max_len, lengths=None):
    """Forward over a prompt; returns (output, cache).  Full caches are
    length ``max_len``; ring caches keep only the last ``window`` positions,
    stored at slot (absolute position % window).

    ``lengths`` (B,) marks right-padded prompts (row b's real tokens are
    x[b, :lengths[b]]).  Full caches need nothing more: pad K/V past a row's
    length sit at positions its decode mask admits only after they are
    overwritten.  Ring caches do: the roll packing keys slots off the padded
    length, so with ``lengths`` each row is gathered instead: slot j holds
    the K/V of absolute position a_j = (len-1) - ((len-1 - j) mod W) when
    a_j >= 0, else zeros (the roll packing for unpadded input)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = attend_full(q, k, v, cfg)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    s_len = k.shape[1]
    clen = cache_len(cfg, max_len)
    if clen < max_len and lengths is not None:
        w = clen
        j = torch.arange(w, device=x.device)
        last = lengths.long()[:, None] - 1                          # (B, 1)
        a = last - torch.remainder(last - j[None, :], w)            # (B, w)
        valid = (a >= 0)[..., None, None]
        idx = a.clamp(min=0)[..., None, None].expand(
            -1, -1, k.shape[2], k.shape[3])

        def gather(t):
            return torch.where(valid, torch.gather(t, 1, idx),
                               torch.zeros((), dtype=t.dtype, device=t.device))

        cache = {"k": gather(k), "v": gather(v)}
    elif clen < max_len:  # ring: the last `window` tokens, ring-ordered
        w = clen
        if s_len >= w:
            k_last, v_last = k[:, s_len - w:], v[:, s_len - w:]
            shift = (s_len - w) % w
        else:
            pad = (0, 0, 0, 0, 0, w - s_len)
            k_last = torch.nn.functional.pad(k, pad)
            v_last = torch.nn.functional.pad(v, pad)
            shift = 0
        cache = {"k": torch.roll(k_last, shift, dims=1),
                 "v": torch.roll(v_last, shift, dims=1)}
    else:
        cache = {"k": _pad_seq(k, max_len - s_len),
                 "v": _pad_seq(v, max_len - s_len)}
    cache = {kk: constrain(vv, ("batch", "kv_seq", "kv_heads", None))
             for kk, vv in cache.items()}
    return constrain(y, ("batch", None, "embed_act")), cache


def decode_step(params, cfg: AttnConfig, cache, x, pos, positions=None):
    """One token per row against a dense cache (updated in place).  x:
    (B, 1, D); pos: a scalar or (B,) int (the serving engine's per-slot
    path: every row writes its cache and attends at its own position);
    positions: rotary positions (B, 1) or (B, 3, 1) under M-RoPE, pos by
    default.  With a ring cache (``ring_cache`` and a window no shorter
    than the cache) row b writes slot pos % W.

    The attention runs through :func:`repro_torch.kernels.ops.swa_decode_attn`
    (the ``swa_decode`` kernel on the card), which keeps f32 from QK through
    PV.  The JAX function computes it inline with scores from a ``q.dtype``
    product and probabilities cast back to ``q.dtype``: equal in f32, apart
    by bf16 rounding in bf16 (a deliberate deviation, ROADMAP queue 3)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    if positions is None:
        positions = decode_positions(cfg.rope, pos)
    q, k, v = _project_qkv(params, cfg, x, positions)
    t = cache["k"].shape[1]
    ring = cfg.ring_cache and cfg.window is not None and t <= cfg.window
    slot = pos % t if ring else pos
    write_slots(cache["k"], k[:, 0], slot)
    write_slots(cache["v"], v[:, 0], slot)
    out = _dense_attention(q[:, 0], cache["k"], cache["v"], pos,
                           window=cfg.window, ring=ring)
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return constrain(y, ("batch", None, "embed_act")), cache


def _grouped(attend):
    """``attend(qg, kv, ...)`` on q (B, H, D): the heads grouped by kv head
    into (B, N, G, D) (N from the cache's kv-head dimension), the output
    back in (B, H, D)."""

    def run(q, k, *rest):
        b, h, d = q.shape
        n = k.shape[2]
        qg = q.reshape(b, n, h // n, d).contiguous()
        return attend(qg, k, *rest).reshape(b, h, d)

    return run


def _dense_attention(q, k_cache, v_cache, pos, *, window, ring):
    """``ops.swa_decode_attn`` for q (B, H, D) -> (B, H, D); under a mesh on
    every rank's batch rows and whole kv-head groups (q's heads sharded
    with the cache's kv heads)."""
    attend = _grouped(lambda qg, k, v, p: ops.swa_decode_attn(
        qg, k, v, p, window=window, ring=ring))
    mesh = _local.mesh_of(q, k_cache)
    if mesh is None:
        return attend(q, k_cache, v_cache, pos)
    from torch.distributed.tensor import Shard
    kpl = _kernel_layout(mesh, k_cache, ("batch", None, "kv_heads", None))
    qpl = _local.follow(kpl, {0: Shard(0), 2: Shard(1)})
    ppl = _local.follow(kpl, {0: Shard(0)})
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=q.device).expand(q.shape[0])
    return _local.run_local(attend, mesh, qpl, (q, k_cache, v_cache, pos),
                            (qpl, kpl, kpl, ppl))


def _paged_attention(q, k_pool, v_pool, pt, pos, *, window):
    """``ops.paged_decode_attn`` for q (B, H, D) -> (B, H, D); under a mesh
    on every rank's whole kv-head groups and, where the pool is replicated
    over the batch's data axes, its batch rows."""
    attend = _grouped(lambda qg, k, v, t, p: ops.paged_decode_attn(
        qg, k, v, t, p, window=window))
    mesh = _local.mesh_of(q, k_pool)
    if mesh is None:
        return attend(q, k_pool, v_pool, pt, pos)
    from torch.distributed.tensor import Replicate, Shard
    kpl = _kernel_layout(mesh, k_pool, (None, None, "kv_heads", None))
    bspec = logical_to_spec(("batch",), (q.shape[0],), mesh)[0]
    baxes = (bspec,) if isinstance(bspec, str) else (bspec or ())
    names = mesh.mesh_dim_names
    qpl = tuple(Shard(1) if p == Shard(2) else
                Shard(0) if p == Replicate() and names[i] in baxes
                and mesh.size(i) > 1 else Replicate()
                for i, p in enumerate(kpl))
    bpl = _local.follow(qpl, {0: Shard(0)})
    return _local.run_local(attend, mesh, qpl, (q, k_pool, v_pool, pt, pos),
                            (qpl, kpl, kpl, bpl, bpl))


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
    write_pages(pool["k"], page, off, k)
    write_pages(pool["v"], page, off, v)
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
    return constrain(y, ("batch", None, "embed_act")), pool


def paged_decode_step(params, cfg: AttnConfig, pool, pt, x, pos,
                      positions=None, active=None, *, page_size):
    """One token against the block-paged pool.  x: (B, 1, D); pos: (B,)
    int32 per-slot positions; pt: (B, PP) int32 page table.  Rows with
    ``active`` False write their K/V to the trash page: a freed slot's stale
    table may point at pages since granted to another slot.  Attention runs
    through :func:`repro_torch.kernels.ops.paged_decode_attn`."""
    b = x.shape[0]
    if positions is None:
        positions = decode_positions(cfg.rope, pos)
    q, k, v = _project_qkv(params, cfg, x, positions)
    rows = torch.arange(b, device=x.device)
    page = pt.long()[rows, (pos // page_size).long()]
    if active is not None:
        page = torch.where(active, page, 0)
    off = (pos % page_size).long()
    write_pages(pool["k"], page, off, k[:, 0])
    write_pages(pool["v"], page, off, v[:, 0])
    out = _paged_attention(q[:, 0], pool["k"], pool["v"], pt, pos,
                           window=cfg.window)
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return constrain(y, ("batch", None, "embed_act")), pool
