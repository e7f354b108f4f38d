"""Decoder LM over stacked per-layer parameters: the full-sequence forward
(training, ``apply``/``apply_hidden``) and the serving paths (dense or ring
KV caches, and the block-paged pool) of ``repro.models.transformer``.

Parameters are nested dicts of tensors with the JAX package's key names,
shapes, layouts and per-leaf dtypes: sub-blocks of the ``block_pattern``
live under ``params["blocks"]["b{i}"]`` stacked on a leading layer axis (a
Python loop over that axis replaces ``lax.scan``), remainder layers under
``"tail{j}"``.  Sub-blocks are attention ("attn", "local"), Mamba-2 SSD
("ssd") and RG-LRU ("rglru"), each with a dense MLP, a Mixture-of-Experts
(``mlp="moe"``, with optional shared experts) or none.  An encoder
(``is_encoder``, hubert) takes feature frames through ``in_proj`` instead
of token ids, with masked frames replaced by ``mask_embed``, and attends
bidirectionally with no rotary positions.

The recurrent sub-blocks run their scans as the JAX package does: the
full-sequence forward (``apply_hidden``, training) through the plain
scans, the serving prefill (``prefill``) through the hand-written ``ssd``
and ``rglru`` kernels on a CUDA tensor (``use_kernel=True``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import rglru as rglru_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.sharding import local as _local
from repro_torch.sharding.rules import constrain

NEG_INF = -1e30

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_ATTENTION = ("attn", "local")


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The fields of the JAX ``LMConfig`` that the port's paths read."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_pattern: tuple = ("attn",)
    mlp: str = "swiglu"              # "swiglu" | "gelu" | "squared_relu" | "none" | "moe"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    causal: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"               # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    window: Optional[int] = None     # window for "local" attention sub-blocks
    sliding_window: Optional[int] = None  # if set, ALL attention is windowed
    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_dim: int = 0
    shared_experts: int = 0
    moe_tokens_per_group: int = 128
    moe_capacity_factor: float = 1.25
    # SSM / RG-LRU
    d_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    d_rnn: Optional[int] = None
    conv_width: int = 4
    is_encoder: bool = False         # hubert: bidirectional, frame inputs
    feat_dim: int = 512              # audio front-end embedding dim
    is_vlm: bool = False             # vision patch embeds scattered into the sequence
    mrope_sections: tuple = (16, 24, 24)
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    remat: str = "block"             # "none" | "block": recompute each
                                     # super-block in the backward pass
    seq_parallel: bool = False       # Megatron-style sequence parallelism:
                                     # residual stream sharded over "model"
                                     # between blocks (under a mesh)
    ring_cache: bool = False
    q_chunk: int = 512
    vocab_pad: int = 256

    @property
    def hd(self):
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self):
        return pad_vocab(self.vocab_size, self.vocab_pad)

    @property
    def n_super(self):
        return self.num_layers // len(self.block_pattern)

    @property
    def n_tail(self):
        return self.num_layers % len(self.block_pattern)

    @property
    def adt(self):
        return DTYPES[self.dtype]

    @property
    def pdt(self):
        return DTYPES[self.param_dtype]

    def attn_cfg(self, local: bool) -> attn_lib.AttnConfig:
        window = self.sliding_window or (self.window if local else None)
        return attn_lib.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            kv_heads=self.kv_heads, head_dim=self.hd, causal=self.causal,
            window=window, qk_norm=self.qk_norm, qkv_bias=self.qkv_bias,
            rope="none" if (self.is_encoder and self.rope == "rope")
            else self.rope, rope_theta=self.rope_theta,
            mrope_sections=self.mrope_sections, q_chunk=self.q_chunk,
            ring_cache=self.ring_cache)

    def ssd_cfg(self) -> ssm_lib.SSDConfig:
        return ssm_lib.SSDConfig(
            d_model=self.d_model, d_state=self.d_state,
            head_dim=self.ssm_head_dim, conv_width=self.conv_width,
            chunk=self.ssm_chunk)

    def rglru_cfg(self) -> rglru_lib.RGLRUConfig:
        return rglru_lib.RGLRUConfig(
            d_model=self.d_model, d_rnn=self.d_rnn or self.d_model,
            conv_width=self.conv_width)

    def moe_cfg(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            d_model=self.d_model, num_experts=self.num_experts,
            top_k=self.top_k, expert_dim=self.expert_dim,
            tokens_per_group=self.moe_tokens_per_group,
            capacity_factor=self.moe_capacity_factor)


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------

def _norm_apply(cfg, p, x):
    if cfg.norm == "layernorm":
        return L.layernorm(p, x)
    return L.rmsnorm(p, x)


def _dense_mlp_apply(cfg: LMConfig, p, x):
    up = constrain(L.dense(p["up"], x), ("batch", None, "mlp"))
    if "gate" in p:
        gate = constrain(L.dense(p["gate"], x), ("batch", None, "mlp"))
        h = L.swiglu(gate, up)
    elif cfg.mlp == "squared_relu":
        h = L.squared_relu(up)
    else:
        h = L.gelu(up)
    return L.dense(p["down"], h)


def _mlp_apply(cfg: LMConfig, p, x):
    """Returns (y, aux_loss): the MoE's Switch loss, 0.0 for a dense MLP."""
    if cfg.mlp == "none":
        return torch.zeros_like(x), 0.0
    if cfg.mlp == "moe":
        y, aux = moe_lib.forward({k: v for k, v in p.items() if k != "shared"},
                                 cfg.moe_cfg(), x)
        if "shared" in p:
            y = y + _dense_mlp_apply(cfg, p["shared"], x)
        return y, aux
    return _dense_mlp_apply(cfg, p, x), 0.0


def _recurrent(cfg: LMConfig, kind: str):
    """(module, config) of a recurrent sub-block kind."""
    if kind == "ssd":
        return ssm_lib, cfg.ssd_cfg()
    if kind == "rglru":
        return rglru_lib, cfg.rglru_cfg()
    raise ValueError(kind)


def _mixer_apply(cfg: LMConfig, kind: str, p, x, positions):
    """The full-sequence mixer.  Recurrent blocks take the plain scans
    (``use_kernel=False``), as the JAX model does: autograd runs through
    them, on the card too."""
    if kind in _ATTENTION:
        return attn_lib.forward(p, cfg.attn_cfg(kind == "local"), x, positions)
    lib, sub = _recurrent(cfg, kind)
    return lib.forward(p, sub, x, use_kernel=False)


def _subblock_fwd(cfg: LMConfig, kind: str, p, x, positions):
    """One sub-block of the full-sequence forward: (x, aux_loss).  Under a
    mesh the residual stream is placed as the JAX function places it: with
    ``seq_parallel`` sequence-sharded over "model" (each mixer and MLP
    output, a partial sum over that axis, is placed there before the
    residual add: a reduce-scatter rather than an all-reduce)."""
    res = ("batch", "seq_sp" if cfg.seq_parallel else None, "embed_act")
    y = _mixer_apply(cfg, kind, p["mixer"], _norm_apply(cfg, p["ln1"], x),
                     positions)
    x = constrain(x, res) + constrain(y, res)
    aux = 0.0
    if cfg.mlp != "none":
        m, aux = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
        x = x + constrain(m, res)
    return x, aux


def _subblock_cache_init(cfg: LMConfig, kind: str, batch, max_len, device,
                         stack=None):
    """Attention K/V in the activation dtype; recurrent state (conv windows
    included) in f32, as the JAX function builds them."""
    if kind in _ATTENTION:
        return attn_lib.init_cache(cfg.attn_cfg(kind == "local"), batch,
                                   max_len, dtype=cfg.adt, device=device,
                                   stack=stack)
    lib, sub = _recurrent(cfg, kind)
    return lib.init_cache(sub, batch, device=device, stack=stack)


def _subblock_decode(cfg: LMConfig, kind: str, p, cache, x, pos, positions):
    """One token through a sub-block; ``cache`` (the layer's views of the
    stacked caches) is updated in place.  Attention writes its row there
    itself; the recurrent steps return new state, copied back here."""
    h = _norm_apply(cfg, p["ln1"], x)
    if kind in _ATTENTION:
        y, _ = attn_lib.decode_step(p["mixer"], cfg.attn_cfg(kind == "local"),
                                    cache, h, pos, positions)
    else:
        lib, sub = _recurrent(cfg, kind)
        y, new = lib.decode_step(p["mixer"], sub, cache, h)
        for key, value in new.items():
            cache[key].copy_(value)
    x = x + y
    if cfg.mlp != "none":
        m, _ = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
        x = x + m
    return x, cache


def _scatter_rows(x, idx, values):
    """``x[b, idx[b, j]] = values[b, j]``: x (B, S, D), idx (B, P), values
    (B, P, D); returns x (written in place).  Under a mesh every rank
    writes the batch rows it holds (only x's batch may be sharded) into a
    new tensor, which autograd can differentiate."""
    if not _local.is_dtensor(x):
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x[rows, idx.long()] = values
        return x
    from torch.distributed.tensor import Shard
    mesh, have = x.device_mesh, tuple(x.placements)
    if any(p.is_shard() and p.dim != 0 for p in have):
        raise NotImplementedError(
            f"vision scatter into a tensor placed {have}: only the batch "
            "may be sharded")
    ipl = _local.follow(have, {0: Shard(0)})

    def scatter(xl, il, vl):
        rows = torch.arange(xl.shape[0], device=xl.device)[:, None]
        return xl.index_put((rows, il.long()), vl.to(xl.dtype))

    return _local.run_local(scatter, mesh, have, (x, idx, values),
                            (have, ipl, ipl))


def attention_only(cfg: LMConfig) -> bool:
    """True when every sub-block is attention (no recurrent state): such a
    model can page its KV cache and prefill right-padded prompts."""
    return all(k in _ATTENTION for k in cfg.block_pattern)


def _assert_pageable(cfg: LMConfig):
    """Paged KV caching covers attention state only: recurrent sub-blocks
    carry dense per-slot state (no pages to share), and ring caches already
    bound their own memory."""
    if not attention_only(cfg):
        raise ValueError(
            f"paged KV cache needs an attention-only block_pattern; "
            f"{cfg.block_pattern} has recurrent sub-blocks")
    if cfg.ring_cache:
        raise ValueError("paged KV cache and ring_cache are exclusive — "
                         "the page pool replaces the ring buffer")


def _paged_subblock_decode(cfg: LMConfig, kind: str, p, pool, pt, x, pos,
                           positions, active, page_size):
    h = _norm_apply(cfg, p["ln1"], x)
    y, pool = attn_lib.paged_decode_step(
        p["mixer"], cfg.attn_cfg(kind == "local"), pool, pt, h, pos,
        positions, active, page_size=page_size)
    x = x + y
    if cfg.mlp != "none":
        m, _ = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
        x = x + m
    return x, pool


def _index(tree, i):
    """Layer ``i`` of a stacked parameter or pool subtree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree):
    """Per-layer views of a stacked subtree, one ``unbind`` a leaf.  Its
    backward stacks the layers' gradients once; indexing layer by layer
    (``_index``) would instead add a zero-padded gradient of the whole stack
    for every layer, L² traffic in a training step."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _sub_blocks(cfg: LMConfig, params, caches):
    """(kind, layer params, layer cache or pool) in layer order: stacked
    super-blocks first, then the tail."""
    pat = cfg.block_pattern
    for layer in range(cfg.n_super):
        for i, kind in enumerate(pat):
            yield (kind, _index(params["blocks"][f"b{i}"], layer),
                   _index(caches["blocks"][f"b{i}"], layer))
    for j in range(cfg.n_tail):
        yield pat[j % len(pat)], params[f"tail{j}"], caches[f"tail{j}"]


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def _norm_init(cfg: LMConfig, stack, device):
    shape = (cfg.d_model,) if stack is None else (stack, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=cfg.pdt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.pdt, device=device)
    return p


def _attn_init(cfg: LMConfig, kind: str, stack, draw):
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    a = cfg.attn_cfg(kind == "local")
    d, h, n, hd = cfg.d_model, a.num_heads, a.kv_heads, a.head_dim
    std = 1.0 / math.sqrt(d)
    mixer = {"wq": draw(sh(d, h, hd), std), "wk": draw(sh(d, n, hd), std),
             "wv": draw(sh(d, n, hd), std), "wo": draw(sh(h, hd, d), std)}
    full = lambda value, *s: torch.full(sh(*s), value, dtype=cfg.pdt,  # noqa: E731
                                        device=draw.device)
    if a.qkv_bias:
        mixer.update(bq=full(0, h, hd), bk=full(0, n, hd), bv=full(0, n, hd))
    if a.qk_norm:
        mixer.update(q_norm=full(1, hd), k_norm=full(1, hd))
    return mixer


def _dense_mlp_init(cfg: LMConfig, ff, stack, draw):
    """``up``, ``gate`` (gated MLPs: swiglu, and MoE's shared experts) and
    ``down``, drawn in that order."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    d = cfg.d_model
    std = 1.0 / math.sqrt(d)
    mlp = {"up": {"w": draw(sh(d, ff), std)}}
    if cfg.mlp in ("swiglu", "moe"):
        mlp["gate"] = {"w": draw(sh(d, ff), std)}
    mlp["down"] = {"w": draw(sh(ff, d), 1.0 / math.sqrt(ff))}
    return mlp


def _mlp_init(cfg: LMConfig, stack, draw):
    if cfg.mlp != "moe":
        return _dense_mlp_init(cfg, cfg.d_ff, stack, draw)
    mlp = moe_lib.init(cfg.moe_cfg(), draw.gen, draw.device, stack=stack,
                       dtype=cfg.pdt)
    if cfg.shared_experts:
        mlp["shared"] = _dense_mlp_init(
            cfg, cfg.expert_dim * cfg.shared_experts, stack, draw)
    return mlp


def _subblock_init(cfg: LMConfig, kind: str, stack, draw):
    if kind in _ATTENTION:
        mixer = _attn_init(cfg, kind, stack, draw)
    else:
        lib, sub = _recurrent(cfg, kind)
        mixer = lib.init(sub, draw.gen, draw.device, stack=stack,
                         dtype=cfg.pdt)
    p = {"ln1": _norm_init(cfg, stack, draw.device), "mixer": mixer}
    if cfg.mlp == "none":
        return p
    p["ln2"], p["mlp"] = (_norm_init(cfg, stack, draw.device),
                          _mlp_init(cfg, stack, draw))
    return p


def _dense_mlp_specs(cfg: LMConfig):
    s = {"up": L.dense_specs()}
    if cfg.mlp in ("swiglu", "moe"):
        s["gate"] = L.dense_specs()
    s["down"] = L.dense_specs("mlp", "embed")
    return s


def _subblock_specs(cfg: LMConfig, kind: str):
    """Logical axes of one (unstacked) sub-block's parameters."""
    if kind in _ATTENTION:
        mixer = attn_lib.specs(cfg.attn_cfg(kind == "local"))
    else:
        lib, sub = _recurrent(cfg, kind)
        mixer = lib.specs(sub)
    s = {"ln1": L.norm_specs(cfg.norm), "mixer": mixer}
    if cfg.mlp == "none":
        return s
    if cfg.mlp == "moe":
        mlp = moe_lib.specs(cfg.moe_cfg())
        if cfg.shared_experts:
            mlp["shared"] = _dense_mlp_specs(cfg)
    else:
        mlp = _dense_mlp_specs(cfg)
    s["ln2"], s["mlp"] = L.norm_specs(cfg.norm), mlp
    return s


def _subblock_cache_specs(cfg: LMConfig, kind: str):
    if kind in _ATTENTION:
        return attn_lib.cache_specs()
    return _recurrent(cfg, kind)[0].cache_specs()


def _layer_tree(cfg: LMConfig, one):
    """{"blocks": {"b{i}": one(kind) with "layers" prepended}, "tail{j}":
    one(kind)}: the tree shape of the params, caches and pools."""
    pat = cfg.block_pattern
    tree = {}
    if cfg.n_super > 0:
        tree["blocks"] = {f"b{i}": L.stacked(one(kind))
                          for i, kind in enumerate(pat)}
    for j in range(cfg.n_tail):
        tree[f"tail{j}"] = one(pat[j % len(pat)])
    return tree


class _Draw:
    """Truncated-normal parameter draws from one seeded generator (none on
    the ``meta`` device, where nothing is drawn)."""

    def __init__(self, cfg: LMConfig, device, seed):
        self.cfg, self.device = cfg, device
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def __call__(self, shape, std):
        return L.trunc_normal(shape, std, self.cfg.pdt, self.device, self.gen)


class Transformer:
    """Namespace of functions over (cfg, params), as in the JAX package."""

    @staticmethod
    def init(cfg: LMConfig, seed: int = 0, *, device="cuda"):
        """Random parameters with the JAX package's tree, shapes and init
        distributions, drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (so the values differ from the JAX init).
        An encoder gets ``in_proj`` (feat_dim -> d_model, with a zero bias)
        and a zero ``mask_embed`` in place of the embedding table."""
        device = resolve_device(device)
        draw = _Draw(cfg, device, seed)
        if cfg.is_encoder:
            p = {"in_proj": {
                     "w": draw((cfg.feat_dim, cfg.d_model),
                               1.0 / math.sqrt(cfg.feat_dim)),
                     "b": torch.zeros(cfg.d_model, dtype=cfg.pdt,
                                      device=device)},
                 "mask_embed": torch.zeros(cfg.feat_dim, dtype=cfg.pdt,
                                           device=device)}
        else:
            p = {"embed": {"table": draw((cfg.padded_vocab, cfg.d_model),
                                         0.02)}}
        if cfg.n_super > 0:
            p["blocks"] = {f"b{i}": _subblock_init(cfg, kind, cfg.n_super, draw)
                           for i, kind in enumerate(cfg.block_pattern)}
        for j in range(cfg.n_tail):
            kind = cfg.block_pattern[j % len(cfg.block_pattern)]
            p[f"tail{j}"] = _subblock_init(cfg, kind, None, draw)
        p["ln_f"] = _norm_init(cfg, None, device)
        p["unembed"] = {"w": draw((cfg.d_model, cfg.padded_vocab),
                                  1.0 / math.sqrt(cfg.d_model))}
        return p

    @staticmethod
    def specs(cfg: LMConfig):
        """The logical spec tree of :meth:`init`'s parameters (the second
        value of the JAX ``Transformer.init``): each leaf a tuple of
        logical axis names, "layers" first on stacked blocks."""
        s = {}
        if cfg.is_encoder:
            s["in_proj"] = L.dense_specs(None, "embed", use_bias=True)
            s["mask_embed"] = (None,)
        else:
            s["embed"] = {"table": ("vocab", "embed")}
        s.update(_layer_tree(cfg, lambda kind: _subblock_specs(cfg, kind)))
        s["ln_f"] = L.norm_specs(cfg.norm)
        s["unembed"] = L.dense_specs("embed", "vocab")
        return s

    @staticmethod
    def cache_specs(cfg: LMConfig):
        """The logical spec tree of :meth:`init_cache`'s caches."""
        return _layer_tree(cfg, lambda kind: _subblock_cache_specs(cfg, kind))

    @staticmethod
    def paged_cache_specs(cfg: LMConfig):
        """The logical spec tree of :meth:`init_paged_cache`'s pools."""
        return _layer_tree(cfg, lambda kind: attn_lib.paged_cache_specs())

    # -- shared plumbing ----------------------------------------------------

    @staticmethod
    def _embed_inputs(cfg: LMConfig, params, batch):
        """Token embeddings, with a VLM's ``vision_embeds`` (B, P, d)
        written over the rows ``vision_positions`` (B, P) names, or an
        encoder's ``features`` (B, S, feat_dim) through ``in_proj``, the
        frames where ``batch["mask"]`` (B, S) is true replaced by
        ``mask_embed``; and the rotary positions: ``batch["positions"]``,
        else the token index, (B, S), or (B, 3, S) under M-RoPE."""
        if cfg.is_encoder:
            feats = batch["features"].to(cfg.adt)
            if "mask" in batch:
                feats = torch.where(batch["mask"][..., None].bool(),
                                    params["mask_embed"].to(cfg.adt), feats)
            x = L.dense(params["in_proj"], feats)
        else:
            x = L.embedding(params["embed"], batch["tokens"]).to(cfg.adt)
        x = constrain(x, ("batch", None, "embed_act"))
        if cfg.is_vlm and "vision_embeds" in batch:
            x = _scatter_rows(x, batch["vision_positions"],
                              batch["vision_embeds"].to(cfg.adt))
        positions = batch.get("positions")
        if positions is None:
            bsz, slen = x.shape[0], x.shape[1]
            positions = torch.arange(slen, dtype=torch.int32,
                                     device=x.device).expand(bsz, slen)
            if cfg.rope == "mrope":
                positions = positions[:, None, :].expand(bsz, 3, slen)
        return x, positions

    @staticmethod
    def _unembed(cfg: LMConfig, params, x):
        x = _norm_apply(cfg, params["ln_f"], x)
        logits = constrain(L.dense(params["unembed"], x).float(),
                           ("batch", None, "vocab"))
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab,
                               device=x.device) >= cfg.vocab_size
            logits = logits.masked_fill_(pad, NEG_INF)
        return logits

    # -- full-sequence forward (train / prefill trunk) ----------------------

    @staticmethod
    def apply_hidden(cfg: LMConfig, params, batch):
        """-> (final hidden states (B, S, D) before ``ln_f``, aux_loss f32
        scalar: the MoE layers' Switch losses summed).  With ``remat ==
        "block"`` and gradients on, each super-block runs under
        ``torch.utils.checkpoint`` (its activations are recomputed in the
        backward pass, as ``jax.checkpoint`` does: memory, not numbers)."""
        x, positions = Transformer._embed_inputs(cfg, params, batch)
        pat = cfg.block_pattern
        stacked = ({b: _unstack(p) for b, p in params["blocks"].items()}
                   if cfg.n_super > 0 else {})

        def super_fwd(x, layer):
            aux = 0.0
            for i, kind in enumerate(pat):
                x, a = _subblock_fwd(cfg, kind, stacked[f"b{i}"][layer], x,
                                     positions)
                aux = aux + a
            return x, torch.as_tensor(aux, dtype=torch.float32,
                                      device=x.device)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for layer in range(cfg.n_super):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    super_fwd, x, layer, use_reentrant=False)
            else:
                x, a = super_fwd(x, layer)
            aux = aux + a
        for j in range(cfg.n_tail):
            x, a = _subblock_fwd(cfg, pat[j % len(pat)], params[f"tail{j}"],
                                 x, positions)
            aux = aux + a
        return x, aux

    @staticmethod
    def logits_from_hidden(cfg: LMConfig, params, hidden):
        return Transformer._unembed(cfg, params, hidden)

    @staticmethod
    def apply(cfg: LMConfig, params, batch):
        """-> (logits (B, S, V_pad) f32, aux_loss f32 scalar)."""
        x, aux = Transformer.apply_hidden(cfg, params, batch)
        return Transformer._unembed(cfg, params, x), aux

    # -- dense decode path (the dense ServeEngine) ---------------------------

    @staticmethod
    def init_cache(cfg: LMConfig, batch, max_len, *, device):
        """Zeroed dense caches in the tree shape of the params: (layers, B,
        W, N, D) K and V under "blocks", (B, W, N, D) for tails, W the
        cache length (``max_len``, or the window for a ring cache); f32
        recurrent state and conv windows for "ssd" and "rglru" blocks."""
        caches = {}
        if cfg.n_super > 0:
            caches["blocks"] = {
                f"b{i}": _subblock_cache_init(cfg, kind, batch, max_len,
                                              device, stack=cfg.n_super)
                for i, kind in enumerate(cfg.block_pattern)}
        for j in range(cfg.n_tail):
            kind = cfg.block_pattern[j % len(cfg.block_pattern)]
            caches[f"tail{j}"] = _subblock_cache_init(cfg, kind, batch,
                                                      max_len, device)
        return caches

    @staticmethod
    def decode_step(cfg: LMConfig, params, caches, token, pos, positions=None):
        """One token per row against the dense caches (updated in place).
        token: (B, 1) int; pos: a scalar or (B,) int32, every row at its own
        position; positions: rotary positions (B, 1), or (B, 3, 1) under
        M-RoPE, pos by default."""
        x, _ = Transformer._embed_inputs(cfg, params, {"tokens": token})
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=x.device).expand(x.shape[0])
        if positions is None:
            positions = attn_lib.decode_positions(cfg.rope, pos)
        for kind, p, cache in _sub_blocks(cfg, params, caches):
            x, _ = _subblock_decode(cfg, kind, p, cache, x, pos, positions)
        return Transformer._unembed(cfg, params, x), caches

    @staticmethod
    def prefill(cfg: LMConfig, params, batch, max_len, lengths=None):
        """Run the prompt and build fresh dense caches (the tree of
        :meth:`init_cache`); returns (logits, caches).

        ``lengths`` (B,) marks right-padded prompts (the engine's bucketed
        prefill): attention caches are padding-safe (ring caches are packed
        length-aware, full-cache pad K/V is never attended), recurrent
        state would not be, so padded prefill is rejected for ssd/rglru
        blocks as in the JAX package."""
        if lengths is not None and not attention_only(cfg):
            raise ValueError(
                "padded (bucketed) prefill needs length-aware recurrent "
                f"state handling; block_pattern {cfg.block_pattern} has "
                "recurrent sub-blocks — prefill each prompt at its exact "
                "length instead (lengths=None)")
        x, positions = Transformer._embed_inputs(cfg, params, batch)

        def block_prefill(p, kind, x):
            h = _norm_apply(cfg, p["ln1"], x)
            if kind in _ATTENTION:
                y, c = attn_lib.prefill(p["mixer"],
                                        cfg.attn_cfg(kind == "local"), h,
                                        positions, max_len, lengths=lengths)
                c = {k: v.to(cfg.adt) for k, v in c.items()}
            else:   # f32 state, conv windows in h's dtype
                lib, sub = _recurrent(cfg, kind)
                y, c = lib.forward(p["mixer"], sub, h, use_kernel=True,
                                   return_cache=True)
            x = x + y
            if cfg.mlp != "none":
                m, _ = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
                x = x + m
            return x, c

        caches = {}
        pat = cfg.block_pattern
        if cfg.n_super > 0:
            per_layer = {f"b{i}": [] for i in range(len(pat))}
            for layer in range(cfg.n_super):
                for i, kind in enumerate(pat):
                    x, c = block_prefill(
                        _index(params["blocks"][f"b{i}"], layer), kind, x)
                    per_layer[f"b{i}"].append(c)
            caches["blocks"] = {
                b: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                for b, cs in per_layer.items()}
        for j in range(cfg.n_tail):
            x, caches[f"tail{j}"] = block_prefill(
                params[f"tail{j}"], pat[j % len(pat)], x)
        return Transformer._unembed(cfg, params, x), caches

    # -- block-paged decode path (the paged ServeEngine) ---------------------

    @staticmethod
    def init_paged_cache(cfg: LMConfig, num_pages, page_size, *, device):
        """Per-layer physical page pools in the tree shape of the params
        ((layers, P, ps, N, D) under "blocks", (P, ps, N, D) for tails).
        One page table indexes every layer's pool."""
        _assert_pageable(cfg)
        kw = dict(dtype=cfg.adt, device=device)
        caches = {}
        if cfg.n_super > 0:
            caches["blocks"] = {
                f"b{i}": attn_lib.init_paged_cache(
                    cfg.attn_cfg(kind == "local"), num_pages, page_size,
                    stack=cfg.n_super, **kw)
                for i, kind in enumerate(cfg.block_pattern)}
        for j in range(cfg.n_tail):
            kind = cfg.block_pattern[j % len(cfg.block_pattern)]
            caches[f"tail{j}"] = attn_lib.init_paged_cache(
                cfg.attn_cfg(kind == "local"), num_pages, page_size, **kw)
        return caches

    @staticmethod
    def paged_decode_step(cfg: LMConfig, params, caches, pt, token, pos,
                          active=None, *, page_size):
        """One token per slot against the paged pools (updated in place).
        token: (B, 1) int; pos: (B,) int32; pt: (B, PP) int32; ``active``
        (B,) bool redirects inactive rows' cache writes to the trash page."""
        x, _ = Transformer._embed_inputs(cfg, params, {"tokens": token})
        positions = attn_lib.decode_positions(cfg.rope, pos)
        for kind, p, pool in _sub_blocks(cfg, params, caches):
            x, _ = _paged_subblock_decode(cfg, kind, p, pool, pt, x, pos,
                                          positions, active, page_size)
        return Transformer._unembed(cfg, params, x), caches

    @staticmethod
    def paged_prefill(cfg: LMConfig, params, batch, caches, pt, lengths,
                      fill, n_prefix_pages, page_size):
        """Prompt-suffix prefill into the paged pools (updated in place) for
        one admission group sharing ``n_prefix_pages``.  ``batch["tokens"]``
        holds the right-padded suffixes and ``batch["positions"]`` their
        absolute positions; returns suffix logits and the pools."""
        x, positions = Transformer._embed_inputs(cfg, params, batch)
        for kind, p, pool in _sub_blocks(cfg, params, caches):
            h = _norm_apply(cfg, p["ln1"], x)
            y, _ = attn_lib.paged_prefill(
                p["mixer"], cfg.attn_cfg(kind == "local"), h, positions,
                pool, pt, lengths, fill, n_prefix_pages, page_size)
            x = x + y
            if cfg.mlp != "none":
                m, _ = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
                x = x + m
        return Transformer._unembed(cfg, params, x), caches
