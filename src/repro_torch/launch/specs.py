"""Meta-tensor input stand-ins and sharding assignment for every
(architecture x input shape) combination: the port of
``repro.launch.specs``.  Nothing is allocated: every tensor here is on the
``meta`` device (shapes and dtypes only), where the JAX package has
``ShapeDtypeStruct``\\ s.
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.transformer import LMConfig, Transformer
from repro_torch.sharding.rules import named_sharding, tree_map_axes


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, shape: InputShape):
    """Model-input meta tensors for one input shape."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder:
            batch = {"features": _meta((b, s, cfg.feat_dim), torch.bfloat16),
                     "mask": _meta((b, s), torch.bool)}
        else:
            batch = {"tokens": _meta((b, s), torch.int32)}
            if cfg.is_vlm:
                npatch = min(4096, s // 4)
                batch["vision_embeds"] = _meta((b, npatch, cfg.d_model),
                                               torch.bfloat16)
                batch["vision_positions"] = _meta((b, npatch), torch.int32)
                batch["positions"] = _meta((b, 3, s), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32)
        return batch
    # decode: one token against a seq_len cache
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    return {"token": _meta((b, 1), torch.int32)}


def batch_logical_axes(batch):
    """Logical axes for each model input."""
    table = {
        "tokens": ("batch", None),
        "labels": ("batch", None),
        "features": ("batch", None, None),
        "mask": ("batch", None),
        "vision_embeds": ("batch", None, None),
        "vision_positions": ("batch", None),
        "positions": ("batch", None, None),
        "token": ("batch", None),
    }
    return {k: table[k] for k in batch}


def batch_shardings(batch, mesh):
    axes = batch_logical_axes(batch)
    return {k: named_sharding(axes[k], batch[k].shape, mesh) for k in batch}


def abstract_params(cfg: LMConfig):
    """(meta parameters, logical specs): no allocation."""
    return Transformer.init(cfg, device="meta"), Transformer.specs(cfg)


def abstract_cache(cfg: LMConfig, batch, max_len):
    """(meta dense caches, logical specs)."""
    return (Transformer.init_cache(cfg, batch, max_len, device="meta"),
            Transformer.cache_specs(cfg))


def _shardings(specs, shapes, mesh):
    return tree_map_axes(lambda ax, leaf: named_sharding(ax, leaf.shape, mesh),
                         specs, shapes)


def params_shardings(cfg: LMConfig, mesh):
    """(meta parameters, a tree of ``(mesh, placements)``)."""
    shapes, specs = abstract_params(cfg)
    return shapes, _shardings(specs, shapes, mesh)


def cache_shardings(cfg: LMConfig, batch, max_len, mesh):
    """(meta dense caches, a tree of ``(mesh, placements)``)."""
    shapes, specs = abstract_cache(cfg, batch, max_len)
    return shapes, _shardings(specs, shapes, mesh)


def _leaves_with_keys(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, keys + (k,))
    else:
        yield keys, tree


def param_count(cfg: LMConfig, active_only=False):
    """Total (or MoE-active) parameter count, embeddings excluded (the 6ND
    convention); the active share counts ``top_k`` of ``num_experts``
    experts, the router whole."""
    shapes, _ = abstract_params(cfg)
    total = 0
    for keys, leaf in _leaves_with_keys(shapes):
        if "embed" in keys or "unembed" in keys or "mask_embed" in keys:
            continue
        n = leaf.numel()
        if active_only and cfg.mlp == "moe" and any(
                k in ("w_gate", "w_up", "w_down", "router") for k in keys):
            if "router" not in keys:
                n = n * cfg.top_k // max(cfg.num_experts, 1)
        total += n
    return total
