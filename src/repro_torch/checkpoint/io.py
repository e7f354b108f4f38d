"""Checkpointing: nested trees -> a single .npz (path-flattened) + JSON
metadata, in the JAX package's format.

Round-resumable FL state: {core params/opt, buffer, round index, rng seed,
per-edge sync weights}.  The counterpart of ``repro.checkpoint.io``: a key
is the tree path with dict keys written as is and list or tuple indices as
``#i``, joined by ``/``, so a checkpoint written by either package loads in
the other (the port's trees carry the JAX package's keys,
``repro_torch.interop``).  ``None`` is an empty subtree, as in JAX.
bfloat16 leaves are widened to float32 in the npz (numpy has no bfloat16;
lossless) and cast back to the template leaf's dtype and device on load.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_SEP = "/"


def _flatten_with_path(tree, prefix=()):
    """[(path, leaf)] in the order ``jax.tree_util.tree_flatten_with_path``
    gives: dict keys sorted, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, prefix + (f"#{i}",))
        return out
    return [(prefix, tree)]


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree):
    flat = {}
    for path, leaf in _flatten_with_path(tree):
        arr = _to_numpy(leaf)
        if arr.dtype.kind not in "fiub":  # e.g. bfloat16 -> widen for npz
            arr = arr.astype(np.float32)
        flat[_SEP.join(path)] = arr
    return flat


def save_tree(path, tree, meta=None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    if meta is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f)


def _meta_path(path):
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def _restore_leaf(arr, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(arr).astype(like.dtype)
    return arr


def _unflatten(like, data, prefix=()):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, data, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, data, prefix + (f"#{i}",))
                          for i, v in enumerate(like))
    return _restore_leaf(data[_SEP.join(prefix)], like)


def load_tree(path, like):
    """Restore into the structure of ``like`` (names must match); each leaf
    takes the dtype (and, for a tensor, the device) of its template."""
    p = path if path.endswith(".npz") else path + ".npz"
    with np.load(p) as data:
        return _unflatten(like, data)


def load_meta(path):
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def save_fl_state(path, *, core_params, opt_state, buffer_params, round_idx,
                  rng_seed=None, edge_sync=None, clock=None, extra_meta=None):
    """Round-resumable FL state: {core params/opt, buffer, round index, rng
    seed, per-edge sync weights}.  ``edge_sync`` is a tree of per-edge
    synchronization state (e.g. the core version each edge last synced, or
    the stale weight trees themselves), stored with the model arrays;
    ``rng_seed`` and ``clock`` (the simulator's virtual time) go into the
    JSON metadata."""
    tree = {"core": core_params, "opt": opt_state, "buffer": buffer_params}
    if edge_sync is not None:
        tree["edge_sync"] = edge_sync
    meta = {"round": int(round_idx)}
    if rng_seed is not None:
        meta["rng_seed"] = int(rng_seed)
    if clock is not None:
        meta["clock"] = float(clock)
    if extra_meta:
        meta.update(extra_meta)
    save_tree(path, tree, meta)


def save_live_state(path, *, trainer, engine, extra_meta=None):
    """Fused live-system checkpoint (one npz + JSON): the trainer's carry
    (core state + history ring + mid-round stepper arrays + round cursor),
    the serving engine's carry (slot state + sampling state + swap epoch +
    stream cursor), and any system-level metadata.  Call between
    co-scheduler loop iterations, never mid-tick or mid-swap."""
    t_tree, t_meta = trainer.carry()
    e_tree, e_meta = engine.carry()
    tree = dict(t_tree)
    tree["engine"] = e_tree
    meta = {"trainer": t_meta, "engine": e_meta}
    if extra_meta:
        meta.update(extra_meta)
    save_tree(path, tree, meta)


def load_live_state(path, *, trainer, engine, requests):
    """Inverse of :func:`save_live_state`, in place: ``trainer``/``engine``
    must be freshly constructed from the same configs and seeds (structure
    templates come from them; every value comes from the checkpoint), and
    ``requests`` must be the same arrival stream the saved session was
    begun with.  Returns the checkpoint meta."""
    meta = load_meta(path)
    trainer.restore(path, meta["trainer"])
    engine.restore(path, meta["engine"], requests)
    return meta


def load_fl_state(path, like_core, like_opt, like_buffer, like_edge_sync=None):
    """Inverse of :func:`save_fl_state`.  Returns ``(core, opt, buffer,
    edge_sync, meta)`` where ``meta`` holds at least ``round`` plus the
    optional ``rng_seed`` / ``clock``; ``edge_sync`` is ``None`` unless a
    matching ``like_edge_sync`` structure is given and the checkpoint holds
    one (files saved without it load with ``None``)."""
    like = {"core": like_core, "opt": like_opt, "buffer": like_buffer}
    if like_edge_sync is not None:
        p = path if path.endswith(".npz") else path + ".npz"
        with np.load(p) as data:
            saved = data.files
        if any(k == "edge_sync" or k.startswith("edge_sync" + _SEP)
               for k in saved):
            like["edge_sync"] = like_edge_sync
    tree = load_tree(path, like)
    meta = load_meta(path) or {}
    meta.setdefault("round", 0)
    return (tree["core"], tree["opt"], tree["buffer"],
            tree.get("edge_sync"), meta)
