"""Weights and token batches drawn from the run's seed, on the device.

The benchmark makes the inputs and hands the same to the program and to the
plain reference.  Parameters come in the program's tree, whose leaves the
configuration's architecture module lists (for the dense decoder: nested
dicts, layers stacked on a leading axis, the JAX package's key names), in
the configuration's parameter type, one ``normal_`` call a leaf from a
generator of the leaf's own: any leaf can be drawn again alone, so the
reference and the change norms need no second copy of the model.
"""

from __future__ import annotations

import hashlib

import torch

from benchlib import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mix(*parts) -> int:
    """A 63-bit generator seed from the run's seed and tags."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def dims(conf: dict) -> dict:
    """The configuration's widths (``Run.dims``), as its architecture
    module states them."""
    return spec.architecture(conf).dims(conf)


def program_kwargs(conf: dict) -> dict:
    """The program's ``LMConfig`` fields as the configuration file states
    them (JSON lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in conf["program"].items()}


def leaf_specs(conf: dict):
    """[(path, shape, init)] of every parameter leaf, as the
    configuration's architecture module states them; ``init`` is a float
    standard deviation or "ones"."""
    return spec.architecture(conf).leaf_specs(conf)


def draw_leaf(conf: dict, seed: int, tag: str, index: int, device):
    """Leaf ``index`` of :func:`leaf_specs` for ``(seed, tag)``."""
    path, shape, init = leaf_specs(conf)[index]
    dtype = DTYPES[conf["program"].get("param_dtype", "bfloat16")]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(mix(seed, tag, index))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, init, generator=gen)


def draw_params(conf: dict, seed: int, tag: str, device):
    """The whole parameter tree for ``(seed, tag)``."""
    tree = {}
    for i, (path, _, _) in enumerate(leaf_specs(conf)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = draw_leaf(conf, seed, tag, i, device)
    return tree


def leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def leaf_names(conf: dict):
    return [".".join(p) for p, _, _ in leaf_specs(conf)]


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                device):
    """Training step ``step``'s feed: uniform token ids, (batch, seq + 1)
    drawn on the device, split into inputs and next-token labels."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, "batch", step))
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                        device=device)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}
