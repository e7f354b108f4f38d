"""Nested containers of tensors (the port's pytrees).

States, parameters and optimizer slots are nested dicts (and tuples or
lists) of tensors with the JAX package's keys; these helpers map over them
as ``jax.tree.map`` does.  ``None`` is an empty subtree.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure filled with ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def stack_trees(trees):
    """Stack a list of identically-structured trees along a new axis 0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def unstack_tree(tree, n):
    """Inverse of :func:`stack_trees`: split axis 0 back into n trees."""
    return [tree_map(lambda l, i=i: l[i], tree) for i in range(n)]


def tree_device(tree) -> torch.device:
    """The device of the first leaf."""
    return tree_leaves(tree)[0].device
