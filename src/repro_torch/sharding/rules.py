"""Logical-axis sharding rules on ``DeviceMesh``/``DTensor``: the port of
``repro.sharding.rules``.

Every parameter, cache and activation dimension is annotated with a
*logical* axis name ("vocab", "embed", "heads", ...).  A ``LogicalRules``
object maps each logical name to an ordered list of *candidate* mesh-axis
tuples; the first candidate whose axes are all in the mesh, unused by
another dimension of the same tensor, and whose total size divides the
dimension is chosen, else the dimension is replicated.  That is what lets a
fixed (data=16, model=16) mesh host a model whose head count does not
divide 16 (heads replicate, mlp and vocab still shard).

A resolved spec is a tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of names (as a JAX ``PartitionSpec``).
:func:`placements` turns it into DTensor placements, and :func:`constrain`
applies it to an activation under the mesh :func:`mesh_context
<repro_torch.launch.mesh.mesh_context>` made active (a no-op without one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Mapping: logical axis name -> ordered candidates (tuples of mesh
    axes)."""

    rules: Mapping[str, Sequence[tuple[str, ...]]]

    def candidates(self, name: str) -> Sequence[tuple[str, ...]]:
        return self.rules.get(name, ())


# The production rule set.  "pod" is used jointly with "data" for the batch
# when present (multi-pod data parallelism); "embed" is the FSDP axis.
_COMMON = {
    "batch": [("pod", "data"), ("data",)],
    "seq": [],                        # activations: sequence stays unsharded
    "seq_sp": [("model",)],           # Megatron-style sequence parallelism
    "kv_seq": [("model",)],           # long-context KV caches: shard sequence
    "vocab": [("model",)],
    "embed": [("data",)],             # FSDP: param d_model dim over data axis
    "embed_act": [],                  # activation d_model dim: replicated
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "mlp": [("model",)],
    "experts": [("model",)],
    "expert_mlp": [],
    "rnn": [("model",)],              # RG-LRU / SSD inner width
    "state": [],                      # SSM state dim
    "conv": [],
    "layers": [],
    "stack": [],
    "norm": [],
    "classes": [],
    "groups": [("data",)],            # MoE dispatch groups
    "capacity": [],
    "window": [],
    "patch": [],
}

DEFAULT_RULES = LogicalRules(_COMMON)
# The same rules: "pod" candidates activate where the mesh has that axis.
MULTIPOD_RULES = DEFAULT_RULES


class Spec(tuple):
    """A resolved spec: one entry per tensor dimension, ``None``, a mesh
    axis name or a tuple of names (the port's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def is_axes(x) -> bool:
    """True for a leaf of a logical spec tree: a tuple of axis names."""
    return isinstance(x, tuple) and not isinstance(x, Spec) and all(
        isinstance(e, (str, type(None))) for e in x)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a port ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(logical_axes: Sequence[str | None], shape: Sequence[int],
                    mesh, rules: LogicalRules = DEFAULT_RULES) -> Spec:
    """Resolve logical axis names for one tensor into a :class:`Spec`."""
    if len(logical_axes) != len(shape):
        raise ValueError(
            f"logical axes {logical_axes} do not match shape {shape}")
    mesh_sizes = axis_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for name, dim in zip(logical_axes, shape):
        if name is None:
            out.append(None)
            continue
        chosen = None
        for cand in rules.candidates(name):
            if not all(a in mesh_sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            total = math.prod(mesh_sizes[a] for a in cand)
            if dim % total != 0:
                continue
            chosen = cand
            break
        if chosen is None:
            out.append(None)
        else:
            used.update(chosen)
            out.append(chosen if len(chosen) > 1 else chosen[0])
    return Spec(*out)


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """Per-device shape of a tensor of ``shape`` placed by ``spec`` (every
    sharded dimension divides evenly, as :func:`logical_to_spec` picks)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        out.append(dim // math.prod(sizes[a] for a in names))
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a resolved spec: ``Shard(d)`` on every mesh
    axis that dimension ``d`` names (a dimension over two axes, such as
    ("pod", "data"), is sharded on both, in mesh order), ``Replicate()``
    on the others and on any axis of size one (it splits nothing, and
    DTensor will not merge or drop a dimension it calls sharded)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    where = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            where[a] = d
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1
                 else Replicate() for a in mesh.mesh_dim_names)


def named_sharding(logical_axes, shape, mesh,
                   rules: LogicalRules = DEFAULT_RULES):
    """``(mesh, placements)`` of one tensor: what ``distribute_tensor`` and
    ``DTensor.from_local`` take."""
    return mesh, placements(logical_to_spec(logical_axes, shape, mesh, rules),
                            mesh)


def tree_map_axes(fn, specs_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of logical-axes tuples and trees
    of the same structure (nested dicts)."""
    if is_axes(specs_tree):
        return fn(specs_tree, *trees)
    return {k: tree_map_axes(fn, specs_tree[k], *(t[k] for t in trees))
            for k in specs_tree}


def tree_specs(specs_tree, shapes_tree, mesh,
               rules: LogicalRules = DEFAULT_RULES):
    """A tree of resolved :class:`Spec`\\ s for a tree of logical axes and a
    matching tree of shaped leaves (tensors, meta tensors included)."""
    return tree_map_axes(
        lambda ax, leaf: logical_to_spec(ax, leaf.shape, mesh, rules),
        specs_tree, shapes_tree)


def tree_shardings(specs_tree, shapes_tree, mesh,
                   rules: LogicalRules = DEFAULT_RULES):
    """A tree of ``(mesh, placements)`` for a tree of logical axes and a
    matching tree of shaped leaves."""
    return tree_map_axes(
        lambda ax, leaf: named_sharding(ax, leaf.shape, mesh, rules),
        specs_tree, shapes_tree)


_STATE = threading.local()


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (or None: no mesh) the active one in this thread for
    the enclosing block; ``repro_torch.launch.mesh.mesh_context`` is the
    public entry."""
    stack = _STATE.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def get_active_mesh_or_none():
    """The mesh of the innermost :func:`mesh_context
    <repro_torch.launch.mesh.mesh_context>` of this thread, if any."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def constrain(x, logical_axes: Sequence[str | None],
              rules: LogicalRules = DEFAULT_RULES):
    """Place ``x`` by logical names: a no-op outside a mesh context.  Under
    one, a DTensor is redistributed to the resolved placements and a plain
    tensor (the same full value on every rank) is first wrapped as a
    replicated DTensor."""
    mesh = get_active_mesh_or_none()
    if mesh is None:
        return x
    from repro_torch.sharding.local import as_placed
    return as_placed(x, mesh, placements(
        logical_to_spec(logical_axes, x.shape, mesh, rules), mesh))
