"""Per-rank plumbing for the meshed paths: placing a tensor as a DTensor,
the offset of a rank's block, and running a function on every rank's
local shards (``torch.distributed.tensor.experimental.local_map``).

The hand-written kernels and the in-place cache writes run through
:func:`run_local`: each rank hands its own shards to the plain-tensor
function, so a CUDA shard launches the kernel (or raises), a CPU or meta
shard takes its plain version, and the cache a rank holds is written where
it lies, with no redistribution of the cache.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding import rules


def inference(fn):
    """Decorator: run ``fn`` under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` while a mesh is active.  DTensor takes an op named
    like ``__and__`` for an in-place one when inference mode keeps it from
    decomposing (it then returns its first argument unchanged, or raises
    when that is a plain tensor), so meshed steps run without it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mode = (torch.no_grad() if rules.get_active_mesh_or_none() is not None
                else torch.inference_mode())
        with mode:
            return fn(*args, **kwargs)

    return wrapper


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def full(x):
    """The whole value of ``x``: a DTensor's ``full_tensor()``, a plain
    tensor itself."""
    return x.full_tensor() if is_dtensor(x) else x


def settle(x):
    """``x`` with every pending (partial) placement reduced, so that a view
    may follow: DTensor keeps a vocabulary-sharded gather's result partial
    with a mask of the gather's shape, which a later view would break."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def whole(x, dim=-1):
    """``x`` with dimension ``dim`` gathered whole on every rank (its other
    placements kept): what an argmax over that dimension reads."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    pl = [Replicate() if p.is_shard() and p.dim == dim else p
          for p in x.placements]
    return settle(as_placed(x, x.device_mesh, pl))


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor whose sharding the new shape cannot
    split evenly (a dimension sharded over more ranks than an output
    dimension it feeds divides) is gathered whole first."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError as e:
        if "unevenly sharded" not in str(e):
            raise
    pl = [Replicate() if p.is_shard() else p for p in x.placements]
    return settle(as_placed(x, x.device_mesh, pl)).reshape(*shape)


def mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None when all
    are plain."""
    for t in tensors:
        if is_dtensor(t):
            return t.device_mesh
    return None


def placements_of(x, mesh) -> tuple:
    """``x``'s placements: a DTensor's own, a plain tensor's replicated on
    every dimension of ``mesh``."""
    return (tuple(x.placements) if is_dtensor(x)
            else (Replicate(),) * mesh.ndim)


def follow(have, table) -> tuple:
    """Placements of a companion tensor: ``table[d]`` on every mesh
    dimension where ``have`` shards tensor dimension d (and ``table`` names
    d), replicated on the others."""
    return tuple(table.get(p.dim, Replicate()) if p.is_shard()
                 else Replicate() for p in have)


def keep_shards(x, mesh, dims) -> tuple:
    """``x``'s placements with only the shards of tensor dimensions
    ``dims`` kept, every other mesh dimension replicated: the layout at
    which a per-rank function takes ``x`` when it is independent across
    ``dims`` and needs the other dimensions whole."""
    return follow(placements_of(x, mesh), {d: Shard(d) for d in dims})


def as_placed(x, mesh, placements):
    """``x`` as a DTensor on ``mesh`` at ``placements``: a plain tensor (the
    same full value on every rank) is wrapped as replicated first, a
    DTensor elsewhere is redistributed."""
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def shard_offset(mesh, placements, dim, local_size) -> int:
    """Global index of this rank's first element along ``dim`` for a
    tensor placed evenly by ``placements`` (mesh-major order over the mesh
    dimensions that shard ``dim``)."""
    coord = mesh.get_coordinate()
    block = 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            block = block * mesh.size(i) + coord[i]
    return block * local_size


def _unmeshed(fn):
    """``fn`` with no active mesh while it runs: it sees plain local
    tensors, so the logical constraints in it are no-ops."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with rules.active_mesh(None):
            return fn(*args, **kwargs)

    return wrapper


def run_local(fn, mesh, out_placements, args, in_placements,
              in_grad_placements=None):
    """``fn`` on every rank's local shards of ``args`` placed at
    ``in_placements`` (plain tensors are wrapped as replicated first), its
    outputs wrapped at ``out_placements`` (None for a function that returns
    nothing).  ``in_grad_placements`` says how each input's local gradient
    adds up across ranks (``Partial()`` where ranks hold parts of a sum:
    a replicated weight used on a rank's own batch rows), by default as
    the input is placed."""
    placed = [as_placed(a, mesh, p) for a, p in zip(args, in_placements)]
    # local_map takes a list for one output, a tuple of lists for several
    if out_placements is None:
        out = None
    elif isinstance(out_placements[0], Placement):
        out = list(out_placements)
    else:
        out = tuple(list(p) for p in out_placements)
    grads = (None if in_grad_placements is None
             else tuple(list(p) for p in in_grad_placements))
    return local_map(_unmeshed(fn), out_placements=out,
                     in_placements=tuple(list(p) for p in in_placements),
                     in_grad_placements=grads, device_mesh=mesh)(*placed)
