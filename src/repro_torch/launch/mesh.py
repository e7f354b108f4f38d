"""Meshes of the port (``repro.launch.mesh``) as ``torch.distributed``
``DeviceMesh``\\ es, and the H100 constants of the dry-run's roofline.

Meshes are made by functions (never module-level constants), so importing
this module touches no process group.  Single pod: 16 x 16 = 256 ranks
(data, model); multi-pod: 2 x 16 x 16 = 512 ranks with a leading "pod" axis
that carries pure data parallelism.  A production mesh needs a process
group of that world size: the dry-run's (``repro_torch.launch.dryrun``) is
a fake one.

The launch CLIs run under :func:`cli_mesh`: a process started by
``torchrun`` joins its group through ``env://`` and runs on a mesh of the
whole world; ``--mesh`` makes a one-rank mesh; with neither, a CLI runs
with no mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket

import torch

from repro_torch.sharding import rules as _rules


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh for the enclosing block:
    :func:`repro_torch.sharding.rules.constrain` resolves against it, and
    plain tensors that meet a DTensor in an op (parameters the caller did
    not shard, masks, positions) count as replicated on it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh_context takes a DeviceMesh, not "
                        f"{type(mesh).__name__} (an AbstractMesh has no "
                        f"devices to place tensors on)")
    with _rules.active_mesh(mesh), implicit_replication():
        yield mesh


def mesh_scope(mesh):
    """:func:`mesh_context` of ``mesh``, or no context for None."""
    return contextlib.nullcontext() if mesh is None else mesh_context(mesh)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices: enough to resolve specs and
    per-device shard shapes (``jax.sharding.AbstractMesh``)."""

    shape: tuple
    mesh_dim_names: tuple

    def size(self):
        return math.prod(self.shape)


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes))


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu"):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") mesh over the default process group, whose world size must be
    256 or 512."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks (the dry-run makes a fake one)")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def started_by_torchrun() -> bool:
    """True when ``env://`` finds a rank, a world size and a rendezvous
    address in the environment, as ``torchrun`` sets them."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def init_group(device) -> bool:
    """Makes the default process group unless one exists: ``nccl`` on
    ``cuda``, ``gloo`` on ``cpu``; under ``torchrun`` joined through
    ``env://`` (on ``cuda`` the card ``LOCAL_RANK`` is made current
    first), else a one-rank group (``tcp://localhost`` on a free port).
    Returns True when this call made the group."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    device = torch.device(device).type
    backend = "nccl" if device == "cuda" else "gloo"
    if started_by_torchrun():
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1)
    return True


def make_test_mesh(devices: int = 8, *, device: str):
    """A small (data, model) mesh over ``min(devices, world size)`` ranks,
    ``model = 2`` when that count is even: ``nccl`` on ``cuda``, ``gloo``
    on ``cpu``.  With no process group yet, one is made
    (:func:`init_group`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device = torch.device(device).type
    init_group(device)
    d = min(devices, dist.get_world_size())
    model = 2 if d % 2 == 0 else 1
    return DeviceMesh(device, torch.arange(d).reshape(d // model, model),
                      mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def cli_mesh(*, full: bool, requested: bool, device):
    """The mesh a launch CLI runs under, or None.  A process started by
    ``torchrun``, or a CLI given ``--mesh`` (``requested``), runs on a
    mesh of the whole group (a one-rank group without ``torchrun``): the
    production mesh for ``--full`` (``full``) on a world of its size, as
    the JAX CLIs' ``--full`` takes it, else :func:`make_test_mesh`.  With
    neither, None: the JAX CLIs always mesh, but a one-rank mesh places
    nothing and costs DTensor's dispatch on every op.  A group this call
    made is destroyed on exit."""
    if not (requested or started_by_torchrun()):
        yield None
        return
    import torch.distributed as dist
    device = torch.device(device).type
    made = init_group(device)
    try:
        world = dist.get_world_size()
        if full and world == math.prod(production_shape()[0]):
            yield make_production_mesh(device=device)
        else:
            yield make_test_mesh(world, device=device)
    finally:
        if made:
            dist.destroy_process_group()


def rank0_print(mesh):
    """``print`` on rank 0 of ``mesh``'s group (and without a mesh); a
    no-op on the other ranks."""
    if mesh is None or mesh.get_rank() == 0:
        return print
    return lambda *args, **kwargs: None


# H100 SXM5 constants for the dry-run's roofline (per GPU).
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: 989 TFLOP/s dense
# BF16 tensor-core throughput (1,979 with sparsity).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
# Same data sheet: 3.35 TB/s HBM3 bandwidth (80 GB SXM5).
HBM_BW = 3.35e12                # bytes/s
# The collective term's rate: one NDR InfiniBand link per GPU, 400 Gb/s =
# 50 GB/s (NVIDIA DGX H100 user guide: eight ConnectX-7 400 Gb/s ports,
# one per GPU).  A 16-wide mesh axis on 8-GPU nodes always crosses a node,
# and a ring collective runs at its slowest link.
NET_BW = 50e9                   # bytes/s per GPU
# NVLink 4 within a node: 900 GB/s bidirectional per GPU (data sheet), 450
# GB/s each way; kept as the intra-node figure, not used by the roofline.
NVLINK_BW = 450e9               # bytes/s, one direction
