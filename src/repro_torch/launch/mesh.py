"""Meshes of the port (``repro.launch.mesh``) as ``torch.distributed``
``DeviceMesh``\\ es, and the H100 constants of the dry-run's roofline.

Meshes are made by functions (never module-level constants), so importing
this module touches no process group.  Single pod: 16 x 16 = 256 ranks
(data, model); multi-pod: 2 x 16 x 16 = 512 ranks with a leading "pod" axis
that carries pure data parallelism.  A production mesh needs a process
group of that world size: the dry-run's (``repro_torch.launch.dryrun``) is
a fake one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
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


def make_test_mesh(devices: int = 8, *, device: str):
    """A small (data, model) mesh over ``min(devices, world size)`` ranks,
    ``model = 2`` when that count is even: ``nccl`` on ``cuda``, ``gloo``
    on ``cpu``.  With no process group yet, a one-rank group on that
    backend is made (``tcp://localhost`` on a free port)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1)
    d = min(devices, dist.get_world_size())
    model = 2 if d % 2 == 0 else 1
    return DeviceMesh(device, torch.arange(d).reshape(d // model, model),
                      mesh_dim_names=("data", "model"))


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
