"""Device meshes for tensor- and data-parallel serving over
``torch.distributed``.

One process per GPU, SPMD: every rank runs the same host scheduler on the
same requests. A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
with dimensions ``("dp", "tp")`` over the ranks ``0 .. dp * tp - 1`` of
the default process group, tp the inner, contiguous dimension (the ranks of
a tp group are consecutive, so on a multi-GPU host they share its NVLink).
Its process groups are made here, explicitly and with a timeout, so that a
collective that hangs fails instead.

The sharding rules (:mod:`.sharding`) name mesh axes per tensor dimension
with :class:`PartitionSpec`, the JAX package's spec: a tuple of axis names
(``"tp"``, ``"dp"``) or None per dimension.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["PartitionSpec", "P", "make_mesh", "mesh_from_ranks",
           "replicated", "shard", "axis_size", "DEFAULT_TIMEOUT"]

# a collective that waits longer than this fails (gloo raises; NCCL's
# watchdog aborts the process)
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class PartitionSpec(tuple):
    """Mesh axis (or None) per tensor dimension; ``P()`` is replicated.
    A tuple, as JAX's ``PartitionSpec`` is, so specs of both packages
    compare equal."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def replicated(mesh=None) -> PartitionSpec:
    """The spec of a tensor every rank holds whole."""
    return P()


def shard(mesh, *spec) -> PartitionSpec:
    """The spec of a tensor sharded over mesh axes, one entry per dim."""
    return P(*spec)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def mesh_from_ranks(ranks: torch.Tensor, device_type: str = "cuda",
                    timeout: Optional[datetime.timedelta] = None,
                    backend: Optional[str] = None):
    """A ("dp", "tp") DeviceMesh over ``ranks`` [dp, tp] of the default
    process group, with one explicit process group per tp row and per dp
    column, each given ``timeout`` (default :data:`DEFAULT_TIMEOUT`) and
    ``backend`` (default: the default group's). Every rank of the default
    group must call it: making a group is collective."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(parallel.initialize, or torchrun and "
                           "dist.init_process_group)")
    timeout = timeout or DEFAULT_TIMEOUT
    ranks = torch.as_tensor(ranks, dtype=torch.int64)
    tp_group, _ = dist.new_subgroups_by_enumeration(
        [r.tolist() for r in ranks], timeout=timeout, backend=backend)
    dp_group, _ = dist.new_subgroups_by_enumeration(
        [r.tolist() for r in ranks.t()], timeout=timeout, backend=backend)
    return DeviceMesh.from_group([dp_group, tp_group], device_type,
                                 mesh=ranks, mesh_dim_names=("dp", "tp"))


def make_mesh(tp: int = 1, dp: int = 1, device_type: str = "cuda",
              timeout: Optional[datetime.timedelta] = None,
              backend: Optional[str] = None):
    """A (dp, tp) mesh over the first ``dp * tp`` ranks of the default
    process group (tp innermost), its groups on ``backend`` (default: the
    default group's). Raises where the group has fewer ranks, as the JAX
    package's ``make_mesh`` raises for too few devices."""
    need = tp * dp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    return mesh_from_ranks(torch.arange(need).reshape(dp, tp), device_type,
                           timeout, backend)
