"""Multi-process initialization and the pod mesh.

:func:`initialize` joins this process to the job's default process group
(one process per GPU); :func:`make_pod_mesh` then lays a (dp, tp) mesh over
it with tp spanning the GPUs of one host (their NVLink) and dp spanning
hosts, so the per-layer all-reduces of tensor parallelism stay inside a
host. Under ``torchrun`` the address, world size and rank come from its
environment; elsewhere the caller passes them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT, mesh_from_ranks

__all__ = ["initialize", "make_pod_mesh"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """``dist.init_process_group`` for a job of ``num_processes``; nothing
    for one process, as the JAX package's ``initialize``.
    ``coordinator_address``: "host:port" of rank 0. ``backend``: the
    caller's explicit choice, "nccl" for GPUs (one per process) or "gloo"
    for the CPU; no backend is picked, and none replaces another.
    ``timeout`` (default :data:`~.mesh.DEFAULT_TIMEOUT`): how long a
    collective may wait before it fails."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError("initialize: pass backend='nccl' (one GPU per "
                         "process) or backend='gloo' (CPU)")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timeout or DEFAULT_TIMEOUT)


def make_pod_mesh(tp: Optional[int] = None, dp: Optional[int] = None,
                  device_type: str = "cuda",
                  timeout: Optional[datetime.timedelta] = None):
    """A (dp, tp) mesh over every rank of the default group. tp defaults
    to the processes per host (``LOCAL_WORLD_SIZE``, as ``torchrun`` sets
    it, else the host's GPUs), dp to the number of hosts. Ranks are
    host-major (``torchrun``'s numbering), so each tp group is one
    host's."""
    n = dist.get_world_size()
    if tp is None:
        tp = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(
            1, torch.cuda.device_count())
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    return mesh_from_ranks(torch.arange(n).reshape(dp, tp), device_type,
                           timeout)
