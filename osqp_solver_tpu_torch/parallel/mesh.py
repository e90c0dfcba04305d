"""The ``(batch, horizon)`` process mesh.

Counterpart of ``osqp_solver_tpu/parallel/mesh.py`` (``BATCH_AXIS``,
``HORIZON_AXIS``, ``make_mesh``) over ``torch.distributed``: one process
per mesh slot.  The ``batch`` axis carries independent problems (no
collective inside a solve); the ``horizon`` axis carries the chunks of one
long trajectory (the Schur separator exchange of :mod:`.schur` /
:mod:`.banded`).

The reference's ``batch_sharding`` / ``replicated`` shardings have no torch
counterpart: a process holds plain tensors, so "sharded over ``batch``"
means each rank takes its contiguous slice of a leading batch axis
(:func:`batch_slice`) and "replicated" means every rank holds the whole
tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXIS = "batch"
HORIZON_AXIS = "horizon"


def make_mesh(batch: Optional[int] = None, horizon: int = 1,
              device=None) -> DeviceMesh:
    """A ``(batch, horizon)`` :class:`DeviceMesh` over the initialised
    default group (rank ``r`` at row ``r // horizon``, column
    ``r % horizon``).  ``batch=None`` puts every remaining rank on the batch
    axis.  ``device``: ``"cuda"`` unless the caller asks for ``"cpu"``.

    The default group's backend decides the transport: NCCL with one GPU per
    rank, gloo on the CPU, and gloo on CUDA tensors where several ranks share
    one GPU (:mod:`._comm` stages those payloads through the host)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialised first "
            "(parallel.multihost.initialize)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh runs on a CUDA device by default and none is "
            "available; pass device='cpu'")
    n = dist.get_world_size()
    if batch is None:
        if n % horizon:
            raise ValueError(f"{n} ranks do not split into horizon={horizon}")
        batch = n // horizon
    if batch * horizon != n:
        raise ValueError(f"mesh {batch}x{horizon} != {n} ranks")
    grid = torch.arange(n).reshape(batch, horizon)
    return DeviceMesh(dev.type, grid,
                      mesh_dim_names=(BATCH_AXIS, HORIZON_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: ``cpu``, or the current CUDA device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def batch_slice(n: int, mesh: DeviceMesh, axis: str = BATCH_AXIS) -> slice:
    """This rank's contiguous slice of a leading batch axis of ``n`` items
    (``n`` must divide by the axis size, as in the reference)."""
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"batch of {n} does not divide by the {k} ranks of "
                         f"mesh axis {axis!r}")
    per = n // k
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)
