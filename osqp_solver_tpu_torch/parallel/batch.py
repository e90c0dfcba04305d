"""Batch-parallel solver: independent QPs split over the mesh's batch axis.

Counterpart of ``osqp_solver_tpu/parallel/batch.py`` (``solve_batch``,
``solve_batch_sharded``).  The reference's ``shard_map`` gives each device
its own masked-convergence loop over its shard; here each rank runs its own
:func:`~osqp_solver_tpu_torch.ops.admm.solve_batched` on its contiguous
slice, with no collective inside the solve, and one ``all_gather`` of the
results at the end returns the whole batch on every rank (the reference
returns a global array).
"""
from __future__ import annotations

import dataclasses

from ..ops import admm
from . import _comm
from .mesh import BATCH_AXIS, batch_slice, mesh_device


def solve_batch(qps, settings: admm.Settings = admm.Settings(), warm_x=None,
                device=None):
    """Solve a batch of QPs in one process:
    :func:`~osqp_solver_tpu_torch.ops.admm.solve_batched` (per-problem
    adaptive ρ, the refactorisation guarded by a batch-level decision)."""
    return admm.solve_batched(qps, settings, warm_x=warm_x, device=device)


def gather_batch(res, group) -> object:
    """Every field of a batch-leading dataclass result gathered over
    ``group`` and concatenated along the batch axis, rank order."""
    def cat(t):
        g = _comm.all_gather(t, group, "gather_result")
        return g.reshape((-1,) + tuple(t.shape[1:]))

    return dataclasses.replace(res, **{
        f.name: cat(getattr(res, f.name)) for f in dataclasses.fields(res)})


def solve_batch_sharded(qps, mesh, settings: admm.Settings = admm.Settings(),
                        axis: str = BATCH_AXIS):
    """Split the trailing problem batch of ``qps`` over ``mesh[axis]`` and
    solve: each rank solves its contiguous slice with its own loop (no
    collective inside the solve), then one ``all_gather`` per result field.
    The batch must divide by the axis size.  Returns the whole batch's
    :class:`~osqp_solver_tpu_torch.ops.admm.SolveResult` on every rank, on
    the mesh's device: each slice is what :func:`solve_batch` returns for
    that slice alone (in float64 also what it returns for the whole batch;
    in float32 another batch size can round otherwise)."""
    (B,) = qps.batch_shape
    sl = batch_slice(B, mesh, axis)
    mine = qps.map_arrays(lambda a: a[..., sl])
    res = admm.solve_batched(mine, settings, device=mesh_device(mesh))
    return gather_batch(res, mesh.get_group(axis))
