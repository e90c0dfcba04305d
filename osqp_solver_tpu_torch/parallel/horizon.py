"""Long-horizon trajectory QPs with chunk-partitioned KKT solves.

Counterpart of ``osqp_solver_tpu/parallel/horizon.py``
(``ChunkedTrajectoryQP``, ``auto_chunks``, ``as_chunked``,
``solve_horizon_sharded``).  On one device the sequential block-tridiagonal
factor and solve of a long horizon are a chain of ``W`` small dependent
steps; the Schur split of :mod:`.schur` turns one long chain into ``K``
short ones that run side by side (on the batch axis of the same kernels)
plus a ``(K-1)``-block reduced chain:

* ``kkt_factor`` → every chunk interior's block Cholesky (one launch), the
  interface columns, and the factored reduced system, cached across ADMM
  iterations;
* ``kkt_solve`` → the chunk-local substitution and the small reduced solve.

:func:`solve_horizon_sharded` splits the whole problem — state, data and
KKT — over the ranks of a mesh axis instead (:mod:`.banded`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..gomp.trajectory_qp import TrajectoryQP
from ..ops import admm as admm_mod
from .banded import (banded_from_trajectory, deinterleave_state,
                     interleave_state, solve_banded_sharded)
from .mesh import HORIZON_AXIS
from .schur import schur_factor, schur_solve_cached


@dataclasses.dataclass(frozen=True)
class ChunkedTrajectoryQP(TrajectoryQP):
    """A :class:`TrajectoryQP` whose reduced KKT is factored and solved in
    ``n_chunks`` horizon chunks (Schur complement) instead of one sequential
    chain."""

    n_chunks: int = 2

    def kkt_factor(self, rho_vec, sigma):
        diag, lower = self.kkt_blocks(rho_vec, sigma)
        return schur_factor(diag, lower, self.n_chunks)

    def kkt_solve(self, factor, rhs):
        return self._deinterleave(
            schur_solve_cached(factor, self._interleave(rhs)))


def auto_chunks(waypoints: int) -> int:
    """Chunk-count policy for one long horizon on one device, the
    reference's number for number: below 512 waypoints the sequential chain
    (1, no split); above, interiors of about 160 waypoints, 2 to 128
    chunks."""
    if waypoints < 512:
        return 1
    return max(2, min(128, waypoints // 160))


def as_chunked(qp: TrajectoryQP, n_chunks: int | None = None):
    """``qp`` re-wrapped for chunk-partitioned KKT solves; ``n_chunks=None``
    applies :func:`auto_chunks`.  One chunk IS the sequential chain: ``qp``
    comes back as it is."""
    if n_chunks is None:
        n_chunks = auto_chunks(qp.waypoints)
    if int(n_chunks) <= 1:
        return qp
    fields = {f.name: getattr(qp, f.name)
              for f in dataclasses.fields(TrajectoryQP)}
    return ChunkedTrajectoryQP(n_chunks=int(n_chunks), **fields)


def solve_horizon_sharded(
    qp: TrajectoryQP,
    mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x=None,
    axis: str = HORIZON_AXIS,
    local_chunks: int = 1,
) -> admm_mod.SolveResult:
    """The full OSQP-semantics ADMM for ONE long-horizon trajectory QP (no
    batch dims) with everything — vector state, problem data, KKT factor and
    solve — split over the ranks of ``mesh[axis]``
    (:func:`.banded.solve_banded_sharded`).  Per ADMM iteration a rank
    exchanges ``(B2,)`` halos and the ``(K, B2)`` separator right-hand sides;
    residual norms reduce as scalars: no payload scales with the horizon.
    ``local_chunks > 1`` splits each rank's interior again (:mod:`.schur`).

    Takes and returns the reference ``[q..., v...]`` layout; the duals map
    back through the banded row map.  Every rank of the axis takes part and
    gets the whole result, on the mesh's device."""
    W, N = qp.waypoints, qp.n_dim
    banded, row_map = banded_from_trajectory(qp)
    warm_int = None
    if warm_x is not None:
        warm_int = interleave_state(
            torch.as_tensor(warm_x, dtype=banded.q_wb.dtype,
                            device=banded.q_wb.device), W, N)
    res = solve_banded_sharded(banded, mesh, settings, warm_x=warm_int,
                               axis=axis, local_chunks=local_chunks)
    rm = torch.as_tensor(row_map, device=res.y.device)
    return dataclasses.replace(res, x=deinterleave_state(res.x, W, N),
                               y=res.y[rm], z=res.z[rm])
