"""Trajectory objective and warm-start helpers.

Counterpart of ``osqp_solver_tpu/gomp/trajectory.py``:
``tri_diagonal_matrix``, ``smoothness_objective``, ``linspace_configs``,
``calc_warm_start``, ``calc_warm_start_jnp`` as
:func:`calc_warm_start_batched` (which takes no batch dims too),
``map_joint_trajectory_to_xyz`` and ``calc_warm_start_masked``.  The dense
variants are numpy (host-side problem setup), the others tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def tri_diagonal_matrix(
    a: float, b: float, n: int, offset: int = 0, diagonal_num: int = 1
) -> np.ndarray:
    """Dense ``triDiagonalMatrix``: rows/cols ``i < offset`` are zero; for
    ``i >= offset``: ``M[i,i] = a``, ``M[i, i±diagonal_num] = b`` (upper
    written when ``i+diag < n``, lower when ``i-diag >= offset``)."""
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(offset, n):
        m[i, i] = a
        if i + diagonal_num < n:
            m[i, i + diagonal_num] = b
        if i - diagonal_num >= offset:
            m[i, i - diagonal_num] = b
    return m


def smoothness_objective(waypoints: int, n_dim: int) -> np.ndarray:
    """The GOMP objective ``P``: ``triDiagonalMatrix(2, -1, 2*W*N,
    offset=W*N, diag=N)`` — a block Laplacian on the velocity half (minimum
    squared acceleration)."""
    n = 2 * waypoints * n_dim
    return tri_diagonal_matrix(2.0, -1.0, n, offset=waypoints * n_dim,
                               diagonal_num=n_dim)


def linspace_configs(a, b, n_steps: int) -> np.ndarray:
    """Flat ``(n_steps*N,)`` linear interpolation from ``a`` to ``b``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    step = (b - a) / (n_steps - 1)
    out = a[None, :] + step[None, :] * np.arange(n_steps)[:, None]
    return out.reshape(-1)


def calc_warm_start(start_pos, end_pos, waypoints: int) -> np.ndarray:
    """Planner warm start: linspace positions + zero velocities, flat
    ``(2*W*N,)``."""
    positions = linspace_configs(start_pos, end_pos, waypoints)
    return np.concatenate([positions, np.zeros_like(positions)])


def calc_warm_start_batched(start_pos, end_pos, waypoints: int):
    """Tensor version for ``start_pos``/``end_pos`` of shape ``(N, *batch)``
    (``*batch`` may be empty): returns ``(2*W*N, *batch)`` (positions, then
    zero velocities)."""
    a, b = start_pos, end_pos
    frac = torch.arange(waypoints, dtype=a.dtype, device=a.device) / (
        waypoints - 1
    )
    frac = frac.reshape((waypoints,) + (1,) * a.dim())
    positions = (a[None] + frac * (b - a)[None]).reshape(
        (waypoints * a.shape[0],) + tuple(a.shape[1:])
    )
    return torch.cat([positions, torch.zeros_like(positions)], dim=0)


def calc_warm_start_masked(start_pos, end_pos, w_max: int, w_active: int):
    """Pad-to-max warm start for ``start_pos``/``end_pos`` of shape
    ``(N, *batch)``: linspace over the first ``w_active`` waypoints, clamped
    at the end configuration beyond.  Returns ``(2*w_max*N, *batch)``."""
    a, b = start_pos, end_pos
    wa = int(w_active)
    t = torch.arange(w_max, dtype=a.dtype, device=a.device)
    frac = t.clamp(max=float(wa - 1)) / float(max(wa - 1, 1))
    frac = frac.reshape((w_max,) + (1,) * a.dim())
    positions = (a[None] + frac * (b - a)[None]).reshape(
        (w_max * a.shape[0],) + tuple(a.shape[1:])
    )
    return torch.cat([positions, torch.zeros_like(positions)], dim=0)


def map_joint_trajectory_to_xyz(trajectory, fk, n_dim: int):
    """FK-map the position half of flat trajectories ``(..., 2*W*N)`` to
    ``(..., W, 3)`` points; ``fk`` maps ``(M, N)`` configurations to
    ``(M, 3)`` (e.g. :func:`~osqp_solver_tpu_torch.models.ur5e.
    forward_kinematics`)."""
    traj = torch.as_tensor(trajectory)
    waypoints = traj.shape[-1] // (2 * n_dim)
    lead = tuple(traj.shape[:-1])
    q = traj[..., : waypoints * n_dim].reshape(-1, n_dim)
    return fk(q).reshape(lead + (waypoints, 3))
