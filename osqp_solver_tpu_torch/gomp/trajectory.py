"""Warm-start helpers.

Counterpart of ``osqp_solver_tpu/gomp/trajectory.py`` (``linspace_configs``,
``calc_warm_start``, ``calc_warm_start_jnp`` as
:func:`calc_warm_start_batched`, and ``calc_warm_start_masked``).
"""
from __future__ import annotations

import numpy as np
import torch


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
    """Tensor version for ``start_pos``/``end_pos`` of shape ``(N, *batch)``:
    returns ``(2*W*N, *batch)`` (positions, then zero velocities)."""
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
