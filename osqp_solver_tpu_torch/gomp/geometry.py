"""Obstacle geometry: the horizontal-line obstacle.

Counterpart of ``osqp_solver_tpu/gomp/geometry.py`` (``HorizontalLine``,
``call_linearize_rows``); the sphere and capsule obstacles of that module
are not ported yet.  Every predicate is a vectorized tensor expression.
Point tensors carry their xyz coordinates along ``axis`` (default: last);
the trajectory-level methods (``has_collision``, ``violates``,
``linearize_rows``) take ``(W, 3, *batch)`` — waypoints first, coordinates
second, batch trailing — which for an unbatched ``(W, 3)`` trajectory is the
reference's layout.

Collision semantics mirror ``horizontal-line.h:78-92``: a waypoint
"collides" with the line iff the ball around the waypoint's XY projection is
within ``radius`` of the line, OR either adjacent trajectory segment crosses
the line in the XY plane.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from .constraints import INF  # noqa: F401  (re-exported convenience)

ERROR = 1e-3  # feasibility slack


def _coord_shape(p, axis):
    shape = [1] * p.dim()
    shape[axis % p.dim()] = 3
    return shape


@dataclasses.dataclass(frozen=True)
class HorizontalLine:
    """An infinite horizontal (XY-plane-parallel) line obstacle.

    ``direction``: unit 3-vector along the line with z == 0; ``point``: any
    point on the line; ``bypass_below``: +1.0 if robot balls must pass under
    the line, else -1.0.
    """

    direction: torch.Tensor  # (3,), unit, z = 0
    point: torch.Tensor  # (3,)
    bypass_below: float  # 1.0 = bypass from below, -1.0 = above

    @classmethod
    def create(cls, direction_xy, point, bypass_from_below: bool = False,
               dtype=torch.float64, device="cpu"):
        d = np.asarray(direction_xy, dtype=np.float64)
        d3 = np.array([d[0], d[1], 0.0]) / np.linalg.norm(d)
        return cls(
            direction=torch.tensor(d3, dtype=dtype, device=device),
            point=torch.tensor(
                np.asarray(point, dtype=np.float64), dtype=dtype, device=device
            ),
            bypass_below=1.0 if bypass_from_below else -1.0,
        )

    def _vec(self, v, p, axis):
        return v.to(dtype=p.dtype, device=p.device).reshape(
            _coord_shape(p, axis)
        )

    # --- geometry (coordinates along ``axis``) -------------------------------

    def distance_vec(self, p, axis: int = -1):
        """Perpendicular from ``p`` to the line, ``X - P``."""
        point = self._vec(self.point, p, axis)
        direction = self._vec(self.direction, p, axis)
        rel = p - point
        proj = (rel * direction).sum(dim=axis, keepdim=True)
        x = point + proj * direction
        return x - p

    def distance_vec_xy(self, p, axis: int = -1):
        """XY components of the perpendicular."""
        return self.distance_vec(p, axis).narrow(axis, 0, 2)

    def distance_xy(self, p, axis: int = -1):
        """Horizontal distance from ``p`` to the line."""
        return torch.linalg.vector_norm(self.distance_vec_xy(p, axis), dim=axis)

    def closest_point(self, p, axis: int = -1):
        """Point on the line closest to ``p``."""
        return p + self.distance_vec(p, axis)

    def on_opposite_sides(self, p, q, axis: int = -1):
        """True if ``p`` and ``q`` are on opposite sides in XY."""
        dp = self.distance_vec_xy(p, axis)
        dq = self.distance_vec_xy(q, axis)
        return (dp * dq).sum(dim=axis) < 0

    def is_close(self, p, radius, axis: int = -1):
        """Ball of ``radius`` at ``p`` intersects the line in XY."""
        return self.distance_xy(p, axis) < radius

    def has_collision(self, trajectory_xyz, radius):
        """Per-waypoint collision mask ``(W, *batch)`` for a
        ``(W, 3, *batch)`` trajectory: close to the line, or either adjacent
        segment crosses it in XY."""
        p = trajectory_xyz
        close = self.is_close(p, radius, axis=1)  # (W, *batch)
        crosses = self.on_opposite_sides(p[:-1], p[1:], axis=1)  # t..t+1
        false_pad = torch.zeros_like(close[:1])
        prev_cross = torch.cat([false_pad, crosses], dim=0)  # segment (t-1, t)
        next_cross = torch.cat([crosses, false_pad], dim=0)  # segment (t, t+1)
        return close | prev_cross | next_cross

    def is_above(self, p, radius, axis: int = -1):
        """Ball at ``p`` is clear on its required side of the line, with the
        ``radius ∓ ERROR`` slack."""
        dz = (p - self._vec(self.point, p, axis)).select(axis, 2)
        if self.bypass_below > 0:
            return dz <= -radius + ERROR
        return dz >= radius - ERROR

    @property
    def bypass_from_below(self):
        return self.bypass_below > 0

    # --- obstacle protocol ---------------------------------------------------

    def violates(self, points, radius):
        """Per-waypoint exact-FK infeasibility: collision-flagged AND not
        clear on the required side.  ``points (W, 3, *batch)``."""
        return self.has_collision(points, radius) & ~self.is_above(
            points, radius, axis=1
        )

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """One linearized collision row per waypoint: bound the ball's Z
        (via ``J_z``) above/below the line height at the closest point
        wherever :meth:`has_collision` flags the waypoint; dummy ``±INF``
        rows with the SAME coefficients elsewhere.

        ``points (W, 3, *batch)``; ``jac (W, 3, N, *batch)``;
        ``jq (W, 3, *batch)`` per-axis ``J·q0``.  ``movable`` is ignored:
        the Z-row is absolute.  Returns ``(row_jac (W, N, *batch),
        low (W, *batch), upp (W, *batch))`` with the ±``radius`` ball
        tightening applied."""
        del movable
        coll = self.has_collision(points, radius)
        bound = (
            self.closest_point(points, axis=1)[:, 2] - points[:, 2] + jq[:, 2]
        )
        below = self.bypass_below > 0
        neg = torch.full_like(bound, -INF)
        pos = torch.full_like(bound, INF)
        low = (neg if below else torch.where(coll, bound, neg)) + radius
        upp = (torch.where(coll, bound, pos) if below else pos) - radius
        return jac[:, 2], low, upp


def call_linearize_rows(obstacle, points, jac, jq, radius, movable=None):
    """Invoke an obstacle's ``linearize_rows``, forwarding ``movable`` only
    when the implementation accepts it (user obstacles written against the
    4-argument protocol keep working)."""
    try:
        params = inspect.signature(obstacle.linearize_rows).parameters
        accepts = "movable" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):  # builtins/partials without signatures
        accepts = True
    if accepts and movable is not None:
        return obstacle.linearize_rows(points, jac, jq, radius, movable=movable)
    return obstacle.linearize_rows(points, jac, jq, radius)
