"""Dense constraint assembly with the reference's fluent API.

Counterpart of ``osqp_solver_tpu/gomp/builder.py`` (``ConstraintBuilder``,
the reference's ``constraint-builder.h:19-151``).  The reference
accumulates Eigen triplets into a sparse CSC matrix; this builder writes
straight into a dense ``(n_rows, n_vars)`` float64 numpy array whose row and
column layout is fixed by :class:`~.layout.TrajectoryLayout`, on the host.
The reference's "dummy constraint" rows, which keep the sparsity pattern
fixed across SCP iterations (``constraint-builder.h:108-117``), are written
as it writes them.

This is the test and small-problem path: its ``(l, A, u)`` become a
:class:`~osqp_solver_tpu_torch.ops.qp.DenseQP` for the generic solver
(``ops/admm.py``).  The planner's SCP path assembles the structured
:class:`~.trajectory_qp.TrajectoryQP` instead.

The reference builder evaluates a ball's FK and Jacobian one waypoint at a
time; here :func:`~osqp_solver_tpu_torch.models.robot.ball_fk_jac`
evaluates them at every waypoint at once (``fk_jac_batched`` where the ball
has one, else ``fk``/``jacobian`` under ``torch.func.vmap``).  Rows come out
in the reference's order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .constraints import Constraint, INF, is_loose
from .geometry import HorizontalLine
from .layout import make_layout
from ..models.robot import RobotBall, ball_fk_jac

# <lower_bounds, constraint_matrix, upper_bounds> — mirror of QPConstraints
# (constraint-builder.h:16); dense here.
QPConstraints = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


class ConstraintBuilder:
    """Fluent builder for the trajectory QP's ``(l, A, u)``.

    Mirrors ``ConstraintBuilder<N_DIM>`` (``constraint-builder.h:19-151``):
    the constructor appends the dynamics rows ``v_t - q_{t+1} + q_t = 0``
    and allocates every other row with ``(-INF, INF)`` bounds.  Obstacles
    are the port's (``gomp/geometry.py``); their tensors are moved to the
    CPU in float64.
    """

    def __init__(
        self,
        waypoints: int,
        n_dim: int,
        balls: Sequence[RobotBall] = (),
        obstacles: Sequence = (),
    ):
        self.layout = make_layout(
            waypoints, n_dim, [b.is_gripper for b in balls], len(obstacles)
        )
        self.waypoints = waypoints
        self.n_dim = n_dim
        self.balls = list(balls)
        self.obstacles = [o.to(device="cpu", dtype=torch.float64)
                          for o in obstacles]

        m, n = self.layout.n_rows, self.layout.n_vars
        self.A = np.zeros((m, n), dtype=np.float64)
        self.l = np.full((m,), -INF, dtype=np.float64)
        self.u = np.full((m,), INF, dtype=np.float64)

        self._link_velocity_to_position()

    # ------------------------------------------------------------------ box

    def position(self, i: int, c: Constraint) -> "ConstraintBuilder":
        return self.positions(i, i, c)

    def positions(self, first: int, last: int,
                  c: Constraint) -> "ConstraintBuilder":
        for i in range(first, last + 1):
            self._constrain_variable(self.layout.nth_pos(i), c)
        return self

    def velocity(self, i: int, c: Constraint) -> "ConstraintBuilder":
        assert 0 <= i < self.waypoints - 1
        return self.velocities(i, i, c)

    def velocities(self, first: int, last: int,
                   c: Constraint) -> "ConstraintBuilder":
        assert first <= last < self.waypoints - 1
        for i in range(first, last + 1):
            self._constrain_variable(self.layout.nth_velocity(i), c)
        return self

    def acceleration(self, i: int, c: Constraint) -> "ConstraintBuilder":
        """``l <= v_{t+1} - v_t <= u`` rows (``constraint-builder.h:71-88``)."""
        assert i + 2 < self.waypoints
        lay = self.layout
        row = lay.user_offset + lay.nth_acceleration(i)
        base_v = lay.nth_velocity(i)
        base_nv = lay.nth_velocity(i + 1)
        for j in range(self.n_dim):
            self._add_constraint(
                row + j, [(base_nv + j, 1.0), (base_v + j, -1.0)],
                c.lower[j], c.upper[j],
            )
        return self

    def accelerations(self, first: int, last: int,
                      c: Constraint) -> "ConstraintBuilder":
        for i in range(first, last + 1):
            self.acceleration(i, c)
        return self

    # ------------------------------------------------------ SCP linearization

    def with_obstacles(self, con_3d: Constraint,
                       trajectory) -> "ConstraintBuilder":
        """Linearized workspace and obstacle rows
        (``constraint-builder.h:90-122``).

        ``trajectory`` is the current ``(2*W*N,)`` iterate; only its
        position half is read (the reference test
        ``ignore_velocity_trajectory``)."""
        lay = self.layout
        W, N = self.waypoints, self.n_dim
        q_traj = np.asarray(trajectory, dtype=np.float64)[: W * N].reshape(W, N)
        q_t = torch.from_numpy(q_traj)

        for b, ball in enumerate(self.balls):
            pts_t, jac_t = ball_fk_jac(ball, q_t)  # (W, 3), (W, 3, N)
            points, jacs = _host(pts_t), _host(jac_t)
            jq_t = torch.einsum("wan,wn->wa", jac_t.to(torch.float64), q_t)
            # The reference's HorizontalLine keeps its scalar per-waypoint
            # loop below; other obstacles (SphereObstacle, ...) give their
            # rows through the vectorized protocol of gomp/geometry.py.
            per_obs = []
            for obs in self.obstacles:
                if isinstance(obs, HorizontalLine):
                    per_obs.append(("line", _host(obs.has_collision(
                        pts_t.to(torch.float64), ball.radius))))
                else:
                    per_obs.append(("generic", tuple(
                        _host(torch.as_tensor(a)) for a in obs.linearize_rows(
                            pts_t.to(torch.float64), jac_t.to(torch.float64),
                            jq_t, ball.radius))))
            for t in range(W):
                q, p, jac = q_traj[t], points[t], jacs[t]
                k = 0
                if ball.is_gripper:
                    # constraint-builder.h:221-244: per axis,
                    # bound = con3d_axis - p_axis + J_axis·q  (±radius).
                    for axis in range(3):
                        low, upp = -INF, INF
                        if not is_loose(con_3d.lower[axis]):
                            low = con_3d.lower[axis] - p[axis] + jac[axis] @ q
                        if not is_loose(con_3d.upper[axis]):
                            upp = con_3d.upper[axis] - p[axis] + jac[axis] @ q
                        self._ws_row(lay.workspace_row(b, t, k), ball, jac,
                                     axis, t, low, upp)
                        k += 1
                for o, obstacle in enumerate(self.obstacles):
                    row = lay.workspace_row(b, t, k)
                    k += 1
                    kind, data = per_obs[o]
                    if kind == "generic":
                        row_jac, g_low, g_upp = data
                        self._ws_row_raw(row, row_jac[t], t, float(g_low[t]),
                                         float(g_upp[t]))
                        continue
                    if bool(data[t]):
                        # constraint-builder.h:246-267: one Z row bounding
                        # J_z·q above/below the line at the closest point.
                        closest = _host(obstacle.closest_point(
                            torch.from_numpy(p)))
                        bound = float(closest[2]) - p[2] + jac[2] @ q
                        if bool(obstacle.bypass_from_below):
                            low, upp = -INF, bound
                        else:
                            low, upp = bound, INF
                    else:
                        # Dummy row: the same coefficients, infinite bounds
                        # (constraint-builder.h:112-116).
                        low, upp = -INF, INF
                    self._ws_row(row, ball, jac, 2, t, low, upp)
        return self

    # --------------------------------------------------------------- output

    def build(self) -> QPConstraints:
        """Copies of ``(l, A, u)`` (``constraint-builder.h:124-136``)."""
        return self.l.copy(), self.A.copy(), self.u.copy()

    # Index mirrors (constraint-builder.h:138-151).
    def nth_pos(self, i: int) -> int:
        return self.layout.nth_pos(i)

    def nth_velocity(self, i: int) -> int:
        return self.layout.nth_velocity(i)

    def nth_acceleration(self, i: int) -> int:
        return self.layout.nth_acceleration(i)

    # -------------------------------------------------------------- internal

    def _add_constraint(self, row: int, factors: Sequence[Tuple[int, float]],
                        low: Optional[float], upp: Optional[float]) -> None:
        """Mirror of ``addConstraint`` (``constraint-builder.h:173-183``).

        A loose (±INF) bound leaves the existing bound as it is, as the
        reference leaves an absent optional unwritten; coefficients
        overwrite (the reference keeps the newest of duplicate triplets,
        ``constraint-builder.h:128-129``)."""
        for var, coeff in factors:
            self.A[row, var] = coeff
        if low is not None and not is_loose(low):
            self.l[row] = low
        if upp is not None and not is_loose(upp):
            self.u[row] = upp
        assert self.l[row] <= self.u[row], f"l > u at row {row}"

    def _ws_row(self, row, ball, jac, axis, waypoint, low, upp) -> None:
        """Workspace row: ``J_axis`` over the ``q_t`` variables, bounds
        tightened by ±radius (``constraint-builder.h:269-281``) and written
        whatever their value, as the reference passes concrete doubles."""
        base = self.layout.nth_pos(waypoint)
        self.A[row, base: base + self.n_dim] = jac[axis]
        self.l[row] = low + ball.radius
        self.u[row] = upp - ball.radius
        assert self.l[row] <= self.u[row], f"l > u at workspace row {row}"

    def _ws_row_raw(self, row, row_vec, waypoint, low, upp) -> None:
        """Workspace row of any direction ``row_vec`` over the ``q_t``
        variables, bounds as given (the obstacle protocol's
        ``linearize_rows`` has applied the ball's radius)."""
        base = self.layout.nth_pos(waypoint)
        self.A[row, base: base + self.n_dim] = row_vec
        self.l[row] = low
        self.u[row] = upp
        assert self.l[row] <= self.u[row], f"l > u at workspace row {row}"

    def _constrain_variable(self, var_start: int, c: Constraint) -> None:
        """Identity box rows of one N-dim variable group
        (``constraint-builder.h:185-193``)."""
        for j in range(self.n_dim):
            self._add_constraint(
                self.layout.user_offset + var_start + j,
                [(var_start + j, 1.0)], c.lower[j], c.upper[j],
            )

    def _link_velocity_to_position(self) -> None:
        """Dynamics rows ``v_t - q_{t+1} + q_t = 0``
        (``constraint-builder.h:203-219``)."""
        lay = self.layout
        for i in range(self.waypoints - 1):
            base_v = lay.nth_velocity(i)
            base_p = lay.nth_pos(i)
            base_np = lay.nth_pos(i + 1)
            for j in range(self.n_dim):
                self._add_constraint(
                    i * self.n_dim + j,
                    [(base_v + j, 1.0), (base_np + j, -1.0),
                     (base_p + j, 1.0)],
                    0.0, 0.0,
                )
