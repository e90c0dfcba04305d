"""Robot collision-ball abstraction.

Counterpart of ``osqp_solver_tpu/models/robot.py`` (``RobotBall``): a sphere
of ``radius`` attached to a robot frame, located by a forward-kinematics
function ``fk(q) -> (3,)`` with Jacobian ``jacobian(q) -> (3, N)``.
``is_gripper`` marks the ball whose position is boxed by the 3-D workspace
constraint.  ``fk`` / ``jacobian`` take one configuration ``q (N,)`` and
must be made of torch operations that ``torch.func.vmap`` can batch
(:func:`ball_fk_jac` evaluates them at every waypoint and problem).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class RobotBall:
    radius: float
    is_gripper: bool = False
    # Optional combined batched evaluator ``q -> (points, jac)`` on tensors
    # whose joint axis is given by its ``axis`` keyword (see
    # ``models/ur5e.py::fk_jacobian_points``).  When set, the SCP
    # linearization and the planner's audit use it instead of the
    # per-configuration callables; it must compute the same function.
    fk_jac_batched: Optional[Callable] = None
    fk: Optional[Callable] = None  # q (N,) -> point (3,)
    jacobian: Optional[Callable] = None  # q (N,) -> (3, N)


def _per_configuration(fn, q, axis: int, dtype):
    """``fn (N,) -> (*shape)`` at every configuration of ``q`` (joint axis
    ``axis``), batched with ``torch.func.vmap``; the result has ``shape``
    where ``q`` had its joint axis."""
    axis = axis % q.dim()
    qm = q.movedim(axis, -1)
    lead = tuple(qm.shape[:-1])
    out = torch.func.vmap(fn)(qm.reshape(-1, qm.shape[-1]))
    out = torch.as_tensor(out).to(dtype)
    k = out.dim() - 1
    out = out.reshape(lead + tuple(out.shape[1:]))
    dims = list(range(len(lead)))
    return out.permute(dims[:axis] + list(range(len(lead), len(lead) + k))
                       + dims[axis:])


def ball_fk_jac(ball: RobotBall, q, axis: int = -1, jacobian: bool = True):
    """``(points, jac)`` of ``ball`` at configurations ``q`` (joint axis
    ``axis``): ``3`` and ``(3, N)`` where ``q`` had its joint axis.  Through
    ``fk_jac_batched`` where the ball has one, else ``fk`` and ``jacobian``
    at every configuration (``jac`` ``None`` when not asked for)."""
    if ball.fk_jac_batched is not None:
        points, jac = ball.fk_jac_batched(q, axis=axis)
        return points, (jac if jacobian else None)
    points = _per_configuration(ball.fk, q, axis, q.dtype)
    jac = (_per_configuration(ball.jacobian, q, axis, q.dtype)
           if jacobian else None)
    return points, jac
