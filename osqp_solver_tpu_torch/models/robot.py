"""Robot collision-ball abstraction.

Counterpart of ``osqp_solver_tpu/models/robot.py`` (``RobotBall``): a sphere
of ``radius`` attached to a robot frame.  ``is_gripper`` marks the ball whose
position is boxed by the 3-D workspace constraint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class RobotBall:
    radius: float
    is_gripper: bool = False
    # Combined batched evaluator ``q -> (points, jac)`` on tensors whose
    # joint axis is given by its ``axis`` keyword (see
    # ``models/ur5e.py::fk_jacobian_points``).  The per-configuration
    # ``fk`` / ``jacobian`` callables of the reference are not ported yet.
    fk_jac_batched: Optional[Callable] = None
    fk: Optional[Callable] = None
    jacobian: Optional[Callable] = None
