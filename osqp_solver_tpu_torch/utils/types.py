"""Small shared types and constants of the reference's utils layer.

Counterpart of ``osqp_solver_tpu/utils/types.py`` (the port keeps its own
copy): the ``Axis`` enum, the ``CENTIMETER`` constant (unused, kept for
parity), the ``ERROR`` feasibility slack (canonical home
:mod:`osqp_solver_tpu_torch.gomp.geometry`) and the
``NoInverseKinematicSolution`` exception, raised by
:func:`~osqp_solver_tpu_torch.models.ur5e.inverse_kinematics_checked`.
"""
from __future__ import annotations

import enum

from ..gomp.geometry import ERROR  # noqa: F401  (re-export)


class Axis(enum.IntEnum):
    """Workspace axes."""

    X = 0
    Y = 1
    Z = 2


XYZ_AXES = (Axis.X, Axis.Y, Axis.Z)

CENTIMETER = 0.01  # unused in the reference as well


class NoInverseKinematicSolution(RuntimeError):
    """No IK branch reaches the requested point."""

    def __init__(self, point):
        super().__init__(f"No inverse kinematic solution exists for point {point}")
        self.point = point
