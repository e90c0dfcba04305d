"""UR5e analytical kinematics: structure-of-arrays FK + geometric Jacobian.

Counterpart of ``osqp_solver_tpu/models/ur5e.py`` for the batched evaluator
the SCP linearization uses (DH constants, ``_soa_compose``,
``fk_jacobian_points``, ``make_ball``).  The 4×4-matrix FK, the autodiff
Jacobians and the closed-form IK of that module are not ported yet.

Classic DH parameters (Universal Robots published values for the UR5e)::

    i | a[m]     d[m]    alpha
    1 | 0        0.1625   π/2
    2 | -0.425   0        0
    3 | -0.3922  0        0
    4 | 0        0.1333   π/2
    5 | 0        0.0997  -π/2
    6 | 0        0.0996   0

Each rotation entry / origin coordinate is its own tensor over the batch
dims, so every op is elementwise.  The Jacobian is the geometric one —
``J[:, i] = z_i × (p_E − p_i)`` for a revolute joint about axis ``z_i``
through ``p_i``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

D1, D4, D5, D6 = 0.1625, 0.1333, 0.0997, 0.0996
A2, A3 = -0.425, -0.3922
ALPHA = (np.pi / 2, 0.0, 0.0, np.pi / 2, -np.pi / 2, 0.0)
A_ = (0.0, A2, A3, 0.0, 0.0, 0.0)
D_ = (D1, 0.0, 0.0, D4, D5, D6)

NUM_JOINTS = 6

# Exact (cos α, sin α) per joint — α ∈ {π/2, 0, −π/2}.
_CA_SA = ((0.0, 1.0), (1.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.0, -1.0), (1.0, 0.0))

_FRAME_LINKS = {"tool": 6, "back6": 5, "elbow": 2}


def _soa_compose(R, p, th, i):
    """(R, p) ∘ DH-link i at angle ``th`` — all entries same-shape tensors."""
    ct, st = torch.cos(th), torch.sin(th)
    ca, sa = _CA_SA[i]
    a, d = A_[i], D_[i]
    cols = (
        (ct, st, 0.0),
        (-st * ca, ct * ca, sa),
        (st * sa, -ct * sa, ca),
    )

    def dot_row(i_, col):
        acc = None
        for k in range(3):
            ck = col[k]
            if isinstance(ck, float) and ck == 0.0:
                continue
            term = R[i_][k] * ck
            acc = term if acc is None else acc + term
        return acc

    Rn = [[dot_row(i_, cols[j]) for j in range(3)] for i_ in range(3)]
    pn = tuple(
        p[i_]
        + (R[i_][0] * (a * ct) if a else 0.0)
        + (R[i_][1] * (a * st) if a else 0.0)
        + (R[i_][2] * d if d else 0.0)
        for i_ in range(3)
    )
    return Rn, pn


def fk_jacobian_points(q, frame: str = "tool", axis: int = -1):
    """Batched FK point + 3×6 position Jacobian, SoA form.

    ``q``: joint configurations with the 6 joints along ``axis`` and
    arbitrary other dims.  Returns ``(points, jac)``: ``points`` has a
    3-axis where ``q`` had the joint axis; ``jac`` has ``(3, 6)`` there.
    With the default ``axis=-1`` that is ``(..., 3)`` and ``(..., 3, 6)``;
    the batch-trailing assembly passes ``(W, 6, B)`` with ``axis=1`` and
    gets ``(W, 3, B)`` and ``(W, 3, 6, B)``.  ``frame``: "tool" (frame-6
    origin), "back6" (frame-5 origin), "elbow" (frame-2 origin).
    """
    n_links = _FRAME_LINKS[frame]
    axis = axis % q.dim()
    th = q.unbind(dim=axis)
    zero = torch.zeros_like(th[0])
    one = torch.ones_like(th[0])
    R = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    p = (zero, zero, zero)
    axes, origins = [], []
    for i in range(n_links):
        # Joint i rotates about the CURRENT frame's z-axis through its origin.
        axes.append((R[0][2], R[1][2], R[2][2]))
        origins.append(p)
        R, p = _soa_compose(R, p, th[i], i)

    cols = []
    for i in range(NUM_JOINTS):
        if i < n_links:
            zx, zy, zz = axes[i]
            rx, ry, rz = (p[0] - origins[i][0], p[1] - origins[i][1],
                          p[2] - origins[i][2])
            cols.append((zy * rz - zz * ry, zz * rx - zx * rz,
                         zx * ry - zy * rx))
        else:
            cols.append((zero, zero, zero))
    points = torch.stack(p, dim=axis)
    jac = torch.stack(
        [torch.stack([cols[i][ax] for i in range(NUM_JOINTS)], dim=axis)
         for ax in range(3)],
        dim=axis,
    )
    return points, jac


def make_ball(frame: str, radius: float, is_gripper: bool = False):
    """UR5e :class:`~osqp_solver_tpu_torch.models.robot.RobotBall` carrying
    the SoA batched evaluator (``fk_jac_batched``) only."""
    from .robot import RobotBall

    return RobotBall(
        radius=radius, is_gripper=is_gripper,
        fk_jac_batched=partial(fk_jacobian_points, frame=frame),
    )
