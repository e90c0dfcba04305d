"""UR5e analytical kinematics: FK, geometric Jacobian and closed-form IK.

Counterpart of ``osqp_solver_tpu/models/ur5e.py``: the 4×4-matrix FK
(``_dh``, ``link_transform``, ``frames``, ``tool_pose``,
``forward_kinematics*``), the batched structure-of-arrays evaluator the SCP
linearization uses (``_soa_compose``, ``fk_jacobian_points``,
``make_ball``) and the 8-branch closed-form IK (``inverse_kinematics*``,
``wrap_to_pi``).  Every function takes any leading batch shape: where the
reference vmaps, the batch dims are written out here.  The reference's
autodiff Jacobians (``joint_jacobian*``) are not ported: the geometric
Jacobian of ``fk_jacobian_points`` is the same function.

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

def _dh(theta, d, a, alpha):
    """Classic DH link transform ``Rz(θ)·Tz(d)·Tx(a)·Rx(α)`` as ``(...,
    4, 4)``; every argument a tensor of the batch shape or a number (in
    ``theta``'s dtype)."""
    theta = torch.as_tensor(theta)
    kw = dict(dtype=theta.dtype, device=theta.device)
    d, a, alpha = (torch.as_tensor(v, **kw) for v in (d, a, alpha))
    shape = torch.broadcast_shapes(theta.shape, d.shape, a.shape, alpha.shape)
    ct, st = torch.cos(theta), torch.sin(theta)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros(shape, **kw), torch.ones(shape, **kw)
    rows = (
        (ct, -st * ca, st * sa, a * ct),
        (st, ct * ca, -ct * sa, a * st),
        (zero, sa, ca, d),
        (zero, zero, zero, one),
    )
    return torch.stack(
        [torch.stack([v.expand(shape) for v in r], dim=-1) for r in rows],
        dim=-2,
    )


def link_transform(i: int, theta):
    return _dh(theta, D_[i], A_[i], ALPHA[i])


def _chain(q, links: int):
    """``T_0k`` for k = 0..links of configurations ``q (..., 6)``."""
    T = torch.eye(4, dtype=q.dtype, device=q.device).expand(
        tuple(q.shape[:-1]) + (4, 4))
    out = [T]
    for i in range(links):
        T = T @ link_transform(i, q[..., i])
        out.append(T)
    return out


def frames(q):
    """Cumulative transforms ``T_0i`` for i = 0..6: ``(..., 7, 4, 4)``."""
    return torch.stack(_chain(q, NUM_JOINTS), dim=-3)


def tool_pose(q):
    """Full 4×4 tool (frame 6) pose, ``(..., 4, 4)``."""
    return _chain(q, NUM_JOINTS)[-1]


def forward_kinematics(q):
    """Tool-point position ``(..., 3)``."""
    return tool_pose(q)[..., :3, 3]


def forward_kinematics_6_back(q):
    """Wrist point one link "back" from the tool (origin of frame 5)."""
    return _chain(q, 5)[-1][..., :3, 3]


def forward_kinematics_elbow_joint(q):
    """Elbow position (origin of frame 2, end of the upper arm)."""
    return _chain(q, 2)[-1][..., :3, 3]


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


# ---------------------------------------------------------------------------
# Closed-form inverse kinematics (8 branches)
# ---------------------------------------------------------------------------


def _inv_rigid(T):
    """Inverse of rigid transforms ``(..., 4, 4)``."""
    R = T[..., :3, :3]
    p = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ p)], dim=-1)
    bottom = torch.zeros_like(T[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def inverse_kinematics(T):
    """All 8 closed-form UR5e joint solutions for tool poses ``T (..., 4,
    4)``.

    Returns ``(solutions (..., 8, 6), valid (..., 8))``; ``valid`` is False
    where a branch is out of the workspace.  Branch order: (shoulder ±) ×
    (wrist ±) × (elbow ±), as the reference's.
    """
    T = torch.as_tensor(T)
    kw = dict(dtype=T.dtype, device=T.device)
    px, py = T[..., 0, 3], T[..., 1, 3]

    # θ1: shoulder.  Wrist center p05 = p06 − d6·z6.
    p05 = T[..., :3, 3] - D6 * T[..., :3, 2]
    R05 = torch.hypot(p05[..., 0], p05[..., 1])
    psi = torch.arctan2(p05[..., 1], p05[..., 0])
    phi = _safe_acos(D4 / torch.clamp(R05, min=1e-12))
    valid_1 = R05 >= abs(D4)
    sols, valids = [], []
    for th1 in (psi + phi + np.pi / 2, psi - phi + np.pi / 2):
        c1, s1 = torch.cos(th1), torch.sin(th1)
        # θ5: wrist-2 from the projection of p06 onto the θ1 plane.
        arg5 = (px * s1 - py * c1 - D4) / D6
        valid_5 = torch.abs(arg5) <= 1.0 + 1e-9
        th5_mag = _safe_acos(arg5)
        T01 = _dh(th1, D1, 0.0, ALPHA[0])
        for th5 in (th5_mag, -th5_mag):
            s5 = torch.sin(th5)
            sgn5 = torch.where(s5 >= 0, 1.0, -1.0).to(**kw)
            # θ6 from the base-frame x/y axes of the tool rotation.
            denom_ok = torch.abs(s5) > 1e-9
            q6 = torch.arctan2(
                sgn5 * -(T[..., 0, 1] * s1 - T[..., 1, 1] * c1),
                sgn5 * (T[..., 0, 0] * s1 - T[..., 1, 0] * c1),
            )
            th6 = torch.where(denom_ok, q6, torch.zeros_like(q6))
            # The planar 2R problem for θ2, θ3, θ4:
            # T14 = T01⁻¹ · T06 · T56⁻¹ · T45⁻¹.
            T45 = _dh(th5, D5, 0.0, ALPHA[4])
            T56 = _dh(th6, D6, 0.0, ALPHA[5])
            T14 = _inv_rigid(T01) @ T @ _inv_rigid(T56) @ _inv_rigid(T45)
            p13 = T14[..., :3, 3] - D4 * T14[..., :3, 1]
            L = torch.hypot(p13[..., 0], p13[..., 1])
            c3 = (L**2 - A2**2 - A3**2) / (2 * A2 * A3)
            valid_3 = torch.abs(c3) <= 1.0 + 1e-9
            th3_mag = _safe_acos(c3)
            for th3 in (th3_mag, -th3_mag):
                th2 = -torch.arctan2(p13[..., 1], -p13[..., 0]) + torch.arcsin(
                    torch.clamp(
                        A3 * torch.sin(th3) / torch.clamp(L, min=1e-12),
                        -1.0, 1.0,
                    )
                )
                # θ4 closes the chain: T34 = T23⁻¹ · T12⁻¹ · T14.
                T12 = _dh(th2, 0.0, A2, 0.0)
                T23 = _dh(th3, 0.0, A3, 0.0)
                T34 = _inv_rigid(T23) @ _inv_rigid(T12) @ T14
                th4 = torch.arctan2(T34[..., 1, 0], T34[..., 0, 0])
                sols.append(torch.stack([th1, th2, th3, th4, th5, th6],
                                        dim=-1))
                valids.append(valid_3 & valid_5 & valid_1)
    return torch.stack(sols, dim=-2), torch.stack(valids, dim=-1)


def inverse_kinematics_position(p, q_ref=None):
    """Position-only IK: the joint configurations ``(..., 6)`` whose tool
    point reaches ``p (..., 3)`` with a fixed downward-facing tool (z down,
    x along base x), the branch closest to ``q_ref`` (default zeros) among
    the valid ones (the first branch when none is), and its validity
    ``(...)``."""
    p = torch.as_tensor(p)
    kw = dict(dtype=p.dtype, device=p.device)
    R = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                     **kw).expand(tuple(p.shape[:-1]) + (3, 3))
    bottom = torch.zeros(tuple(p.shape[:-1]) + (1, 4), **kw)
    bottom[..., 0, 3] = 1.0
    T = torch.cat([torch.cat([R, p[..., None]], dim=-1), bottom], dim=-2)
    sols, valid = inverse_kinematics(T)
    if q_ref is None:
        q_ref = torch.zeros(6, **kw)
    q_ref = torch.as_tensor(q_ref, **kw)
    dist = torch.where(
        valid, ((sols - q_ref[..., None, :]) ** 2).sum(dim=-1),
        torch.full(valid.shape, float("inf"), **kw),
    )
    best = torch.argmin(dist, dim=-1, keepdim=True)
    q = torch.gather(sols, -2, best[..., None].expand(
        tuple(best.shape) + (6,))).squeeze(-2)
    return q, torch.gather(valid, -1, best).squeeze(-1)


def inverse_kinematics_checked(p, q_ref=None):
    """Position IK of one point ``p (3,)`` that raises
    :class:`~osqp_solver_tpu_torch.utils.types.NoInverseKinematicSolution`
    when no branch reaches it."""
    from ..utils.types import NoInverseKinematicSolution

    q, valid = inverse_kinematics_position(p, q_ref)
    if not bool(valid):
        raise NoInverseKinematicSolution(
            tuple(float(v) for v in torch.as_tensor(p).reshape(-1)))
    return q


def wrap_to_pi(q):
    """Wrap angles to (−π, π]."""
    return torch.arctan2(torch.sin(q), torch.cos(q))
