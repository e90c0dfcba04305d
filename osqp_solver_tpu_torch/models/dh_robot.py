"""Generic DH-parameterized robot arms.

Counterpart of ``osqp_solver_tpu/models/dh_robot.py``: a classic-DH
table-driven arm of any number of joints, revolute or prismatic, with

* the matrix-path FK of any frame (``link_transform``, ``frames``,
  ``point_fk``, ``pose_fk``) and the per-configuration callables of a
  :class:`~osqp_solver_tpu_torch.models.robot.RobotBall` (``fk(link)``,
  ``jacobian(link)``: ``torch.func.jacfwd`` of the matrix path, as the
  reference's ``jax.jacfwd``);
* the structure-of-arrays batched FK and geometric Jacobian the planner's
  SCP linearization uses (``fk_jacobian_points``, ``fk_pose_jacobian``):
  every rotation entry is its own tensor over the batch dims, the twists
  that are axis-aligned are snapped to exact 0 / ±1 so that their terms
  drop out when the walk is built, and the joint axis is given by ``axis``
  (the planner passes ``(W, N, *batch)`` with ``axis=1``), as
  ``models/ur5e.py::fk_jacobian_points`` takes it;
* damped-least-squares position and pose IK on batched targets
  ``(..., 3)`` (the reference vmaps; here the batch dims are written out),
  the iteration in PyTorch on the targets' device;
* the presets ``UR5E`` (built from ``models/ur5e.py``'s constants),
  ``UR10E``, the 7-joint ``IIWA14`` and the 4-joint ``SCARA`` (RRPR: a
  prismatic Z stroke).

Classic DH convention throughout: ``T_i = Rz(θ_i)·Tz(d_i)·Tx(a_i)·Rx(α_i)``;
a prismatic joint's variable adds to ``d_i`` and ``θ_i`` stays fixed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import torch


def _snap(x: float) -> float:
    """cos/sin of an axis-aligned angle snapped to exact 0 / ±1, so that the
    SoA walk drops the corresponding terms."""
    for v in (0.0, 1.0, -1.0):
        if abs(x - v) < 1e-12:
            return v
    return float(x)


def _is_num(v) -> bool:
    return isinstance(v, (int, float))


def _as_float(x, device=None):
    """``x`` as a floating tensor: a tensor keeps its device (integers take
    the default dtype), anything else goes to ``device`` (the entry-point
    rule: CUDA unless ``"cpu"`` is asked for)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.get_default_dtype())
    from ..ops.admm import resolve_device

    t = torch.as_tensor(x, device=resolve_device(device))
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


@dataclass(frozen=True)
class DHRobot:
    """A serial arm given by its classic DH table.

    ``a``/``d``/``alpha``: per-joint link length, offset and twist (meters,
    radians), all of length N.  ``joint_types``: per joint ``"r"``
    (revolute: the joint variable is θᵢ, ``d[i]`` fixed) or ``"p"``
    (prismatic: the joint variable adds to ``d[i]``, θ fixed at
    ``theta[i]``); all revolute by default.
    """

    a: Tuple[float, ...]
    d: Tuple[float, ...]
    alpha: Tuple[float, ...]
    name: str = "dh-robot"
    joint_types: Tuple[str, ...] | None = None
    theta: Tuple[float, ...] | None = None  # fixed θ of prismatic joints

    def __post_init__(self):
        assert len(self.a) == len(self.d) == len(self.alpha), (
            self.a, self.d, self.alpha)
        if self.joint_types is None:
            object.__setattr__(self, "joint_types", ("r",) * len(self.a))
        if self.theta is None:
            object.__setattr__(self, "theta", (0.0,) * len(self.a))
        assert len(self.joint_types) == len(self.a) and all(
            t in ("r", "p") for t in self.joint_types
        ), self.joint_types
        assert len(self.theta) == len(self.a)

    @property
    def n_joints(self) -> int:
        return len(self.a)

    # -- matrix path ---------------------------------------------------------

    def link_transform(self, i: int, qi):
        """Link transform ``(..., 4, 4)`` at joint variable ``qi`` (any
        shape): θᵢ for a revolute joint, the extension added to ``d[i]``
        for a prismatic one."""
        qi = torch.as_tensor(qi)
        # The constants as tensors of qi's type (the values a Python float
        # would round to): under torch.func.jacfwd a Python float factor
        # promotes a float32 tangent to float64.
        const = lambda v: torch.tensor(  # noqa: E731
            v, dtype=qi.dtype, device=qi.device)
        if self.joint_types[i] == "r":
            theta, d = qi, const(self.d[i]) * torch.ones_like(qi)
        else:
            theta = torch.full_like(qi, self.theta[i])
            d = const(self.d[i]) + qi
        ct, st = torch.cos(theta), torch.sin(theta)
        ca = const(_snap(math.cos(self.alpha[i])))
        sa = const(_snap(math.sin(self.alpha[i])))
        a = const(self.a[i])
        zero, one = torch.zeros_like(ct), torch.ones_like(ct)
        rows = (
            (ct, -st * ca, st * sa, a * ct),
            (st, ct * ca, -ct * sa, a * st),
            (zero, sa * one, ca * one, d),
            (zero, zero, zero, one),
        )
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def _chain(self, q, links: int):
        """``[T_00, ..., T_0links]`` of configurations ``q (..., N)``."""
        q = torch.as_tensor(q)
        T = torch.eye(4, dtype=q.dtype, device=q.device).expand(
            tuple(q.shape[:-1]) + (4, 4))
        out = [T]
        for i in range(links):
            T = T @ self.link_transform(i, q[..., i])
            out.append(T)
        return out

    def frames(self, q):
        """Cumulative transforms ``T_0i`` for i = 0..N: ``(..., N+1, 4,
        4)`` of ``q (..., N)``."""
        return torch.stack(self._chain(q, self.n_joints), dim=-3)

    def point_fk(self, q, link: int | None = None):
        """Origin of frame ``link`` (default: the tool frame N), ``(...,
        3)``."""
        link = self.n_joints if link is None else int(link)
        return self._chain(q, link)[-1][..., :3, 3]

    def pose_fk(self, q, link: int | None = None):
        """``(point (..., 3), R (..., 3, 3))`` of frame ``link`` (matrix
        path)."""
        link = self.n_joints if link is None else int(link)
        T = self._chain(q, link)[-1]
        return T[..., :3, 3], T[..., :3, :3]

    def fk(self, link: int | None = None):
        """``q (N,) -> point (3,)`` callable for :class:`RobotBall.fk`."""
        return partial(self.point_fk, link=link)

    def jacobian(self, link: int | None = None):
        """``q (N,) -> (3, N)``: the exact position Jacobian, forward-mode
        autodiff of the matrix-path FK (as the reference's ``jacfwd``)."""
        return torch.func.jacfwd(self.fk(link))

    # -- structure-of-arrays batched path ------------------------------------

    def _soa_compose(self, R, p, qi, i):
        """(R, p) ∘ DH link i at joint variable ``qi`` (every entry a
        tensor of the batch shape).  Revolute: θ = ``qi``; prismatic: θ
        fixed (cos/sin snapped) and ``qi`` extends ``d[i]``."""
        if self.joint_types[i] == "r":
            ct, st = torch.cos(qi), torch.sin(qi)
            d = self.d[i]
        else:
            ct = _snap(math.cos(self.theta[i]))
            st = _snap(math.sin(self.theta[i]))
            d = self.d[i] + qi
        ca, sa = _snap(math.cos(self.alpha[i])), _snap(math.sin(self.alpha[i]))
        a = self.a[i]
        cols = (
            (ct, st, 0.0),
            (-st * ca, ct * ca, sa),
            (st * sa, -ct * sa, ca),
        )

        def dot_row(r, col):
            acc = None
            for k in range(3):
                ck = col[k]
                if isinstance(ck, float) and ck == 0.0:
                    continue
                term = R[r][k] * ck
                acc = term if acc is None else acc + term
            return acc

        Rn = [[dot_row(r, cols[j]) for j in range(3)] for r in range(3)]
        pn = tuple(
            p[r]
            + (R[r][0] * (a * ct) if not (_is_num(a) and a == 0.0
                                          or _is_num(ct) and ct == 0.0)
               else 0.0)
            + (R[r][1] * (a * st) if not (_is_num(a) and a == 0.0
                                          or _is_num(st) and st == 0.0)
               else 0.0)
            + (R[r][2] * d if not (_is_num(d) and d == 0.0) else 0.0)
            for r in range(3)
        )
        return Rn, pn

    def _fk_soa(self, q, link: int | None = None, axis: int = -1):
        """The SoA walk to frame ``link``: ``(points, Jp, R, Jw)`` with
        ``3``, ``(3, N)``, ``(3, 3)`` and ``(3, N)`` where ``q`` has its
        joint axis ``axis``.  ``Jw``'s column i is the joint axis ``z_i`` in
        the base frame (zero for a prismatic joint); columns i ≥ link are
        zero."""
        q = torch.as_tensor(q)
        n = self.n_joints
        link = n if link is None else int(link)
        axis = axis % q.dim()
        th = q.unbind(dim=axis)
        zero, one = torch.zeros_like(th[0]), torch.ones_like(th[0])
        R = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
        p = (zero, zero, zero)
        axes, origins = [], []
        for i in range(link):
            axes.append((R[0][2], R[1][2], R[2][2]))
            origins.append(p)
            R, p = self._soa_compose(R, p, th[i], i)

        cols = []
        for i in range(n):
            if i < link:
                zx, zy, zz = axes[i]
                if self.joint_types[i] == "p":
                    # linear motion along the joint axis: the column is z_i
                    cols.append((zx, zy, zz))
                    continue
                rx, ry, rz = (p[0] - origins[i][0], p[1] - origins[i][1],
                              p[2] - origins[i][2])
                cols.append((zy * rz - zz * ry, zz * rx - zx * rz,
                             zx * ry - zy * rx))
            else:
                cols.append((zero, zero, zero))

        def table(entry, width):
            return torch.stack(
                [torch.stack([entry(r, c) for c in range(width)], dim=axis)
                 for r in range(3)], dim=axis)

        points = torch.stack(p, dim=axis)
        jac = table(lambda ax, i: cols[i][ax], n)
        rot = table(lambda r, c: R[r][c], 3)
        jac_w = table(lambda ax, i: axes[i][ax] if i < link and
                      self.joint_types[i] == "r" else zero, n)
        return points, jac, rot, jac_w

    def fk_jacobian_points(self, q, link: int | None = None, axis: int = -1):
        """Batched FK point and 3×N geometric Jacobian, SoA form.

        ``q``: configurations with the N joints along ``axis`` and any
        other dims; returns ``(points, jac)`` with ``3`` and ``(3, N)``
        where ``q`` had its joint axis (``(..., 3)``, ``(..., 3, N)`` for
        the default ``axis=-1``).  Column ``J[:, i] = z_i × (p_link − p_i)``
        (revolute) or ``z_i`` (prismatic): the function ``jacobian(link)``
        computes."""
        points, jac, _, _ = self._fk_soa(q, link, axis)
        return points, jac

    def fk_pose_jacobian(self, q, link: int | None = None, axis: int = -1):
        """Batched full-pose FK: ``(point, R, Jp, Jw)`` with ``3``,
        ``(3, 3)``, ``(3, N)``, ``(3, N)`` where ``q`` has its joint axis —
        the task-space surface behind :meth:`pose_ik`."""
        points, jac, rot, jac_w = self._fk_soa(q, link, axis)
        return points, rot, jac, jac_w

    def make_ball(self, link: int | None = None, radius: float = 0.05,
                  is_gripper: bool = False):
        """:class:`~osqp_solver_tpu_torch.models.robot.RobotBall` at frame
        ``link`` with the per-configuration callables and the SoA batched
        evaluator."""
        from .robot import RobotBall

        return RobotBall(
            radius=radius,
            is_gripper=is_gripper,
            fk_jac_batched=partial(self.fk_jacobian_points, link=link),
            fk=self.fk(link),
            jacobian=self.jacobian(link),
        )

    # -- numeric IK ----------------------------------------------------------

    @staticmethod
    def _default_tol(dtype) -> float:
        """Convergence tolerance by dtype: 1e-6 in float64, 1e-4 below (f32
        FK noise sits above 1e-6)."""
        return 1e-6 if dtype == torch.float64 else 1e-4

    def position_ik(self, p, q0=None, link: int | None = None,
                    iters: int = 64, damping: float = 1e-3,
                    tol: float | None = None, device=None):
        """Damped-least-squares position IK: q with ``fk(q) ≈ p``.

        ``p (..., 3)``: targets, any batch dims (a tensor keeps its device;
        anything else goes to ``device``, CUDA unless ``"cpu"``).  ``q0``:
        ``(N,)`` or ``(..., N)`` starting configurations (zeros by
        default).  Each of ``iters`` steps is ``dq = Jᵀ (J Jᵀ + λ² I)⁻¹ e``
        (for a redundant arm the minimum-norm step).  Returns ``(q (...,
        N), converged (...))``, converged where ``‖fk(q) − p‖ ≤ tol``
        (``tol`` by dtype: 1e-6 f64, 1e-4 f32).  Float32 products run in
        full precision: TF32 stalls DLS short of the f32 tolerance."""
        from ..ops.admm import pin_matmul_precision

        pin_matmul_precision()
        p = _as_float(p, device)
        if tol is None:
            tol = self._default_tol(p.dtype)
        q = self._start(q0, p)
        lam2 = damping ** 2
        eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
        for _ in range(iters):
            pt, J = self.fk_jacobian_points(q, link=link)
            e = p - pt
            JJt = J @ J.mT + lam2 * eye3
            q = q + (J.mT @ torch.linalg.solve(JJt, e[..., None]))[..., 0]
        err = torch.linalg.vector_norm(self.point_fk(q, link) - p, dim=-1)
        return q, err <= tol

    def pose_ik(self, p, rot, q0=None, link: int | None = None,
                iters: int = 96, damping: float = 1e-3,
                tol: float | None = None, tol_rot: float | None = None,
                device=None):
        """Damped-least-squares full-pose IK: ``fk(q) ≈ p`` and the frame's
        rotation ≈ ``rot (..., 3, 3)``.

        The 6-D task error ``[p − p(q); ½ Σᵢ R(q)[:, i] × rot[:, i]]`` and
        the stacked geometric Jacobian ``[Jp; Jw]``; the step is
        :meth:`position_ik`'s.  Returns ``(q, converged)``: position error
        ≤ ``tol`` and relative-rotation angle ≤ ``tol_rot`` (radians;
        1e-6 f64, 1e-3 f32 by default).  The orientation error also
        vanishes at the antipode: seed ``q0`` within a half-turn."""
        from ..ops.admm import pin_matmul_precision

        pin_matmul_precision()
        p = _as_float(p, device)
        rot = torch.as_tensor(rot, dtype=p.dtype, device=p.device)
        if tol is None:
            tol = self._default_tol(p.dtype)
        if tol_rot is None:
            tol_rot = 1e-6 if p.dtype == torch.float64 else 1e-3
        q = self._start(q0, p)
        lam2 = damping ** 2
        eye6 = torch.eye(6, dtype=p.dtype, device=p.device)

        def orient_err(R):
            return 0.5 * sum(
                torch.linalg.cross(R[..., :, i], rot[..., :, i], dim=-1)
                for i in range(3))

        for _ in range(iters):
            pt, R, Jp, Jw = self.fk_pose_jacobian(q, link=link)
            e = torch.cat([p - pt, orient_err(R)], dim=-1)
            J = torch.cat([Jp, Jw], dim=-2)  # (..., 6, N)
            JJt = J @ J.mT + lam2 * eye6
            q = q + (J.mT @ torch.linalg.solve(JJt, e[..., None]))[..., 0]
        pt, R = self.pose_fk(q, link=link)
        pos_err = torch.linalg.vector_norm(pt - p, dim=-1)
        tr = (rot.mT @ R).diagonal(dim1=-2, dim2=-1).sum(-1)
        ang_err = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
        return q, (pos_err <= tol) & (ang_err <= tol_rot)

    def _start(self, q0, p):
        """``q0`` (zeros by default) broadcast to the targets' batch."""
        shape = tuple(p.shape[:-1]) + (self.n_joints,)
        if q0 is None:
            return torch.zeros(shape, dtype=p.dtype, device=p.device)
        q0 = torch.as_tensor(q0, dtype=p.dtype, device=p.device)
        return q0.expand(shape).clone()


def ik_checked(robot: DHRobot, p, *, rot=None, q0=None,
               link: int | None = None, **kw):
    """IK that raises :class:`~osqp_solver_tpu_torch.utils.types.
    NoInverseKinematicSolution` where DLS does not reach ``p`` (and, with
    ``rot``, the target orientation) — for any target of a batch."""
    from ..utils.types import NoInverseKinematicSolution

    if rot is None:
        q, ok = robot.position_ik(p, q0=q0, link=link, **kw)
    else:
        q, ok = robot.pose_ik(p, rot, q0=q0, link=link, **kw)
    if not bool(ok.all()):
        raise NoInverseKinematicSolution(
            tuple(float(v) for v in torch.as_tensor(p).reshape(-1)))
    return q


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_PI2 = math.pi / 2

from . import ur5e as _ur5e  # noqa: E402  (presets only)

#: Universal Robots UR5e, built from ``models/ur5e.py``'s DH constants.
UR5E = DHRobot(
    a=(0.0, _ur5e.A2, _ur5e.A3, 0.0, 0.0, 0.0),
    d=(_ur5e.D1, 0.0, 0.0, _ur5e.D4, _ur5e.D5, _ur5e.D6),
    alpha=tuple(float(x) for x in _ur5e.ALPHA),
    name="ur5e",
)

#: Universal Robots UR10e (published classic DH values).
UR10E = DHRobot(
    a=(0.0, -0.6127, -0.57155, 0.0, 0.0, 0.0),
    d=(0.1807, 0.0, 0.0, 0.17415, 0.11985, 0.11655),
    alpha=(_PI2, 0.0, 0.0, _PI2, -_PI2, 0.0),
    name="ur10e",
)

#: KUKA LBR iiwa 14 R820, classic-DH form: a 7-joint redundant arm.
IIWA14 = DHRobot(
    a=(0.0,) * 7,
    d=(0.36, 0.0, 0.42, 0.0, 0.4, 0.0, 0.126),
    alpha=(-_PI2, _PI2, _PI2, -_PI2, -_PI2, _PI2, 0.0),
    name="iiwa14",
)

#: A 4-joint SCARA (RRPR: two shoulder revolutes, a prismatic Z stroke, a
#: tool-rotation wrist; Epson LS6-class link lengths).  The α₂ = π flip
#: points the z₃/z₄ axes down, so +q₃ plunges the tool (z = 0.2 − q₃);
#: q₃ ∈ [0, 0.2] m.
SCARA = DHRobot(
    a=(0.325, 0.275, 0.0, 0.0),
    d=(0.2, 0.0, 0.0, 0.0),
    alpha=(0.0, math.pi, 0.0, 0.0),
    joint_types=("r", "r", "p", "r"),
    name="scara",
)
