"""Structured trajectory QP: container fields and constructors.

Counterpart of ``osqp_solver_tpu/gomp/trajectory_qp.py`` for the assembly
(``TrajectoryQP`` fields, ``smoothness_P_blocks``, ``empty_trajectory_qp``,
``with_gomp_boxes``, ``pinned_movable_mask``, ``with_horizon_mask``,
``with_gomp_boxes_masked``, ``linearize_workspace`` in its
``fk_jac_batched`` branch).  The horizon ``w_active`` of the masked
constructors is one Python int for the whole batch (the planner's host loop
knows it); the containers stay ``W_max``-shaped so that every horizon shares
one row layout, hence one build of the kernels.  The solver methods of the reference's container (``to_dense``,
the operator protocol for the vmapped solve) are not ported yet: the port
solves through :class:`~.trajectory_qp_lane.LaneTrajectoryQP`.

Where the reference ``vmap``s these constructors over a problem batch, the
batch is a written-out TRAILING dimension here: every array below may carry
extra trailing dims ``*batch`` (none, or ``(B,)``), per-problem inputs are
``(N, *batch)`` / ``(2WN, *batch)``, and the result lands batch-trailing —
the lane layout — with no relayout.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .constraints import INF, INF_THRESHOLD
from .geometry import call_linearize_rows


@dataclasses.dataclass(frozen=True)
class TrajectoryQP:
    # --- static structure ---------------------------------------------------
    waypoints: int
    n_dim: int
    gripper_flags: Tuple[bool, ...]
    n_obstacles: int

    # --- objective: block-tridiagonal P over interleaved [q_t, v_t] ---------
    P_diag: torch.Tensor  # (W, 2N, 2N, *batch)
    P_lower: torch.Tensor  # (W-1, 2N, 2N, *batch)
    q_vec: torch.Tensor  # (2WN, *batch) layout [q..., v...]

    # --- constraint blocks --------------------------------------------------
    dyn_coef: torch.Tensor  # (W-1, N, 3, *batch): on [v_t, q_{t+1}, q_t]
    dyn_l: torch.Tensor  # (W-1, N, *batch)
    dyn_u: torch.Tensor
    pos_coef: torch.Tensor  # (W, N, *batch)
    pos_l: torch.Tensor
    pos_u: torch.Tensor
    vel_coef: torch.Tensor  # (W-1, N, *batch)
    vel_l: torch.Tensor
    vel_u: torch.Tensor
    acc_coef: torch.Tensor  # (W-2, N, 2, *batch): on [v_{t+1}, v_t]
    acc_l: torch.Tensor
    acc_u: torch.Tensor
    ws_jac: torch.Tensor  # (n_balls, W, 3, N, *batch) — zero if not gripper
    ws_l: torch.Tensor  # (n_balls, W, 3, *batch)
    ws_u: torch.Tensor
    obs_jac: torch.Tensor  # (n_balls, n_obs, W, N, *batch)
    obs_l: torch.Tensor  # (n_balls, n_obs, W, *batch)
    obs_u: torch.Tensor

    # "block" = generic dense (2N, 2N) blocks; "vel_diag" = nonzeros only on
    # the velocity diagonal (the GOMP smoothness Laplacian).
    p_structure: str = "block"

    def replace(self, **changes) -> "TrajectoryQP":
        return dataclasses.replace(self, **changes)

    @property
    def n_balls(self) -> int:
        return len(self.gripper_flags)

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.q_vec.shape[1:])


# --------------------------------------------------------------------------
# Constructors
# --------------------------------------------------------------------------


def smoothness_P_blocks(waypoints: int, n_dim: int, dtype=torch.float64,
                        device="cpu"):
    """The GOMP objective in block-tridiagonal form: zero on positions,
    tridiag(2, -1) Laplacian across velocities."""
    W, N = waypoints, n_dim
    B = 2 * N
    eyeN = torch.eye(N, dtype=dtype, device=device)
    d = torch.zeros((B, B), dtype=dtype, device=device)
    d[N:, N:] = 2.0 * eyeN
    lo = torch.zeros((B, B), dtype=dtype, device=device)
    lo[N:, N:] = -1.0 * eyeN
    return d.repeat(W, 1, 1), lo.repeat(W - 1, 1, 1)


def empty_trajectory_qp(
    waypoints: int,
    n_dim: int,
    gripper_flags: Sequence[bool] = (),
    n_obstacles: int = 0,
    dtype=torch.float64,
    device="cpu",
    batch_shape: tuple = (),
) -> TrajectoryQP:
    """Fresh trajectory QP: dynamics rows wired (l=u=0), smoothness P, all
    other bounds at ±INF, workspace Jacobians zero.  ``batch_shape``: extra
    trailing dims every array carries (``()`` or ``(B,)``)."""
    W, N = waypoints, n_dim
    nb = len(gripper_flags)
    bs = tuple(batch_shape)
    kw = dict(dtype=dtype, device=device)

    def bcast(a):
        """Append the batch dims to a constant array."""
        a = a.reshape(tuple(a.shape) + (1,) * len(bs))
        return a.expand(tuple(a.shape[: a.dim() - len(bs)]) + bs).contiguous()

    P_diag, P_lower = smoothness_P_blocks(W, N, dtype, device)
    z = lambda *s: torch.zeros(s + bs, **kw)  # noqa: E731
    neg = lambda *s: torch.full(s + bs, -INF, **kw)  # noqa: E731
    pos = lambda *s: torch.full(s + bs, INF, **kw)  # noqa: E731
    return TrajectoryQP(
        waypoints=W,
        n_dim=N,
        gripper_flags=tuple(bool(g) for g in gripper_flags),
        n_obstacles=int(n_obstacles),
        P_diag=bcast(P_diag),
        P_lower=bcast(P_lower),
        q_vec=z(2 * W * N),
        dyn_coef=bcast(
            torch.tensor([1.0, -1.0, 1.0], **kw).expand(W - 1, N, 3)
        ),
        dyn_l=z(W - 1, N),
        dyn_u=z(W - 1, N),
        # Box-row coefficients start at zero: a box row's identity
        # coefficient is written only when with_gomp_boxes touches the row.
        pos_coef=z(W, N),
        pos_l=neg(W, N),
        pos_u=pos(W, N),
        vel_coef=z(W - 1, N),
        vel_l=neg(W - 1, N),
        vel_u=pos(W - 1, N),
        acc_coef=bcast(torch.tensor([1.0, -1.0], **kw).expand(W - 2, N, 2)),
        acc_l=neg(W - 2, N),
        acc_u=pos(W - 2, N),
        ws_jac=z(nb, W, 3, N),
        ws_l=neg(nb, W, 3),
        ws_u=pos(nb, W, 3),
        obs_jac=z(nb, n_obstacles, W, N),
        obs_l=neg(nb, n_obstacles, W),
        obs_u=pos(nb, n_obstacles, W),
        p_structure="vel_diag",
    )


def _masked(new, old):
    """Write ``new`` where finite, keep ``old`` where ``new`` is ±INF — the
    optional-bound write semantics."""
    return torch.where(new.abs() >= INF_THRESHOLD, old, new)


def with_gomp_boxes(
    qp: TrajectoryQP,
    start_pos,
    end_pos,
    pos_con,
    vel_con,
    acc_con,
) -> TrajectoryQP:
    """Apply the planner's box constraints, including the deliberate
    ``W-3`` endpoint quirk: ``q_0 = start``, ``q_1..q_{W-2}`` boxed,
    ``q_{W-3} = end``, ``v_0..v_{W-4}`` boxed, ``v_{W-3} = 0``,
    ``a_0..a_{W-4}`` boxed, ``a_{W-3} = 0``.

    ``start_pos``/``end_pos``: ``(N, *batch)``.  ``pos_con``/``vel_con``/
    ``acc_con``: ``(lower, upper)`` pairs of ``(N,)`` tensors shared by the
    batch (±INF = unbounded); vel/acc already dt-scaled by the caller.
    """
    W = qp.waypoints
    kw = dict(dtype=qp.pos_l.dtype, device=qp.pos_l.device)
    nb = len(qp.batch_shape)
    start = torch.as_tensor(start_pos, **kw)
    end = torch.as_tensor(end_pos, **kw)

    def con(b):  # (N,) -> (N, 1...) broadcastable against (rows, N, *batch)
        b = torch.as_tensor(b, **kw)
        return b.reshape(tuple(b.shape) + (1,) * nb)

    pl, pu = (con(b) for b in pos_con)
    vl, vu = (con(b) for b in vel_con)
    al, au = (con(b) for b in acc_con)

    pos_coef = qp.pos_coef.clone()
    pos_coef[: W - 1] = 1.0
    vel_coef = qp.vel_coef.clone()
    vel_coef[: W - 2] = 1.0

    pos_l, pos_u = qp.pos_l.clone(), qp.pos_u.clone()
    pos_l[0] = start
    pos_u[0] = start
    pos_l[1 : W - 1] = _masked(pl, pos_l[1 : W - 1])
    pos_u[1 : W - 1] = _masked(pu, pos_u[1 : W - 1])
    pos_l[W - 3] = end
    pos_u[W - 3] = end

    vel_l, vel_u = qp.vel_l.clone(), qp.vel_u.clone()
    vel_l[: W - 3] = _masked(vl, vel_l[: W - 3])
    vel_u[: W - 3] = _masked(vu, vel_u[: W - 3])
    vel_l[W - 3] = 0.0
    vel_u[W - 3] = 0.0

    acc_l, acc_u = qp.acc_l.clone(), qp.acc_u.clone()
    acc_l[: W - 3] = _masked(al, acc_l[: W - 3])
    acc_u[: W - 3] = _masked(au, acc_u[: W - 3])
    acc_l[W - 3] = 0.0
    acc_u[W - 3] = 0.0

    return qp.replace(
        pos_coef=pos_coef, vel_coef=vel_coef,
        pos_l=pos_l, pos_u=pos_u, vel_l=vel_l, vel_u=vel_u,
        acc_l=acc_l, acc_u=acc_u,
    )


def pinned_movable_mask(W: int, w_active=None, device=None):
    """``(W,)`` bool: which waypoints the GOMP QP can actually move —
    everything except the pinned ``q₀`` (start) and ``q_{wa−3}`` (end, the
    reference quirk).  Fed to :func:`linearize_workspace`'s ``movable`` so
    relative obstacle cuts never demand motion from a pin."""
    idx = torch.arange(W, device=device)
    wa = W if w_active is None else int(w_active)
    return ~((idx == 0) | (idx == wa - 3))


def with_horizon_mask(qp: TrajectoryQP, w_active: int) -> TrajectoryQP:
    """Restrict a ``W_max``-shaped empty QP to an *active prefix* of
    ``w_active`` waypoints: padding waypoints get zero objective/constraint
    coefficients and ±INF bounds, exactly like a freshly built QP at
    ``w_active`` plus mathematically inert rows.

    Apply to ``empty_trajectory_qp(W_max, ...)`` BEFORE
    :func:`with_gomp_boxes_masked` / :func:`linearize_workspace` (the latter
    masked via its ``w_active`` argument).
    """
    W = qp.waypoints
    wa = int(w_active)
    nb = len(qp.batch_shape)
    t = torch.arange(W, device=qp.q_vec.device)

    def mask(m, extra):  # (rows,) -> (rows, 1 × extra, 1 × batch dims)
        return m.reshape((-1,) + (1,) * (extra + nb))

    act_v = t < wa  # velocity var exists for t < w_active
    act_dyn = t[: W - 1] < wa - 1
    act_acc = t[: W - 2] < wa - 2
    dt_ = qp.q_vec.dtype
    return qp.replace(
        # Smoothness P at horizon w_active: tridiag(2, -1) over active blocks.
        P_diag=qp.P_diag * mask(act_v, 2).to(dt_),
        P_lower=qp.P_lower * mask(act_dyn, 2).to(dt_),
        dyn_coef=qp.dyn_coef * mask(act_dyn, 2).to(dt_),
        dyn_l=torch.where(
            mask(act_dyn, 1), qp.dyn_l, torch.full_like(qp.dyn_l, -INF)
        ),
        dyn_u=torch.where(
            mask(act_dyn, 1), qp.dyn_u, torch.full_like(qp.dyn_u, INF)
        ),
        acc_coef=qp.acc_coef * mask(act_acc, 2).to(dt_),
    )


def with_gomp_boxes_masked(
    qp: TrajectoryQP,
    start_pos,
    end_pos,
    pos_con,
    vel_con,
    acc_con,
    w_active: int,
) -> TrajectoryQP:
    """Horizon-masked version of :func:`with_gomp_boxes`: identical row
    semantics (including the ``W-3`` endpoint quirk) with ``W := w_active``
    inside a ``W_max``-shaped container."""
    W, N = qp.waypoints, qp.n_dim
    wa = int(w_active)
    kw = dict(dtype=qp.pos_l.dtype, device=qp.pos_l.device)
    bs = qp.batch_shape
    nb = len(bs)
    start = torch.as_tensor(start_pos, **kw)
    end = torch.as_tensor(end_pos, **kw)

    def box(b, rows, fill):
        """(N,) bound → (rows, N, *batch), loose entries set to ``fill``."""
        b = torch.as_tensor(b, **kw)
        b = torch.where(b.abs() >= INF_THRESHOLD, torch.full_like(b, fill), b)
        return b.reshape((1, N) + (1,) * nb).expand((rows, N) + bs)

    def rows(n):  # waypoint index, broadcast over N and the batch
        return torch.arange(n, device=kw["device"]).reshape(
            (n, 1) + (1,) * nb
        )

    def put(mask, value, old):
        value = torch.as_tensor(value, **kw)
        return torch.where(mask, value.expand(old.shape), old)

    t = rows(W)
    neg_p = torch.full((W, N) + bs, -INF, **kw)
    # position rows: coefficient for q_0..q_{wa-2}
    pos_coef = (t <= wa - 2).to(kw["dtype"]).expand((W, N) + bs).contiguous()
    inner = (t >= 1) & (t <= wa - 2)
    pos_l = put(inner, box(pos_con[0], W, -INF), neg_p)
    pos_u = put(inner, box(pos_con[1], W, INF), -neg_p)
    pos_l = put(t == 0, start[None], pos_l)
    pos_u = put(t == 0, start[None], pos_u)
    pos_l = put(t == wa - 3, end[None], pos_l)
    pos_u = put(t == wa - 3, end[None], pos_u)

    tv = rows(W - 1)
    neg_v = torch.full((W - 1, N) + bs, -INF, **kw)
    vel_coef = (tv <= wa - 3).to(kw["dtype"]).expand(neg_v.shape).contiguous()
    vel_l = put(tv <= wa - 4, box(vel_con[0], W - 1, -INF), neg_v)
    vel_u = put(tv <= wa - 4, box(vel_con[1], W - 1, INF), -neg_v)
    vel_l = put(tv == wa - 3, 0.0, vel_l)
    vel_u = put(tv == wa - 3, 0.0, vel_u)

    ta = rows(W - 2)
    neg_a = torch.full((W - 2, N) + bs, -INF, **kw)
    acc_l = put(ta <= wa - 4, box(acc_con[0], W - 2, -INF), neg_a)
    acc_u = put(ta <= wa - 4, box(acc_con[1], W - 2, INF), -neg_a)
    acc_l = put(ta == wa - 3, 0.0, acc_l)
    acc_u = put(ta == wa - 3, 0.0, acc_u)

    return qp.replace(
        pos_coef=pos_coef, vel_coef=vel_coef,
        pos_l=pos_l, pos_u=pos_u, vel_l=vel_l, vel_u=vel_u,
        acc_l=acc_l, acc_u=acc_u,
    )


def linearize_workspace(
    qp: TrajectoryQP,
    balls,
    obstacles,
    con_3d,
    trajectory,
    w_active=None,
    movable=None,
) -> TrajectoryQP:
    """SCP linearization of workspace + obstacle constraints: FK and
    Jacobians are evaluated batched over waypoints (and the trailing batch),
    and only *values* of fixed-shape arrays change.

    ``balls``: sequence of :class:`~osqp_solver_tpu_torch.models.robot.
    RobotBall` with ``fk_jac_batched``.  ``obstacles``: sequence of obstacle
    objects (length ``qp.n_obstacles``).  ``con_3d``: ``(lower, upper)`` pair
    of 3-vectors.  ``trajectory (2WN, *batch)``: only its position half is
    read.  ``w_active``: pad-to-max horizon — waypoints at or beyond it get
    inert rows (zero Jacobian, ±INF bounds; see :func:`with_horizon_mask`).
    ``movable``: optional ``(W,)`` bool mask forwarded to obstacles that
    accept it.
    """
    W, N = qp.waypoints, qp.n_dim
    kw = dict(dtype=qp.ws_l.dtype, device=qp.ws_l.device)
    bs = qp.batch_shape
    nb = len(bs)
    q_traj = torch.as_tensor(trajectory, **kw)[: W * N].reshape((W, N) + bs)
    c3l = torch.as_tensor(con_3d[0], **kw).reshape((1, 3) + (1,) * nb)
    c3u = torch.as_tensor(con_3d[1], **kw).reshape((1, 3) + (1,) * nb)
    act = None
    if w_active is not None:
        act = (
            torch.arange(W, device=kw["device"]) < int(w_active)
        ).reshape((W,) + (1,) * nb)  # (W, 1 × batch dims)

    ws_jac, ws_l, ws_u = qp.ws_jac.clone(), qp.ws_l.clone(), qp.ws_u.clone()
    obs_jac, obs_l, obs_u = (
        qp.obs_jac.clone(), qp.obs_l.clone(), qp.obs_u.clone()
    )

    for b, ball in enumerate(balls):
        if getattr(ball, "fk_jac_batched", None) is None:
            raise NotImplementedError(
                "linearize_workspace needs RobotBall.fk_jac_batched (the "
                "per-configuration fk/jacobian branch is not ported yet)"
            )
        # points (W, 3, *batch), jac (W, 3, N, *batch)
        points, jac = ball.fk_jac_batched(q_traj, axis=1)
        jq = (jac * q_traj[:, None]).sum(dim=2)  # (W, 3, *batch) J·q₀
        r = ball.radius

        if ball.is_gripper:
            # Per-axis Taylor bounds ± radius.
            low = torch.where(
                c3l.abs() >= INF_THRESHOLD,
                torch.full_like(points, -INF),
                c3l - points + jq,
            )
            upp = torch.where(
                c3u.abs() >= INF_THRESHOLD,
                torch.full_like(points, INF),
                c3u - points + jq,
            )
            low, upp = low + r, upp - r
            if act is not None:
                jac = jac * act[:, None, None].to(jac.dtype)
                low = torch.where(act[:, None], low, torch.full_like(low, -INF))
                upp = torch.where(act[:, None], upp, torch.full_like(upp, INF))
            ws_jac[b] = jac
            ws_l[b] = low
            ws_u[b] = upp

        for o, line in enumerate(obstacles):
            # Duck-typed obstacle protocol: one linearized row per waypoint;
            # dummy (±INF) rows share coefficients.
            ojac, low, upp = call_linearize_rows(
                line, points, jac, jq, r, movable=movable
            )
            if act is not None:
                ojac = ojac * act[:, None].to(ojac.dtype)
                low = torch.where(act, low, torch.full_like(low, -INF))
                upp = torch.where(act, upp, torch.full_like(upp, INF))
            obs_jac[b, o] = ojac
            obs_l[b, o] = low
            obs_u[b, o] = upp

    return qp.replace(
        ws_jac=ws_jac, ws_l=ws_l, ws_u=ws_u,
        obs_jac=obs_jac, obs_l=obs_l, obs_u=obs_u,
    )
