"""Structured trajectory QP: container fields and constructors.

Counterpart of ``osqp_solver_tpu/gomp/trajectory_qp.py`` for the assembly
(``TrajectoryQP`` fields, ``smoothness_P_blocks``, ``empty_trajectory_qp``,
``with_gomp_boxes``, ``pinned_movable_mask``, ``with_horizon_mask``,
``with_gomp_boxes_masked``, ``linearize_workspace`` in both its branches:
the batched ``fk_jac_batched`` and the per-configuration ``fk``/
``jacobian``), the operator protocol of the generic solver
(:mod:`osqp_solver_tpu_torch.ops.admm`), and the host-side exports
``layout``, ``row_map``, ``to_dense`` and ``to_csr``.  The horizon
``w_active`` of the masked constructors is one Python int for the whole
batch (the planner's host loop knows it); the containers stay
``W_max``-shaped so that every horizon shares one row layout, hence one
build of the kernels.

Where the reference ``vmap``s these constructors over a problem batch, the
batch is a written-out TRAILING dimension here: every array below may carry
extra trailing dims ``*batch`` (none, or ``(B,)``), per-problem inputs are
``(N, *batch)`` / ``(2WN, *batch)``, and the result lands batch-trailing —
the lane layout — with no relayout.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops import tridiag_kernel
from ..ops.qp import RowReductions
from ..ops.tridiag import BlockTridiagFactor, block_tridiag_to_dense
from .constraints import INF, INF_THRESHOLD
from ..models.robot import ball_fk_jac
from .geometry import call_linearize_rows
from .layout import TrajectoryLayout, make_layout


def _pad0(x, before: int, after: int):
    """Zero rows before/after ``x`` along its first dimension."""
    z = x.new_zeros((1,) + tuple(x.shape[1:]))
    return torch.cat([z.expand((before,) + tuple(x.shape[1:])), x,
                      z.expand((after,) + tuple(x.shape[1:]))])


@dataclasses.dataclass(frozen=True)
class TrajectoryQP(RowReductions):
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

    @property
    def n(self) -> int:
        return 2 * self.waypoints * self.n_dim

    @property
    def m(self) -> int:
        W, N = self.waypoints, self.n_dim
        return (4 * W - 4) * N + sum(
            W * self._rows_per_wp(b) for b in range(self.n_balls)
        )

    def map_arrays(self, fn) -> "TrajectoryQP":
        """The same structure with ``fn`` applied to every array field."""
        return self.replace(**{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    # ------------------------------------------------------------------
    # Operator protocol of the generic solver (ops/admm.py), batch-trailing:
    # x (n, *batch) in the reference variable order [q..., v...], rows
    # (m, *batch) in its compact row order.
    # ------------------------------------------------------------------

    def _rows_per_wp(self, ball: int) -> int:
        return (3 if self.gripper_flags[ball] else 0) + self.n_obstacles

    def _concat_rows(self, dyn, pos, vel, acc, ws, obs):
        """Pack per-block row values into the flat ``(m, *batch)`` vector.

        ``ws``: ``(n_balls, W, 3, *batch)``; ``obs``: ``(n_balls, n_obs, W,
        *batch)``.  Per ball, the waypoint-major interleave of gripper XYZ
        rows then obstacle rows."""
        bs = dyn.shape[2:]
        parts = [a.reshape((-1,) + bs) for a in (dyn, pos, vel, acc)]
        for b in range(self.n_balls):
            per_wp = []
            if self.gripper_flags[b]:
                per_wp.append(ws[b])  # (W, 3, *batch)
            if self.n_obstacles:
                per_wp.append(obs[b].movedim(0, 1))  # (W, n_obs, *batch)
            if per_wp:
                parts.append(torch.cat(per_wp, dim=1).reshape((-1,) + bs))
        return torch.cat(parts)

    def _split_rows(self, y):
        """Inverse of :meth:`_concat_rows`: ``(dyn, pos, vel, acc, ws,
        obs)``, ws/obs zero for balls without those rows."""
        W, N = self.waypoints, self.n_dim
        bs = tuple(y.shape[1:])
        kw = dict(dtype=y.dtype, device=y.device)
        off = 0
        outs = []
        for rows in (W - 1, W, W - 1, W - 2):
            outs.append(y[off : off + rows * N].reshape((rows, N) + bs))
            off += rows * N
        ws = torch.zeros((self.n_balls, W, 3) + bs, **kw)
        obs = torch.zeros((self.n_balls, self.n_obstacles, W) + bs, **kw)
        for b in range(self.n_balls):
            rpw = self._rows_per_wp(b)
            if rpw == 0:
                continue
            blk = y[off : off + W * rpw].reshape((W, rpw) + bs)
            off += W * rpw
            k = 0
            if self.gripper_flags[b]:
                ws[b] = blk[:, :3]
                k = 3
            if self.n_obstacles:
                obs[b] = blk[:, k:].movedim(0, 1)
        return (*outs, ws, obs)

    @property
    def l(self):
        return self._concat_rows(self.dyn_l, self.pos_l, self.vel_l,
                                 self.acc_l, self.ws_l, self.obs_l)

    @property
    def u(self):
        return self._concat_rows(self.dyn_u, self.pos_u, self.vel_u,
                                 self.acc_u, self.ws_u, self.obs_u)

    @property
    def q(self):
        return self.q_vec

    def _qv(self, x):
        W, N = self.waypoints, self.n_dim
        bs = tuple(x.shape[1:])
        return (x[: W * N].reshape((W, N) + bs),
                x[W * N :].reshape((W, N) + bs))

    def _interleave(self, x):
        """``(n, *batch)`` → per-waypoint states ``(W, 2N, *batch)``."""
        q, v = self._qv(x)
        return torch.cat([q, v], dim=1)

    def _deinterleave(self, s):
        N = self.n_dim
        bs = tuple(s.shape[2:])
        return torch.cat([s[:, :N].reshape((-1,) + bs),
                          s[:, N:].reshape((-1,) + bs)])

    def A_matvec(self, x):
        q, v = self._qv(x)
        c, a = self.dyn_coef, self.acc_coef
        dyn = c[:, :, 0] * v[:-1] + c[:, :, 1] * q[1:] + c[:, :, 2] * q[:-1]
        pos = self.pos_coef * q
        vel = self.vel_coef * v[:-1]
        acc = a[:, :, 0] * v[1:-1] + a[:, :, 1] * v[:-2]
        ws = (self.ws_jac * q[None, :, None]).sum(dim=3)
        obs = (self.obs_jac * q[None, None]).sum(dim=3)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def AT_matvec(self, y):
        dyn, pos, vel, acc, ws, obs = self._split_rows(y)
        c, a = self.dyn_coef, self.acc_coef
        qg = self.pos_coef * pos
        qg[1:] += c[:, :, 1] * dyn
        qg[:-1] += c[:, :, 2] * dyn
        qg = qg + (self.ws_jac * ws[:, :, :, None]).sum(dim=(0, 2))
        qg = qg + (self.obs_jac * obs[:, :, :, None]).sum(dim=(0, 1))
        vg = torch.zeros_like(qg)
        vg[:-1] += c[:, :, 0] * dyn + self.vel_coef * vel
        vg[1:-1] += a[:, :, 0] * acc
        vg[:-2] += a[:, :, 1] * acc
        bs = tuple(y.shape[1:])
        return torch.cat([qg.reshape((-1,) + bs), vg.reshape((-1,) + bs)])

    def P_matvec(self, x):
        s = self._interleave(x)
        y = (self.P_diag * s[:, None]).sum(dim=2)
        if self.waypoints > 1:
            y[1:] += (self.P_lower * s[:-1, None]).sum(dim=2)
            y[:-1] += (self.P_lower * s[1:, :, None]).sum(dim=1)
        return self._deinterleave(y)

    # --- Ruiz norms -----------------------------------------------------

    def A_col_absmax(self):
        c, a = self.dyn_coef.abs(), self.acc_coef.abs()
        qm = self.pos_coef.abs()
        qm = torch.maximum(qm, _pad0(c[:, :, 2], 0, 1))
        qm = torch.maximum(qm, _pad0(c[:, :, 1], 1, 0))
        if self.n_balls:
            qm = torch.maximum(qm, self.ws_jac.abs().amax(dim=(0, 2)))
        if self.n_obstacles and self.n_balls:
            qm = torch.maximum(qm, self.obs_jac.abs().amax(dim=(0, 1)))
        vm = _pad0(torch.maximum(self.vel_coef.abs(), c[:, :, 0]), 0, 1)
        vm = torch.maximum(vm, _pad0(a[:, :, 1], 0, 2))
        vm = torch.maximum(vm, _pad0(a[:, :, 0], 1, 1))
        bs = tuple(qm.shape[2:])
        return torch.cat([qm.reshape((-1,) + bs), vm.reshape((-1,) + bs)])

    def A_row_absmax(self):
        def amax(t, dim):  # an empty ball axis has no rows to reduce
            return t.abs().amax(dim=dim) if t.numel() else t.sum(dim=dim)

        return self._concat_rows(
            amax(self.dyn_coef, 2), self.pos_coef.abs(), self.vel_coef.abs(),
            amax(self.acc_coef, 2), amax(self.ws_jac, 3),
            amax(self.obs_jac, 3),
        )

    def P_col_absmax(self):
        pd = self.P_diag.abs().amax(dim=1)  # (W, 2N, *batch) per-col max
        if self.waypoints > 1:
            low = self.P_lower.abs()
            pd[:-1] = torch.maximum(pd[:-1], low.amax(dim=1))  # cols of t
            pd[1:] = torch.maximum(pd[1:], low.amax(dim=2))  # cols of t+1
        return self._deinterleave(pd)

    # --- scaling ----------------------------------------------------------

    def scale_data(self, D, E, c):
        Dq, Dv = self._qv(D)
        e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs = self._split_rows(E)
        d_int = self._interleave(D)  # (W, 2N, *batch)
        P_diag = c * d_int[:, :, None] * self.P_diag * d_int[:, None, :]
        P_lower = (
            c * d_int[1:, :, None] * self.P_lower * d_int[:-1, None, :]
            if self.waypoints > 1 else self.P_lower
        )
        dc, ac = self.dyn_coef, self.acc_coef
        dyn_coef = torch.stack([
            dc[:, :, 0] * e_dyn * Dv[:-1],
            dc[:, :, 1] * e_dyn * Dq[1:],
            dc[:, :, 2] * e_dyn * Dq[:-1],
        ], dim=2)
        acc_coef = torch.stack([
            ac[:, :, 0] * e_acc * Dv[1:-1],
            ac[:, :, 1] * e_acc * Dv[:-2],
        ], dim=2)
        return self.replace(
            P_diag=P_diag,
            P_lower=P_lower,
            q_vec=c * D * self.q_vec,
            dyn_coef=dyn_coef,
            dyn_l=e_dyn * self.dyn_l,
            dyn_u=e_dyn * self.dyn_u,
            pos_coef=self.pos_coef * e_pos * Dq,
            pos_l=e_pos * self.pos_l,
            pos_u=e_pos * self.pos_u,
            vel_coef=self.vel_coef * e_vel * Dv[:-1],
            vel_l=e_vel * self.vel_l,
            vel_u=e_vel * self.vel_u,
            acc_coef=acc_coef,
            acc_l=e_acc * self.acc_l,
            acc_u=e_acc * self.acc_u,
            ws_jac=self.ws_jac * e_ws[:, :, :, None] * Dq[None, :, None],
            ws_l=e_ws * self.ws_l,
            ws_u=e_ws * self.ws_u,
            obs_jac=self.obs_jac * e_obs[:, :, :, None] * Dq[None, None],
            obs_l=e_obs * self.obs_l,
            obs_u=e_obs * self.obs_u,
        )

    # --- KKT path ---------------------------------------------------------

    def kkt_blocks(self, rho_vec, sigma):
        """``P + σI + Aᵀdiag(ρ)A`` as block-tridiagonal ``(diag (W, 2N, 2N,
        *batch), lower (W-1, 2N, 2N, *batch))``: every AᵀρA contribution
        of the stencil rows lands on a sub-block diagonal of the waypoint
        blocks, the workspace rows on the position block."""
        N = self.n_dim
        r_dyn, r_pos, r_vel, r_acc, r_ws, r_obs = self._split_rows(rho_vec)
        bs = self.batch_shape
        kw = dict(dtype=self.P_diag.dtype, device=self.P_diag.device)
        c0, c1, c2 = (self.dyn_coef[:, :, k] for k in range(3))
        a0, a1 = self.acc_coef[:, :, 0], self.acc_coef[:, :, 1]

        # Per-waypoint sub-block diagonals of AᵀρA (each (W, N, *batch)).
        d_qq = r_pos * self.pos_coef**2
        d_qq = (d_qq + _pad0(r_dyn * c2 * c2, 0, 1)
                + _pad0(r_dyn * c1 * c1, 1, 0))
        d_vv = _pad0(r_dyn * c0 * c0 + r_vel * self.vel_coef**2, 0, 1)
        d_vv = (d_vv + _pad0(r_acc * a0 * a0, 1, 1)
                + _pad0(r_acc * a1 * a1, 0, 2))
        d_qv = _pad0(r_dyn * c2 * c0, 0, 1)

        ones = (1,) * len(bs)
        eye = torch.eye(2 * N, **kw).reshape((2 * N, 2 * N) + ones)
        # ones at (j, N + j)
        k_qv = torch.diag(torch.ones(N, **kw), N).reshape(eye.shape)
        zpad = torch.zeros_like(d_qv)
        M_diag = (
            self.P_diag
            + sigma * eye
            + torch.cat([d_qq, d_vv], dim=1)[:, :, None] * eye
            + torch.cat([d_qv, zpad], dim=1)[:, :, None] * k_qv
            + torch.cat([zpad, d_qv], dim=1)[:, :, None] * k_qv.transpose(0, 1)
        )

        # Lower (t+1, t) blocks: dyn couples (q_{t+1} → q_t, v_t), acc
        # couples (v_{t+1} → v_t).
        l_qq = r_dyn * c1 * c2
        l_qv = r_dyn * c1 * c0
        l_vv = _pad0(r_acc * a0 * a1, 0, 1)
        zlow = torch.zeros_like(l_qq)
        M_lower = (
            self.P_lower
            + torch.cat([l_qq, l_vv], dim=1)[:, :, None] * eye
            + torch.cat([l_qv, zlow], dim=1)[:, :, None] * k_qv
        )

        J = self.ws_jac  # (n_balls, W, 3, N, *batch)
        ws_c = (J[:, :, :, :, None] * r_ws[:, :, :, None, None]
                * J[:, :, :, None]).sum(dim=(0, 2))
        if self.n_obstacles and self.n_balls:
            O = self.obs_jac  # (n_balls, n_obs, W, N, *batch)
            ws_c = ws_c + (O[:, :, :, :, None] * r_obs[:, :, :, None, None]
                           * O[:, :, :, None]).sum(dim=(0, 1))
        M_diag[:, :N, :N] += ws_c
        return M_diag, M_lower

    def kkt_factor(self, rho_vec, sigma):
        """Block-tridiagonal Cholesky of the reduced KKT (one trailing batch
        dim): the kernel of :mod:`..ops.tridiag_kernel` on a CUDA batch, the
        plain recurrence of :mod:`..ops.tridiag` on the CPU."""
        chol, gain = tridiag_kernel.factor_lane_major(
            *self.kkt_blocks(rho_vec, sigma))
        return BlockTridiagFactor(chol=chol, gain=gain)

    def kkt_solve(self, factor, rhs):
        s = tridiag_kernel.solve_lane_major(
            factor.chol, factor.gain, self._interleave(rhs))
        return self._deinterleave(s)

    # --- host-side exports -------------------------------------------------

    def layout(self) -> TrajectoryLayout:
        return make_layout(
            self.waypoints, self.n_dim, self.gripper_flags, self.n_obstacles
        )

    def row_map(self) -> np.ndarray:
        """Compact row -> the reference's padded row index (host side;
        :class:`~.builder.ConstraintBuilder`'s rows)."""
        lay = self.layout()
        W, N = self.waypoints, self.n_dim
        idx = list(range((W - 1) * N))  # dynamics
        idx.extend(range(lay.position_offset, lay.position_offset + W * N))
        idx.extend(range(lay.velocity_offset,
                         lay.velocity_offset + (W - 1) * N))
        idx.extend(range(lay.acceleration_offset,
                         lay.acceleration_offset + (W - 2) * N))
        for b in range(self.n_balls):
            for t in range(W):
                for k in range(self._rows_per_wp(b)):
                    idx.append(lay.workspace_row(b, t, k))
        return np.asarray(idx)

    def to_csr(self):
        """Host-side CSR export of one problem (no batch dims) in the
        *interleaved* ``[q_t, v_t]`` variable order (banded KKT), for the
        native sparse oracle (``native/osqp_oracle.cpp``).

        Returns ``(P_csr, q, A_csr, l, u, kb, perm)`` as numpy data: each
        ``*_csr`` an ``(indptr, indices, data)`` triple, ``kb = 4N-1`` the
        KKT half-bandwidth, and ``perm`` mapping reference-layout variable
        i to its interleaved index (``x_ref = x_interleaved[perm]``)."""
        if self.batch_shape:
            raise ValueError(f"to_csr takes one problem; this container has "
                             f"batch dims {self.batch_shape}")
        W, N = self.waypoints, self.n_dim

        def host(t):
            return t.detach().cpu().numpy()

        def qcol(t, j):
            return 2 * N * t + j

        def vcol(t, j):
            return 2 * N * t + N + j

        A_rows = []  # (cols, vals) per row, in the compact row order
        dyn = host(self.dyn_coef)
        for t in range(W - 1):
            for j in range(N):
                A_rows.append((np.array([vcol(t, j), qcol(t + 1, j),
                                         qcol(t, j)]), dyn[t, j]))
        pos_c = host(self.pos_coef)
        for t in range(W):
            for j in range(N):
                A_rows.append((np.array([qcol(t, j)]), pos_c[t, j:j + 1]))
        vel_c = host(self.vel_coef)
        for t in range(W - 1):
            for j in range(N):
                A_rows.append((np.array([vcol(t, j)]), vel_c[t, j:j + 1]))
        acc = host(self.acc_coef)
        for t in range(W - 2):
            for j in range(N):
                A_rows.append((np.array([vcol(t + 1, j), vcol(t, j)]),
                               acc[t, j]))
        ws_jac, obs_jac = host(self.ws_jac), host(self.obs_jac)
        q_cols = np.arange(N)
        for b in range(self.n_balls):
            for t in range(W):
                if self.gripper_flags[b]:
                    for a in range(3):
                        A_rows.append((2 * N * t + q_cols, ws_jac[b, t, a]))
                for o in range(self.n_obstacles):
                    A_rows.append((2 * N * t + q_cols, obs_jac[b, o, t]))

        def csr(rows):
            indptr = np.zeros(len(rows) + 1, np.int32)
            indptr[1:] = np.cumsum([len(c) for c, _ in rows])
            return (indptr,
                    np.concatenate([c for c, _ in rows]).astype(np.int32),
                    np.concatenate([v for _, v in rows]).astype(np.float64))

        # P from the block-tridiagonal (diag, lower) pair, row by row.
        Pd, Pl = host(self.P_diag), host(self.P_lower)
        B2 = 2 * N
        P_rows = []
        for t in range(W):
            for k in range(B2):
                cols, vals = [], []
                if t > 0:  # P[t, t-1] = P_lower[t-1]
                    cols.append(2 * N * (t - 1) + np.arange(B2))
                    vals.append(Pl[t - 1, k])
                cols.append(2 * N * t + np.arange(B2))
                vals.append(Pd[t, k])
                if t < W - 1:  # P[t, t+1] = P_lower[t].T
                    cols.append(2 * N * (t + 1) + np.arange(B2))
                    vals.append(Pl[t, :, k])
                P_rows.append((np.concatenate(cols), np.concatenate(vals)))

        perm = host(self._perm_to_interleaved())
        q_int = np.zeros(2 * W * N)
        q_int[perm] = host(self.q_vec)
        return (csr(P_rows), q_int, csr(A_rows),
                np.asarray(host(self.l), np.float64),
                np.asarray(host(self.u), np.float64), 4 * N - 1, perm)

    # --- dense ------------------------------------------------------------

    def to_dense(self):
        """Dense ``(P, q, A, l, u)`` in the reference variable layout with
        compact rows, batch-trailing (tests and ground truth only)."""
        n, bs = self.n, self.batch_shape
        kw = dict(dtype=self.q_vec.dtype, device=self.q_vec.device)
        cols = []
        for j in range(n):
            e = torch.zeros((n,) + bs, **kw)
            e[j] = 1.0
            cols.append(self.A_matvec(e))
        A = torch.stack(cols, dim=1)
        P_int = block_tridiag_to_dense(self.P_diag, self.P_lower)
        perm = self._perm_to_interleaved()
        P = P_int[perm][:, perm]
        return P, self.q_vec, A, self.l, self.u

    def _perm_to_interleaved(self):
        """``perm[i]`` = interleaved index of reference-layout variable i."""
        W, N = self.waypoints, self.n_dim
        t = torch.arange(W)[:, None] * 2 * N
        j = torch.arange(N)[None, :]
        return torch.cat([(t + j).reshape(-1), (t + N + j).reshape(-1)])


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
    RobotBall`: with ``fk_jac_batched``, or with the per-configuration
    ``fk``/``jacobian`` (evaluated by ``torch.func.vmap``).  ``obstacles``: sequence of obstacle
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
        # points (W, 3, *batch), jac (W, 3, N, *batch): the SoA batched
        # evaluator, else fk/jacobian at every waypoint and problem.
        points, jac = ball_fk_jac(ball, q_traj, axis=1)
        points, jac = points.to(kw["dtype"]), jac.to(kw["dtype"])
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
