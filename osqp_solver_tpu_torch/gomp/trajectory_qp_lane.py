"""Lane-major (batch-last) trajectory QP container.

Counterpart of ``osqp_solver_tpu/gomp/trajectory_qp_lane.py``
(``LaneTrajectoryQP``, ``LaneFactor``, ``from_trailing``, ``to_lane``).
Every array keeps the batch axis LAST, ``(rows..., B)``, so that the CUDA
kernels read the values of adjacent problems from adjacent addresses.  Methods mirror the reference one for one, including the
multiply grouping of ``scale_data`` (the equilibration kernel reproduces it
value for value).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import tridiag_kernel
from ..ops.qp import RowReductions
from .trajectory_qp import TrajectoryQP

_INF = 1e30  # matches constraints.INF


def _padw(x, before: int, after: int):
    """Zero-pad the leading (waypoint) axis."""
    parts = []
    if before:
        parts.append(x.new_zeros((before,) + x.shape[1:]))
    parts.append(x)
    if after:
        parts.append(x.new_zeros((after,) + x.shape[1:]))
    return torch.cat(parts, dim=0) if len(parts) > 1 else x


@dataclasses.dataclass(frozen=True)
class LaneFactor:
    chol: torch.Tensor  # (W, 2N, 2N, B)
    gain: torch.Tensor  # (W-1, 2N, 2N, B)


@dataclasses.dataclass(frozen=True)
class LaneTrajectoryQP(RowReductions):
    # --- static structure ---------------------------------------------------
    waypoints: int
    n_dim: int
    gripper_flags: Tuple[bool, ...]
    n_obstacles: int

    # --- objective (batch-trailing) -----------------------------------------
    P_diag: torch.Tensor  # (W, 2N, 2N, B)
    P_lower: torch.Tensor  # (W-1, 2N, 2N, B)
    q_vec: torch.Tensor  # (2WN, B)

    # --- constraint blocks (batch-trailing) ---------------------------------
    dyn_coef: torch.Tensor  # (W-1, N, 3, B)
    dyn_l: torch.Tensor  # (W-1, N, B)
    dyn_u: torch.Tensor
    pos_coef: torch.Tensor  # (W, N, B)
    pos_l: torch.Tensor
    pos_u: torch.Tensor
    vel_coef: torch.Tensor  # (W-1, N, B)
    vel_l: torch.Tensor
    vel_u: torch.Tensor
    acc_coef: torch.Tensor  # (W-2, N, 2, B)
    acc_l: torch.Tensor  # (W-2, N, B)
    acc_u: torch.Tensor
    ws_jac: torch.Tensor  # (n_balls, W, 3, N, B)
    ws_l: torch.Tensor  # (n_balls, W, 3, B)
    ws_u: torch.Tensor
    obs_jac: torch.Tensor  # (n_balls, n_obs, W, N, B)
    obs_l: torch.Tensor  # (n_balls, n_obs, W, B)
    obs_u: torch.Tensor

    # Row-space layout of the flat (m, B) constraint vectors (l, u, ρ, z, y):
    #   "type":     all dyn rows, then pos, vel, acc, ws/obs;
    #   "waypoint": R rows per waypoint (dyn, pos, vel, acc, ws/obs), padded
    #               to a multiple of 8 — what the kernels stream.  Padding
    #               rows carry zero coefficients and (−INF, INF) bounds.
    row_layout: str = "type"
    # "vel_diag": P nonzero only on the velocity diagonal (GOMP objective).
    p_structure: str = "block"

    # ------------------------------------------------------------ structure

    def replace(self, **changes) -> "LaneTrajectoryQP":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "LaneTrajectoryQP":
        device = torch.device(device)
        if self.q_vec.device == device:
            return self
        return self.replace(
            **{k: getattr(self, k).to(device) for k in _ARRAY_FIELDS}
        )

    @property
    def device(self) -> torch.device:
        return self.q_vec.device

    @property
    def dtype(self) -> torch.dtype:
        return self.q_vec.dtype

    @property
    def n_balls(self) -> int:
        return len(self.gripper_flags)

    @property
    def batch(self) -> int:
        return self.q_vec.shape[-1]

    @property
    def n(self) -> int:
        return 2 * self.waypoints * self.n_dim

    @property
    def m(self) -> int:
        W, N = self.waypoints, self.n_dim
        if self.row_layout == "waypoint":
            return W * self.rows_per_waypoint_padded
        return (
            (W - 1) * N
            + W * N
            + (W - 1) * N
            + (W - 2) * N
            + sum(W * self._rows_per_wp(b) for b in range(self.n_balls))
        )

    def _rows_per_wp(self, ball: int) -> int:
        return (3 if self.gripper_flags[ball] else 0) + self.n_obstacles

    @property
    def rows_per_waypoint(self) -> int:
        """Real constraint rows per waypoint in the waypoint-major layout."""
        return 4 * self.n_dim + sum(
            self._rows_per_wp(b) for b in range(self.n_balls)
        )

    @property
    def rows_per_waypoint_padded(self) -> int:
        """Rows per waypoint rounded up to a multiple of 8 (the reference's
        pack layout, kept row for row)."""
        return -(-self.rows_per_waypoint // 8) * 8

    # ---------------------------------------------------------- row packing

    def _concat_rows(self, dyn, pos, vel, acc, ws, obs, pad_value=0.0):
        """Pack per-block row values into the flat (m, B) vector."""
        B = dyn.shape[-1]
        if self.row_layout == "waypoint":
            W = self.waypoints

            def padW(x, missing):
                if not missing:
                    return x
                fill = x.new_full((missing,) + x.shape[1:], pad_value)
                return torch.cat([x, fill], dim=0)

            parts = [padW(dyn, 1), pos, padW(vel, 1), padW(acc, 2)]
            for b in range(self.n_balls):
                if self.gripper_flags[b]:
                    parts.append(ws[b])  # (W, 3, B)
                if self.n_obstacles:
                    parts.append(obs[b].movedim(0, 1))  # (W, n_obs, B)
            rows = torch.cat(parts, dim=1)  # (W, R, B)
            Rp = self.rows_per_waypoint_padded
            if Rp > rows.shape[1]:
                fill = rows.new_full((W, Rp - rows.shape[1], B), pad_value)
                rows = torch.cat([rows, fill], dim=1)
            return rows.reshape(W * Rp, B)
        parts = [
            dyn.reshape(-1, B), pos.reshape(-1, B),
            vel.reshape(-1, B), acc.reshape(-1, B),
        ]
        for b in range(self.n_balls):
            per_wp = []
            if self.gripper_flags[b]:
                per_wp.append(ws[b])  # (W, 3, B)
            if self.n_obstacles:
                per_wp.append(obs[b].movedim(0, 1))  # (W, n_obs, B)
            if per_wp:
                parts.append(torch.cat(per_wp, dim=1).reshape(-1, B))
        return torch.cat(parts, dim=0)

    def _split_rows(self, y):
        """Inverse of :meth:`_concat_rows` (padding dropped); ws/obs
        zero-filled for balls without those rows."""
        W, N = self.waypoints, self.n_dim
        B = y.shape[-1]
        ws = y.new_zeros((self.n_balls, W, 3, B))
        obs = y.new_zeros((self.n_balls, self.n_obstacles, W, B))
        if self.row_layout == "waypoint":
            rows = y.reshape(W, self.rows_per_waypoint_padded, B)
            dyn = rows[: W - 1, 0:N]
            pos = rows[:, N : 2 * N]
            vel = rows[: W - 1, 2 * N : 3 * N]
            acc = rows[: W - 2, 3 * N : 4 * N]
            off = 4 * N
            for b in range(self.n_balls):
                if self.gripper_flags[b]:
                    ws[b] = rows[:, off : off + 3]
                    off += 3
                if self.n_obstacles:
                    obs[b] = rows[:, off : off + self.n_obstacles].movedim(0, 1)
                    off += self.n_obstacles
            return dyn, pos, vel, acc, ws, obs
        sizes = [(W - 1) * N, W * N, (W - 1) * N, (W - 2) * N]
        off = 0
        outs = []
        for s in sizes:
            outs.append(y[off : off + s])
            off += s
        dyn = outs[0].reshape(W - 1, N, B)
        pos = outs[1].reshape(W, N, B)
        vel = outs[2].reshape(W - 1, N, B)
        acc = outs[3].reshape(W - 2, N, B)
        for b in range(self.n_balls):
            rpw = self._rows_per_wp(b)
            if rpw == 0:
                continue
            blk = y[off : off + W * rpw].reshape(W, rpw, B)
            off += W * rpw
            k = 0
            if self.gripper_flags[b]:
                ws[b] = blk[:, :3]
                k = 3
            if self.n_obstacles:
                obs[b] = blk[:, k:].movedim(0, 1)
        return dyn, pos, vel, acc, ws, obs

    # --------------------------------------------------------- flat bounds

    @property
    def l(self):
        return self._concat_rows(
            self.dyn_l, self.pos_l, self.vel_l, self.acc_l, self.ws_l,
            self.obs_l, pad_value=-_INF,
        )

    @property
    def u(self):
        return self._concat_rows(
            self.dyn_u, self.pos_u, self.vel_u, self.acc_u, self.ws_u,
            self.obs_u, pad_value=_INF,
        )

    @property
    def q(self):
        return self.q_vec

    # ---------------------------------------------------------- operators

    def _qv(self, x):
        W, N = self.waypoints, self.n_dim
        B = x.shape[-1]
        return x[: W * N].reshape(W, N, B), x[W * N :].reshape(W, N, B)

    def _interleave(self, x):
        q, v = self._qv(x)
        return torch.cat([q, v], dim=1)  # (W, 2N, B)

    def _deinterleave(self, s):
        N = self.n_dim
        B = s.shape[-1]
        return torch.cat(
            [s[:, :N].reshape(-1, B), s[:, N:].reshape(-1, B)], dim=0
        )

    def A_matvec(self, x):
        q, v = self._qv(x)
        c = self.dyn_coef
        dyn = c[..., 0, :] * v[:-1] + c[..., 1, :] * q[1:] + c[..., 2, :] * q[:-1]
        pos = self.pos_coef * q
        vel = self.vel_coef * v[:-1]
        a = self.acc_coef
        acc = a[..., 0, :] * v[1:-1] + a[..., 1, :] * v[:-2]
        ws = torch.einsum("gwanb,wnb->gwab", self.ws_jac, q)
        obs = torch.einsum("gownb,wnb->gowb", self.obs_jac, q)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def AT_matvec(self, y):
        dyn, pos, vel, acc, ws, obs = self._split_rows(y)
        W, N = self.waypoints, self.n_dim
        B = y.shape[-1]
        c = self.dyn_coef
        a = self.acc_coef
        qg = self.pos_coef * pos
        qg[1:] += c[..., 1, :] * dyn
        qg[:-1] += c[..., 2, :] * dyn
        qg = qg + torch.einsum("gwanb,gwab->wnb", self.ws_jac, ws)
        qg = qg + torch.einsum("gownb,gowb->wnb", self.obs_jac, obs)
        vg = y.new_zeros((W, N, B))
        vg[:-1] += c[..., 0, :] * dyn + self.vel_coef * vel
        vg[1:-1] += a[..., 0, :] * acc
        vg[:-2] += a[..., 1, :] * acc
        return torch.cat([qg.reshape(-1, B), vg.reshape(-1, B)], dim=0)

    def P_matvec(self, x):
        s = self._interleave(x)  # (W, 2N, B)
        y = torch.einsum("wijb,wjb->wib", self.P_diag, s)
        if self.waypoints > 1:
            y[1:] += torch.einsum("wijb,wjb->wib", self.P_lower, s[:-1])
            y[:-1] += torch.einsum("wjib,wjb->wib", self.P_lower, s[1:])
        return self._deinterleave(y)

    # ---------------------------------------------------------- Ruiz norms
    # The trajectory container's, which take any trailing batch dims (the
    # generic Ruiz of ``ops/ruiz.py`` reads them).

    A_col_absmax = TrajectoryQP.A_col_absmax
    A_row_absmax = TrajectoryQP.A_row_absmax
    P_col_absmax = TrajectoryQP.P_col_absmax

    # ------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        """Diagonal scaling with batch-trailing ``D (n, B)``, ``E (m, B)``,
        ``c (B,)``; the multiply grouping is the reference's."""
        W = self.waypoints
        Dq, Dv = self._qv(D)
        e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs = self._split_rows(E)
        d_int = self._interleave(D)  # (W, 2N, B)
        P_diag = c * d_int[:, :, None, :] * self.P_diag * d_int[:, None, :, :]
        P_lower = (
            c * d_int[1:, :, None, :] * self.P_lower * d_int[:-1, None, :, :]
            if W > 1
            else self.P_lower
        )
        dyn_coef = torch.stack(
            [
                self.dyn_coef[..., 0, :] * e_dyn * Dv[:-1],
                self.dyn_coef[..., 1, :] * e_dyn * Dq[1:],
                self.dyn_coef[..., 2, :] * e_dyn * Dq[:-1],
            ],
            dim=-2,
        )
        acc_coef = torch.stack(
            [
                self.acc_coef[..., 0, :] * e_acc * Dv[1:-1],
                self.acc_coef[..., 1, :] * e_acc * Dv[:-2],
            ],
            dim=-2,
        )
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
            ws_jac=self.ws_jac * e_ws[:, :, :, None, :] * Dq[None, :, None, :, :],
            ws_l=e_ws * self.ws_l,
            ws_u=e_ws * self.ws_u,
            obs_jac=self.obs_jac
            * e_obs[:, :, :, None, :]
            * Dq[None, None, :, :, :],
            obs_l=e_obs * self.obs_l,
            obs_u=e_obs * self.obs_u,
        )

    # ------------------------------------------------------------ KKT path

    def kkt_blocks(self, rho_vec, sigma):
        """``P + σI + Aᵀdiag(ρ)A`` as lane-major block-tridiagonal
        ``(diag (W, 2N, 2N, B), lower (W-1, 2N, 2N, B))``."""
        N = self.n_dim
        r_dyn, r_pos, r_vel, r_acc, r_ws, r_obs = self._split_rows(rho_vec)
        dt, dev = self.P_diag.dtype, self.P_diag.device

        c0 = self.dyn_coef[..., 0, :]
        c1 = self.dyn_coef[..., 1, :]
        c2 = self.dyn_coef[..., 2, :]
        a0 = self.acc_coef[..., 0, :]
        a1 = self.acc_coef[..., 1, :]

        d_qq = r_pos * self.pos_coef**2
        d_qq = d_qq + _padw(r_dyn * c2 * c2, 0, 1) + _padw(r_dyn * c1 * c1, 1, 0)
        d_vv = _padw(r_dyn * c0 * c0 + r_vel * self.vel_coef**2, 0, 1)
        d_vv = d_vv + _padw(r_acc * a0 * a0, 1, 1) + _padw(r_acc * a1 * a1, 0, 2)
        d_qv = _padw(r_dyn * c2 * c0, 0, 1)

        def shifted_eye(k):
            return torch.diag(
                torch.ones(2 * N - abs(k), dtype=dt, device=dev), k
            )[None, :, :, None]

        eye, k_qv, k_vq = shifted_eye(0), shifted_eye(N), shifted_eye(-N)
        zpad = torch.zeros_like(d_qv)
        M_diag = (
            self.P_diag
            + sigma * eye
            + torch.cat([d_qq, d_vv], dim=1)[:, :, None, :] * eye
            + torch.cat([d_qv, zpad], dim=1)[:, :, None, :] * k_qv
            + torch.cat([zpad, d_qv], dim=1)[:, :, None, :] * k_vq
        )

        l_qq = r_dyn * c1 * c2
        l_qv = r_dyn * c1 * c0
        l_vv = _padw(r_acc * a0 * a1, 0, 1)
        zlow = torch.zeros_like(l_qq)
        M_lower = (
            self.P_lower
            + torch.cat([l_qq, l_vv], dim=1)[:, :, None, :] * eye
            + torch.cat([l_qv, zlow], dim=1)[:, :, None, :] * k_qv
        )

        ws_c = torch.einsum(
            "gwanb,gwab,gwamb->wnmb", self.ws_jac, r_ws, self.ws_jac
        )
        if self.n_obstacles and self.n_balls:
            ws_c = ws_c + torch.einsum(
                "gownb,gowb,gowmb->wnmb", self.obs_jac, r_obs, self.obs_jac
            )
        M_diag = M_diag.clone()
        M_diag[:, :N, :N] += ws_c
        return M_diag, M_lower

    def kkt_factor(self, rho_vec, sigma) -> LaneFactor:
        """Full-block factor: the block-tridiagonal kernel
        (:func:`..ops.tridiag_kernel.factor_lane_major`) on a CUDA batch, as
        the reference takes its Pallas kernel on the TPU; the plain version
        on the CPU."""
        chol, gain = tridiag_kernel.factor_lane_major(
            *self.kkt_blocks(rho_vec, sigma))
        return LaneFactor(chol=chol, gain=gain)

    def kkt_solve(self, factor: LaneFactor, rhs):
        """``K⁻¹ rhs`` for ``rhs (n, B)``: the block-tridiagonal solve kernel
        on a CUDA batch, the plain version on the CPU."""
        s = self._interleave(rhs)
        return self._deinterleave(
            tridiag_kernel.solve_lane_major(factor.chol, factor.gain, s))


_ARRAY_FIELDS = (
    "P_diag", "P_lower", "q_vec",
    "dyn_coef", "dyn_l", "dyn_u",
    "pos_coef", "pos_l", "pos_u",
    "vel_coef", "vel_l", "vel_u",
    "acc_coef", "acc_l", "acc_u",
    "ws_jac", "ws_l", "ws_u",
    "obs_jac", "obs_l", "obs_u",
)


def from_trailing(qps, row_layout: str = "type") -> LaneTrajectoryQP:
    """Wrap a ``TrajectoryQP`` whose arrays are already batch-*trailing*
    (the port's assembly writes that layout directly)."""
    return LaneTrajectoryQP(
        waypoints=qps.waypoints,
        n_dim=qps.n_dim,
        gripper_flags=qps.gripper_flags,
        n_obstacles=qps.n_obstacles,
        row_layout=row_layout,
        p_structure=getattr(qps, "p_structure", "block"),
        **{k: getattr(qps, k) for k in _ARRAY_FIELDS},
    )


def to_lane(qps) -> LaneTrajectoryQP:
    """Convert a batch-*leading* ``TrajectoryQP`` (every array ``(B, ...)``)
    into the lane-major container — one relayout per problem batch."""
    return LaneTrajectoryQP(
        waypoints=qps.waypoints,
        n_dim=qps.n_dim,
        gripper_flags=qps.gripper_flags,
        n_obstacles=qps.n_obstacles,
        p_structure=getattr(qps, "p_structure", "block"),
        **{
            k: getattr(qps, k).movedim(0, -1).contiguous()
            for k in _ARRAY_FIELDS
        },
    )
