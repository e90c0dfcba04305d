"""Horizon-sharded banded QP: separator-only distributed ADMM.

Counterpart of ``osqp_solver_tpu/parallel/banded.py`` (``BandedQP``,
``banded_from_trajectory``, ``interleave_state``/``deinterleave_state``,
``partition_banded``, ``ShardedBandedQP``, ``solve_banded_sharded``,
``solve_banded_sharded_2d``), over ``torch.distributed``.  The whole problem
— state, bounds, duals, constraint data — is split along the horizon over
the ranks of a mesh axis, and every per-iteration exchange is ``O(K·B2)``:

* the constraints are per-waypoint row blocks ``z_t = A0[t]·s_t +
  A1[t]·s_{t+1}`` (``s_t = [q_t, v_t]``, the interleaved waypoint state);
* matvecs take one ``(B2,)`` halo from a neighbour (an ``all_gather`` of
  the ranks' edge vectors through :mod:`._comm`);
* the KKT solve is the Schur split of :mod:`.schur`: chunk-local factor and
  substitution, one ``all_gather`` of the ``(B2,)`` separator right-hand
  sides, the small reduced solve on every rank, local back-substitution —
  the interior never leaves its rank;
* residual norms and certificates reduce as per-problem scalars through the
  generic solver's ``process_group`` hooks (``ops/admm.py``,
  ``ops/ruiz.py``).

Layout is batch-trailing as everywhere in the port (``P_diag (W, B2, B2,
*batch)``), so a rank's shard may carry several problems (the 2-D mesh).
Chunk layout: the horizon is padded to ``K·Ws`` waypoints; rank ``k`` owns
slots ``[k·Ws, (k+1)·Ws)`` — ``Ws-1`` interior waypoints plus its right
separator in the last slot (rank ``K-1``'s is padding).  Padded slots carry
an identity P diagonal, zero coupling, zero rows with ±INF bounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..gomp.constraints import INF
from ..ops import admm as admm_mod
from ..ops.qp import RowReductions
from . import _comm
from .batch import gather_batch
from .mesh import (BATCH_AXIS, HORIZON_AXIS, axis_index, axis_size,
                   batch_slice, mesh_device)
from .schur import (_chunk_factor, schur_factor, schur_solve_cached,
                    tridiag_factor, tridiag_solve)

_MV = "trb...,tb...->tr..."  # A_t s_t
_MTV = "trb...,tr...->tb..."  # A_tᵀ y_t
_PV = "tij...,tj...->ti..."  # P_t s_t
_PTV = "tji...,tj...->ti..."  # P_tᵀ s_t
_ARA = "tri...,tr...,trj...->tij..."  # A_tᵀ diag(ρ_t) A'_t


def _shift_down(a):
    """zeros followed by ``a[:-1]``: ``out[t] = a[t-1]``."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]])


# ---------------------------------------------------------------------------
# One-process banded container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedQP(RowReductions):
    """Trajectory QP in per-waypoint row-block form (one process).

    State interleaved ``(W, B2, *batch)``; every constraint row belongs to a
    waypoint ``t`` and reads only ``(s_t, s_{t+1})``: ``z[t] = A0[t] @ s_t +
    A1[t] @ s_{t+1}``, ``A1[W-1] = 0``.  ``P_lower (W, B2, B2, *batch)``:
    ``P_lower[t]`` couples ``(t+1, t)``, the last block zero, so that the
    container splits along the horizon without reshaping."""

    waypoints: int
    block: int  # B2 = 2N
    rows_per_wp: int  # r

    P_diag: torch.Tensor  # (W, B2, B2, *batch)
    P_lower: torch.Tensor  # (W, B2, B2, *batch), last block zero
    q_wb: torch.Tensor  # (W, B2, *batch)
    A0: torch.Tensor  # (W, r, B2, *batch)
    A1: torch.Tensor  # (W, r, B2, *batch), last block zero
    l_wr: torch.Tensor  # (W, r, *batch)
    u_wr: torch.Tensor  # (W, r, *batch)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.q_wb.shape[2:])

    def map_arrays(self, fn):
        return self.replace(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    # ------------------------------------------------------------- protocol

    def _flat(self, a):
        return a.reshape((-1,) + self.batch_shape)

    @property
    def q(self):
        return self._flat(self.q_wb)

    @property
    def l(self):
        return self._flat(self.l_wr)

    @property
    def u(self):
        return self._flat(self.u_wr)

    @property
    def n(self) -> int:
        return self.waypoints * self.block

    @property
    def m(self) -> int:
        return self.waypoints * self.rows_per_wp

    def _s(self, x):
        return x.reshape((self.waypoints, self.block) + tuple(x.shape[1:]))

    def _from_right(self, v):
        """The next slot's value past the last one (none: zeros)."""
        return torch.zeros_like(v)

    def _from_left(self, v):
        return torch.zeros_like(v)

    def _halos(self, to_left, to_right):
        """``(from_right, from_left)``: the right neighbour's ``to_left``
        and the left neighbour's ``to_right`` (zeros on one process)."""
        return torch.zeros_like(to_left), torch.zeros_like(to_right)

    def A_matvec(self, x):
        s = self._s(x)
        s_ext = torch.cat([s[1:], self._from_right(s[0])[None]])
        z = torch.einsum(_MV, self.A0, s) + torch.einsum(_MV, self.A1, s_ext)
        return self._flat(z)

    def AT_matvec(self, y):
        yv = y.reshape((self.waypoints, self.rows_per_wp) + tuple(y.shape[1:]))
        out = torch.einsum(_MTV, self.A0, yv)
        carry = torch.einsum(_MTV, self.A1, yv)  # → state_{t+1}
        out = out + _shift_down(carry)
        out[0] += self._from_left(carry[-1])
        return self._flat(out)

    def P_matvec(self, x):
        s = self._s(x)
        y = torch.einsum(_PV, self.P_diag, s)
        low = self.P_lower[:-1]
        y[1:] += torch.einsum(_PV, low, s[:-1])
        y[:-1] += torch.einsum(_PTV, low, s[1:])
        # cross-chunk terms through the last coupling block
        last = self.P_lower[-1]
        from_right, from_left = self._halos(
            s[0], torch.einsum("ij...,j...->i...", last, s[-1]))
        y[0] += from_left
        y[-1] += torch.einsum("ji...,j...->i...", last, from_right)
        return self._flat(y)

    # ------------------------------------------------------------ Ruiz norms

    def A_col_absmax(self):
        c0 = self.A0.abs().amax(dim=1)  # (W, B2, *batch)
        c1 = self.A1.abs().amax(dim=1)
        cols = torch.maximum(c0, _shift_down(c1))
        cols[0] = torch.maximum(cols[0], self._from_left(c1[-1]))
        return self._flat(cols)

    def A_row_absmax(self):
        return self._flat(torch.maximum(self.A0.abs().amax(dim=2),
                                        self.A1.abs().amax(dim=2)))

    def P_col_absmax(self):
        d = self.P_diag.abs().amax(dim=1)  # (W, B2, *batch)
        low = self.P_lower.abs()
        # P_lower[t] = M[t+1, t]: its columns belong to block t, its rows to
        # block t+1 (the last one lands on the next chunk's first block).
        lo_col = low.amax(dim=1)
        lo_row = low.amax(dim=2)
        d = torch.maximum(d, lo_col)
        d = torch.maximum(d, _shift_down(lo_row))
        d[0] = torch.maximum(d[0], self._from_left(lo_row[-1]))
        return self._flat(d)

    # -------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        Dv = self._s(D)
        Ev = E.reshape((self.waypoints, self.rows_per_wp) + tuple(E.shape[1:]))
        D_next = torch.cat([Dv[1:], self._from_right(Dv[0])[None]])
        return self.replace(
            P_diag=c * Dv[:, :, None] * self.P_diag * Dv[:, None, :],
            P_lower=c * D_next[:, :, None] * self.P_lower * Dv[:, None, :],
            q_wb=c * Dv * self.q_wb,
            A0=Ev[:, :, None] * self.A0 * Dv[:, None, :],
            A1=Ev[:, :, None] * self.A1 * D_next[:, None, :],
            l_wr=Ev * self.l_wr,
            u_wr=Ev * self.u_wr,
        )

    # ------------------------------------------------------------- KKT path

    def kkt_blocks(self, rho_vec, sigma):
        """``(diag (W, B2, B2, *batch), lower (W, B2, B2, *batch))``; the
        last ``lower`` block couples the next chunk (zero on one
        process)."""
        B2 = self.block
        bs = tuple(rho_vec.shape[1:])
        rv = rho_vec.reshape((self.waypoints, self.rows_per_wp) + bs)
        eye = torch.eye(B2, dtype=self.P_diag.dtype,
                        device=self.P_diag.device).reshape(
            (B2, B2) + (1,) * len(bs))
        diag = self.P_diag + sigma * eye
        diag = diag + torch.einsum(_ARA, self.A0, rv, self.A0)
        c1 = torch.einsum(_ARA, self.A1, rv, self.A1)  # → (t+1, t+1)
        diag = diag + _shift_down(c1)
        diag[0] += self._from_left(c1[-1])
        lower = self.P_lower + torch.einsum(_ARA, self.A1, rv, self.A0)
        return diag, lower

    def kkt_factor(self, rho_vec, sigma):
        diag, lower = self.kkt_blocks(rho_vec, sigma)
        return tridiag_factor(diag, lower[:-1])

    def kkt_solve(self, factor, rhs):
        return self._flat(tridiag_solve(factor, self._s(rhs)))


def banded_from_trajectory(qp) -> Tuple[BandedQP, np.ndarray]:
    """A :class:`~osqp_solver_tpu_torch.gomp.trajectory_qp.TrajectoryQP` (any
    trailing batch dims) in banded row-block form.

    Returns ``(banded, row_map)``: ``row_map[i]`` is the banded flat row
    holding the i-th compact row of the trajectory container.  Row families
    inside a waypoint block: dyn(N), pos(N), vel(N), acc(N), then per ball
    gripper-XYZ and obstacle rows; a family absent at a waypoint (dyn at
    ``t = W-1``) is an inert zero row with ±INF bounds."""
    W, N = qp.waypoints, qp.n_dim
    B2 = 2 * N
    nb = qp.n_balls
    r = 4 * N + sum(3 if g else 0 for g in qp.gripper_flags) + (
        nb * qp.n_obstacles)
    bs = qp.batch_shape
    kw = dict(dtype=qp.q_vec.dtype, device=qp.q_vec.device)

    A0 = torch.zeros((W, r, B2) + bs, **kw)
    A1 = torch.zeros((W, r, B2) + bs, **kw)
    lo = torch.full((W, r) + bs, -INF, **kw)
    up = torch.full((W, r) + bs, INF, **kw)
    jj = torch.arange(N, device=kw["device"])

    # dyn rows (t < W-1): c0·v_t + c1·q_{t+1} + c2·q_t
    c = qp.dyn_coef  # (W-1, N, 3, *batch)
    A0[:-1, jj, N + jj] = c[:, :, 0]
    A0[:-1, jj, jj] = c[:, :, 2]
    A1[:-1, jj, jj] = c[:, :, 1]
    lo[:-1, jj] = qp.dyn_l
    up[:-1, jj] = qp.dyn_u
    # pos rows (all t)
    A0[:, N + jj, jj] = qp.pos_coef
    lo[:, N + jj] = qp.pos_l
    up[:, N + jj] = qp.pos_u
    # vel rows (t < W-1)
    A0[:-1, 2 * N + jj, N + jj] = qp.vel_coef
    lo[:-1, 2 * N + jj] = qp.vel_l
    up[:-1, 2 * N + jj] = qp.vel_u
    # acc rows (t < W-2): a0·v_{t+1} + a1·v_t
    a = qp.acc_coef  # (W-2, N, 2, *batch)
    A0[: W - 2, 3 * N + jj, N + jj] = a[:, :, 1]
    A1[: W - 2, 3 * N + jj, N + jj] = a[:, :, 0]
    lo[: W - 2, 3 * N + jj] = qp.acc_l
    up[: W - 2, 3 * N + jj] = qp.acc_u
    # workspace + obstacle rows
    off = 4 * N
    for b in range(nb):
        if qp.gripper_flags[b]:
            for ax in range(3):
                A0[:, off, :N] = qp.ws_jac[b, :, ax]
                lo[:, off] = qp.ws_l[b, :, ax]
                up[:, off] = qp.ws_u[b, :, ax]
                off += 1
        for o in range(qp.n_obstacles):
            A0[:, off, :N] = qp.obs_jac[b, o]
            lo[:, off] = qp.obs_l[b, o]
            up[:, off] = qp.obs_u[b, o]
            off += 1

    banded = BandedQP(
        waypoints=W, block=B2, rows_per_wp=r,
        P_diag=qp.P_diag,
        P_lower=torch.cat([qp.P_lower, torch.zeros((1, B2, B2) + bs, **kw)]),
        q_wb=interleave_state(qp.q_vec, W, N).reshape((W, B2) + bs),
        A0=A0, A1=A1, l_wr=lo, u_wr=up,
    )

    # Compact-row → banded-flat-row map (host side).
    row_map = []
    for t in range(W - 1):
        row_map.extend(t * r + j for j in range(N))  # dyn
    for t in range(W):
        row_map.extend(t * r + N + j for j in range(N))  # pos
    for t in range(W - 1):
        row_map.extend(t * r + 2 * N + j for j in range(N))  # vel
    for t in range(W - 2):
        row_map.extend(t * r + 3 * N + j for j in range(N))  # acc
    boff, k = [], 0
    for b in range(nb):
        boff.append(k)
        k += (3 if qp.gripper_flags[b] else 0) + qp.n_obstacles
    for b in range(nb):
        rpw = (3 if qp.gripper_flags[b] else 0) + qp.n_obstacles
        for t in range(W):
            for j in range(rpw):
                row_map.append(t * r + 4 * N + boff[b] + j)
    return banded, np.asarray(row_map)


def interleave_state(x_ref, W: int, N: int):
    """Reference layout ``[q..., v...] (2WN, *batch)`` → interleaved
    ``(W·2N, *batch)``."""
    bs = tuple(x_ref.shape[1:])
    return torch.cat([x_ref[: W * N].reshape((W, N) + bs),
                      x_ref[W * N:].reshape((W, N) + bs)],
                     dim=1).reshape((-1,) + bs)


def deinterleave_state(x_int, W: int, N: int):
    bs = tuple(x_int.shape[1:])
    s = x_int.reshape((W, 2 * N) + bs)
    return torch.cat([s[:, :N].reshape((-1,) + bs),
                      s[:, N:].reshape((-1,) + bs)])


# ---------------------------------------------------------------------------
# Horizon-sharded container (one rank's chunk)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBandedQP(BandedQP):
    """One rank's chunk of a :class:`BandedQP`: ``waypoints`` is the local
    slot count ``Ws`` (``Ws-1`` interior + the right separator), the tensors
    are the local chunk, and the operators exchange only ``(B2,)`` halos and
    ``(K, B2)`` separator data over ``process_group`` (the ranks of the
    mesh's horizon axis; this rank is ``axis_index`` there).

    ``local_chunks > 1`` factors and solves each rank's INTERIOR by a
    rank-local Schur split (:mod:`.schur`) instead of the sequential
    tridiagonal kernels: the two-level decomposition, which gives a long
    interior width on one device."""

    n_chunks: int = 2
    total_waypoints: int = 0
    axis_index: int = 0
    local_chunks: int = 1
    process_group: object = None

    def _interior_backend(self):
        if self.local_chunks > 1:
            lc = self.local_chunks
            return (lambda D, L: schur_factor(D, L, lc), schur_solve_cached)
        return tridiag_factor, tridiag_solve

    @property
    def n_valid_mask(self):
        """``(n,)`` bool: True on the state entries of real (unpadded)
        waypoints."""
        Ws, B2 = self.waypoints, self.block
        g = self.axis_index * Ws + torch.arange(Ws, device=self.q_wb.device)
        return (g < self.total_waypoints).repeat_interleave(B2)

    # ----------------------------------------------------------- reductions
    # Every scalar reduction of the solve combines over the group, one
    # ``all_reduce`` a quantity (the reference's ``pmax``/``psum``).  It
    # leaves the same value on every rank, so every rank takes the same
    # branch (terminate, adapt ρ, certificates) and the next collective
    # cannot hang.

    def reduce(self, r, op: str):
        return _comm.all_reduce(r, op, self.process_group)

    def row_mean(self, v):
        """Mean over the real state slots of every rank, padded ones
        masked out."""
        mask = self.n_valid_mask.reshape((-1,) + (1,) * (v.dim() - 1))
        s = torch.where(mask, v, torch.zeros_like(v)).sum(dim=0)
        cnt = mask.to(v.dtype).sum(dim=0).expand_as(s)
        return self.reduce(s, "sum") / self.reduce(cnt, "sum")

    # ---------------------------------------------------------------- halos

    def _halos(self, to_left, to_right):
        """One ``all_gather`` of this rank's two edge values: the right
        neighbour's ``to_left`` (rank ``K-1`` gets zeros) and the left
        neighbour's ``to_right`` (rank 0 gets zeros)."""
        K, k = self.n_chunks, self.axis_index
        if K == 1:
            return torch.zeros_like(to_left), torch.zeros_like(to_right)
        g = _comm.all_gather(torch.stack([to_left, to_right]),
                             self.process_group)
        from_right = g[k + 1, 0] if k < K - 1 else torch.zeros_like(to_left)
        from_left = g[k - 1, 1] if k > 0 else torch.zeros_like(to_right)
        return from_right, from_left

    def _from_right(self, v):
        return self._halos(v, torch.zeros_like(v))[0]

    def _from_left(self, v):
        return self._halos(torch.zeros_like(v), v)[1]

    # ------------------------------------------------------------- KKT path

    def kkt_factor(self, rho_vec, sigma):
        K = self.n_chunks
        diag, lower = self.kkt_blocks(rho_vec, sigma)
        Ws = self.waypoints
        Lleft = lower[-2]  # M[s_k, last interior]
        Lright = self._from_left(lower[-1])  # M[first interior, s_{k-1}]
        interior, U, V, C_right, C_left, C_off = _chunk_factor(
            diag[:-1], lower[:-2] if Ws > 2 else lower[:0], Lleft, Lright,
            backend=self._interior_backend())
        f = dict(interior=interior, U=U, V=V, Lleft=Lleft, Lright=Lright,
                 reduced=None)
        if K == 1:
            # No separator (the one chunk's separator slot is padding,
            # pinned to zero in kkt_solve): the interior factor alone.
            return f
        g = _comm.all_gather(torch.stack([diag[-1], C_right, C_left, C_off]),
                             self.process_group)  # (K, 4, B2, B2, *batch)
        Sdiag = g[: K - 1, 0] - g[: K - 1, 1] - g[1:K, 2]
        Slower = -g[1 : K - 1, 3].transpose(1, 2)
        f["reduced"] = tridiag_factor(Sdiag, Slower)
        return f

    def kkt_solve(self, f, rhs):
        K, k = self.n_chunks, self.axis_index
        _, interior_solve = self._interior_backend()
        b = self._s(rhs)
        w = interior_solve(f["interior"], b[:-1])  # local interior
        if K == 1:
            return self._flat(torch.cat([w, torch.zeros_like(w[:1])]))
        r_right = torch.einsum("ij...,j...->i...", f["Lleft"], w[-1])
        r_left = torch.einsum("ji...,j...->i...", f["Lright"], w[0])
        g = _comm.all_gather(torch.stack([b[-1], r_right, r_left]),
                             self.process_group)  # (K, 3, B2, *batch)
        rS = g[: K - 1, 0] - g[: K - 1, 1] - g[1:K, 2]
        xs = tridiag_solve(f["reduced"], rS)  # the small reduced solve
        zero = torch.zeros_like(w[0])
        x_right = xs[k] if k < K - 1 else zero
        x_left = xs[k - 1] if k > 0 else zero
        mv = "wbr...,r...->wb..."
        xi = (w - torch.einsum(mv, f["U"], x_right)
              - torch.einsum(mv, f["V"], x_left))
        # the interior stays local — only separator values crossed ranks.
        return self._flat(torch.cat([xi, x_right[None]]))


# ---------------------------------------------------------------------------
# Partition / solve drivers
# ---------------------------------------------------------------------------

_DATA = ("P_diag", "P_lower", "q_wb", "A0", "A1", "l_wr", "u_wr")


def partition_banded(qp: BandedQP, n_chunks: int):
    """Pad the horizon to ``K·Ws`` and reshape every tensor to a leading
    ``(K,)`` chunk axis: ``(dict, Ws)``.  Padded slots: identity P diagonal,
    zero coupling and rows, ±INF bounds, zero q.  ``K·Ws ≥ W+1``, so the
    last rank's separator slot is padding."""
    K = n_chunks
    W, B2, r = qp.waypoints, qp.block, qp.rows_per_wp
    Ws = max(2, -(-(W + 1) // K))
    pad = K * Ws - W
    bs = qp.batch_shape
    kw = dict(dtype=qp.q_wb.dtype, device=qp.q_wb.device)
    eye = torch.eye(B2, **kw).reshape((1, B2, B2) + (1,) * len(bs))

    P_lower = torch.cat([qp.P_lower, torch.zeros((pad, B2, B2) + bs, **kw)])
    A1 = torch.cat([qp.A1, torch.zeros((pad, r, B2) + bs, **kw)])
    if pad:
        # cut the last real waypoint's coupling into the padding
        P_lower[W - 1] = 0.0
        A1[W - 1] = 0.0
    data = dict(
        P_diag=torch.cat([qp.P_diag, eye.expand((pad, B2, B2) + bs)]),
        P_lower=P_lower,
        q_wb=torch.cat([qp.q_wb, torch.zeros((pad, B2) + bs, **kw)]),
        A0=torch.cat([qp.A0, torch.zeros((pad, r, B2) + bs, **kw)]),
        A1=A1,
        l_wr=torch.cat([qp.l_wr, torch.full((pad, r) + bs, -INF, **kw)]),
        u_wr=torch.cat([qp.u_wr, torch.full((pad, r) + bs, INF, **kw)]),
    )
    return {k: v.reshape((K, Ws) + tuple(v.shape[1:]))
            for k, v in data.items()}, Ws


def _solve_chunked(qp: BandedQP, K: int, k: int, group, device, settings,
                   warm_x, local_chunks: int):
    """This rank's part of a horizon-sharded solve of ``qp`` (no batch dims
    or one trailing batch dim): the result's x/y/z gathered back to the
    global banded layout, padding dropped."""
    W, B2, r = qp.waypoints, qp.block, qp.rows_per_wp
    bs = qp.batch_shape
    chunks, Ws = partition_banded(qp, K)
    sq = ShardedBandedQP(
        waypoints=Ws, block=B2, rows_per_wp=r, n_chunks=K, total_waypoints=W,
        axis_index=k, local_chunks=int(local_chunks), process_group=group,
        **{name: chunks[name][k].to(device) for name in _DATA},
    )
    warm = None
    if warm_x is not None:
        w = torch.as_tensor(warm_x, dtype=qp.q_wb.dtype, device=device)
        # batch-leading (B, W·B2) / (W·B2,) → this rank's (Ws·B2) slots
        w = w.movedim(0, -1) if bs else w
        w = torch.cat([w, w.new_zeros(((K * Ws - W) * B2,) + bs)])
        w = w.reshape((K, Ws * B2) + bs)[k]
        warm = w.movedim(-1, 0) if bs else w
    solve = admm_mod.solve_batched if bs else admm_mod.solve
    res = solve(sq, settings, warm_x=warm, device=device)

    def glob(v, width):  # local (.., Ws·width) → global (.., W·width)
        g = _comm.all_gather(v, group, "gather_result")  # (K, [B,] Ws·w)
        g = g.movedim(0, -2) if bs else g
        lead = tuple(g.shape[:-2])
        return g.reshape(lead + (K * Ws, width))[..., :W, :].reshape(
            lead + (W * width,))

    return dataclasses.replace(res, x=glob(res.x, B2), y=glob(res.y, r),
                               z=glob(res.z, r))


def solve_banded_sharded(
    qp: BandedQP,
    mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x: Optional[torch.Tensor] = None,
    axis: str = HORIZON_AXIS,
    local_chunks: int = 1,
) -> admm_mod.SolveResult:
    """The OSQP-semantics ADMM for ONE long-horizon QP (no batch dims) with
    state, data and KKT split over ``mesh[axis]``: per iteration ``O(K·B2)``
    separator exchange, ``O(B2)`` halos and scalar reductions.  Every rank
    of the axis takes part; ``warm_x`` is interleaved ``(W·B2,)``.  The
    returned x/y/z are gathered back to the global banded layout on every
    rank (padding dropped), on the mesh's device."""
    return _solve_chunked(
        qp, axis_size(mesh, axis), axis_index(mesh, axis),
        mesh.get_group(axis), mesh_device(mesh), settings, warm_x,
        local_chunks)


def solve_banded_sharded_2d(
    qps: BandedQP,
    mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x: Optional[torch.Tensor] = None,
    batch_axis: Optional[str] = None,
    axis: str = HORIZON_AXIS,
) -> admm_mod.SolveResult:
    """A batch of long-horizon QPs on the 2-D ``(batch, horizon)`` mesh:
    the problems (one trailing batch dim, a multiple of the batch axis
    size) split over ``batch_axis`` — no collective crosses it — and each
    problem's horizon over ``axis`` as in :func:`solve_banded_sharded`; a
    rank's several problems run as one batch with the solver's masked
    convergence.  ``warm_x``: ``(n_problems, W·B2)`` or None.  Returns a
    batch-leading :class:`SolveResult` of every problem on every rank."""
    baxis = batch_axis or BATCH_AXIS
    (nb,) = qps.batch_shape
    sl = batch_slice(nb, mesh, baxis)
    mine = qps.map_arrays(lambda a: a[..., sl])
    warm = None if warm_x is None else torch.as_tensor(warm_x)[sl]
    res = _solve_chunked(
        mine, axis_size(mesh, axis), axis_index(mesh, axis),
        mesh.get_group(axis), mesh_device(mesh), settings, warm, 1)
    return gather_batch(res, mesh.get_group(baxis))
