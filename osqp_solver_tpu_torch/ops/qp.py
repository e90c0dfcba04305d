"""Dense QP container and the operator protocol the generic ADMM path solves.

Counterpart of ``osqp_solver_tpu/ops/qp.py`` (``DenseQP``, ``dense_qp``),
batch-trailing: where the reference ``vmap``s a container over a batch,
every array here carries the batch as its LAST dimension (``P (n, n, B)``,
``q (n, B)``, ``A (m, n, B)``, ``l``/``u (m, B)``), or none at all (a batch
of one to the solvers).

Protocol (duck-typed; shared with the trajectory container
:class:`~osqp_solver_tpu_torch.gomp.trajectory_qp.TrajectoryQP`):

- ``q, l, u``: ``(n, *batch)`` / ``(m, *batch)``; ``batch_shape``
- ``P_matvec(x)``, ``A_matvec(x)``, ``AT_matvec(y)``
- ``P_col_absmax()``, ``A_col_absmax()``, ``A_row_absmax()`` (Ruiz norms)
- ``scale_data(D, E, c)`` → same type, data scaled (P̄=cDPD, Ā=EAD,
  q̄=cDq, ``l̄``/``ū`` = E·l/u)
- ``kkt_factor(rho_vec, sigma)`` → factor of the reduced KKT
  ``P + σI + Aᵀdiag(ρ)A``; ``kkt_solve(factor, rhs)`` → x
- ``map_arrays(fn)`` → same type with ``fn`` applied to every array
- ``reduce(r, op)``, ``row_mean(v)``: the solve's scalar reductions over
  the rows (:class:`RowReductions`)

The matvecs, ``scale_data`` and the KKT methods take one trailing batch dim
(the solvers give an unbatched container a batch of one).

The matvecs and the reduced-KKT assembly are plain batched products (the
reference leaves them to XLA); the factor and solve are the hand-written
kernels of :mod:`.dense_kernel` on a CUDA batch and their plain versions on
the CPU.  The products run on batch-leading copies of ``P`` and ``A``
(:meth:`DenseQP.batch_major`), built once per solve: a batch-trailing
operand would make every product copy it first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import dense_kernel


def _bmv(Mb, v):
    """Batch-leading ``Mb (B, r, c)`` times batch-trailing ``v (c, B)`` →
    ``(r, B)``."""
    return torch.bmm(Mb, v.T.unsqueeze(-1)).squeeze(-1).T


class RowReductions:
    """The solve's per-problem reductions over a container's rows, for a
    container that holds all of them: ``reduce(r, op)`` ("max" or "sum")
    returns the partial ``r`` as it is, ``row_mean(v)`` is the mean over the
    row axis.  A container whose rows are split over processes
    (``parallel.banded.ShardedBandedQP``) overrides both to combine over its
    group."""

    def reduce(self, r, op: str):
        return r

    def row_mean(self, v):
        return v.mean(dim=0)


@dataclasses.dataclass(frozen=True)
class DenseQP(RowReductions):
    """min ½xᵀPx + qᵀx  s.t.  l ≤ Ax ≤ u, with dense ``P (n, n, *batch)``
    and ``A (m, n, *batch)``."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    # Batch-leading copies (B, n, n) / (B, m, n) for the products, or None.
    P_bm: Optional[torch.Tensor] = None
    A_bm: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.P.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.q.shape[1:])

    def replace(self, **changes) -> "DenseQP":
        """New values for fields; the batch-leading copies are dropped
        whenever ``P`` or ``A`` change."""
        if "P" in changes and "P_bm" not in changes:
            changes["P_bm"] = None
        if "A" in changes and "A_bm" not in changes:
            changes["A_bm"] = None
        return dataclasses.replace(self, **changes)

    def map_arrays(self, fn) -> "DenseQP":
        return DenseQP(*(fn(a) for a in (self.P, self.q, self.A, self.l,
                                          self.u)))

    def batch_major(self) -> "DenseQP":
        """The same problem with batch-leading contiguous copies of ``P``
        and ``A`` (one batch dim)."""
        if self.P_bm is not None and self.A_bm is not None:
            return self
        return dataclasses.replace(
            self,
            P_bm=self.P.movedim(-1, 0).contiguous(),
            A_bm=self.A.movedim(-1, 0).contiguous(),
        )

    def _lead(self, name):
        bm = getattr(self, name + "_bm")
        return getattr(self, name).movedim(-1, 0) if bm is None else bm

    # --- operators ----------------------------------------------------------

    def P_matvec(self, x):
        return _bmv(self._lead("P"), x)

    def A_matvec(self, x):
        return _bmv(self._lead("A"), x)

    def AT_matvec(self, y):
        return _bmv(self._lead("A").transpose(1, 2), y)

    # --- Ruiz norms ---------------------------------------------------------

    def P_col_absmax(self):
        return self.P.abs().amax(dim=0)

    def A_col_absmax(self):
        if not self.m:
            return torch.zeros_like(self.q)
        return self.A.abs().amax(dim=0)

    def A_row_absmax(self):
        return self.A.abs().amax(dim=1) if self.m else self.l

    # --- scaling ------------------------------------------------------------

    def scale_data(self, D, E, c):
        return DenseQP(
            P=c * (D[:, None] * self.P * D[None, :]),
            q=c * D * self.q,
            A=E[:, None] * self.A * D[None, :],
            l=E * self.l,
            u=E * self.u,
        )

    # --- reduced KKT --------------------------------------------------------

    def kkt_matrix(self, rho_vec, sigma):
        """``P + σI + Aᵀ diag(ρ) A``, batch-trailing ``(n, n, B)``."""
        A = self._lead("A")
        eye = torch.eye(self.n, dtype=self.P.dtype, device=self.P.device)
        M = self._lead("P") + sigma * eye
        M = M + torch.bmm(A.transpose(1, 2), rho_vec.T.unsqueeze(-1) * A)
        return M.movedim(0, -1).contiguous()

    def kkt_factor(self, rho_vec, sigma):
        """Cholesky of the reduced KKT (SPD by construction): the dense
        factor kernel on a CUDA batch, its plain version on the CPU."""
        return dense_kernel.factor_lane_major(self.kkt_matrix(rho_vec, sigma))

    def kkt_solve(self, factor, rhs):
        return dense_kernel.solve_lane_major(factor, rhs)


def dense_qp(P, q, A, l, u, dtype=None) -> DenseQP:
    """Build a :class:`DenseQP` from array-likes (batch-trailing, or with no
    batch dims), upcast to a common dtype (``dtype`` if given).  The solvers
    move it to their device."""
    arrs = [torch.as_tensor(v) for v in (P, q, A, l, u)]
    if dtype is None:
        dtype = arrs[0].dtype
        for a in arrs[1:]:
            dtype = torch.promote_types(dtype, a.dtype)
    return DenseQP(*(a.to(dtype) for a in arrs))
