"""Preconditioned conjugate-gradient KKT solve (indirect method).

Counterpart of ``osqp_solver_tpu/ops/cg.py`` (``kkt_matvec``,
``kkt_diagonal``, ``cg_solve``), batch-trailing.  The matrix-free
alternative to the direct Cholesky path (``Settings(kkt_method="cg")``):
solves ``(P + σI + Aᵀdiag(ρ)A) x = b`` with the operator protocol's matvecs
only, so it serves every container, with Jacobi preconditioning and an
iteration cap.  It runs no kernel of its own.

The reference's ``lax.while_loop`` (under ``vmap``: each problem stops at
its own iteration) is a loop of ``max_iter`` steps here in which a problem
whose residual met the tolerance keeps its iterate: the same per-problem
result, with no device read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor  # (n, B)
    iterations: torch.Tensor  # (B,) int32
    residual: torch.Tensor  # (B,) ‖r‖₂


def kkt_matvec(qp, rho_vec, sigma, x):
    """``(P + σI + Aᵀ diag(ρ) A) x`` through the operator protocol."""
    return qp.P_matvec(x) + sigma * x + qp.AT_matvec(rho_vec * qp.A_matvec(x))


def kkt_diagonal(qp, rho_vec, sigma):
    """Jacobi preconditioner of the reduced KKT: the reference's SPD
    surrogate from the column norms, ``colmax(P) + σ + colmax(|A|)²·max(ρ)``
    (its exact branch needs ``P_diagonal``/``A_sq_colsum``, which no
    container has)."""
    a_cols = qp.A_col_absmax()
    return qp.P_col_absmax() + sigma + a_cols * a_cols * rho_vec.amax(dim=0)


def cg_solve(
    qp,
    rho_vec,
    sigma,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-7,
    max_iter: int = 200,
) -> CGResult:
    """Preconditioned CG on the reduced KKT system, ``b (n, B)``."""
    diag = kkt_diagonal(qp, rho_vec, sigma)
    Minv = 1.0 / diag.clamp(min=1e-12)

    def norm(v):
        return torch.linalg.vector_norm(v, dim=0)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - kkt_matvec(qp, rho_vec, sigma, x)
    z = Minv * r
    p = z
    rz = (r * z).sum(dim=0)
    b_norm = norm(b).clamp(min=1e-12)
    k = torch.zeros(b.shape[1:], dtype=torch.int32, device=b.device)

    for _ in range(max_iter):
        active = norm(r) > tol * b_norm
        Ap = kkt_matvec(qp, rho_vec, sigma, p)
        alpha = rz / (p * Ap).sum(dim=0).clamp(min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = Minv * r_n
        rz_n = (r_n * z_n).sum(dim=0)
        beta = rz_n / rz.clamp(min=1e-30)
        p_n = z_n + beta * p
        x, r, z, p, rz = (
            torch.where(active, new, old)
            for new, old in ((x_n, x), (r_n, r), (z_n, z), (p_n, p),
                             (rz_n, rz))
        )
        k = k + active.to(torch.int32)
    return CGResult(x=x, iterations=k, residual=norm(r))
