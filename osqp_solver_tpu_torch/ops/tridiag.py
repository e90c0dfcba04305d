"""Symmetric block-tridiagonal factorization and solves, batch-trailing.

Counterpart of ``osqp_solver_tpu/ops/tridiag.py``
(``block_tridiag_factor``, ``block_tridiag_solve``,
``block_tridiag_matvec``, ``block_tridiag_to_dense``) in the lane layout the
reference reaches by ``vmap``: ``diag (W, n, n, B)``, ``lower (W-1, n, n,
B)`` with ``lower[t] = M[t+1, t]``.  The horizon recurrence is a Python
loop over ``W``.  This is the plain reference of the KKT-factor kernel
(:mod:`.kkt_factor`) and the CPU ``kkt_solve``; nothing on the CUDA main
path calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BlockTridiagFactor(NamedTuple):
    """``M = C Cᵀ`` with block-bidiagonal ``C``: diagonal blocks ``chol``
    (lower-triangular), sub-diagonal blocks ``gain`` = ``L_t C_t⁻ᵀ``."""

    chol: torch.Tensor  # (W, n, n, B)
    gain: torch.Tensor  # (W-1, n, n, B)


def _lead(a):  # (..., B) -> (B, ...)
    return a.movedim(-1, 0)


def _trail(a):  # (B, ...) -> (..., B)
    return a.movedim(0, -1)


def _chol(a):
    """Batched Cholesky; a block that is not positive definite becomes NaN
    (no exception), as the reference's ``jnp.linalg.cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[:, None, None], L, float("nan"))


def block_tridiag_factor(diag, lower) -> BlockTridiagFactor:
    """``C_0 = chol(D_0)``; ``G_t = L_t C_t⁻ᵀ``;
    ``C_{t+1} = chol(D_{t+1} − G_t G_tᵀ)``.  A non-positive pivot yields a
    NaN block (no exception), as in the reference."""
    W = diag.shape[0]
    c = _chol(_lead(diag[0]))
    chols, gains = [c], []
    for t in range(W - 1):
        L_t = _lead(lower[t])  # (B, n, n)
        # G_t = L_t C_t^{-T}  ⟺  solve C_t Xᵀ = L_tᵀ.
        g = torch.linalg.solve_triangular(
            c, L_t.transpose(-1, -2), upper=False
        ).transpose(-1, -2)
        c = _chol(_lead(diag[t + 1]) - g @ g.transpose(-1, -2))
        chols.append(c)
        gains.append(g)
    chol = _trail(torch.stack(chols, dim=1))  # (B, W, n, n) -> (W, n, n, B)
    if gains:
        gain = _trail(torch.stack(gains, dim=1))
    else:
        gain = lower
    return BlockTridiagFactor(chol=chol, gain=gain)


def block_tridiag_solve(factor: BlockTridiagFactor, b):
    """Solve ``M x = b`` for ``b (W, n, B)``: forward substitution sweep,
    then backward substitution sweep."""
    chol, gain = _lead(factor.chol), _lead(factor.gain)  # (B, W, n, n)
    rhs = _lead(b).unsqueeze(-1)  # (B, W, n, 1)
    W = chol.shape[1]
    tri = torch.linalg.solve_triangular
    ws = [tri(chol[:, 0], rhs[:, 0], upper=False)]
    for t in range(1, W):
        ws.append(
            tri(chol[:, t], rhs[:, t] - gain[:, t - 1] @ ws[-1], upper=False)
        )
    xs = [None] * W
    xs[W - 1] = tri(chol[:, W - 1].transpose(-1, -2), ws[W - 1], upper=True)
    for t in range(W - 2, -1, -1):
        xs[t] = tri(
            chol[:, t].transpose(-1, -2),
            ws[t] - gain[:, t].transpose(-1, -2) @ xs[t + 1],
            upper=True,
        )
    return _trail(torch.stack(xs, dim=1).squeeze(-1))  # (W, n, B)


def block_tridiag_matvec(diag, lower, x):
    """``y = M x`` for ``x (W, n, *batch)``, with ``diag (W, n, n, *batch)``
    and ``lower (W-1, n, n, *batch)``; no batch dims is the reference's
    unbatched call."""
    y = torch.einsum("tij...,tj...->ti...", diag, x)
    if lower.shape[0]:
        y[1:] += torch.einsum("tij...,tj...->ti...", lower, x[:-1])
        y[:-1] += torch.einsum("tji...,tj...->ti...", lower, x[1:])
    return y


def block_tridiag_to_dense(diag, lower):
    """The dense ``(W*n, W*n, *batch)`` matrix (tests only)."""
    W, n = diag.shape[:2]
    bs = tuple(diag.shape[3:])
    M = diag.new_zeros((W * n, W * n) + bs)
    for t in range(W):
        M[t * n:(t + 1) * n, t * n:(t + 1) * n] = diag[t]
    for t in range(W - 1):
        M[(t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = lower[t]
        M[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = lower[t].transpose(0, 1)
    return M
