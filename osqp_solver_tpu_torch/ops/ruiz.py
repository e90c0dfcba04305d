"""Scaling container and limits of the modified Ruiz equilibration.

Counterpart of ``osqp_solver_tpu/ops/ruiz.py`` (``Scaling``, ``_limit``,
``MIN_SCALING``, ``MAX_SCALING``, ``identity_scaling``,
``ruiz_equilibrate``), batch-trailing: ``D (n, *batch)``, ``E (m, *batch)``,
``c (*batch)``.  The scaled problem is ``P̄ = c·D P D``,
``q̄ = c·D q``, ``Ā = E A D``, ``l̄ = E l``, ``ū = E u``; unscaling:
``x = D x̄``, ``y = E ȳ / c``.  :func:`ruiz_equilibrate` serves the
generic path (any container of the operator protocol); the lane container's
equilibration lives in :mod:`osqp_solver_tpu_torch.ops.ruiz_kernel`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MIN_SCALING = 1e-4  # OSQP MIN_SCALING
MAX_SCALING = 1e4  # OSQP MAX_SCALING


class Scaling(NamedTuple):
    D: torch.Tensor  # (n, B) primal scaling
    E: torch.Tensor  # (m, B) dual / constraint scaling
    c: torch.Tensor  # (B,) cost scaling
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor


def _limit(norms: torch.Tensor) -> torch.Tensor:
    """OSQP ``limit_scaling``: zeros→1 (leave unscaled), clip to MAX."""
    norms = torch.where(norms < MIN_SCALING, torch.ones_like(norms), norms)
    return torch.clamp(norms, max=MAX_SCALING)


def identity_scaling(n: int, m: int, dtype=torch.float64, batch: tuple = (),
                     device=None) -> Scaling:
    """No scaling: ``D``, ``E``, ``c`` all one, with trailing batch dims
    ``batch``."""
    kw = dict(dtype=dtype, device=device)
    one = torch.ones(tuple(batch), **kw)
    ones_n = torch.ones((n,) + tuple(batch), **kw)
    ones_m = torch.ones((m,) + tuple(batch), **kw)
    return Scaling(D=ones_n, E=ones_m, c=one, Dinv=ones_n, Einv=ones_m,
                   cinv=one)


def ruiz_equilibrate(qp, iters: int = 10):
    """Return ``(scaled_qp, Scaling)`` for any container of the operator
    protocol (``DenseQP``, ``TrajectoryQP``), batch-trailing.

    Each iteration: column inf-norms of the symmetric KKT block
    ``[[P, Aᵀ], [A, 0]]`` give ``δ = 1/sqrt(norm)`` updates for D and E, then
    the cost is normalized by ``γ = 1/max(mean(colnorm(P)), ‖q‖∞)``.

    The cost-normalisation scalars go through the container's ``row_mean``
    and ``reduce``: on a container split over processes
    (``parallel.banded.ShardedBandedQP``) they combine over its group, padded
    state slots masked out of the mean (the reference's ``collective_axis`` /
    ``n_valid_mask``); the row and column norms stay local (its absmax
    methods exchange the halos).
    """
    q = qp.q
    n, bs = q.shape[0], tuple(q.shape[1:])
    m = qp.l.shape[0]
    kw = dict(dtype=q.dtype, device=q.device)
    D = torch.ones((n,) + bs, **kw)
    E = torch.ones((m,) + bs, **kw)
    c = torch.ones(bs, **kw)

    scaled = qp
    for _ in range(iters):
        cols_x = torch.maximum(scaled.P_col_absmax(), scaled.A_col_absmax())
        D = D * (1.0 / torch.sqrt(_limit(cols_x)))
        if m:
            E = E * (1.0 / torch.sqrt(_limit(scaled.A_row_absmax())))
        scaled = qp.scale_data(D, E, c)

        p_cols = _limit(scaled.P_col_absmax())
        gamma = 1.0 / _limit(
            torch.maximum(qp.row_mean(p_cols),
                          qp.reduce(scaled.q.abs().amax(dim=0), "max"))
        )
        c = c * gamma
        scaled = qp.scale_data(D, E, c)

    scaling = Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return scaled, scaling
