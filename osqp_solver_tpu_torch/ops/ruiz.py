"""Scaling container and limits of the modified Ruiz equilibration.

Counterpart of ``osqp_solver_tpu/ops/ruiz.py`` (``Scaling``, ``_limit``,
``MIN_SCALING``, ``MAX_SCALING``).  The scaled problem is ``P̄ = c·D P D``,
``q̄ = c·D q``, ``Ā = E A D``, ``l̄ = E l``, ``ū = E u``; unscaling:
``x = D x̄``, ``y = E ȳ / c``.  The equilibration itself lives in
:mod:`osqp_solver_tpu_torch.ops.ruiz_kernel`.
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
