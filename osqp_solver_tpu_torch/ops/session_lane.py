"""Batched lane-major solver sessions: a fleet of warm-started MPC solvers.

Counterpart of ``osqp_solver_tpu/ops/session_lane.py`` (``LaneSession``,
``setup_lane``, ``update_bounds_lane``, ``solve_lane``, ``mpc_scan_lane``).
The OSQP session contract for a whole batch in the lane (batch-last)
layout: equilibrate once with *frozen* scaling, cache the KKT factor (and,
on the fused path, the bounds-independent kernel packs), carry x/y/ρ across
solves.  Production shape: B independent receding-horizon controllers
stepped together — per tick every problem's bounds change (values only) and
the batch re-solves warm-started on the cached factor, with zero Ruiz and
zero refactorization.

The cached factor stays valid only while each row's classification
(equality / loose / finite, hence ρ_vec) is unchanged.  Keep bound sweeps
classification-stable, or pass ``guard_reclassification=True`` to
:func:`update_bounds_lane`: one device read decides whether any row of any
problem flipped, and the whole batch refactors only then.

The reference's ``lax.scan`` over ticks is a host loop here; it adds no
device read of its own (each solve reads once per chunk, counted in
:data:`.admm_lane.HOST_SYNCS`, as is the guard's read).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import admm_lane
from .admm import (
    Settings,
    _rho_vec,
    check_supported,
    pin_matmul_precision,
    resolve_device,
)
from .admm_lane import (
    _packed_factor,
    _solve_core,
    _use_fused,
    build_const_packs,
    check_kernel_limits,
    identity_scaling_lane,
    ruiz_equilibrate_lane,
)
from .ruiz import Scaling


@dataclasses.dataclass(frozen=True)
class LaneSession:
    base: object  # unscaled LaneTrajectoryQP
    scaled: object  # Ruiz-scaled problem (scaling frozen at setup)
    scaling: Scaling
    warm_x: torch.Tensor  # (n, B) unscaled primal carry
    warm_y: torch.Tensor  # (m, B) unscaled dual carry
    rho_bar: torch.Tensor  # (B,) carried ρ̄ (advanced by adaptation)
    factor: object  # cached KKT factor for (scaled, rho_bar)
    cache: Optional[dict] = None  # bounds-independent kernel packs (fused)

    def replace(self, **changes) -> "LaneSession":
        return dataclasses.replace(self, **changes)


def setup_lane(qps, settings: Settings = Settings(), device=None) -> LaneSession:
    """Equilibrate once, factor once (``OsqpSolver::Init`` semantics for
    the whole batch).

    ``qps``: a :class:`~osqp_solver_tpu_torch.gomp.trajectory_qp_lane.
    LaneTrajectoryQP`, or a batch-leading ``TrajectoryQP`` converted with
    ``to_lane`` (the ``"type"`` row layout, which takes the unfused path).
    ``device``: ``"cuda"`` unless the caller passes ``"cpu"`` (raises when
    CUDA is absent and the CPU was not asked for); the batch is moved there.
    """
    from ..gomp.trajectory_qp_lane import LaneTrajectoryQP, to_lane

    dev = resolve_device(device)
    check_supported(settings)
    pin_matmul_precision()
    if not isinstance(qps, LaneTrajectoryQP):
        qps = to_lane(qps)
    check_kernel_limits(qps, settings, dev)
    qps = qps.to(dev)
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate_lane(qps, settings.scaling)
    else:
        scaled, scaling = qps, identity_scaling_lane(qps)
    n, B = qps.q.shape
    kw = dict(dtype=qps.q.dtype, device=dev)
    rho_bar = torch.full((B,), settings.rho, **kw)
    cache = (
        build_const_packs(scaled, scaling)
        if _use_fused(scaled, settings) else None
    )
    return LaneSession(
        base=qps,
        scaled=scaled,
        scaling=scaling,
        warm_x=torch.zeros((n, B), **kw),
        warm_y=torch.zeros((qps.m, B), **kw),
        rho_bar=rho_bar,
        factor=_fresh_factor(scaled, rho_bar, settings, cache),
        cache=cache,
    )


def _fresh_factor(scaled, rho_bar, settings: Settings, cache=None):
    """Factor in the representation the solve path will consume: the
    packed ``(cholp, gainp | None)`` of the fused path (gain written unless
    ``factor_form="hrec"`` on a vel-diag batch; block P packs the
    block-tridiagonal factor, gain form), or the full-block factor of the
    unfused one — the branches of ``admm_lane._solve_core``."""
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    if _use_fused(scaled, settings):
        return _packed_factor(scaled, rho_vec, settings,
                              coef=None if cache is None else cache["coef"])
    return scaled.kkt_factor(rho_vec, settings.sigma)


def _on_device(base, fields):
    return {
        k: torch.as_tensor(v, dtype=base.dtype, device=base.device)
        for k, v in fields.items()
    }


def update_bounds_lane(
    session: LaneSession,
    guard_reclassification: bool = False,
    settings: Settings = Settings(),
    **bound_fields,
) -> LaneSession:
    """Values-only bounds/q update with frozen scaling and KEPT factor
    (``SetBounds``).  ``bound_fields`` replace fields of the unscaled base
    container (e.g. ``pos_l=..., pos_u=...``).

    With ``guard_reclassification=True`` the classification (ρ_vec) is
    compared elementwise, one device read (counted in
    :data:`.admm_lane.HOST_SYNCS`) decides whether any row of any problem
    flipped, and only then the WHOLE batch refactors.  Off by default, as in
    the reference: an unguarded flip only stalls convergence, it never
    corrupts an accepted solution."""
    s = session.scaling
    old_rho = (
        _rho_vec(session.rho_bar, session.scaled.l, session.scaled.u)
        if guard_reclassification else None
    )
    base = session.base.replace(**_on_device(session.base, bound_fields))
    session = session.replace(base=base, scaled=base.scale_data(s.D, s.E, s.c))
    if not guard_reclassification:
        return session
    new_rho = _rho_vec(session.rho_bar, session.scaled.l, session.scaled.u)
    changed = bool(torch.any(old_rho != new_rho))  # the guard's one read
    admm_lane.HOST_SYNCS += 1
    if not changed:
        return session
    return session.replace(
        factor=_fresh_factor(
            session.scaled, session.rho_bar, settings, session.cache
        )
    )


def solve_lane(session: LaneSession, settings: Settings = Settings()):
    """Warm-started re-solve on the cached factor; returns ``(advanced
    session, batch-leading SolveResult)`` — the OSQP cross-``Solve()`` carry
    (x/y/ρ/factor advance)."""
    result, (x, y, rho_bar, factor) = _solve_core(
        session.base, session.scaled, session.scaling, settings,
        wx=session.warm_x, wy=session.warm_y, rb=session.rho_bar,
        factor=session.factor, cached_packs=session.cache,
    )
    return (
        session.replace(warm_x=x, warm_y=y, rho_bar=rho_bar, factor=factor),
        result,
    )


def mpc_scan_lane(
    session: LaneSession,
    updates,
    apply_update,
    settings: Settings = Settings(),
    emit: str = "stats",
):
    """Fleet MPC sweep: a host loop over ticks, whole batch per tick.

    ``updates``: one entry per tick (a tensor with a leading tick axis, or
    a sequence).  ``apply_update(base_qps, upd) -> new_base`` must change
    only bounds/q (A/P untouched, classification stable) so the cached
    factor stays valid.  Returns ``(session, (status, iterations))`` with
    ``(T, B)`` device tensors, and with ``emit="full"`` also ``x (T, B,
    n)``.  The loop itself reads nothing from the device."""
    if emit not in ("stats", "full"):
        raise ValueError(f"emit={emit!r}: 'stats' or 'full'")
    status, iters, xs = [], [], []
    for t in range(len(updates)):
        session = update_bounds_lane_apply(session, apply_update, updates[t])
        session, res = solve_lane(session, settings)
        status.append(res.status)
        iters.append(res.iterations)
        if emit == "full":
            xs.append(res.x)
    out = (torch.stack(status), torch.stack(iters))
    if emit == "full":
        out = out + (torch.stack(xs),)
    return session, out


def update_bounds_lane_apply(session: LaneSession, apply_update, upd):
    """One tick's values-only update through a caller's function of the
    base container (frozen scaling, kept factor)."""
    s = session.scaling
    base = apply_update(session.base, upd)
    return session.replace(base=base, scaled=base.scale_data(s.D, s.E, s.c))
