"""Lane-major (batch-last) batched ADMM solve loop.

Counterpart of ``osqp_solver_tpu/ops/admm_lane.py``
(``solve_batched_lane``, ``_solve_core`` and their helpers).  Same OSQP
semantics — Ruiz equilibration, σ/ρ reduced-KKT, projection, α
over-relaxation, per-row ρ with per-problem adaptation, OSQP termination and
infeasibility certificates — with the batch axis last on every array.

The reference's ``lax.while_loop`` over chunks is a host loop here.  On a
CUDA device every iteration, factorization and the equilibration of a
waypoint-layout vel-diag batch run in the hand-written kernels
(:mod:`.admm_fused`, :mod:`.kkt_factor`, :mod:`.ruiz_kernel`, and with
``Settings(term_fused="off")`` :mod:`.residuals`), in either factor form
(``Settings.factor_form``).  The unfused path — ``Settings(fused_chunk=
"off")`` or the ``"type"`` row layout — runs op by op, its KKT factor and
solve in the block-tridiagonal kernels (:mod:`.tridiag_kernel`).  Either
way the host reads the device ONCE per chunk (one small tensor holding "any
problem still running" and "any ρ to adapt"), counted in
:data:`HOST_SYNCS`.  On the CPU the same loops run the kernels' plain
versions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .admm import (
    DIV_TOL,
    INF_THRESHOLD,
    RHO_MAX,
    RHO_MIN,
    Settings,
    SolveResult,
    _rho_vec,
    _stall_init,
    _stall_reset,
    _stall_update,
    check_supported,
    pin_matmul_precision,
    resolve_device,
)
from .ruiz import Scaling
from .status import ExitCode

# Device→host reads since import: one per chunk of the chunk loop, one per
# guarded bounds update of a session (ops/session_lane.py).
HOST_SYNCS = 0
# Batch refactorizations after a ρ adaptation since import (decided by the
# chunk's one read; no read of their own).  A verification counter:
# chip_smoke.py holds the factor kernel's launches to one per setup plus
# this count.
RHO_REFACTORS = 0


# ---------------------------------------------------------------------------
# Ruiz equilibration, batch-last
# ---------------------------------------------------------------------------


def ruiz_equilibrate_lane(qp, iters: int = 10):
    """Dispatch by row layout: the kernel wrapper for waypoint-layout
    batches (CUDA kernel on the card, plain version on the CPU), the plain
    torch version for the ``"type"`` layout on any device — the reference's
    own dispatch (its Pallas Ruiz admits only the waypoint layout, and it
    runs the jnp version for the others on the TPU too), not a fallback."""
    from .ruiz_kernel import (
        ruiz_equilibrate_lane_kernel,
        ruiz_equilibrate_lane_plain,
    )

    if qp.row_layout == "waypoint":
        return ruiz_equilibrate_lane_kernel(qp, iters)
    return ruiz_equilibrate_lane_plain(qp, iters)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaneADMMState:
    x: torch.Tensor  # (n, B) scaled primal — or the (W, SRp, B) state pack
    z: Optional[torch.Tensor]  # (m, B)
    y: Optional[torch.Tensor]  # (m, B)
    dx: Optional[torch.Tensor]
    dy: Optional[torch.Tensor]
    rho_bar: torch.Tensor  # (B,)
    rho_vec: torch.Tensor  # (m, B)
    factor: object
    iterations: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
    # Stall-detection carry (Settings.stall_checks > 0; None otherwise).
    stall_ref: Optional[torch.Tensor] = None
    stall_k: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "LaneADMMState":
        return dataclasses.replace(self, **changes)


def _norm0(v):
    """Per-problem inf-norm over the row axis: (m, B) → (B,)."""
    return v.abs().amax(dim=0)


def init_state_lane(
    scaled,
    settings: Settings,
    warm_x=None,
    warm_y=None,
    scaling: Optional[Scaling] = None,
    rho_bar=None,
    factor=None,
    rho_vec=None,
) -> LaneADMMState:
    """Cold/warm start; ``warm_x``/``warm_y`` are unscaled ``(n|m, B)``."""
    dtype, dev = scaled.q.dtype, scaled.q.device
    n, B = scaled.q.shape
    m = scaled.m
    if warm_x is None:
        x = torch.zeros((n, B), dtype=dtype, device=dev)
        z = torch.zeros((m, B), dtype=dtype, device=dev)
    else:
        x = scaling.Dinv * torch.as_tensor(warm_x, dtype=dtype, device=dev)
        z = scaled.A_matvec(x)
    if warm_y is None:
        y = torch.zeros((m, B), dtype=dtype, device=dev)
    else:
        y = scaling.c * scaling.Einv * torch.as_tensor(
            warm_y, dtype=dtype, device=dev
        )

    if rho_bar is None:
        rho_bar = torch.full((B,), settings.rho, dtype=dtype, device=dev)
    if rho_vec is None:
        rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    if factor is None:
        factor = scaled.kkt_factor(rho_vec, settings.sigma)
    stall_ref, stall_k = _stall_init(settings, dtype, (B,), dev)
    return LaneADMMState(
        x=x,
        z=z,
        y=y,
        dx=torch.zeros((n, B), dtype=dtype, device=dev),
        dy=torch.zeros((m, B), dtype=dtype, device=dev),
        rho_bar=rho_bar,
        rho_vec=rho_vec,
        factor=factor,
        iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        status=torch.full(
            (B,), int(ExitCode.kUnknown), dtype=torch.int32, device=dev
        ),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        prim_res=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        dual_res=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        stall_ref=stall_ref,
        stall_k=stall_k,
    )


# ---------------------------------------------------------------------------
# Iteration / termination / adaptation
# ---------------------------------------------------------------------------


def _iteration(scaled, st: LaneADMMState, factor, settings: Settings,
               kkt_solve=None):
    """One scaled ADMM iteration on the flat state (unfused path).  The KKT
    solve is ``scaled.kkt_solve`` (the block-tridiagonal kernel on a CUDA
    batch) unless a ``kkt_solve(factor, rhs)`` is given."""
    sigma, alpha = settings.sigma, settings.alpha
    rhs = sigma * st.x - scaled.q + scaled.AT_matvec(st.rho_vec * st.z - st.y)
    xt = (scaled.kkt_solve if kkt_solve is None else kkt_solve)(factor, rhs)
    zt = scaled.A_matvec(xt)

    x_new = alpha * xt + (1.0 - alpha) * st.x
    z_tmp = alpha * zt + (1.0 - alpha) * st.z
    z_new = torch.minimum(
        torch.maximum(z_tmp + st.y / st.rho_vec, scaled.l), scaled.u
    )
    y_new = st.y + st.rho_vec * (z_tmp - z_new)

    keep = st.done  # (B,) broadcasts against (rows, B)

    def sel(new, old):
        return torch.where(keep, old, new)

    return st.replace(
        x=sel(x_new, st.x),
        z=sel(z_new, st.z),
        y=sel(y_new, st.y),
        dx=sel(x_new - st.x, st.dx),
        dy=sel(y_new - st.y, st.dy),
        iterations=st.iterations + (~keep).to(torch.int32),
    )


class TermQuantities(NamedTuple):
    """Per-problem (B,) reductions feeding the OSQP termination decision,
    produced either by the plain matvec path
    (:func:`_termination_quantities`) or from the chunk kernel's
    accumulators (:func:`.residuals.assemble_term_quantities`)."""

    prim_res: torch.Tensor
    dual_res: torch.Tensor
    prim_norm: torch.Tensor
    dual_norm: torch.Tensor
    norm_dy: torch.Tensor
    norm_dx: torch.Tensor
    At_dy_max: torch.Tensor  # ‖Aᵀdy_u‖∞
    support: torch.Tensor  # Σ u·(dy_u)₊ + l·(dy_u)₋ over tight rows
    loose_dy_pos_max: torch.Tensor  # max (dy_u)₊ over loose-u rows
    loose_dy_neg_max: torch.Tensor  # max −(dy_u)₋ over loose-l rows
    P_dx_max: torch.Tensor  # ‖P dx_u‖∞
    A_dx_max: torch.Tensor  # max A dx_u over tight-u rows (−inf if none)
    A_dx_min: torch.Tensor  # min A dx_u over tight-l rows (+inf if none)
    q_dot_dx: torch.Tensor  # qᵀ dx_u
    blew_up: torch.Tensor  # bool: iterates went non-finite


def _termination_quantities(
    base, scaled, scaling: Scaling, st: LaneADMMState
) -> TermQuantities:
    """Plain path on the flat state and the BASE (unscaled) operators."""
    Einv, Dinv, cinv = scaling.Einv, scaling.Dinv, scaling.cinv

    Ax = scaled.A_matvec(st.x)
    Px = scaled.P_matvec(st.x)
    ATy = scaled.AT_matvec(st.y)

    prim_res = _norm0(Einv * (Ax - st.z))
    dual_res = cinv * _norm0(Dinv * (Px + scaled.q + ATy))
    prim_norm = torch.maximum(_norm0(Einv * Ax), _norm0(Einv * st.z))
    dual_norm = cinv * torch.maximum(
        torch.maximum(_norm0(Dinv * Px), _norm0(Dinv * ATy)),
        _norm0(Dinv * scaled.q),
    )

    dy_u = cinv * scaling.E * st.dy
    dx_u = scaling.D * st.dx
    base_l, base_u = base.l, base.u
    loose_u = base_u >= INF_THRESHOLD
    loose_l = base_l <= -INF_THRESHOLD

    zero = torch.zeros_like(dy_u)
    inf = torch.full_like(dy_u, float("inf"))
    dy_pos = dy_u.clamp(min=0.0)
    dy_neg = dy_u.clamp(max=0.0)
    support = (
        torch.where(loose_u, zero, base_u * dy_pos)
        + torch.where(loose_l, zero, base_l * dy_neg)
    ).sum(dim=0)
    A_dx = base.A_matvec(dx_u)
    return TermQuantities(
        prim_res=prim_res,
        dual_res=dual_res,
        prim_norm=prim_norm,
        dual_norm=dual_norm,
        norm_dy=_norm0(dy_u),
        norm_dx=_norm0(dx_u),
        At_dy_max=_norm0(base.AT_matvec(dy_u)),
        support=support,
        loose_dy_pos_max=torch.where(loose_u, dy_pos, zero).amax(dim=0),
        loose_dy_neg_max=torch.where(loose_l, -dy_neg, zero).amax(dim=0),
        P_dx_max=_norm0(base.P_matvec(dx_u)),
        A_dx_max=torch.where(loose_u, -inf, A_dx).amax(dim=0),
        A_dx_min=torch.where(loose_l, inf, A_dx).amin(dim=0),
        q_dot_dx=(base.q * dx_u).sum(dim=0),
        blew_up=~torch.isfinite(st.x.sum(dim=0) + st.y.sum(dim=0)),
    )


def _termination_decide(
    st: LaneADMMState, tq: TermQuantities, settings: Settings
):
    """Status decision from the reductions (shared by both paths).

    ``all(v ≤ ε)`` over masked rows is expressed as ``max(v over mask) ≤ ε``
    (empty mask → vacuous true via the 0/∓inf initializers)."""
    prim_res, dual_res = tq.prim_res, tq.dual_res
    eps_prim = settings.eps_abs + settings.eps_rel * tq.prim_norm
    eps_dual = settings.eps_abs + settings.eps_rel * tq.dual_norm
    solved = (prim_res <= eps_prim) & (dual_res <= eps_dual)
    solved_inacc = (prim_res <= 10 * eps_prim) & (dual_res <= 10 * eps_dual)

    def prim_inf_at(eps):
        eps_p = eps * tq.norm_dy
        return (
            (tq.norm_dy > eps)
            & (tq.At_dy_max <= eps_p)
            & (tq.support <= -eps_p)
            & (tq.loose_dy_pos_max <= eps_p)
            & (tq.loose_dy_neg_max <= eps_p)
        )

    def dual_inf_at(eps):
        eps_d = eps * tq.norm_dx
        return (
            (tq.norm_dx > eps)
            & (tq.P_dx_max <= eps_d)
            & (tq.q_dot_dx <= -eps_d)
            & (tq.A_dx_max <= eps_d)
            & (tq.A_dx_min >= -eps_d)
        )

    prim_inf = prim_inf_at(settings.eps_prim_inf)
    dual_inf = dual_inf_at(settings.eps_dual_inf)
    # OSQP at max_iter re-checks with 10×-relaxed tolerances → the
    # k*InfeasibleInaccurate statuses.
    prim_inf_inacc = prim_inf_at(10 * settings.eps_prim_inf)
    dual_inf_inacc = dual_inf_at(10 * settings.eps_dual_inf)

    blew_up = tq.blew_up

    st, stalled = _stall_update(
        st, prim_res, dual_res, eps_prim, eps_dual, settings
    )
    # A stalled problem gives up through the max_iter ladder below.
    at_max = (st.iterations >= settings.max_iter) | stalled

    def code(c):
        return torch.full_like(st.status, int(c))

    w = torch.where
    new_status = w(
        blew_up,
        code(ExitCode.kNonConvex),
        w(
            solved,
            code(ExitCode.kOptimal),
            w(
                prim_inf,
                code(ExitCode.kPrimalInfeasible),
                w(
                    dual_inf,
                    code(ExitCode.kDualInfeasible),
                    w(
                        at_max,
                        w(
                            solved_inacc,
                            code(ExitCode.kOptimalInaccurate),
                            w(
                                prim_inf_inacc,
                                code(ExitCode.kPrimalInfeasibleInaccurate),
                                w(
                                    dual_inf_inacc,
                                    code(ExitCode.kDualInfeasibleInaccurate),
                                    code(ExitCode.kMaxIterations),
                                ),
                            ),
                        ),
                        code(ExitCode.kUnknown),
                    ),
                ),
            ),
        ),
    )
    newly_done = solved | prim_inf | dual_inf | at_max | blew_up

    st = st.replace(
        status=w(st.done, st.status, new_status),
        done=st.done | newly_done,
        prim_res=w(st.done, st.prim_res, prim_res),
        dual_res=w(st.done, st.dual_res, dual_res),
    )
    return st, (prim_res, dual_res, tq.prim_norm, tq.dual_norm)


def _adapt_rho_decision(st: LaneADMMState, norms, settings: Settings):
    prim_res, dual_res, prim_norm, dual_norm = norms
    pr = prim_res / prim_norm.clamp(min=DIV_TOL)
    dr = dual_res / dual_norm.clamp(min=DIV_TOL)
    new_rho = torch.clamp(
        st.rho_bar * torch.sqrt(pr / dr.clamp(min=DIV_TOL)), RHO_MIN, RHO_MAX
    )
    tol = settings.adaptive_rho_tolerance
    adapt = (~st.done) & (
        (new_rho > tol * st.rho_bar) | (new_rho < st.rho_bar / tol)
    )
    return new_rho, adapt


# ---------------------------------------------------------------------------
# Entry point and chunk loop
# ---------------------------------------------------------------------------


def solve_batched_lane(
    qps,
    settings: Settings = Settings(),
    warm_x=None,
    warm_y=None,
    rho0=None,
    device=None,
) -> SolveResult:
    """Batched solve in lane-major layout.

    ``qps``: a :class:`~osqp_solver_tpu_torch.gomp.trajectory_qp_lane.
    LaneTrajectoryQP` (batch-last).  ``warm_x``/``warm_y`` are
    batch-leading ``(B, n)``/``(B, m)``.  ``rho0`` (scalar or ``(B,)``)
    overrides ``settings.rho`` as the initial per-problem ρ̄.  ``device``:
    where the solve runs — ``"cuda"`` unless the caller passes ``"cpu"``
    (raises when CUDA is absent and the CPU was not asked for); the batch is
    moved there if it lives elsewhere.  Returns a batch-leading
    :class:`SolveResult` on that device.
    """
    from ..gomp.trajectory_qp_lane import LaneTrajectoryQP

    dev = resolve_device(device)
    check_supported(settings)
    pin_matmul_precision()
    if not isinstance(qps, LaneTrajectoryQP):
        raise TypeError(
            "solve_batched_lane takes a LaneTrajectoryQP (convert a "
            "batch-leading container with trajectory_qp_lane.to_lane)"
        )
    base = qps.to(dev)
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate_lane(base, settings.scaling)
    else:
        scaled, scaling = base, identity_scaling_lane(base)

    dt = base.q.dtype

    def lane(a):
        if a is None:
            return None
        return torch.as_tensor(a, dtype=dt, device=dev).movedim(0, -1)

    rb = None
    if rho0 is not None:
        rb = torch.as_tensor(rho0, dtype=dt, device=dev).expand(
            base.q.shape[-1]
        ).contiguous()
    result, _ = _solve_core(
        base, scaled, scaling, settings, lane(warm_x), lane(warm_y), rb
    )
    return result


def build_const_packs(scaled, scaling: Scaling):
    """Bounds-independent kernel constants for :func:`_solve_core` (valid
    across any number of bounds-only updates)."""
    from .admm_fused import build_coef_pack
    from .residuals import build_residual_packs

    rowc, varc, Pdp, Plf, norm_Dq = build_residual_packs(scaled, scaling)
    Rp = scaled.rows_per_waypoint_padded
    return {
        "coef": build_coef_pack(scaled),
        "varc": varc,
        "Pdp": Pdp,
        "Plf": Plf,
        "norm_Dq": norm_Dq,
        "EEinv": rowc[:, : 2 * Rp].contiguous(),  # (W, [E; Einv] rows, B)
    }


def identity_scaling_lane(base) -> Scaling:
    n, B = base.q.shape
    kw = dict(dtype=base.q.dtype, device=base.q.device)
    one = torch.ones((B,), **kw)
    ones_n = torch.ones((n, B), **kw)
    ones_m = torch.ones((base.m, B), **kw)
    return Scaling(
        D=ones_n, E=ones_m, c=one, Dinv=ones_n, Einv=ones_m, cinv=one
    )


def _use_fused(scaled, settings: Settings) -> bool:
    """Whether the solve runs through the packed-state chunk (a
    waypoint-layout vel-diag batch, unless ``fused_chunk="off"``) or the
    unfused path (the ``"type"`` layout, ``"off"``, block P on the CPU).
    Kernels on CUDA, plain versions on the CPU, either way.  A
    waypoint-layout block-P batch on CUDA raises: its Ruiz and chunk need
    the block-P kernel forms, which are not ported yet."""
    if (
        scaled.device.type == "cuda"
        and scaled.row_layout == "waypoint"
        and scaled.p_structure != "vel_diag"
    ):
        raise NotImplementedError(
            "on a CUDA device a 'waypoint'-layout lane batch needs vel-diag "
            "P (the block-P forms of the Ruiz, chunk and residual kernels "
            "are not ported yet)"
        )
    return settings.fused_chunk != "off" and (
        scaled.row_layout == "waypoint" and scaled.p_structure == "vel_diag"
    )


def _solve_core(
    base, scaled, scaling: Scaling, settings: Settings,
    wx=None, wy=None, rb=None, factor=None, cached_packs=None,
):
    """Chunked ADMM loop on an already-equilibrated lane problem.

    ``wx``/``wy``: lane-major unscaled warm starts; ``factor``: a cached KKT
    factor consistent with ``rb``; ``cached_packs``: the bounds-independent
    constants from :func:`build_const_packs`.  Returns ``(SolveResult,
    (x_lane, y_lane, rho_bar, factor))``; the second element is the
    lane-major carry a later solve can be started from.
    """
    global HOST_SYNCS, RHO_REFACTORS
    from .admm_fused import (
        build_lu_pack,
        fused_admm_chunk,
        pack_state,
        unpack_state,
    )
    from .kkt_factor import factor_packed_lane
    from .residuals import (
        assemble_term_quantities,
        termination_quantities_kernel,
    )

    check_supported(settings)
    use_fused = _use_fused(scaled, settings)
    # Gain-free factor form (factor_form="hrec"): the packed factor is
    # (cholp, None) and the chunk kernel rebuilds the sparse coupling in
    # registers; the gain form streams the packed G_t the factor writes.
    use_hrec = use_fused and settings.factor_form == "hrec"
    # Termination reductions inside the chunk kernel, or ("off") the chunk's
    # delta-writing form followed by the streaming residual kernel.
    use_term_fused = settings.term_fused != "off"
    ct = settings.check_termination

    if use_fused:
        # Constants per solve, computed once outside the loop.  The state
        # crosses chunks PACKED, the factor packed triangular, and dx/dy
        # never materialise: the kernel consumes them in registers.
        lu_pack = build_lu_pack(scaled)
        packs = cached_packs or build_const_packs(scaled, scaling)
        coef_pack = packs["coef"]
        term_packs = (packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])
        norm_Dq = packs["norm_Dq"]
        if not use_term_fused:
            resid_packs = (
                torch.cat([packs["EEinv"], lu_pack], dim=1),  # [E; Einv; l; u]
                packs["varc"], packs["Pdp"], packs["Plf"], norm_Dq,
                scaling.cinv,
            )

    def fresh_factor(rho_vec_arr):
        """Packed (fused) or full-block (unfused) factor for a given ρ."""
        if use_fused:
            return factor_packed_lane(
                scaled, rho_vec_arr, settings.sigma, coef=coef_pack,
                emit_gain=not use_hrec,
            )
        return scaled.kkt_factor(rho_vec_arr, settings.sigma)

    if rb is None:
        rb = torch.full(
            (base.q.shape[-1],), settings.rho,
            dtype=base.q.dtype, device=base.q.device,
        )
    rho_vec0 = _rho_vec(rb, scaled.l, scaled.u)
    if factor is None:
        factor = fresh_factor(rho_vec0)
    st = init_state_lane(
        scaled, settings, wx, wy, scaling,
        rho_bar=rb, rho_vec=rho_vec0, factor=factor,
    )
    if use_fused:
        st = st.replace(
            x=pack_state(scaled, st.x, st.z, st.y),
            z=None, y=None, dx=None, dy=None,
        )

    def plain_iterations(st, k):
        for _ in range(k):
            st = _iteration(scaled, st, st.factor, settings)
        return st

    warmup = min(settings.termination_warmup, settings.max_iter)
    if warmup > 0:
        # One big unchecked chunk before the cadence starts.
        if use_fused:
            sp, _ = fused_admm_chunk(
                scaled, st.rho_vec, st.done, settings,
                coef=coef_pack, lu=lu_pack, packed_factor=st.factor,
                state_pack=st.x, n_iter=warmup,
            )
            st = st.replace(x=sp, iterations=st.iterations + warmup)
        else:
            st = plain_iterations(st, warmup)

    def chunk(st):
        """One chunk of ``check_termination`` iterations, the termination
        decision and the ρ-adaptation decision — device work only.  Returns
        ``(state, new_rho, adapt, flags)`` with ``flags`` a 2-element device
        tensor ``[any problem still running, any ρ to adapt]``."""
        if use_fused:
            chunk_args = dict(
                coef=coef_pack, lu=lu_pack, packed_factor=st.factor,
                state_pack=st.x,
            )
            if use_term_fused:
                sp, acc = fused_admm_chunk(
                    scaled, st.rho_vec, st.done, settings,
                    term_packs=term_packs, **chunk_args,
                )
                tq = assemble_term_quantities(acc, scaling.cinv, norm_Dq)
            else:
                sp, dp = fused_admm_chunk(
                    scaled, st.rho_vec, st.done, settings, emit_dxdy=True,
                    **chunk_args,
                )
                tq = termination_quantities_kernel(
                    scaled, sp, dp, coef_pack, resid_packs
                )
            st = st.replace(
                x=sp, iterations=st.iterations + ct * (~st.done).to(torch.int32)
            )
        else:
            st = plain_iterations(st, ct)
            tq = _termination_quantities(base, scaled, scaling, st)
        st, norms = _termination_decide(st, tq, settings)
        live = (~st.done) & (st.iterations < settings.max_iter)
        new_rho = adapt = None
        any_adapt = torch.zeros((), dtype=torch.bool, device=live.device)
        if settings.adaptive_rho:
            interval = max(settings.adaptive_rho_interval, ct)
            at_interval = (st.iterations % interval) < ct
            new_rho, adapt = _adapt_rho_decision(st, norms, settings)
            adapt = adapt & at_interval
            any_adapt = adapt.any()
        return st, new_rho, adapt, torch.stack([live.any(), any_adapt])

    # All problems start live with equal iteration counts: no device read
    # is needed to enter the loop.
    running = warmup < settings.max_iter
    while running:
        st, new_rho, adapt, flags = chunk(st)
        running, any_adapt = flags.tolist()  # the chunk's one host sync
        HOST_SYNCS += 1
        if any_adapt:
            RHO_REFACTORS += 1
            rho_bar = torch.where(adapt, new_rho, st.rho_bar)
            rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
            st = st.replace(
                rho_bar=rho_bar, rho_vec=rho_vec, factor=fresh_factor(rho_vec)
            )
            st = _stall_reset(st, adapt, settings)

    if use_fused:
        x, z, y = unpack_state(scaled, st.x)
        st = st.replace(x=x, z=z, y=y)
    carry = (
        scaling.D * st.x,
        scaling.cinv * scaling.E * st.y,
        st.rho_bar,
        st.factor,
    )
    return _finalize(base, scaling, st), carry


def _finalize(base, scaling: Scaling, st: LaneADMMState) -> SolveResult:
    """Unscale and package a batch-leading :class:`SolveResult`."""
    x = scaling.D * st.x
    y = scaling.cinv * scaling.E * st.y
    z = scaling.Einv * st.z
    status = torch.where(
        st.done,
        st.status,
        torch.full_like(st.status, int(ExitCode.kMaxIterations)),
    )
    obj = 0.5 * (x * base.P_matvec(x)).sum(dim=0) + (base.q * x).sum(dim=0)
    return SolveResult(
        x=x.T.contiguous(),
        y=y.T.contiguous(),
        z=z.T.contiguous(),
        status=status,
        iterations=st.iterations,
        prim_res=st.prim_res,
        dual_res=st.dual_res,
        rho=st.rho_bar,
        obj_val=obj,
    )
