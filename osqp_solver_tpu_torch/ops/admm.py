"""OSQP-semantics ADMM core and the generic batched solver.

Counterpart of ``osqp_solver_tpu/ops/admm.py``: ``Settings``,
``SolveResult``, the OSQP constants, ``_rho_vec``, the long-horizon
refinement policy (``refine_steps_for_horizon``, ``with_auto_refine``), the
stall detector (``stall_checks_needed``, ``_stall_init``, ``_stall_update``,
``_stall_reset``), and the generic path over any container of the operator
protocol (:mod:`.qp`'s ``DenseQP``, the trajectory container's
``TrajectoryQP``): ``ADMMState``, ``kkt_factor``/``kkt_solve`` (direct,
``kkt_refine``, or the CG backend of :mod:`.cg`), ``_admm_iteration``,
``_termination``, ``_adapt_rho_decision``, ``init_state``, ``run_admm``,
``polish``, ``finalize``, ``solve_batched`` and ``solve``.  The termination
and adaptation pieces are shared with the lane driver (:mod:`.admm_lane`).

Every array is batch-trailing (``x (n, B)``, per-problem scalars ``(B,)``);
:class:`SolveResult` is batch-leading, as the reference's vmapped result.
The reference's ``lax.while_loop`` over chunks is a host loop: each chunk
ends in ONE device read (``any problem still running``, ``any ρ to adapt``,
counted in :data:`HOST_SYNCS`), and the batch refactors only when some
problem's ρ moved (:data:`RHO_REFACTORS`), as the reference's scalar
``lax.cond`` does.  Every ``Settings`` field keeps the reference's name and
default; values this port does not implement yet are refused by
:func:`check_supported`, never ignored.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .ruiz import Scaling, identity_scaling, ruiz_equilibrate
from .status import ExitCode

# OSQP internal constants.
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_FACTOR = 1e3  # rho multiplier for equality rows
RHO_TOL = 1e-4  # |u - l| below this (scaled) => equality row
INF_THRESHOLD = 1e25
DIV_TOL = 1e-10


@dataclasses.dataclass(frozen=True)
class Settings:
    """OSQP-default settings (same fields and defaults as the reference).

    ``adaptive_rho_interval``: ρ is re-evaluated every this-many iterations
    (OSQP's wall-clock heuristic has no meaning in a batched solver).
    """

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    max_iter: int = 4000
    check_termination: int = 25
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    adaptive_rho_tolerance: float = 5.0
    scaling: int = 10  # Ruiz iterations; 0 disables
    # KKT backend: "direct" = cached Cholesky; "cg" = matrix-free Jacobi
    # PCG on the reduced system (generic path only).
    kkt_method: str = "direct"
    cg_tol: float = 1e-7
    cg_max_iter: int = 100
    # Iterative-refinement steps after each direct KKT solve.
    kkt_refine: int = 0
    # Solution polishing.
    polish: bool = False
    polish_delta: float = 1e-6
    polish_refine_iter: int = 3
    # Unroll factor of the reference's inner loop; no effect on a host loop.
    inner_unroll: int = 1
    # Fused ADMM chunk: "auto"/"on" = the CUDA kernels on a CUDA device and
    # their plain PyTorch versions on the CPU; "off" = the unfused op-by-op
    # path (the block-tridiagonal factor/solve kernels on a CUDA device).
    fused_chunk: str = "auto"
    # Termination reductions fused into the chunk's final backward pass
    # ("auto"/"on"), or "off": the chunk writes the last iteration's packed
    # deltas and the separate streaming residual kernel reduces them.
    term_fused: str = "auto"
    # Factor stream form of the chunk kernel: "hrec" = gain-free, the sparse
    # KKT coupling block is rebuilt in registers from the stencil
    # coefficients; "gain" = the factor kernel also writes the packed gain
    # G_t and the chunk kernel streams it.
    factor_form: str = "hrec"
    # Anderson acceleration of the chunk fixed-point map (lane driver only,
    # as in the reference).
    anderson: int = 0
    anderson_reg: float = 1e-8
    anderson_safeguard: float = 1.5
    # Reduced-precision factor streams (not ported; only "none").
    factor_round: str = "none"
    factor_warmup_stream: str = "none"
    # Run the first this-many iterations as ONE unchecked chunk before the
    # ``check_termination`` cadence starts.  Cold solves of a known class
    # never converge before a known floor; keep 0 for warm-started solves.
    termination_warmup: int = 0
    # In-solver stall detection (beyond OSQP; 0 = exact OSQP give-up
    # semantics).  The metric max(prim_res/eps_prim, dual_res/eps_dual) is
    # tracked across termination checks: an improvement by ``stall_rtol``
    # (relative) re-arms the window; after ``stall_checks`` consecutive
    # checks without one the problem exits through the max_iter ladder.
    stall_checks: int = 12
    stall_rtol: float = 0.05
    # Patience floor in iterations: effective checks =
    # max(stall_checks, ceil(stall_min_iters / check_termination)).
    stall_min_iters: int = 36


_STREAM_VALUES = ("none", "f16", "bf16")


def check_supported(settings: Settings, generic: bool = False) -> None:
    """Refuse every ``Settings`` value that this port does not implement.

    ``generic``: the caller is the generic path (:func:`solve_batched`,
    :mod:`.session`), which has the CG backend and no Anderson acceleration;
    the lane driver has Anderson acceleration and no CG backend, as in the
    reference."""
    for name in ("factor_round", "factor_warmup_stream"):
        val = getattr(settings, name)
        if val not in _STREAM_VALUES:
            raise ValueError(
                f"Settings.{name}={val!r}: allowed values are {_STREAM_VALUES}"
            )
    if settings.kkt_method not in ("direct", "cg"):
        raise ValueError(f"Settings.kkt_method={settings.kkt_method!r}")
    if not generic and settings.kkt_method != "direct":
        raise NotImplementedError(
            "the lane driver supports the direct KKT backend only, as the "
            "reference's; use ops.admm.solve_batched for kkt_method='cg'")
    if generic and settings.anderson > 0:
        raise NotImplementedError(
            f"anderson={settings.anderson}: Anderson acceleration is a "
            "setting of the lane driver only, as in the reference")
    waiting = []
    if settings.factor_round != "none":
        waiting.append(f"factor_round={settings.factor_round!r}")
    if settings.factor_warmup_stream != "none":
        waiting.append(
            f"factor_warmup_stream={settings.factor_warmup_stream!r}"
        )
    if waiting:
        raise NotImplementedError(
            "reduced-precision factor streams are TPU settings that the "
            "PyTorch/CUDA package does not implement: " + ", ".join(waiting)
        )
    for name in ("fused_chunk", "term_fused"):
        if getattr(settings, name) not in ("auto", "on", "off"):
            raise ValueError(f"Settings.{name}={getattr(settings, name)!r}")
    if settings.factor_form not in ("hrec", "gain"):
        raise ValueError(f"Settings.factor_form={settings.factor_form!r}")


def refine_steps_for_horizon(waypoints: int, dtype) -> int:
    """Iterative-refinement steps the long-horizon policy asks for: none in
    float64, none up to 1024 waypoints in float32 (the verified range), one
    beyond as a safety margin."""
    if dtype == torch.float64:
        return 0
    if waypoints > 1024:
        return 1
    return 0


def with_auto_refine(settings: Settings, waypoints: int, dtype) -> Settings:
    """Bump ``kkt_refine`` per the long-horizon policy (never lowers an
    explicit user setting).  Either driver honours the bumped setting: the
    lane driver then takes its unfused path, whose every KKT solve is
    followed by the refinement steps."""
    auto = refine_steps_for_horizon(waypoints, dtype)
    if auto > settings.kkt_refine:
        return dataclasses.replace(settings, kkt_refine=auto)
    return settings


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Structured per-problem solve output, batch-leading."""

    x: torch.Tensor  # (B, n) primal solution (unscaled)
    y: torch.Tensor  # (B, m) dual solution (unscaled)
    z: torch.Tensor  # (B, m) Ax at the solution (unscaled)
    status: torch.Tensor  # (B,) int32 ExitCode
    iterations: torch.Tensor  # (B,) int32
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    rho: torch.Tensor
    obj_val: torch.Tensor


def _rho_vec(rho_bar, l, u):
    """Per-constraint ρ (OSQP semantics): equality rows get 1e3·ρ, loose rows
    get RHO_MIN.  ``rho_bar (B,)``, ``l/u (m, B)``."""
    loose = (l <= -INF_THRESHOLD) & (u >= INF_THRESHOLD)
    eq = (u - l) < RHO_TOL
    rho = torch.where(eq, RHO_EQ_FACTOR * rho_bar, rho_bar.expand_as(l))
    rho = torch.where(loose, torch.full_like(rho, RHO_MIN), rho)
    return torch.clamp(rho, RHO_MIN, RHO_MAX)


def stall_checks_needed(settings) -> int:
    """Effective consecutive-no-progress-check threshold: ``stall_checks``
    floored so the window spans at least ``stall_min_iters`` iterations at
    the configured termination cadence."""
    ct = max(1, int(settings.check_termination))
    return max(
        int(settings.stall_checks), -(-int(settings.stall_min_iters) // ct)
    )


def _stall_update(st, prim_res, dual_res, eps_prim, eps_dual, settings):
    """Windowed no-progress detector (``Settings.stall_checks``).

    Returns ``(state-with-updated-window, stalled)``; the caller folds
    ``stalled`` into its ``at_max`` branch so a stalled problem exits with
    exactly the status max_iter would produce."""
    if settings.stall_checks <= 0 or st.stall_ref is None:
        return st, torch.zeros_like(st.done)
    tiny = 1e-30
    metric = torch.maximum(
        prim_res / torch.clamp(eps_prim, min=tiny),
        dual_res / torch.clamp(eps_dual, min=tiny),
    )
    improved = metric < (1.0 - settings.stall_rtol) * st.stall_ref
    stall_k = torch.where(
        improved, torch.zeros_like(st.stall_k), st.stall_k + 1
    )
    stall_ref = torch.where(improved, metric, st.stall_ref)
    stalled = (~st.done) & (stall_k >= stall_checks_needed(settings))
    return (
        dataclasses.replace(
            st,
            stall_ref=torch.where(st.done, st.stall_ref, stall_ref),
            stall_k=torch.where(st.done, st.stall_k, stall_k),
        ),
        stalled,
    )


def _stall_reset(st, mask, settings: Settings):
    """Re-arm the stall window where ``mask`` (ρ adapted there)."""
    if settings.stall_checks <= 0 or st.stall_ref is None:
        return st
    return dataclasses.replace(
        st,
        stall_ref=torch.where(
            mask, torch.full_like(st.stall_ref, float("inf")), st.stall_ref
        ),
        stall_k=torch.where(mask, torch.zeros_like(st.stall_k), st.stall_k),
    )


def _stall_init(settings: Settings, dtype, shape=(), device=None):
    """Initial (stall_ref, stall_k) carry — ``(None, None)`` when off."""
    if settings.stall_checks <= 0:
        return None, None
    return (
        torch.full(shape, float("inf"), dtype=dtype, device=device),
        torch.zeros(shape, dtype=torch.int32, device=device),
    )


def resolve_device(device: Optional[object]) -> torch.device:
    """Entry-point device rule: the default is CUDA, and the CPU is taken
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this entry point runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def pin_matmul_precision() -> None:
    """Exact f32 products everywhere (the reference pins
    ``Precision.HIGHEST`` on every einsum of the trajectory QP)."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Generic path: state, KKT backend, iteration, termination, adaptation
# ---------------------------------------------------------------------------

# Device→host reads of the generic path since import: one per chunk of
# :func:`run_admm`, one per guarded bounds update of a session
# (ops/session.py).
HOST_SYNCS = 0
# Batch refactorizations after a ρ adaptation since import (decided by the
# chunk's one read; no read of their own).  A verification counter: the
# factor kernel's launches are one per setup (and per polish) plus this.
RHO_REFACTORS = 0


@dataclasses.dataclass(frozen=True)
class ADMMState:
    """Batch-trailing solver state (also the lane driver's, whose fused
    path carries its packed state in ``x`` and leaves ``z``..``dy`` None)."""

    x: torch.Tensor  # (n, B) scaled primal iterate
    z: Optional[torch.Tensor]  # (m, B) scaled constraint iterate
    y: Optional[torch.Tensor]  # (m, B) scaled dual iterate
    dx: Optional[torch.Tensor]  # last-iteration deltas (certificates)
    dy: Optional[torch.Tensor]
    rho_bar: torch.Tensor  # (B,)
    rho_vec: torch.Tensor  # (m, B) per-row ρ
    factor: object  # cached KKT factor
    iterations: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32 ExitCode
    done: torch.Tensor  # (B,) bool — frozen problems stop updating
    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
    # Stall-detection carry (Settings.stall_checks > 0; None otherwise).
    stall_ref: Optional[torch.Tensor] = None
    stall_k: Optional[torch.Tensor] = None
    # Anderson-acceleration carry of the lane driver (Settings.anderson > 0;
    # None otherwise): the ring of chunk-map outputs and residuals on
    # v = (x, z + y/ρ) (anderson, n + m, B), the current chunk's input v,
    # the slots filled (B,) and the last residual's norm (B,).
    aa_g: Optional[torch.Tensor] = None
    aa_f: Optional[torch.Tensor] = None
    aa_vin: Optional[torch.Tensor] = None
    aa_n: Optional[torch.Tensor] = None
    aa_fnorm: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "ADMMState":
        return dataclasses.replace(self, **changes)


def _max0(v, empty: float):
    """Per-problem max over the row axis, ``(m, B)`` → ``(B,)``; ``empty``
    when there are no rows."""
    if v.shape[0] == 0:
        return torch.full(v.shape[1:], empty, dtype=v.dtype, device=v.device)
    return v.amax(dim=0)


def _norm0(v):
    """Per-problem inf-norm over the row axis: (m, B) → (B,)."""
    return _max0(v.abs(), 0.0)


def kkt_factor(qp, rho_vec, sigma, settings: Settings):
    """Backend-dispatching KKT "factorization": the container's Cholesky,
    or the (ρ, σ) snapshot of the matrix-free CG backend."""
    if settings.kkt_method == "cg":
        return (rho_vec, sigma)
    return qp.kkt_factor(rho_vec, sigma)


def kkt_solve(qp, factor, rhs, settings: Settings, rho_vec=None):
    """Reduced-KKT solve through the backend, plus ``kkt_refine``
    iterative-refinement steps on the direct path when ``rho_vec`` is
    given."""
    if settings.kkt_method == "cg":
        from .cg import cg_solve

        rho_vec_f, sigma = factor
        return cg_solve(
            qp, rho_vec_f, sigma, rhs,
            tol=settings.cg_tol, max_iter=settings.cg_max_iter,
        ).x
    x = qp.kkt_solve(factor, rhs)
    if settings.kkt_refine and rho_vec is not None:
        for _ in range(settings.kkt_refine):
            resid = rhs - (
                qp.P_matvec(x)
                + settings.sigma * x
                + qp.AT_matvec(rho_vec * qp.A_matvec(x))
            )
            x = x + qp.kkt_solve(factor, resid)
    return x


def _admm_iteration(scaled, st: ADMMState, settings: Settings, factor=None,
                    solve=None) -> ADMMState:
    """One scaled ADMM iteration (OSQP alg. 1): x̃ = K⁻¹(σx − q + Aᵀ(ρz −
    y)); z̃ = Ax̃; over-relax; project; dual update.  Done problems keep
    their iterates.  ``factor`` defaults to ``st.factor``; ``solve(factor,
    rhs)`` replaces the backend's KKT solve."""
    sigma, alpha = settings.sigma, settings.alpha
    factor = st.factor if factor is None else factor
    rhs = sigma * st.x - scaled.q + scaled.AT_matvec(st.rho_vec * st.z - st.y)
    if solve is None:
        xt = kkt_solve(scaled, factor, rhs, settings, rho_vec=st.rho_vec)
    else:
        xt = solve(factor, rhs)
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
    (:func:`_termination_quantities`) or from the lane chunk kernel's
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
    base, scaled, scaling: Scaling, st: ADMMState
) -> TermQuantities:
    """Unscaled residuals and certificate reductions from the operators of
    the scaled and the BASE (unscaled) problem."""
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
        loose_dy_pos_max=_max0(torch.where(loose_u, dy_pos, zero), 0.0),
        loose_dy_neg_max=_max0(torch.where(loose_l, -dy_neg, zero), 0.0),
        P_dx_max=_norm0(base.P_matvec(dx_u)),
        A_dx_max=_max0(torch.where(loose_u, -inf, A_dx), -float("inf")),
        A_dx_min=-_max0(torch.where(loose_l, -inf, -A_dx), -float("inf")),
        q_dot_dx=(base.q * dx_u).sum(dim=0),
        blew_up=~torch.isfinite(st.x.sum(dim=0) + st.y.sum(dim=0)),
    )


def _termination_decide(st: ADMMState, tq: TermQuantities,
                        settings: Settings):
    """Status decision from the reductions (shared by the generic and the
    lane paths): OSQP's criterion, both infeasibility certificates at the
    strict and (at max_iter or stall) the 10×-relaxed tolerances, and the
    kNonConvex blow-up test.

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

    # A diverged/NaN iterate (a non-convex P gives a NaN factor) marks the
    # problem kNonConvex instead of raising: its batch siblings keep going.
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


def _termination(base, scaled, scaling: Scaling, st: ADMMState,
                 settings: Settings):
    """Unscaled residuals, OSQP termination + infeasibility certificates:
    the state with ``done``/``status``/residuals set, and the norms that ρ
    adaptation reads."""
    return _termination_decide(
        st, _termination_quantities(base, scaled, scaling, st), settings
    )


def _adapt_rho_decision(st: ADMMState, norms, settings: Settings):
    """OSQP adaptive-ρ decision: candidate ρ from the sqrt residual ratio,
    and whether it moved by more than ``adaptive_rho_tolerance``."""
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


def _adapt_rho(scaled, st: ADMMState, adapt, new_rho,
               settings: Settings) -> ADMMState:
    """Refactor the whole batch after a ρ adaptation: the problems in
    ``adapt`` take ``new_rho``, every other one is refactored from its own
    unchanged ρ (numerically the factor it had), and the stall window
    re-arms where ρ moved."""
    global RHO_REFACTORS
    RHO_REFACTORS += 1
    rho_bar = torch.where(adapt, new_rho, st.rho_bar)
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    st = st.replace(
        rho_bar=rho_bar, rho_vec=rho_vec,
        factor=kkt_factor(scaled, rho_vec, settings.sigma, settings),
    )
    return _stall_reset(st, adapt, settings)


# ---------------------------------------------------------------------------
# Generic path: drivers
# ---------------------------------------------------------------------------


def init_state(
    scaled,
    settings: Settings,
    warm_x=None,
    warm_y=None,
    scaling: Optional[Scaling] = None,
    rho_bar=None,
    factor=None,
    rho_vec=None,
) -> ADMMState:
    """Cold (x=z=y=0) or warm-started scaled state + the KKT factor.

    ``warm_x``/``warm_y`` are *unscaled* ``(n|m, B)``; on a warm ``x``,
    ``z = A x`` so that dynamics-consistent trajectories start feasible.
    ``rho_bar (B,)`` and ``factor`` (consistent with it) may come from a
    session's cache; ``rho_vec`` saves recomputing it."""
    dtype, dev = scaled.q.dtype, scaled.q.device
    n, B = scaled.q.shape
    m = scaled.l.shape[0]
    if scaling is None:
        scaling = identity_scaling(n, m, dtype, (B,), dev)
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
        factor = kkt_factor(scaled, rho_vec, settings.sigma, settings)
    stall_ref, stall_k = _stall_init(settings, dtype, (B,), dev)
    return ADMMState(
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


def run_admm(base, scaled, scaling: Scaling, st: ADMMState,
             settings: Settings) -> ADMMState:
    """The chunked ADMM loop to termination (every problem done or at
    ``max_iter``): ``check_termination`` iterations, the termination
    decision and the adaptation decision per chunk, then ONE device read;
    the batch refactors only when some problem's ρ moved."""
    global HOST_SYNCS
    ct = settings.check_termination
    interval = max(settings.adaptive_rho_interval, ct)
    # All problems start live with equal iteration counts: no device read
    # is needed to enter the loop.
    running = settings.max_iter > 0
    while running:
        for _ in range(ct):
            st = _admm_iteration(scaled, st, settings)
        st, norms = _termination(base, scaled, scaling, st, settings)
        live = (~st.done) & (st.iterations < settings.max_iter)
        adapt = None
        any_adapt = torch.zeros((), dtype=torch.bool, device=live.device)
        if settings.adaptive_rho:
            new_rho, adapt = _adapt_rho_decision(st, norms, settings)
            adapt = adapt & ((st.iterations % interval) < ct)
            any_adapt = adapt.any()
        running, refactor = torch.stack([live.any(), any_adapt]).tolist()
        HOST_SYNCS += 1  # the chunk's one read
        if refactor:
            st = _adapt_rho(scaled, st, adapt, new_rho, settings)
    return st


def polish(base, scaled, scaling: Scaling, st: ADMMState,
           settings: Settings) -> ADMMState:
    """OSQP-style solution polishing (penalty form): pin the dual-active
    constraints (ȳ<0 → lower bound, ȳ>0 → upper) by solving ``(P + σI +
    Aᵀdiag(ρ_pol)A) x = −q + Aᵀ(ρ_pol·z_act)`` with huge ρ on active rows
    and tiny elsewhere, plus iterative refinement; the polished iterate is
    adopted only where it improves both residuals of a kOptimal problem.
    One more factorization of the whole batch."""
    delta = settings.polish_delta
    # The active-set guess is made on UNSCALED data (OSQP polish.c).
    z_u = scaling.Einv * st.z
    y_u = scaling.cinv * scaling.E * st.y
    l_u = scaling.Einv * scaled.l
    u_u = scaling.Einv * scaled.u
    act_low = (z_u - l_u) < -y_u
    act_upp = (u_u - z_u) < y_u
    active = act_low | act_upp
    z_target = torch.where(
        act_low, scaled.l, torch.where(act_upp, scaled.u, st.z)
    )
    rho_pol = torch.where(
        active, torch.full_like(st.z, 1.0 / delta),
        torch.full_like(st.z, delta),
    )

    factor = kkt_factor(scaled, rho_pol, settings.sigma, settings)
    rhs = -scaled.q + scaled.AT_matvec(rho_pol * z_target)
    x = kkt_solve(scaled, factor, rhs, settings)
    for _ in range(settings.polish_refine_iter):
        resid = rhs - (
            scaled.P_matvec(x)
            + settings.sigma * x
            + scaled.AT_matvec(rho_pol * scaled.A_matvec(x))
        )
        x = x + kkt_solve(scaled, factor, resid, settings)
    Ax = scaled.A_matvec(x)
    y = torch.where(active, rho_pol * (Ax - z_target), torch.zeros_like(Ax))
    z = torch.where(active, z_target, Ax)

    # Unscaled residuals of the polished iterate.
    prim = _norm0(scaling.Einv * (Ax - z))
    dual = scaling.cinv * _norm0(
        scaling.Dinv * (scaled.P_matvec(x) + scaled.q + scaled.AT_matvec(y))
    )
    better = (prim <= st.prim_res) & (dual <= st.dual_res) & (
        st.status == int(ExitCode.kOptimal)
    )

    def sel(new, old):
        return torch.where(better, new, old)

    return st.replace(
        x=sel(x, st.x),
        z=sel(z, st.z),
        y=sel(y, st.y),
        prim_res=sel(prim, st.prim_res),
        dual_res=sel(dual, st.dual_res),
    )


def finalize(base, scaling: Scaling, st: ADMMState) -> SolveResult:
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


def as_batch(qp, device):
    """``(container on device with one trailing batch dim, batched)``: a
    container with no batch dims becomes a batch of one (``batched`` False);
    one with more than one batch dim raises."""
    bs = qp.batch_shape
    if len(bs) > 1:
        raise ValueError(f"one trailing batch dim at most, got {bs}")
    qp = qp.map_arrays(lambda a: a.to(device))
    if bs:
        return qp, True
    return qp.map_arrays(lambda a: a.unsqueeze(-1)), False


def unbatch_result(res: SolveResult) -> SolveResult:
    """The only problem of a batch-of-one result."""
    return SolveResult(**{f.name: getattr(res, f.name)[0]
                          for f in dataclasses.fields(res)})


def prepare(qp):
    """The container as the solve loop reads it: with batch-leading copies
    of its dense operands where it has them (``DenseQP.batch_major``)."""
    return qp.batch_major() if hasattr(qp, "batch_major") else qp


def equilibrate(qp, settings: Settings):
    """``(scaled, scaling)``: Ruiz with ``settings.scaling`` iterations, or
    the identity when it is 0."""
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate(qp, settings.scaling)
    else:
        n, B = qp.q.shape
        scaled = qp
        scaling = identity_scaling(n, qp.l.shape[0], qp.q.dtype, (B,),
                                   qp.q.device)
    return prepare(scaled), scaling


def _lane_warm(v, batched, dtype, device):
    """A caller's warm start — batch-leading ``(B, k)``, or ``(k,)`` for an
    unbatched container — as the state's ``(k, B)``."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=dtype, device=device)
    return v.movedim(0, -1) if batched else v.unsqueeze(-1)


def solve_batched(
    qps,
    settings: Settings = Settings(),
    warm_x=None,
    warm_y=None,
    device=None,
) -> SolveResult:
    """Batched solve with per-problem adaptive ρ and no unconditional
    batch-wide refactorization: equilibrate → ADMM → (polish) → unscale.

    ``qps``: a container of the operator protocol (``DenseQP``,
    ``TrajectoryQP``) with one trailing batch dim — or none, a batch of
    one, whose result then has no batch dim either.  ``warm_x``/``warm_y``:
    unscaled, batch-leading ``(B, n)``/``(B, m)`` (``(n,)``/``(m,)`` for an
    unbatched container).  ``device``: ``"cuda"`` unless the caller passes
    ``"cpu"`` (raises when CUDA is absent and the CPU was not asked for);
    the problem is moved there.  On a CUDA device the dense container's
    factor and solve are the kernels of :mod:`.dense_kernel`, the trajectory
    container's those of :mod:`.tridiag_kernel`.  Returns a batch-leading
    :class:`SolveResult` on that device."""
    dev = resolve_device(device)
    check_supported(settings, generic=True)
    pin_matmul_precision()
    base, batched = as_batch(qps, dev)
    base = prepare(base)
    scaled, scaling = equilibrate(base, settings)
    dt = base.q.dtype
    st = init_state(
        scaled, settings,
        _lane_warm(warm_x, batched, dt, dev),
        _lane_warm(warm_y, batched, dt, dev),
        scaling,
    )
    st = run_admm(base, scaled, scaling, st, settings)
    if settings.polish:
        st = polish(base, scaled, scaling, st, settings)
    res = finalize(base, scaling, st)
    return res if batched else unbatch_result(res)


def solve(qp, settings: Settings = Settings(), warm_x=None, warm_y=None,
          device=None) -> SolveResult:
    """Solve ONE QP (a container with no batch dims) end to end:
    :func:`solve_batched` on a batch of one, whose loop is then the
    reference's single-problem ``run_admm`` with per-problem adaptation.
    ``warm_x (n,)``, ``warm_y (m,)``; the result has no batch dim."""
    if qp.batch_shape:
        raise ValueError(
            "solve takes one problem (no batch dims); use solve_batched"
        )
    return solve_batched(qp, settings, warm_x, warm_y, device)
