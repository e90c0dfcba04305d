"""OSQP-semantics ADMM core: settings, result container, shared helpers.

Counterpart of ``osqp_solver_tpu/ops/admm.py`` for what the lane solve
(:mod:`.admm_lane`) needs: ``Settings``, ``SolveResult``, the OSQP constants,
``_rho_vec``, the long-horizon refinement policy
(``refine_steps_for_horizon``, ``with_auto_refine``) and the stall detector
(``stall_checks_needed``, ``_stall_init``, ``_stall_update``,
``_stall_reset``).  Every ``Settings``
field keeps the reference's name and default; values this port does not
implement yet are refused by :func:`check_supported`, never ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
    # KKT backend: "direct" = cached block Cholesky.  "cg" is not ported.
    kkt_method: str = "direct"
    cg_tol: float = 1e-7
    cg_max_iter: int = 100
    # Iterative-refinement steps after each direct KKT solve (not ported).
    kkt_refine: int = 0
    # Solution polishing (not ported).
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
    # Anderson acceleration of the chunk fixed-point map (not ported).
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


def check_supported(settings: Settings) -> None:
    """Refuse every ``Settings`` value that this port does not implement."""
    for name in ("factor_round", "factor_warmup_stream"):
        val = getattr(settings, name)
        if val not in _STREAM_VALUES:
            raise ValueError(
                f"Settings.{name}={val!r}: allowed values are {_STREAM_VALUES}"
            )
    waiting = []
    if settings.kkt_method != "direct":
        waiting.append(f"kkt_method={settings.kkt_method!r}")
    if settings.anderson > 0:
        waiting.append(f"anderson={settings.anderson}")
    if settings.polish:
        waiting.append("polish=True")
    if settings.kkt_refine > 0:
        waiting.append(f"kkt_refine={settings.kkt_refine}")
    if settings.factor_round != "none":
        waiting.append(f"factor_round={settings.factor_round!r}")
    if settings.factor_warmup_stream != "none":
        waiting.append(
            f"factor_warmup_stream={settings.factor_warmup_stream!r}"
        )
    if waiting:
        raise NotImplementedError(
            "not ported to the PyTorch/CUDA package yet: " + ", ".join(waiting)
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
    explicit user setting).  Refinement itself is not ported: a bumped
    setting is refused by :func:`check_supported` at the solve."""
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
