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
(``Settings.factor_form``), with the reference's Anderson acceleration of
the chunk map between chunks (``Settings.anderson``; glue, no kernel of its
own) and its solution polish after the loop (``Settings.polish``: one more
block-tridiagonal factor and ``1 + polish_refine_iter`` solves).  A
waypoint-layout block-P batch takes the same packed chunk in the gain form,
fed :func:`.admm_fused.pack_factor` of the block-tridiagonal factor kernel
(:mod:`.tridiag_kernel`), with the block-P Ruiz and the residual kernel
once per chunk.  The unfused path — ``Settings(fused_chunk="off")`` or the
``"type"`` row layout — runs op by op, its KKT factor and solve in the
block-tridiagonal kernels (:mod:`.tridiag_kernel`); it is also the path of
``Settings(kkt_refine=k)``, whose every KKT solve is followed by ``k``
refinement solves.  Either way the host reads the device ONCE per chunk
(one small tensor holding "any problem still running" and "any ρ to
adapt"), counted in :data:`HOST_SYNCS`.  On the CPU the same loops run the
kernels' plain versions.
"""
from __future__ import annotations

import torch

from .admm import (
    ADMMState,
    Settings,
    SolveResult,
    _admm_iteration,
    _adapt_rho_decision,
    _rho_vec,
    _stall_reset,
    _termination_decide,
    _termination_quantities,
    check_supported,
    finalize,
    identity_scaling,
    init_state,
    pin_matmul_precision,
    polish,
    resolve_device,
)
from .ruiz import Scaling

# Device→host reads since import: one per chunk of the chunk loop, one per
# guarded bounds update of a session (ops/session_lane.py).
HOST_SYNCS = 0
# Batch refactorizations after a ρ adaptation since import (decided by the
# chunk's one read; no read of their own).  A verification counter:
# chip_smoke.py holds the factor kernel's launches to one per setup plus
# this count.
RHO_REFACTORS = 0
# Polish factorizations since import (one per solve with Settings.polish):
# counted apart from the ρ refactors, which a session's contract limits.
POLISH_FACTORS = 0


# ---------------------------------------------------------------------------
# Ruiz equilibration, batch-last
# ---------------------------------------------------------------------------


def ruiz_equilibrate_lane(qp, iters: int = 10):
    """Dispatch as the reference's ``ruiz_kernel_supported`` does: the
    kernel wrapper for waypoint-layout batches of at least 4 waypoints (CUDA
    kernel on the card, plain version on the CPU), the plain torch version
    for the ``"type"`` layout and for fewer waypoints on any device — the
    reference's own dispatch (its Pallas Ruiz admits only those batches, and
    it runs the jnp version for the others on the TPU too), not a
    fallback."""
    from .ruiz_kernel import (
        ruiz_equilibrate_lane_kernel,
        ruiz_equilibrate_lane_plain,
        ruiz_kernel_supported,
    )

    if ruiz_kernel_supported(qp):
        return ruiz_equilibrate_lane_kernel(qp, iters)
    return ruiz_equilibrate_lane_plain(qp, iters)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


# The generic path's state and cold/warm start serve the lane driver too
# (its fused path carries the packed state in ``x`` and leaves z..dy None).
LaneADMMState = ADMMState
init_state_lane = init_state


# ---------------------------------------------------------------------------
# Iteration / termination / adaptation
# ---------------------------------------------------------------------------


def _iteration(scaled, st: LaneADMMState, factor, settings: Settings,
               kkt_solve=None):
    """One scaled ADMM iteration on the flat state (unfused path): the
    generic step with the lane factor.  The KKT solve is
    ``scaled.kkt_solve`` (the block-tridiagonal kernel on a CUDA batch)
    unless a ``kkt_solve(factor, rhs)`` is given."""
    return _admm_iteration(scaled, st, settings, factor=factor,
                           solve=kkt_solve)


def _anderson_init(scaled, st: LaneADMMState, settings: Settings,
                   use_fused: bool) -> LaneADMMState:
    """The Anderson carry (the reference's ``admm_lane.py:901-915``): an
    empty ring of ``settings.anderson`` slots on v = (x, w = z + y/ρ), the
    current v as the next chunk's input, no slot filled, and an infinite
    last residual norm."""
    from .admm_fused import unpack_state

    if use_fused:
        x0, z0, y0 = unpack_state(scaled, st.x)
    else:
        x0, z0, y0 = st.x, st.z, st.y
    v0 = torch.cat([x0, z0 + y0 / st.rho_vec], dim=0)
    B = v0.shape[-1]
    ring = (settings.anderson,) + tuple(v0.shape)
    return st.replace(
        aa_g=v0.new_zeros(ring),
        aa_f=v0.new_zeros(ring),
        aa_vin=v0,
        aa_n=torch.zeros((B,), dtype=torch.int32, device=v0.device),
        aa_fnorm=torch.full((B,), float("inf"), dtype=v0.dtype,
                            device=v0.device),
    )


def _anderson_step(scaled, st: LaneADMMState, settings: Settings,
                   use_fused: bool, reset_mask) -> LaneADMMState:
    """Safeguarded Anderson extrapolation of the chunk fixed-point map (the
    reference's ``_anderson_step``, step for step).

    One chunk is a map T on v = (x, w = z + y/ρ).  The last
    ``settings.anderson`` outputs g_i = T(v_i) and residuals f_i = g_i − v_i
    give α ∝ M⁻¹1 with M = FᵀF + λ·(tr M / mh)·I, normalised to Σα = 1, and
    v⁺ = Σ αᵢ g_i; z and y are recovered from w (z = Π_[l,u](w), y = ρ(w −
    z)).  A problem's history resets where its residual grew past
    ``anderson_safeguard`` times the last one, where ``reset_mask`` (its ρ
    just adapted), and at its first step; a reset fills every slot with the
    current pair.  Done problems and problems whose extrapolation is not
    finite (or whose Σα vanishes) keep the plain iterate; done problems keep
    their state and carry.  Device work only: the per-problem mh×mh systems
    are solved without a check that would read the device."""
    from .admm_fused import pack_state, unpack_state

    mh = settings.anderson
    n = scaled.q.shape[0]
    if use_fused:
        x0, z0, y0 = unpack_state(scaled, st.x)
    else:
        x0, z0, y0 = st.x, st.z, st.y
    v_out = torch.cat([x0, z0 + y0 / st.rho_vec], dim=0)  # (d, B)
    f = v_out - st.aa_vin
    fnorm = f.abs().amax(dim=0)  # (B,)

    grew = fnorm > settings.anderson_safeguard * st.aa_fnorm
    reset = grew | reset_mask | (st.aa_n == 0)
    kept = torch.where(reset, torch.zeros_like(st.aa_n), st.aa_n)
    slot = kept % mh
    ar = torch.arange(mh, device=slot.device)
    sm = ((ar[:, None] == slot[None, :]) | reset[None, :])[:, None, :]
    aa_g = torch.where(sm, v_out[None], st.aa_g)
    aa_f = torch.where(sm, f[None], st.aa_f)

    M = torch.einsum("idb,jdb->bij", aa_f, aa_f)
    tr = torch.diagonal(M, dim1=1, dim2=2).sum(dim=1)
    lam = settings.anderson_reg * tr / mh + 1e-30
    M = M + lam[:, None, None] * torch.eye(mh, dtype=M.dtype,
                                           device=M.device)
    a = torch.linalg.solve_ex(
        M, torch.ones((M.shape[0], mh, 1), dtype=M.dtype, device=M.device),
        check_errors=False,
    ).result[..., 0]
    s = a.sum(dim=1, keepdim=True)
    tiny = s.abs() < 1e-12
    alpha = a / torch.where(tiny, torch.ones_like(s), s)
    v_acc = torch.einsum("bi,idb->db", alpha, aa_g)
    bad = ~torch.isfinite(v_acc.abs().amax(dim=0)) | tiny[:, 0]
    v_new = torch.where((st.done | bad)[None, :], v_out, v_acc)

    xn = v_new[:n]
    w = v_new[n:]
    zn = torch.minimum(torch.maximum(w, scaled.l), scaled.u)
    yn = st.rho_vec * (w - zn)
    frozen = st.done[None, :]
    xn = torch.where(frozen, x0, xn)
    zn = torch.where(frozen, z0, zn)
    yn = torch.where(frozen, y0, yn)
    if use_fused:
        st = st.replace(x=pack_state(scaled, xn, zn, yn))
    else:
        st = st.replace(x=xn, z=zn, y=yn)
    return st.replace(
        aa_g=aa_g,
        aa_f=aa_f,
        aa_vin=torch.cat([xn, zn + yn / st.rho_vec], dim=0),
        aa_n=torch.where(st.done, st.aa_n, kept + 1),
        aa_fnorm=torch.where(st.done, st.aa_fnorm, fnorm),
    )


def _polish(base, scaled, scaling: Scaling, st: LaneADMMState,
            settings: Settings) -> LaneADMMState:
    """The reference's lane polish (``admm_lane.py:1018-1061``), which is
    the generic one on the lane container: the active set from the unscaled
    z, y, l and u, one ``scaled.kkt_factor`` (the block-tridiagonal factor
    kernel on a CUDA batch, counted in :data:`POLISH_FACTORS`), ``1 +
    polish_refine_iter`` solves, and the polished iterate taken per problem
    where it improves both residuals of a kOptimal problem."""
    global POLISH_FACTORS
    POLISH_FACTORS += 1
    return polish(base, scaled, scaling, st, settings)


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
    check_kernel_limits(qps, dev, settings)
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
    return identity_scaling(n, base.m, base.q.dtype, (B,), base.q.device)


def _use_fused(scaled, settings: Settings) -> bool:
    """Whether the solve runs through the packed-state chunk or the unfused
    path: the reference's ``fused_chunk_supported`` without its TPU tile
    gates.  A waypoint-layout batch, vel-diag or block P, goes fused unless
    ``fused_chunk="off"``, ``kkt_method="cg"`` or ``kkt_refine > 0``; the
    ``"type"`` layout never does.  Kernels on CUDA, plain versions on the
    CPU, either way."""
    return (
        settings.fused_chunk != "off"
        and scaled.row_layout == "waypoint"
        and settings.kkt_method == "direct"
        and settings.kkt_refine == 0
    )


def least_shared_bytes(qp, settings: Settings) -> dict:
    """The fewest bytes of shared memory a block asks for, by kernel, of the
    lane kernels that the solve of ``qp`` under ``settings`` runs, each with
    every ring and window it can place in the device-memory workspace
    placed there (the wide forms, above 16 joints; 0 below, where the
    narrow forms' one placement fits the card): Ruiz at one warp of
    per-thread slots (``csrc/ruiz.cu``), the chunk's and the residual
    kernel's group slots (``SLOT`` of ``csrc/admm_chunk.cu`` and
    ``csrc/residuals.cu``) on the fused path, the tridiagonal solve's
    (:func:`.tridiag_kernel.least_shared_bytes`) on the unfused path and for
    polish.  The KKT and tridiagonal factors' wide forms keep 64 values on
    chip (``W_HEAD``) with their working matrices in the workspace, which
    binds nowhere.  Mirrors the sources' constants; their plans decide at
    launch."""
    from .. import _build
    from .ruiz_kernel import ruiz_kernel_supported
    from .tridiag_kernel import least_shared_bytes as tridiag_bytes

    B2 = 2 * qp.n_dim
    if B2 <= 32:
        return {}
    G = _build.group_size(B2, 4)
    GC = G * (-(-B2 // G))
    Rp = qp.rows_per_waypoint_padded
    need = {}
    if settings.scaling > 0 and ruiz_kernel_supported(qp):
        need["ruiz"] = 4 * (32 * B2 + 2)  # a warp's slots of 2N values
    if _use_fused(qp, settings):
        need["admm_chunk"] = 4 * (9 * GC + 6 * Rp + 24)
        need["residuals"] = 4 * (4 * GC + 6 * Rp + 24 + G)
    if not _use_fused(qp, settings) or settings.polish:
        need["tridiag_solve"] = tridiag_bytes(B2)
    return need


def check_kernel_limits(qp, device, settings: Settings) -> None:
    """On a CUDA ``device``, raise ``NotImplementedError`` naming the
    kernel, before anything is built or moved, where a lane kernel that the
    solve of ``qp`` under ``settings`` runs cannot be placed: its smallest
    launch (:func:`least_shared_bytes`) takes more shared memory than a
    block of the card may use.  Every other joint count launches: above 16
    joints the wide forms, above 256 a group of 512 threads, each owning
    several columns (``chip_smoke.py`` holds them on the card at N = 4-32,
    40, 64, 100, 256 and 300).  The plain versions on the CPU have no
    limit."""
    from .. import _build

    if torch.device(device).type != "cuda":
        return
    for name, need in least_shared_bytes(qp, settings).items():
        if need > _build.CARD_SHARED_BYTES:
            raise NotImplementedError(
                f"the lane kernel {name} cannot be placed on the card at "
                f"N={qp.n_dim}: its smallest launch takes {need} bytes of "
                f"shared memory a block, the card "
                f"{_build.CARD_SHARED_BYTES}")


def _packed_factor(scaled, rho_vec, settings: Settings, coef=None):
    """The fused path's packed factor ``(cholp, gainp | None)``: for vel-diag
    P the factor kernel straight from the stencil, without the gain pack
    under ``factor_form="hrec"``; for block P, :func:`.admm_fused.
    pack_factor` of the block-tridiagonal factor, gain form whatever
    ``factor_form`` says — the hrec chunk needs vel-diag P (the reference's
    ``admm_lane.py:759-767``, ``:815-827``)."""
    from .admm_fused import pack_factor
    from .kkt_factor import factor_packed_lane

    if scaled.p_structure == "vel_diag":
        return factor_packed_lane(
            scaled, rho_vec, settings.sigma, coef=coef,
            emit_gain=settings.factor_form != "hrec")
    return pack_factor(scaled, scaled.kkt_factor(rho_vec, settings.sigma))


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
    from .residuals import (
        assemble_term_quantities,
        termination_quantities_kernel,
    )

    check_supported(settings)
    use_fused = _use_fused(scaled, settings)
    # Termination reductions inside the chunk kernel (vel-diag P), or the
    # chunk's delta-writing form followed by the streaming residual kernel
    # ("off", and block P).  The factor form (hrec or gain) is the packed
    # factor's: _packed_factor picks it.
    use_term_fused = (settings.term_fused != "off"
                      and scaled.p_structure == "vel_diag")
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
            return _packed_factor(scaled, rho_vec_arr, settings,
                                  coef=coef_pack)
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
    if settings.anderson > 0:
        st = _anderson_init(scaled, st, settings, use_fused)

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
        if settings.anderson > 0:
            # After the refactor, as the reference's chunk body: w = z + y/ρ
            # changes scale where ρ adapted, and the history resets there.
            st = _anderson_step(
                scaled, st, settings, use_fused,
                torch.zeros_like(st.done) if adapt is None else adapt)

    if use_fused:
        x, z, y = unpack_state(scaled, st.x)
        st = st.replace(x=x, z=z, y=y)
    if settings.polish:
        st = _polish(base, scaled, scaling, st, settings)
    carry = (
        scaling.D * st.x,
        scaling.cinv * scaling.E * st.y,
        st.rho_bar,
        st.factor,
    )
    return finalize(base, scaling, st), carry
