"""Termination quantities: accumulator rows, per-solve packs, and the
streaming residual kernel.

Counterpart of ``osqp_solver_tpu/ops/residuals_pallas.py``: the accumulator
rows ``_ACC`` / ``_NACC``, ``build_residual_packs``,
``assemble_term_quantities`` and ``termination_quantities_kernel`` — the
separate streaming pass the lane solve loop runs after each chunk when the
termination reductions are not fused into the chunk kernel
(``Settings(term_fused="off")``).

Kernel note (``csrc/residuals.cu`` replaces the Pallas body
``residuals_pallas.py::_make_kernel`` behind
``termination_quantities_kernel``).  The TPU kernel walks the horizon with
a 4-slot VMEM ring per (8, 128) tile of problems.  Here a GROUP of threads
(16 at N=6) works on each problem and a block holds a few adjacent problems
(:func:`plan`; above 16 joints one problem a block, a group of several
warps, and the ring in a device-memory workspace where it does not fit on
chip); the walk is the fused chunk kernel's termination tail
(``csrc/admm_chunk.cu`` ``MODE_TERM``) without the ADMM update, through the
same device functions (``lane_common.cuh``), so the fused and the unfused
termination decide from the same float values, bit for bit.  All six
matvecs (Ax, Px, Aᵀy, A·dx, P·dx, Aᵀ·dy) are waypoint-local stencils: the
walk goes backward, a producer warp stages each waypoint's rows two steps
ahead into a three-stage shared-memory ring, lane i owns variable i and
rows i, i+16, ..., and what a waypoint needs of its neighbour is carried in
registers or the group's slot.  The four sums are added per waypoint in row
order and parked in a ``(W, 4, B)`` scratch, then added in waypoint order;
the maxima are reduced across the group.  Bound on an H100: every pack is
read once and 24 values per problem are written — bytes on paper; each
problem's walk of W steps in practice.  The block-P form (the build with
``-DBLOCK_P=1``) streams the packed lower triangle of each ``P_diag`` block
and the full ``P_lower`` block through the same ring (578 rows a stage:
9.2 KB at 4 problems) and carries rows of ``Pd_u·x_u`` and ``Pl_uᵀ·x_{u+1}``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

# accumulator rows in the (NACC, B) output pack
_ACC = dict(
    prim_res=0, normEAx=1, normEz=2, dual_raw=3, normDPx=4, normDATy=5,
    normEdy=6, norm_dx=7, At_dy=8, support=9, loose_pos=10, loose_neg=11,
    Pdx_max=12, Adx_max=13, Adx_min=14, q_dot=15, xsum=16, ysum=17,
)
_NACC = 24  # padded to a multiple of 8


def _tri_low(B2):
    low = {}
    k = 0
    for i in range(B2):
        for j in range(i + 1):
            low[(i, j)] = k
            k += 1
    return low, -(-len(low) // 8) * 8


def build_residual_packs(scaled, scaling):
    """Per-solve constants of the termination reductions.

    Returns ``(rowc (W, 4Rp, B), varc (W, VCp, B), Pdp, Plf, norm_Dq (B,))``
    with ``rowc = [E; Einv; l; u]``, ``varc = [q; D; Dinv]`` (interleaved per
    waypoint); for vel-diag P, ``Pdp``/``Plf`` are the ``(W, pad8(N), B)``
    velocity diagonals of ``P_diag``/``P_lower`` (last ``Plf`` row zero); for
    block P, ``Pdp (W, Tp, B)`` is the packed lower triangle of each
    ``P_diag`` block and ``Plf (W, 4N², B)`` the full ``P_lower`` blocks
    (the last one zero)."""
    W, N = scaled.waypoints, scaled.n_dim
    Rp = scaled.rows_per_waypoint_padded
    B = scaled.batch
    B2 = 2 * N
    E3 = scaling.E.reshape(W, Rp, B)
    Einv3 = scaling.Einv.reshape(W, Rp, B)
    l3 = scaled.l.reshape(W, Rp, B)
    u3 = scaled.u.reshape(W, Rp, B)
    rowc = torch.cat([E3, Einv3, l3, u3], dim=1)

    q_i = scaled._interleave(scaled.q_vec)
    D_i = scaled._interleave(scaling.D)
    Dinv_i = scaled._interleave(scaling.Dinv)
    parts = [q_i, D_i, Dinv_i]
    VC = 3 * B2
    VCp = -(-VC // 8) * 8
    if VCp > VC:
        parts.append(q_i.new_zeros((W, VCp - VC, B)))
    varc = torch.cat(parts, dim=1)

    if scaled.p_structure == "vel_diag":
        from .kkt_factor import build_p_vel_packs

        Pdp, Plf = build_p_vel_packs(scaled)
    else:
        low, Tp = _tri_low(B2)
        low_flat = torch.tensor(
            [i * B2 + j for (i, j) in sorted(low, key=low.get)],
            device=scaled.device,
        )
        Pdp = scaled.P_diag.reshape(W, B2 * B2, B)[:, low_flat]
        if Tp > len(low_flat):
            Pdp = torch.cat(
                [Pdp, Pdp.new_zeros((W, Tp - len(low_flat), B))], dim=1
            )
        Plf = torch.cat(
            [
                scaled.P_lower.reshape(W - 1, B2 * B2, B),
                scaled.P_lower.new_zeros((1, B2 * B2, B)),
            ],
            dim=0,
        )
    norm_Dq = (scaling.Dinv * scaled.q).abs().amax(dim=0)
    return rowc, varc, Pdp, Plf, norm_Dq


def assemble_term_quantities(acc, cinv, norm_Dq):
    """(NACC, B) raw accumulators → :class:`.admm.TermQuantities`
    (applies the host-side ``cinv`` / ``norm_Dq`` combines)."""
    from .admm import TermQuantities

    def g(k):
        return acc[_ACC[k]]

    return TermQuantities(
        prim_res=g("prim_res"),
        dual_res=cinv * g("dual_raw"),
        prim_norm=torch.maximum(g("normEAx"), g("normEz")),
        dual_norm=cinv * torch.maximum(
            torch.maximum(g("normDPx"), g("normDATy")), norm_Dq
        ),
        norm_dy=cinv * g("normEdy"),
        norm_dx=g("norm_dx"),
        At_dy_max=cinv * g("At_dy"),
        support=cinv * g("support"),
        loose_dy_pos_max=cinv * g("loose_pos"),
        loose_dy_neg_max=cinv * g("loose_neg"),
        P_dx_max=cinv * g("Pdx_max"),
        A_dx_max=g("Adx_max"),
        A_dx_min=g("Adx_min"),
        q_dot_dx=cinv * g("q_dot"),
        blew_up=~torch.isfinite(g("xsum") + g("ysum")),
    )


def accumulator_rows(scaled, ee, varc, x, z, y, dx, dy):
    """The 18 raw ``_ACC`` accumulators ``(NACC, B)`` from torch reductions on
    the flat state and deltas, through the scaled-operator identities
    ``A_base·dx_u = Einv·(A_s·dx)``, ``Aᵀ_base·dy_u = cinv·Dinv·(Aᵀ_s·dy)``,
    ``P_base·dx_u = cinv·Dinv·(P_s·dx)`` (the ``cinv`` factors are applied by
    :func:`assemble_term_quantities`).  ``ee (W, 2Rp, B) = [E; Einv]``,
    ``varc = [q; D; Dinv]``."""
    from .admm import INF_THRESHOLD

    W, N, B = scaled.waypoints, scaled.n_dim, scaled.batch
    Rp = scaled.rows_per_waypoint_padded
    B2 = 2 * N
    E = ee[:, :Rp].reshape(W * Rp, B)
    Einv = ee[:, Rp : 2 * Rp].reshape(W * Rp, B)
    D = scaled._deinterleave(varc[:, B2 : 2 * B2])
    Dinv = scaled._deinterleave(varc[:, 2 * B2 : 3 * B2])

    def amax(v):
        return v.abs().amax(dim=0)

    Ax = scaled.A_matvec(x)
    Px = scaled.P_matvec(x)
    ATy = scaled.AT_matvec(y)
    edy = E * dy
    edy_pos = edy.clamp(min=0.0)
    edy_neg = edy.clamp(max=0.0)
    u_b = Einv * scaled.u
    l_b = Einv * scaled.l
    loose_u = u_b >= INF_THRESHOLD
    loose_l = l_b <= -INF_THRESHOLD
    zero = torch.zeros_like(edy)
    eadx = Einv * scaled.A_matvec(dx)
    inf = torch.full_like(edy, float("inf"))
    rows = {
        "prim_res": amax(Einv * (Ax - z)),
        "normEAx": amax(Einv * Ax),
        "normEz": amax(Einv * z),
        "dual_raw": amax(Dinv * (Px + scaled.q + ATy)),
        "normDPx": amax(Dinv * Px),
        "normDATy": amax(Dinv * ATy),
        "normEdy": amax(edy),
        "norm_dx": amax(D * dx),
        "At_dy": amax(Dinv * scaled.AT_matvec(dy)),
        "support": (
            torch.where(loose_u, zero, u_b * edy_pos)
            + torch.where(loose_l, zero, l_b * edy_neg)
        ).sum(dim=0),
        "loose_pos": torch.where(loose_u, edy_pos, zero).amax(dim=0),
        "loose_neg": torch.where(loose_l, -edy_neg, zero).amax(dim=0),
        "Pdx_max": amax(Dinv * scaled.P_matvec(dx)),
        "Adx_max": torch.where(loose_u, -inf, eadx).amax(dim=0),
        "Adx_min": torch.where(loose_l, inf, eadx).amin(dim=0),
        "q_dot": (scaled.q * dx).sum(dim=0),
        "xsum": x.sum(dim=0),
        "ysum": y.sum(dim=0),
    }
    acc = x.new_zeros((_NACC, B))
    for k, idx in _ACC.items():
        acc[idx] = rows[k]
    return acc


def termination_accumulators_plain(scaled, state_pack, dxdy_pack, rowc, varc):
    """Plain PyTorch version of the kernel's pass: unpack the two packs and
    reduce with the container's matvecs.  Returns ``acc (NACC, B)``."""
    from .admm_fused import unpack_dxdy, unpack_state

    x, z, y = unpack_state(scaled, state_pack)
    dx, dy = unpack_dxdy(scaled, dxdy_pack)
    return accumulator_rows(scaled, rowc, varc, x, z, y, dx, dy)


def termination_quantities_plain(scaled, state_pack, dxdy_pack, coef, packs):
    """Plain PyTorch version of :func:`termination_quantities_kernel` (same
    arguments, same result)."""
    del coef  # the plain version reads the container directly
    rowc, varc, _, _, norm_Dq, cinv = packs[:6]
    acc = termination_accumulators_plain(
        scaled, state_pack, dxdy_pack, rowc, varc
    )
    return assemble_term_quantities(acc, cinv, norm_Dq)


PLAN_KEYS = ("G", "Q", "stages", "shared_bytes", "blocks",
             "threads_per_block", "tile_stride", "copy_bytes",
             "workspace_bytes")


def _configure(lib):
    """Set the C signatures of a loaded ``csrc/residuals.cu`` library
    (once)."""
    if lib.residuals_launch.argtypes is None:
        lib.residuals_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.residuals_launch.restype = ctypes.c_int
        lib.residuals_plan.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int]
        lib.residuals_plan.restype = ctypes.c_int
    return lib


def plan(lib, B, budget=0):
    """The launch plan of ``csrc/residuals.cu`` for a batch of ``B`` on the
    current device, as :func:`_launch_residuals` makes it: threads per
    problem, problems per block, ring stages, shared bytes, blocks, threads
    per block, the tile's row stride, the bytes of a staging copy (for
    16-byte aligned packs) and the bytes of the device-memory workspace
    (above 16 joints, where the ring does not fit in ``budget``, the shared
    bytes a block may use, 0: the device's; else 0)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib.residuals_plan(B, out, int(budget)), "residuals_plan")
    return dict(zip(PLAN_KEYS, out))


def _launch_residuals(lib, coef, Pdp, Plf, state_pack, dxdy_pack, rowc, varc,
                      acc, budget=0):
    """Call the C entry point of ``csrc/residuals.cu`` on packs of one
    device (with a ``(W, 4, B)`` scratch for the per-waypoint sums);
    ``budget``: as :func:`plan`."""
    W, _, B = state_pack.shape
    lib = _configure(lib)
    sums = state_pack.new_empty((W, 4, B))
    p = _build.ptr
    work = None
    if _build.wide(lib, lambda lb: plan(lb, 1)["G"]):
        work = _build.workspace(plan(lib, B, budget)["workspace_bytes"],
                                state_pack.device)
    err = lib.residuals_launch(
        p(coef), p(Pdp), p(Plf), p(state_pack), p(dxdy_pack), p(rowc),
        p(varc), p(sums), p(acc), W, B, _build.stream(state_pack.device),
        p(work), int(budget))
    _build.check(err, "residuals_launch")


def termination_quantities_kernel(scaled, state_pack, dxdy_pack, coef, packs):
    """One streaming pass over the horizon → :class:`.admm.
    TermQuantities`.

    ``scaled``: waypoint-layout :class:`LaneTrajectoryQP` (Ruiz scaled);
    ``state_pack (W, SRp, B)`` / ``dxdy_pack (W, DRp, B)``: the chunk's
    packed outputs (:func:`.admm_fused.fused_admm_chunk` with
    ``emit_dxdy``); ``coef``: the stencil pack; ``packs``:
    :func:`build_residual_packs` output followed by ``scaling.cinv``.

    On a CUDA tensor the kernel runs (float32, in the form of
    ``scaled.p_structure``) or the call raises; on a CPU tensor the plain
    version runs.
    """
    from .admm_fused import (
        _check_pack, _coef_layout, _tri_pad, dxdy_rows, p_signature,
        state_rows,
    )

    rowc, varc, Pdp, Plf, norm_Dq, cinv = packs[:6]
    W, N, B = scaled.waypoints, scaled.n_dim, scaled.batch
    Rp = scaled.rows_per_waypoint_padded
    if scaled.row_layout != "waypoint":
        raise ValueError(
            "termination_quantities_kernel needs the 'waypoint' row layout"
        )
    _check_pack("state_pack", state_pack, (W, state_rows(scaled)[1], B),
                state_pack)
    _check_pack("dxdy_pack", dxdy_pack, (W, dxdy_rows(scaled)[1], B),
                state_pack)
    _check_pack("coef", coef, (W, _coef_layout(scaled)[3], B), state_pack)
    _check_pack("rowc", rowc, (W, 4 * Rp, B), state_pack)
    _check_pack("varc", varc, (W, -(-6 * N // 8) * 8, B), state_pack)

    if state_pack.device.type == "cpu":
        return termination_quantities_plain(
            scaled, state_pack, dxdy_pack, coef, packs
        )
    if state_pack.dtype != torch.float32:
        raise TypeError(
            f"the CUDA residual kernel takes float32, got {state_pack.dtype}"
        )
    sig = p_signature(scaled)
    if sig["BLOCK_P"]:
        B2 = 2 * N
        _check_pack("Pdp", Pdp, (W, _tri_pad(B2), B), state_pack)
        _check_pack("Plf", Plf, (W, B2 * B2, B), state_pack)
    else:
        PNp = -(-N // 8) * 8
        _check_pack("Pdp", Pdp, (W, PNp, B), state_pack)
        _check_pack("Plf", Plf, (W, PNp, B), state_pack)
    acc = torch.empty((_NACC, B), dtype=torch.float32, device=state_pack.device)
    _launch_residuals(
        _build.library("residuals", sig),
        coef, Pdp, Plf, state_pack, dxdy_pack, rowc, varc, acc,
    )
    termination_quantities_kernel.launches += 1
    termination_quantities_kernel.launches_block += sig["BLOCK_P"]
    return assemble_term_quantities(acc, cinv, norm_Dq)


# Kernel launches since import: both forms, and the block-P form alone.
termination_quantities_kernel.launches = 0
termination_quantities_kernel.launches_block = 0
