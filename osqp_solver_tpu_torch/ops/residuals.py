"""Termination accumulators and per-solve residual packs.

Counterpart of ``osqp_solver_tpu/ops/residuals_pallas.py`` for what the
termination-fused chunk kernel needs: the accumulator rows ``_ACC`` /
``_NACC``, ``build_residual_packs`` and ``assemble_term_quantities``.  The
separate streaming residual kernel of that module
(``termination_quantities_kernel``) is not ported yet.
"""
from __future__ import annotations

import torch

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
    velocity diagonals of ``P_diag``/``P_lower`` (last ``Plf`` row zero)."""
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
    """(NACC, B) raw accumulators → :class:`.admm_lane.TermQuantities`
    (applies the host-side ``cinv`` / ``norm_Dq`` combines)."""
    from .admm_lane import TermQuantities

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
