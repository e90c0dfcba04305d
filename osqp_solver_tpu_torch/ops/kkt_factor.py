"""Fused KKT assemble + block-Cholesky + pack.

Counterpart of ``osqp_solver_tpu/ops/kkt_factor_pallas.py``
(``build_p_vel_packs``, ``factor_packed_lane``).

Kernel note (``csrc/kkt_factor.cu`` replaces the Pallas body
``kkt_factor_pallas.py::_make_kernel`` behind ``factor_packed_lane``).
Every entry of ``P + σI + Aᵀdiag(ρ)A`` is a few multiplies of the
per-waypoint stencil coefficients, so each 2N×2N block is assembled in
registers from the ``(W, CRp, B)`` coefficient pack, the Schur step
``S_t = M_t − G_{t-1}G_{t-1}ᵀ`` and the Cholesky run in place, and only the
packed lower triangle is written; the full blocks never exist in memory.
One thread owns one problem and walks the horizon; ``G_{t-1}`` (78 packed
values at N=6) is carried in registers beside the 78 of ``C_t``, so the
kernel spills.  Bound on an H100: a chain of W dependent 12×12 Cholesky
steps per thread — latency, not bandwidth (it reads coef+ρ+Pd+Pl and writes
Tp rows once) and not FLOP rate; small blocks spread B=1024 over the SMs.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def build_p_vel_packs(qp):
    """(W, Np, B) velocity-diagonal entries of P_diag / P_lower (last row of
    the lower pack is zero so both stream W steps)."""
    W, N, B = qp.waypoints, qp.n_dim, qp.batch
    Np = -(-N // 8) * 8
    idx = torch.arange(N, 2 * N, device=qp.device)
    Pd = qp.P_diag[:, idx, idx]  # (W, N, B)
    Pl = qp.P_lower[:, idx, idx]
    Pl = torch.cat([Pl, Pl.new_zeros((1, N, B))], dim=0)
    if Np > N:
        z = Pd.new_zeros((W, Np - N, B))
        Pd, Pl = torch.cat([Pd, z], dim=1), torch.cat([Pl, z], dim=1)
    return Pd.contiguous(), Pl.contiguous()


def factor_packed_lane_plain(scaled, rho_vec, sigma, coef=None,
                             emit_gain=False):
    """Plain PyTorch version: ``kkt_blocks`` → block-tridiagonal Cholesky
    (:mod:`.tridiag`) → ``pack_factor``."""
    from .admm_fused import pack_factor

    del coef
    cholp, gainp = pack_factor(scaled, scaled.kkt_factor(rho_vec, sigma))
    return cholp, (gainp if emit_gain else None)


def _launch_factor(lib, coef, rho3, Pd, Pl, cholp, sigma):
    """Call the C entry point of ``csrc/kkt_factor.cu`` on packs of one
    device."""
    W, _, B = cholp.shape
    fn = lib.kkt_factor_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    p = _build.ptr
    err = fn(p(coef), p(rho3), p(Pd), p(Pl), p(cholp), W, B, float(sigma),
             _build.stream(cholp.device))
    _build.check(err, "kkt_factor_launch")


def factor_packed_lane(scaled, rho_vec, sigma, coef=None, emit_gain=False):
    """Packed triangular KKT factor straight from the stencil.

    ``scaled``: waypoint-layout vel-diag :class:`LaneTrajectoryQP` (Ruiz
    scaled); ``rho_vec (m, B)``; ``coef``: its :func:`build_coef_pack`
    (built when omitted).  Returns ``(cholp (W, Tp, B), None)`` — equal to
    ``pack_factor(qp, qp.kkt_factor(rho_vec, sigma))[0]`` up to f32
    reassociation.  The gain pack (``emit_gain=True``) is produced by the
    plain version only; the kernel's gain write is not ported yet.
    """
    from .admm_fused import (
        _coef_layout, _tri_maps, build_coef_pack, layout_signature,
    )

    W, N, B = scaled.waypoints, scaled.n_dim, scaled.batch
    Rp = scaled.rows_per_waypoint_padded
    if scaled.row_layout != "waypoint":
        raise ValueError("factor_packed_lane needs the 'waypoint' row layout")
    if tuple(rho_vec.shape) != (W * Rp, B):
        raise ValueError(
            f"rho_vec: shape {tuple(rho_vec.shape)} != {(W * Rp, B)}"
        )
    if rho_vec.dtype != scaled.dtype:
        raise TypeError(f"rho_vec: dtype {rho_vec.dtype} != {scaled.dtype}")
    if rho_vec.device != scaled.device:
        raise ValueError(f"rho_vec: device {rho_vec.device} != {scaled.device}")
    if rho_vec.device.type == "cpu":
        return factor_packed_lane_plain(scaled, rho_vec, sigma, coef, emit_gain)
    if scaled.p_structure != "vel_diag":
        raise NotImplementedError("the factor kernel needs vel-diag P")
    if emit_gain:
        raise NotImplementedError(
            "the factor kernel's gain write (factor_form='gain') is not "
            "ported yet"
        )
    if rho_vec.dtype != torch.float32:
        raise TypeError(
            f"the CUDA factor kernel takes float32, got {rho_vec.dtype}"
        )
    _, _, _, CRp = _coef_layout(scaled)
    _, _, Tp = _tri_maps(2 * N)
    if coef is None:
        coef = build_coef_pack(scaled)
    if tuple(coef.shape) != (W, CRp, B) or not coef.is_contiguous():
        raise ValueError(f"coef: expected contiguous {(W, CRp, B)}")
    Pd, Pl = build_p_vel_packs(scaled)
    rho3 = rho_vec.reshape(W, Rp, B).contiguous()
    cholp = torch.empty((W, Tp, B), dtype=torch.float32, device=rho_vec.device)

    _launch_factor(
        _build.library("kkt_factor", layout_signature(scaled)),
        coef, rho3, Pd, Pl, cholp, sigma,
    )
    factor_packed_lane.launches += 1
    return cholp, None


factor_packed_lane.launches = 0
