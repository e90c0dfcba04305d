"""Fused KKT assemble + block-Cholesky + pack.

Counterpart of ``osqp_solver_tpu/ops/kkt_factor_pallas.py``
(``build_p_vel_packs``, ``factor_packed_lane``).

Kernel note (``csrc/kkt_factor.cu`` replaces the Pallas body
``kkt_factor_pallas.py::_make_kernel`` behind ``factor_packed_lane``).
Every entry of ``P + σI + Aᵀdiag(ρ)A`` is a few multiplies of the
per-waypoint stencil coefficients, so each 2N×2N block is assembled on chip
from the ``(W, CRp, B)`` coefficient pack, the Schur step
``S_t = M_t − G_{t-1}G_{t-1}ᵀ`` and the Cholesky run on chip, and only the
packed lower triangle is written (and, with ``emit_gain``, the packed upper
triangle ``G_t`` the ``gain`` chunk form streams); the full blocks never
exist in memory.  A group of threads works on each problem and a block
holds a few adjacent problems: the blocks of a window of waypoints are
assembled at once, off the step chain, into shared memory; on the chain
the group's lanes share the Schur update, each lane factors the whole
block in its registers and lane ``i`` forms row ``i`` of ``G_t``.  The
problems per block and the window are planned at each launch
(:func:`plan`).  Above 16 joints one problem a block and a group of
several warps, each step assembling its own waypoint into a working matrix
``[G | C]`` and factoring it by the blocked panels of
``csrc/wide_chol.cuh`` (register-tiled products, a warp per diagonal
block, a thread per row below); the matrix lives in a device-memory
workspace (allocated here) where it does not fit on chip.  Bound on an H100: each
problem's chain of W dependent 12×12 steps — latency, not bandwidth (it
reads coef+ρ+Pd+Pl and writes Tp rows once) and not FLOP rate.
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
    from ..gomp.trajectory_qp_lane import LaneFactor
    from .admm_fused import pack_factor
    from .tridiag_kernel import factor_lane_major_plain

    del coef
    chol, gain = factor_lane_major_plain(*scaled.kkt_blocks(rho_vec, sigma))
    cholp, gainp = pack_factor(scaled, LaneFactor(chol=chol, gain=gain))
    return cholp, (gainp if emit_gain else None)


def _configure(lib):
    """Set the C signatures of a loaded ``csrc/kkt_factor.cu`` library
    (once)."""
    if lib.kkt_factor_launch.argtypes is None:
        lib.kkt_factor_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.kkt_factor_launch.restype = ctypes.c_int
        lib.kkt_factor_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.kkt_factor_plan.restype = ctypes.c_int
    return lib


PLAN_KEYS = ("G", "Q", "window", "windows", "shared_bytes", "blocks",
             "threads_per_block", "budget", "workspace_bytes",
             "blocks_per_problem", "launches_a_step")


def plan(lib, W, B, budget=0):
    """The launch plan of ``csrc/kkt_factor.cu`` for ``W`` waypoints and a
    batch of ``B`` on the current device, as :func:`_launch_factor` makes
    it: threads per problem, problems per block, waypoints per assembled
    window (above 16 joints: 1, each step assembling its own), windows,
    shared bytes, blocks, threads per block, the shared bytes planned for
    (``budget`` 0: the device's), the bytes of the device-memory
    workspace it needs (above 16 joints, where the working matrix does not
    fit on chip or the form is split; else 0), the blocks a problem
    (above 1: the wide form split, each phase of a step a launch of that
    many blocks a problem, where the batch leaves SMs idle) and the split
    form's launches a step (0: one launch a call; :func:`device_launches`)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib.kkt_factor_plan(W, B, budget, out), "kkt_factor_plan")
    return dict(zip(PLAN_KEYS, out))


def device_launches(plan_, W):
    """The CUDA launches that one call of the factor makes under ``plan_``
    (:func:`plan`) for ``W`` waypoints: 1, or the split form's 1 + W times
    its launches a step."""
    return 1 + W * plan_["launches_a_step"]


def _launch_factor(lib, coef, rho3, Pd, Pl, cholp, sigma, gainp=None,
                   budget=0):
    """Call the C entry point of ``csrc/kkt_factor.cu`` on packs of one
    device; ``gainp`` (or ``None``) selects the gain write; ``budget``: the
    shared bytes a block may use (0: the device's)."""
    W, _, B = cholp.shape
    lib = _configure(lib)
    p = _build.ptr
    work = None
    if _build.wide(lib, lambda lb: plan(lb, 4, 1)["G"]):
        work = _build.workspace(plan(lib, W, B, budget)["workspace_bytes"],
                                cholp.device)
    err = lib.kkt_factor_launch(p(coef), p(rho3), p(Pd), p(Pl), p(cholp),
                                p(gainp), W, B, float(sigma), int(budget),
                                _build.stream(cholp.device), p(work))
    _build.check(err, "kkt_factor_launch")


def factor_packed_lane(scaled, rho_vec, sigma, coef=None, emit_gain=False):
    """Packed triangular KKT factor straight from the stencil.

    ``scaled``: waypoint-layout vel-diag :class:`LaneTrajectoryQP` (Ruiz
    scaled); ``rho_vec (m, B)``; ``coef``: its :func:`build_coef_pack`
    (built when omitted).  Returns ``(cholp (W, Tp, B), None)``, or with
    ``emit_gain=True`` ``(cholp, gainp (W, Tp, B))`` — equal to
    ``pack_factor(qp, qp.kkt_factor(rho_vec, sigma))`` up to f32
    reassociation.
    """
    from .admm_fused import (
        _coef_layout, _tri_pad, build_coef_pack, layout_signature,
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
    if rho_vec.dtype != torch.float32:
        raise TypeError(
            f"the CUDA factor kernel takes float32, got {rho_vec.dtype}"
        )
    _, _, _, CRp = _coef_layout(scaled)
    Tp = _tri_pad(2 * N)
    if coef is None:
        coef = build_coef_pack(scaled)
    if tuple(coef.shape) != (W, CRp, B) or not coef.is_contiguous():
        raise ValueError(f"coef: expected contiguous {(W, CRp, B)}")
    Pd, Pl = build_p_vel_packs(scaled)
    rho3 = rho_vec.reshape(W, Rp, B).contiguous()
    cholp = torch.empty((W, Tp, B), dtype=torch.float32, device=rho_vec.device)
    gainp = torch.empty_like(cholp) if emit_gain else None

    _launch_factor(
        _build.library("kkt_factor", layout_signature(scaled)),
        coef, rho3, Pd, Pl, cholp, sigma, gainp,
    )
    factor_packed_lane.launches += 1
    if emit_gain:
        factor_packed_lane.launches_gain += 1
    return cholp, gainp


# Kernel launches since import: both forms, and the gain-writing form alone.
factor_packed_lane.launches = 0
factor_packed_lane.launches_gain = 0
