"""Modified Ruiz equilibration of a lane batch: all passes in one kernel.

Counterpart of ``osqp_solver_tpu/ops/ruiz_pallas.py``
(``ruiz_equilibrate_lane_kernel``); the plain version is the port of
``osqp_solver_tpu/ops/admm_lane.py::_ruiz_equilibrate_lane_jnp``.

Kernel note (``csrc/ruiz.cu`` replaces the Pallas body
``ruiz_pallas.py::_make_kernel``).  OSQP's modified Ruiz is a per-waypoint
stencil: a row touches variables of waypoints (t, t+1), a column gathers
rows of (t−1, t), and the vel-diag P adds columns of (t−1, t, t+1).  Each
pass is a JACOBI sweep — every row and column maximum reads the OLD D/E of
all neighbours — so the new D/E of every waypoint of a pass can be formed
at once; only the cost normalisation (the new D, the old ``c``) reduces
over the horizon.  A group of threads works on each problem, each thread on
a contiguous run of waypoints, and a block holds a few adjacent problems;
the constant rows and D/E stay in shared memory across all passes while
they fit (else both are read and written in device memory), and D, E and
``c`` are written once at the end.  The group size,
the run length, the problems per block and where the rows live are planned
at each launch (:func:`plan`).  Products keep the grouping of
``LaneTrajectoryQP.scale_data`` (``(|a|·e)·d``); sums over the horizon are
taken in another order than the plain version's (ulp-level differences).
Bound on an H100: reading the packs once (a few tens of MB at B=1024).

Block P (``p_structure="block"``, the reference's block branches): the
build with ``-DBLOCK_P=1`` takes full ``|P_diag|`` and ``|P_lower|`` blocks
``(W, 2N, 2N, B)`` (the lower pack padded to W with a zero block) and forms
the P column maxima over whole blocks; the cost normalisation averages all
2N columns.  Those packs (2 x 59 MB at W=100, N=6, B=1024, f32) are read
from device memory at the point of use, several times a pass.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ruiz import Scaling, _limit


def _ruiz_scalings_plain(qp, iters: int):
    """``(D (n, B), E (m, B), c (B,))`` by norm-only iterations: each pass
    computes the scaled row/column maxima directly from the base absolute
    coefficients weighted by the running (D, E, c) — the same values and
    multiply grouping as scaling the container and taking its norms."""
    dtype, dev = qp.q.dtype, qp.q.device
    B = qp.q.shape[-1]
    W, N = qp.waypoints, qp.n_dim
    c = torch.ones((B,), dtype=dtype, device=dev)

    a_c0 = qp.dyn_coef[..., 0, :].abs()
    a_c1 = qp.dyn_coef[..., 1, :].abs()
    a_c2 = qp.dyn_coef[..., 2, :].abs()
    a_pos = qp.pos_coef.abs()
    a_vel = qp.vel_coef.abs()
    a_a0 = qp.acc_coef[..., 0, :].abs()
    a_a1 = qp.acc_coef[..., 1, :].abs()
    a_ws = qp.ws_jac.abs()
    a_obs = qp.obs_jac.abs()
    a_Pd = qp.P_diag.abs()
    a_Pl = qp.P_lower.abs()
    a_q = qp.q_vec.abs()

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    Dq = ones(W, N, B)
    Dv = ones(W, N, B)
    e_dyn = ones(W - 1, N, B)
    e_pos = ones(W, N, B)
    e_vel = ones(W - 1, N, B)
    e_acc = ones(W - 2, N, B)
    e_ws = ones(qp.n_balls, W, 3, B)
    e_obs = ones(qp.n_balls, qp.n_obstacles, W, B)

    def p_colmax(ci):
        """Column maxima of |c·D P D| as (W, 2N, B)."""
        d_int = torch.cat([Dq, Dv], dim=1)  # (W, 2N, B)
        cd = ci * d_int
        pd = (a_Pd * cd[:, :, None]).amax(dim=1) * d_int
        if W > 1:
            low_col = (a_Pl * cd[1:, :, None]).amax(dim=1) * d_int[:-1]
            low_row = (a_Pl * d_int[:-1, None, :]).amax(dim=2) * cd[1:]
            pd = pd.clone()
            pd[:-1] = torch.maximum(pd[:-1], low_col)
            pd[1:] = torch.maximum(pd[1:], low_row)
        return pd

    def pad(x, b, a):
        parts = []
        if b:
            parts.append(x.new_zeros((b,) + x.shape[1:]))
        parts.append(x)
        if a:
            parts.append(x.new_zeros((a,) + x.shape[1:]))
        return torch.cat(parts, dim=0)

    def rs(v):
        return 1.0 / torch.sqrt(_limit(v))

    mx = torch.maximum
    for _ in range(iters):
        # Scaled absolute coefficients (grouping mirrors scale_data).
        s_c0 = a_c0 * e_dyn * Dv[:-1]
        s_c1 = a_c1 * e_dyn * Dq[1:]
        s_c2 = a_c2 * e_dyn * Dq[:-1]
        s_pos = a_pos * e_pos * Dq
        s_vel = a_vel * e_vel * Dv[:-1]
        s_a0 = a_a0 * e_acc * Dv[1:-1]
        s_a1 = a_a1 * e_acc * Dv[:-2]
        s_ws = a_ws * e_ws[:, :, :, None, :] * Dq[None, :, None, :, :]
        s_obs = a_obs * e_obs[:, :, :, None, :] * Dq[None, None, :, :, :]

        # A column maxima.
        qm = mx(s_pos, pad(s_c2, 0, 1))
        qm = mx(qm, pad(s_c1, 1, 0))
        if qp.n_balls:
            qm = mx(qm, s_ws.amax(dim=(0, 2)))
        if qp.n_obstacles and qp.n_balls:
            qm = mx(qm, s_obs.amax(dim=(0, 1)))
        vm = pad(mx(s_vel, s_c0), 0, 1)
        vm = mx(vm, pad(s_a1, 0, 2))
        vm = mx(vm, pad(s_a0, 1, 1))

        # KKT column maxima: P block included with the current c.
        pm = p_colmax(c)
        col_q = mx(qm, pm[:, :N])
        col_v = mx(vm, pm[:, N:])
        Dq = Dq * rs(col_q)
        Dv = Dv * rs(col_v)

        # A row maxima → E updates per type.
        e_dyn = e_dyn * rs(mx(mx(s_c0, s_c1), s_c2))
        e_pos = e_pos * rs(s_pos)
        e_vel = e_vel * rs(s_vel)
        e_acc = e_acc * rs(mx(s_a0, s_a1))
        e_ws = e_ws * rs(s_ws.amax(dim=-2))
        e_obs = e_obs * rs(s_obs.amax(dim=-2))

        # Cost normalization with the UPDATED D, current c.
        p_cols = _limit(p_colmax(c))
        Dflat = torch.cat([Dq.reshape(-1, B), Dv.reshape(-1, B)], dim=0)
        q_max = (c * Dflat * a_q).amax(dim=0)
        gamma = 1.0 / _limit(mx(p_cols.reshape(-1, B).mean(dim=0), q_max))
        c = c * gamma

    D = torch.cat([Dq.reshape(-1, B), Dv.reshape(-1, B)], dim=0)
    E = qp._concat_rows(e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs, pad_value=1.0)
    return D, E, c


def _finish(qp, D, E, c):
    scaled = qp.scale_data(D, E, c)
    scaling = Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return scaled, scaling


def ruiz_equilibrate_lane_plain(qp, iters: int = 10):
    """Plain PyTorch version: returns ``(scaled_qp, Scaling)``."""
    return _finish(qp, *_ruiz_scalings_plain(qp, iters))


def _configure(lib):
    """Set the C signatures of a loaded ``csrc/ruiz.cu`` library (once)."""
    if lib.ruiz_launch.argtypes is None:
        lib.ruiz_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ruiz_launch.restype = ctypes.c_int
        lib.ruiz_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ruiz_plan.restype = ctypes.c_int
    return lib


PLAN_KEYS = ("G", "Q", "rpt", "rows_in_shared", "shared_bytes", "blocks",
             "threads_per_block", "partials_per_problem", "budget")


def plan(lib, W, B, budget=0, threads=0):
    """The launch plan of ``csrc/ruiz.cu`` for ``W`` waypoints and a batch
    of ``B`` on the current device, as :func:`_launch_ruiz` makes it:
    threads per problem, problems per block, waypoints per thread, whether
    the constant rows and D/E sit in shared memory (else in device memory),
    shared bytes, blocks, threads per block, the group's partial sums and
    the shared bytes planned for (``budget`` 0: the device's; ``threads``
    per block at most, 0: the kernel's own limit)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib.ruiz_plan(W, B, budget, threads, out), "ruiz_plan")
    return dict(zip(PLAN_KEYS, out))


def _launch_ruiz(lib, ac, aPd, aPl, aq, D, E, c, iters, budget=0,
                 threads=0):
    """Call the C entry point of ``csrc/ruiz.cu`` on packs of one device;
    ``budget``, ``threads``: as :func:`plan`."""
    W, _, B = D.shape
    lib = _configure(lib)
    p = _build.ptr
    err = lib.ruiz_launch(p(ac), p(aPd), p(aPl), p(aq), p(D), p(E), p(c),
                          W, B, int(iters), int(budget), int(threads),
                          _build.stream(c.device))
    _build.check(err, "ruiz_launch")


def _ruiz_kernel_packs(qp):
    """The kernel's inputs and outputs: ``|coef|, |Pd|, |Pl|, |q|`` packs
    (the P packs as the form of ``qp.p_structure`` takes them) and the
    ``D (W, 2N, B)``, ``E (W, Rp, B)``, ``c (B,)`` outputs."""
    from .admm_fused import build_coef_pack
    from .kkt_factor import build_p_vel_packs

    W, B = qp.waypoints, qp.batch
    kw = dict(dtype=qp.dtype, device=qp.device)
    ac = build_coef_pack(qp).abs_()
    if qp.p_structure == "vel_diag":
        aPd, aPl = (p.abs_() for p in build_p_vel_packs(qp))
    else:  # full blocks, |P_lower| padded to W (ruiz_pallas.py:407-416)
        aPd = qp.P_diag.abs().contiguous()
        aPl = torch.cat([qp.P_lower.abs(),
                         qp.P_lower.new_zeros((1,) + qp.P_lower.shape[1:])])
    aq = qp._interleave(qp.q_vec).abs()
    D = torch.empty((W, 2 * qp.n_dim, B), **kw)
    E = torch.empty((W, qp.rows_per_waypoint_padded, B), **kw)
    c = torch.empty((B,), **kw)
    return ac, aPd, aPl, aq, D, E, c


def _unpack_scalings(qp, D, E, c):
    return qp._deinterleave(D), E.reshape(-1, qp.batch), c


# The reference's Pallas Ruiz (ruiz_pallas.py:40-48) admits waypoint-layout
# batches of at least 4 waypoints; its B % 128 tiling is a TPU limit.
MIN_WAYPOINTS = 4


def ruiz_kernel_supported(qp) -> bool:
    """Whether the reference runs its Ruiz kernel on ``qp``
    (``ruiz_pallas.ruiz_kernel_supported`` without the TPU tiling)."""
    return qp.row_layout == "waypoint" and qp.waypoints >= MIN_WAYPOINTS


def ruiz_scalings_kernel(qp, iters: int):
    """Launch the kernel: ``(D (n, B), E (m, B), c (B,))`` on the card, in
    the form of ``qp.p_structure``."""
    from .admm_fused import p_signature

    if qp.dtype != torch.float32:
        raise TypeError(f"the CUDA Ruiz kernel takes float32, got {qp.dtype}")
    if not ruiz_kernel_supported(qp):
        raise ValueError(
            "the Ruiz kernel takes waypoint-layout batches of at least 4 "
            f"waypoints, got {qp.waypoints} (as the reference's "
            "ruiz_pallas.ruiz_kernel_supported)")
    packs = _ruiz_kernel_packs(qp)
    sig = p_signature(qp)
    _launch_ruiz(_build.library("ruiz", sig), *packs, iters)
    ruiz_equilibrate_lane_kernel.launches += 1
    ruiz_equilibrate_lane_kernel.launches_block += sig["BLOCK_P"]
    return _unpack_scalings(qp, *packs[4:])


def ruiz_equilibrate_lane_kernel(qp, iters: int = 10):
    """Kernel-backed lane Ruiz: returns ``(scaled_qp, Scaling)``.

    ``qp``: waypoint-layout :class:`LaneTrajectoryQP`.  On a CUDA batch the
    kernel computes ``(D, E, c)`` (float32, the form of ``qp.p_structure``)
    and the container is scaled once afterwards; on a CPU batch the plain
    version runs."""
    if qp.row_layout != "waypoint":
        raise ValueError("ruiz_equilibrate_lane_kernel needs the 'waypoint' "
                         "row layout")
    if int(iters) < 1:
        raise ValueError(f"iters={iters}")
    if qp.device.type == "cpu":
        return ruiz_equilibrate_lane_plain(qp, iters)
    return _finish(qp, *ruiz_scalings_kernel(qp, iters))


# Kernel launches since import: both forms, and the block-P form alone.
ruiz_equilibrate_lane_kernel.launches = 0
ruiz_equilibrate_lane_kernel.launches_block = 0
