"""Fused ADMM chunk: whole iterations inside one CUDA kernel.

Counterpart of ``osqp_solver_tpu/ops/admm_fused.py``: the static layouts
(``_row_layout``, ``_coef_layout``, ``_tri_maps``), the host-side packs
(``build_coef_pack``, ``build_lu_pack``, ``pack_state``/``unpack_state``,
``pack_factor``) — all kept row for row, pad-to-8 rows included — and
``fused_admm_chunk`` in both factor forms, ``hrec`` (gain-free) and
``gain`` (the packed ``G_t`` streamed): with the termination accumulators
(``emit_term``) riding the last backward pass, without them (the warm-up
chunk), or writing the last iteration's packed deltas (``emit_dxdy``) for
the separate residual kernel (:mod:`.residuals`).

Kernel note (``csrc/admm_chunk.cu`` replaces the Pallas body
``admm_fused.py::_make_kernel`` behind ``fused_admm_chunk``).  The TPU
kernel keeps an (8, 128) tile of problems per scalar and double-buffers
every stream between HBM and VMEM; none of that carries over.  Here a
group of threads (the smallest power of two >= 2N: 16 at N=6) works on each
problem and a block holds up to 4 adjacent problems, fed by a producer warp
that stages each waypoint's rows two steps ahead into a three-stage ring;
above 16 joints one problem a block, a group of several warps, and the ring
in a device-memory workspace where it does not fit on chip
(``admm_chunk_workspace_bytes``; :func:`_launch_chunk` allocates it).  Per
iteration the forward pass builds the reduced-KKT right-hand side waypoint
by waypoint and forward-substitutes (``h_t``, or ``w_t`` in the gain form,
goes to a ``(W, 2N, B)`` global scratch that stays in L2); the backward pass
finishes the solve and applies A rows, relaxation, projection and dual
update in stream, writing the state pack IN PLACE.  Bound on an H100: each
problem's chain of W dependent 2N×2N triangular solves per pass, not memory
bandwidth or FLOP rate.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build as _launch
from .residuals import _NACC, accumulator_rows


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


# ---------------------------------------------------------------------------
# Static layouts
# ---------------------------------------------------------------------------


def _row_layout(qp):
    """Per-waypoint row offsets inside the padded (Rp) row tile."""
    N = qp.n_dim
    off = {"dyn": 0, "pos": N, "vel": 2 * N, "acc": 3 * N}
    ball_rows = []
    o = 4 * N
    for b in range(qp.n_balls):
        ws_off = o if qp.gripper_flags[b] else None
        if qp.gripper_flags[b]:
            o += 3
        obs_off = o if qp.n_obstacles else None
        o += qp.n_obstacles
        ball_rows.append((ws_off, obs_off))
    return off, tuple(ball_rows)


def _coef_layout(qp):
    """Row offsets inside the per-waypoint coefficient pack (CRp rows)."""
    N = qp.n_dim
    off = {
        "c0": 0, "c1": N, "c2": 2 * N,
        "pos": 3 * N, "vel": 4 * N,
        "a0": 5 * N, "a1": 6 * N,
    }
    ball_coefs = []
    o = 7 * N
    for b in range(qp.n_balls):
        ws_off = o if qp.gripper_flags[b] else None
        if qp.gripper_flags[b]:
            o += 3 * N
        obs_off = o if qp.n_obstacles else None
        o += qp.n_obstacles * N
        ball_coefs.append((ws_off, obs_off))
    return off, tuple(ball_coefs), o, _pad8(o)


def n_dense_rows(qp) -> int:
    """Workspace + obstacle rows per waypoint.  In both layouts above they
    follow the four stencil types in one order (row ``4N + k`` has its ``N``
    coefficients at ``7N + k·N``), so the kernels need only this count."""
    return qp.rows_per_waypoint - 4 * qp.n_dim


def layout_signature(qp) -> dict:
    """Compile-time structure of the kernels: one build per signature."""
    return {"NDIM": qp.n_dim, "NX": n_dense_rows(qp)}


def p_signature(qp) -> dict:
    """:func:`layout_signature` plus the P form (``BLOCK_P``: 0 for vel-diag
    P, 1 for generic blocks) — the signature of the kernels that read P
    (``csrc/ruiz.cu``, ``csrc/residuals.cu``)."""
    return dict(layout_signature(qp), BLOCK_P=int(qp.p_structure != "vel_diag"))


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def build_coef_pack(qp) -> torch.Tensor:
    """(W, CRp, B) stencil coefficient pack — constant per solve."""
    W, N, B = qp.waypoints, qp.n_dim, qp.batch
    _, _, CR, CRp = _coef_layout(qp)

    def padW(x, missing):
        if not missing:
            return x
        return torch.cat([x, x.new_zeros((missing,) + x.shape[1:])], dim=0)

    c = qp.dyn_coef  # (W-1, N, 3, B)
    a = qp.acc_coef  # (W-2, N, 2, B)
    parts = [
        padW(c[..., 0, :], 1), padW(c[..., 1, :], 1), padW(c[..., 2, :], 1),
        qp.pos_coef, padW(qp.vel_coef, 1),
        padW(a[..., 0, :], 2), padW(a[..., 1, :], 2),
    ]
    for b in range(qp.n_balls):
        if qp.gripper_flags[b]:
            parts.append(qp.ws_jac[b].reshape(W, 3 * N, B))
        if qp.n_obstacles:
            parts.append(
                qp.obs_jac[b].movedim(0, 1).reshape(W, qp.n_obstacles * N, B)
            )
    if CRp > CR:
        parts.append(qp.q_vec.new_zeros((W, CRp - CR, B)))
    return torch.cat(parts, dim=1)


def build_lu_pack(qp) -> torch.Tensor:
    """(W, 2·Rp, B): per-waypoint lower bounds then upper bounds (scaled)."""
    W = qp.waypoints
    Rp = qp.rows_per_waypoint_padded
    B = qp.batch
    return torch.cat([qp.l.reshape(W, Rp, B), qp.u.reshape(W, Rp, B)], dim=1)


def state_rows(qp):
    """(SR, SRp): stacked per-waypoint state rows [x (2N); z (Rp); y (Rp)]."""
    SR = 2 * qp.n_dim + 2 * qp.rows_per_waypoint_padded
    return SR, _pad8(SR)


def dxdy_rows(qp):
    DR = 2 * qp.n_dim + qp.rows_per_waypoint_padded
    return DR, _pad8(DR)


def pack_dxdy(qp, dx, dy):
    """dx (n, B) flat, dy (m, B) waypoint-major → stacked (W, DRp, B)."""
    W = qp.waypoints
    Rp = qp.rows_per_waypoint_padded
    B = dx.shape[-1]
    DR, DRp = dxdy_rows(qp)
    parts = [qp._interleave(dx), dy.reshape(W, Rp, B)]
    if DRp > DR:
        parts.append(dx.new_zeros((W, DRp - DR, B)))
    return torch.cat(parts, dim=1)


def unpack_dxdy(qp, d):
    W, N = qp.waypoints, qp.n_dim
    Rp = qp.rows_per_waypoint_padded
    B = d.shape[-1]
    dx = qp._deinterleave(d[:, : 2 * N])
    dy = d[:, 2 * N : 2 * N + Rp].reshape(W * Rp, B)
    return dx, dy


def pack_state(qp, x, z, y):
    """x (n, B) flat, z/y (m, B) waypoint-major → stacked (W, SRp, B)."""
    W = qp.waypoints
    Rp = qp.rows_per_waypoint_padded
    B = x.shape[-1]
    SR, SRp = state_rows(qp)
    parts = [qp._interleave(x), z.reshape(W, Rp, B), y.reshape(W, Rp, B)]
    if SRp > SR:
        parts.append(x.new_zeros((W, SRp - SR, B)))
    return torch.cat(parts, dim=1)


def unpack_state(qp, st):
    W, N = qp.waypoints, qp.n_dim
    Rp = qp.rows_per_waypoint_padded
    B = st.shape[-1]
    x = qp._deinterleave(st[:, : 2 * N])
    z = st[:, 2 * N : 2 * N + Rp].reshape(W * Rp, B)
    y = st[:, 2 * N + Rp : 2 * N + 2 * Rp].reshape(W * Rp, B)
    return x, z, y


# ---------------------------------------------------------------------------
# Packed triangular factor
# ---------------------------------------------------------------------------
#
# ``chol`` is lower-triangular and — for the trajectory QP family — ``gain``
# is exactly upper-triangular, so both pack to 2N(2N+1)/2 entries.  That
# holds while every coupling block of P (``P_lower[t]``: rows of waypoint
# t+1, columns of t) is upper-triangular, as GOMP's are; a block P with
# entries below the diagonal there loses them here, in the reference
# (``admm_fused.py:257-260``) and in this port alike.


def _tri_pad(B2):
    """Rows of a packed triangle of a B2 x B2 block, padded to 8: the
    packs' ``Tp`` (what :func:`_tri_maps` returns last, without its maps,
    which take ~0.1 s to build at B2=600)."""
    return _pad8(B2 * (B2 + 1) // 2)


def _tri_maps(B2):
    low = {}
    k = 0
    for i in range(B2):
        for j in range(i + 1):
            low[(i, j)] = k
            k += 1
    up = {}
    k = 0
    for i in range(B2):
        for j in range(i, B2):
            up[(i, j)] = k
            k += 1
    return low, up, _tri_pad(B2)


def pack_factor(qp, factor):
    """LaneFactor (full blocks) → (cholp (W, Tp, B), gainp (W, Tp, B))."""
    W, N = qp.waypoints, qp.n_dim
    B2 = 2 * N
    B = factor.chol.shape[-1]
    low, up, Tp = _tri_maps(B2)
    dev = factor.chol.device
    low_flat = torch.tensor(
        [i * B2 + j for (i, j) in sorted(low, key=low.get)], device=dev
    )
    up_flat = torch.tensor(
        [i * B2 + j for (i, j) in sorted(up, key=up.get)], device=dev
    )
    cholp = factor.chol.reshape(W, B2 * B2, B)[:, low_flat]
    gain = torch.cat(
        [factor.gain, factor.gain.new_zeros((1,) + factor.gain.shape[1:])],
        dim=0,
    )
    gainp = gain.reshape(W, B2 * B2, B)[:, up_flat]
    pad = Tp - len(low_flat)
    if pad:
        z = cholp.new_zeros((W, pad, B))
        cholp = torch.cat([cholp, z], dim=1)
        gainp = torch.cat([gainp, z], dim=1)
    # Contiguous whatever the layout of the factor's blocks (with no pad to
    # append, as at 2N = 16 and 32, the gather keeps it), as the kernels
    # read it.
    return cholp.contiguous(), gainp.contiguous()


def unpack_gain(qp, gainp):
    """(W, Tp, B) packed upper triangles → full (W-1, 2N, 2N, B) gain
    blocks (the last waypoint's zero row dropped)."""
    W, B2 = qp.waypoints, 2 * qp.n_dim
    _, up, _ = _tri_maps(B2)
    flat = torch.tensor(
        [i * B2 + j for (i, j) in sorted(up, key=up.get)],
        device=gainp.device,
    )
    full = gainp.new_zeros((W - 1, B2 * B2, gainp.shape[-1]))
    full[:, flat] = gainp[: W - 1, : len(up)]
    return full.reshape(W - 1, B2, B2, -1)


def unpack_chol(qp, cholp):
    """(W, Tp, B) packed lower triangle → full (W, 2N, 2N, B) blocks."""
    W, B2 = qp.waypoints, 2 * qp.n_dim
    low, _, _ = _tri_maps(B2)
    flat = torch.tensor(
        [i * B2 + j for (i, j) in sorted(low, key=low.get)],
        device=cholp.device,
    )
    full = cholp.new_zeros((W, B2 * B2, cholp.shape[-1]))
    full[:, flat] = cholp[:, : len(low)]
    return full.reshape(W, B2, B2, -1)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_admm_chunk_plain(
    scaled, rho_vec, done, settings, *, coef=None, lu=None,
    packed_factor, state_pack, term_packs=None, n_iter=None,
    emit_dxdy=False,
):
    """Plain PyTorch version of :func:`fused_admm_chunk`: ``n_iter`` ×
    :func:`.admm_lane._iteration` (with the plain block-tridiagonal solve)
    on the unpacked state, then the ``_ACC`` rows or the packed deltas,
    repacked.  Returns a NEW state pack (the input is not modified).
    """
    from ..gomp.trajectory_qp_lane import LaneFactor
    from .admm_lane import LaneADMMState, _iteration
    from .tridiag_kernel import solve_lane_major_plain

    del coef, lu  # the plain version reads the container directly
    n_iter = settings.check_termination if n_iter is None else int(n_iter)
    cholp, gainp = packed_factor
    chol = unpack_chol(scaled, cholp)
    if gainp is not None:
        gain = unpack_gain(scaled, gainp)
    else:
        # hrec carries no gain pack: rebuild G_t = Ml_t·C_t⁻ᵀ from the same
        # sparse coupling block the kernel rebuilds in registers.
        _, m_lower = scaled.kkt_blocks(rho_vec, settings.sigma)
        c_lead = chol[:-1].movedim(-1, 0)
        gain = torch.linalg.solve_triangular(
            c_lead, m_lower.movedim(-1, 0).transpose(-1, -2), upper=False
        ).transpose(-1, -2).movedim(0, -1)
    factor = LaneFactor(chol=chol, gain=gain)

    x, z, y = unpack_state(scaled, state_pack)
    B = x.shape[-1]
    st = LaneADMMState(
        x=x, z=z, y=y, dx=torch.zeros_like(x), dy=torch.zeros_like(y),
        rho_bar=None, rho_vec=rho_vec, factor=None,
        iterations=torch.zeros(B, dtype=torch.int32, device=x.device),
        status=None, done=done.bool(), prim_res=None, dual_res=None,
    )

    def plain_solve(f, rhs):
        s = scaled._interleave(rhs)
        return scaled._deinterleave(solve_lane_major_plain(f.chol, f.gain, s))

    prev = st
    for _ in range(n_iter):
        prev = st
        st = _iteration(scaled, st, factor, settings, kkt_solve=plain_solve)
    out = pack_state(scaled, st.x, st.z, st.y)
    # Deltas of the LAST iteration; exactly zero for frozen problems.
    dx, dy = st.x - prev.x, st.y - prev.y
    if emit_dxdy:
        return out, pack_dxdy(scaled, dx, dy)
    if term_packs is None:
        return out, None
    ee, varc = term_packs[0], term_packs[1]
    return out, accumulator_rows(scaled, ee, varc, st.x, st.z, st.y, dx, dy)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check_pack(name, t, shape, ref):
    if t.device != ref.device:
        raise ValueError(f"{name}: device {t.device} != {ref.device}")
    if t.dtype != ref.dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {ref.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _chunk_group(lib):
    """Threads per problem of a ``csrc/admm_chunk.cu`` build (its plan)."""
    fn = lib.admm_chunk_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 9)()
    fn(1, 1, 0, 0, out)
    return out[0]


def _launch_chunk(lib, cholp, coef, q_int, lu, rho3, Plf, ee, varc, Pdp,
                  done_f, state_pack, w, acc, n_iter, sigma, alpha,
                  dxdy=None, gainp=None, budget=0):
    """Call the C entry point of ``csrc/admm_chunk.cu`` on packs of one
    device.  ``acc`` selects the instantiation with the accumulators,
    ``dxdy`` the one that writes the delta pack, neither the one that only
    advances the state; ``gainp`` the gain form of each.  ``budget``: the
    shared bytes a block may use (0: the device's); above 16 joints the
    ring goes to a device-memory workspace where it does not fit."""
    W, _, B = state_pack.shape
    mode = 1 if acc is not None else 2 if dxdy is not None else 0
    fn = lib.admm_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
    ptr = _launch.ptr
    work = None
    if _launch.wide(lib, _chunk_group):
        ws = lib.admm_chunk_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_longlong
        work = _launch.workspace(
            ws(B, mode, int(gainp is not None), int(budget)),
            state_pack.device)
    err = fn(
        ptr(cholp), ptr(gainp), ptr(coef), ptr(q_int), ptr(lu), ptr(rho3),
        ptr(Plf),
        ptr(ee), ptr(varc), ptr(Pdp), ptr(done_f), ptr(state_pack), ptr(w),
        ptr(acc), ptr(dxdy), W, B, int(n_iter), mode,
        float(sigma), float(alpha), _launch.stream(state_pack.device),
        ptr(work), int(budget),
    )
    _launch.check(err, "admm_chunk_launch")


def fused_admm_chunk(
    scaled, rho_vec, done, settings, *, coef, lu, packed_factor,
    state_pack, term_packs=None, n_iter=None, emit_dxdy=False,
):
    """Run ``n_iter`` (default ``settings.check_termination``) ADMM
    iterations fused, on the packed state.

    ``scaled``: waypoint-layout :class:`LaneTrajectoryQP` (Ruiz scaled);
    ``rho_vec (m, B)``; ``done (B,)`` bool; ``coef``/``lu``: the
    :func:`build_coef_pack` / :func:`build_lu_pack` outputs;
    ``packed_factor``: ``(cholp (W, Tp, B), None)`` (the ``hrec`` form) or
    ``(cholp, gainp (W, Tp, B))`` (the ``gain`` form) from
    :func:`.kkt_factor.factor_packed_lane`, or for block P from
    :func:`pack_factor` of the block-tridiagonal factor (gain form only, no
    ``term_packs``: the iteration itself never reads P);
    ``state_pack (W, SRp, B)``;
    ``term_packs``: ``(EEinv (W, 2Rp, B), varc, Pdp, Plf)`` — with them the
    kernel also emits the raw termination accumulators ``acc (24, B)`` in
    its last backward pass; without them ``Plf`` is rebuilt and only the
    state advances.  ``emit_dxdy`` (without ``term_packs``): the last
    iteration's deltas are written as the ``(W, DRp, B)`` pack ``[dx; dy]``
    that :func:`.residuals.termination_quantities_kernel` consumes.

    Returns ``(state_out, acc | None)``, or ``(state_out, dxdy)`` with
    ``emit_dxdy``.  On a CUDA tensor the kernel
    updates ``state_pack`` IN PLACE and returns the same tensor; frozen
    problems (``done``) keep their state and emit zero deltas.  On a CPU
    tensor the plain version runs and returns a new tensor.
    """
    W, N, B = scaled.waypoints, scaled.n_dim, scaled.batch
    Rp = scaled.rows_per_waypoint_padded
    _, SRp = state_rows(scaled)
    _, _, _, CRp = _coef_layout(scaled)
    Tp = _tri_pad(2 * N)
    PNp = _pad8(N)
    VCp = _pad8(6 * N)
    n_iter = settings.check_termination if n_iter is None else int(n_iter)
    if n_iter < 1:
        raise ValueError(f"n_iter={n_iter}")
    if scaled.row_layout != "waypoint":
        raise ValueError("fused_admm_chunk needs the 'waypoint' row layout")
    cholp, gainp = packed_factor
    if scaled.p_structure != "vel_diag" and (
            gainp is None or term_packs is not None):
        # The reference asserts the same (admm_fused.py:1022-1024, :1036):
        # the hrec form rebuilds the coupling from the vel-diag P, and the
        # fused accumulators read the vel-diag P packs.
        raise ValueError(
            "a block-P chunk runs in the gain form (a gain pack in "
            "packed_factor) and without term_packs"
        )
    _check_pack("state_pack", state_pack, (W, SRp, B), state_pack)
    _check_pack("cholp", cholp, (W, Tp, B), state_pack)
    if gainp is not None:
        _check_pack("gainp", gainp, (W, Tp, B), state_pack)
    _check_pack("coef", coef, (W, CRp, B), state_pack)
    _check_pack("lu", lu, (W, 2 * Rp, B), state_pack)
    rho3 = rho_vec.reshape(W, Rp, B)
    _check_pack("rho_vec", rho3, (W, Rp, B), state_pack)
    if tuple(done.shape) != (B,):
        raise ValueError(f"done: shape {tuple(done.shape)} != ({B},)")
    emit_term = term_packs is not None
    if emit_term and emit_dxdy:
        raise ValueError(
            "emit_dxdy writes the deltas that term_packs consumes in "
            "registers: pass one or the other"
        )
    if emit_term:
        ee, varc, Pdp, Plf = term_packs
        _check_pack("EEinv", ee, (W, 2 * Rp, B), state_pack)
        _check_pack("varc", varc, (W, VCp, B), state_pack)
        _check_pack("Pdp", Pdp, (W, PNp, B), state_pack)
        _check_pack("Plf", Plf, (W, PNp, B), state_pack)

    if state_pack.device.type == "cpu":
        return fused_admm_chunk_plain(
            scaled, rho_vec, done, settings, packed_factor=packed_factor,
            state_pack=state_pack, term_packs=term_packs, n_iter=n_iter,
            emit_dxdy=emit_dxdy,
        )
    if state_pack.dtype != torch.float32:
        raise TypeError(
            f"the CUDA chunk kernel takes float32, got {state_pack.dtype}"
        )

    if not emit_term:
        from .kkt_factor import build_p_vel_packs

        Plf = build_p_vel_packs(scaled)[1]
        ee = varc = Pdp = None
    q_int = scaled._interleave(scaled.q_vec).contiguous()  # (W, 2N, B)
    done_f = done.to(torch.float32).contiguous()
    w = torch.empty((W, 2 * N, B), dtype=torch.float32, device=state_pack.device)
    acc = (
        torch.empty((_NACC, B), dtype=torch.float32, device=state_pack.device)
        if emit_term else None
    )
    dxdy = (
        torch.empty(
            (W, dxdy_rows(scaled)[1], B), dtype=torch.float32,
            device=state_pack.device,
        )
        if emit_dxdy else None
    )
    _launch_chunk(
        _launch.library("admm_chunk", layout_signature(scaled)),
        cholp, coef, q_int, lu, rho3, Plf, ee, varc, Pdp, done_f, state_pack,
        w, acc, n_iter, settings.sigma, settings.alpha, dxdy=dxdy,
        gainp=gainp,
    )
    fused_admm_chunk.launches += 1
    if gainp is not None:
        fused_admm_chunk.launches_gain += 1
    if scaled.p_structure != "vel_diag":
        fused_admm_chunk.launches_block += 1
    if emit_dxdy:
        fused_admm_chunk.launches_dxdy += 1
        return state_pack, dxdy
    return state_pack, acc


# Kernel launches since import: all forms, the delta-writing form alone,
# the gain form alone, and those on a block-P batch alone.
fused_admm_chunk.launches = 0
fused_admm_chunk.launches_dxdy = 0
fused_admm_chunk.launches_gain = 0
fused_admm_chunk.launches_block = 0
