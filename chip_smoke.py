#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``osqp_solver_tpu_torch``).

Run it from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``osqp_solver_tpu_torch/csrc`` (five
sources; three layout signatures of the lane kernels and the block size of
the tridiagonal one; all compilers started together), holds each kernel —
the chunk kernel in its accumulator, warm-up and delta-writing forms, each
in the ``hrec`` and the ``gain`` factor form, the factor kernel with and
without its gain write, the block-tridiagonal factor and solve — against its
plain PyTorch version on the card at the main path's shape (honest GOMP
class, W=100, N=6, B=1024, float32), times both, then drives the port's
entry points:

* ``solve_batched_lane`` on a 1024-problem honest batch (``solve``), the same
  with ``term_fused="off"`` (``solve_unfused_term``: delta-writing chunk +
  streaming residual kernel, counts equal to ``solve``), a 256-problem batch
  with stock settings (ρ adaptation refactors) and a box-only batch;
* ``GOMPSolver.run_batch_padded``, the full time-scaling search, on 1024
  UR5e queries at W_max=50 (``planner_full``; fused and unfused termination
  give equal results; every plan audited by exact FK in float64 on the host);
* ``run_batch_padded`` and ``run_batch_lane`` on a fleet with per-query
  sphere keep-outs (``planner_obstacles``; every optimal plan audited
  against its own sphere);
* ``setup_lane`` → ``mpc_scan_lane`` on the fleet of
  ``benchmarks/mpc_fleet.py`` (1024 controllers x 50 ticks, honest class)
  in the default ``hrec`` form (``mpc_fleet``), with ``factor_form="gain"``
  (``mpc_fleet_gain``) and on the unfused path with its tridiagonal kernels,
  reached by ``fused_chunk="off"`` and by the ``"type"`` row layout
  (``mpc_fleet_unfused``), with guarded bound updates.

It checks statuses, ADMM iteration counts, OSQP's residual criterion
recomputed in float64 on the host, and that every kernel was really launched
by its path.  One JSON line per phase; the last three lines are the kernel
table, the card's name and power limit, and the verdict.  Exits non-zero
without a CUDA device or when any phase fails.  ``--phases build,kernels``
runs a subset; ``--out FILE`` also writes every phase's record to a JSON
file.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from osqp_solver_tpu_torch import GOMPSolver, SphereObstacle, _build
from osqp_solver_tpu_torch import constraints, stack_obstacles
from osqp_solver_tpu_torch import (
    mpc_scan_lane,
    setup_lane,
    solve_lane,
    update_bounds_lane,
)
from osqp_solver_tpu_torch.gomp import planner
from osqp_solver_tpu_torch.gomp.geometry import ERROR
from osqp_solver_tpu_torch.gomp.honest_batch import (
    build_box_batch,
    build_honest_batch,
)
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import _ARRAY_FIELDS
from osqp_solver_tpu_torch.models import ur5e
from osqp_solver_tpu_torch.ops import admm_fused, admm_lane, kkt_factor
from osqp_solver_tpu_torch.ops import session_lane
from osqp_solver_tpu_torch.ops import residuals, ruiz_kernel, tridiag_kernel
from osqp_solver_tpu_torch.ops.admm import Settings, _rho_vec
from osqp_solver_tpu_torch.ops.residuals import _ACC
from osqp_solver_tpu_torch.ops.status import ExitCode

W, N, BATCH = 100, 6, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BENCH = dict(rho=0.04, check_termination=2, adaptive_rho_interval=45,
             scaling=3, alpha=1.6, factor_form="hrec", termination_warmup=21)
TOL_RUIZ, TOL_FACTOR, TOL_CHUNK = 1e-5, 1e-4, 1e-3
# Block-tridiagonal factor and solve (f32 kernel) against the plain version
# run in f64 on the same f32 inputs, as max abs error over max |f64|: f32
# reassociation along a 100-step recurrence of 12x12 Cholesky steps.
TOL_TRIDIAG = 1e-4
TOL_RESID_MAX, TOL_RESID_SUM = 1e-4, 1e-3
RESID_SUMS = ("support", "q_dot", "xsum", "ysum")
PLANNER = dict(rho=0.04, check_termination=3, scaling=3)
LANE_KERNELS = ("ruiz", "kkt_factor", "admm_chunk")
UNFUSED_KERNELS = LANE_KERNELS + ("admm_chunk_dxdy", "residuals")
GAIN_KERNELS = LANE_KERNELS + ("kkt_factor_gain", "admm_chunk_gain")
TRIDIAG_KERNELS = ("tridiag_factor", "tridiag_solve")
# benchmarks/mpc_fleet.py: 1024 controllers x 50 ticks, honest W=100 class.
FLEET = dict(rho=0.05, check_termination=5, adaptive_rho_interval=51)
FLEET_TICKS = 50
PHASES = ("build,kernels,solve,solve_unfused_term,solve_stock,box,"
          "planner_full,planner_obstacles,mpc_fleet,mpc_fleet_gain,"
          "mpc_fleet_unfused")
RECORDS = {}


def emit(phase, **fields):
    RECORDS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps=7, warm=2):
    """Median device time of ``fn`` in ms (CUDA events, warmed)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, ref, scale=None):
    """(max abs error, that error over ``scale`` — by default max |ref|);
    infinities must agree."""
    inf = torch.isinf(ref)
    if not torch.equal(inf, torch.isinf(got)) or not torch.equal(
            got[inf], ref[inf]):
        return float("inf"), float("inf")
    if not torch.isfinite(got[~inf]).all():
        return float("nan"), float("nan")
    err = (got[~inf] - ref[~inf]).abs().max().item() if (~inf).any() else 0.0
    if scale is None:
        scale = ref[~inf].abs().max().item() if (~inf).any() else 1.0
    return err, err / max(scale, 1e-30)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def tril_bytes(blocks):
    """Bytes of the lower triangles of a (W, B2, B2, B) array of blocks."""
    W, B2, _, B = blocks.shape
    return W * (B2 * (B2 + 1) // 2) * B * blocks.element_size()


# ----------------------------------------------------------- operation counts
# Counted from the kernels' loops for this run's shapes; a multiply, add,
# max/min, compare, divide or square root each count as one operation.


def ops_tri_solves(B2):
    """One lower + one upper substitution with a packed 2N x 2N factor."""
    return 2 * sum(2 * i + 1 for i in range(B2))


def ops_factor(W, N, NX, B):
    B2 = 2 * N
    dense = NX * (N + 2 * N * (N + 1) // 2)
    stencil = N * 40
    schur = sum(2 * (B2 - i) + 1 for i in range(B2) for _ in range(i + 1))
    chol = sum(2 * jj + 2 + (B2 - jj - 1) * (2 * jj + 1) for jj in range(B2))
    gain = sum(2 * (j - i) + 1 for i in range(B2) for j in range(i, B2))
    return W * B * (dense + stencil + schur + chol + gain)


def ops_ruiz(W, N, NX, B, iters):
    R = 4 * N + NX
    per_wp = N * (51 + 3 * NX) + 3 * NX * N + 5 * R + 20 * N
    return iters * W * B * per_wp


def ops_chunk(W, N, NX, B, n_iter, emit_term):
    B2, R = 2 * N, 4 * N + NX
    Rp = -(-R // 8) * 8
    a_rows = 5 * N + N + N + 3 * N + 2 * N * NX
    fwd = 2 * R + N * (2 * (3 + NX) + 3) + N * 11 + 6 * N + 5 * N
    fwd += ops_tri_solves(B2)
    bwd = 5 * N + 6 * N + ops_tri_solves(B2) + B2 + 5 * B2 + a_rows + 10 * Rp
    term = 2 * a_rows + 30 * Rp + 4 * N + 2 * B2 + 4 * N + 14 * B2 + 5 * B2
    term += 2 * N * (5 + 2 * NX) + 2 * 5 * N + 6 * N
    return W * B * (n_iter * (fwd + bwd) + (term if emit_term else 0))


def ops_residuals(W, N, NX, B):
    B2, R = 2 * N, 4 * N + NX
    Rp = -(-R // 8) * 8
    a_rows = 5 * N + N + N + 3 * N + 2 * N * NX
    at = 2 * N * (5 + 2 * NX) + 8 * N
    return W * B * (2 * a_rows + 30 * Rp + at + 10 * N + 16 * B2)


def ops_tridiag_factor(W, B2, B):
    gain = B2 * sum(2 * j + 1 for j in range(B2))
    schur = (B2 * (B2 + 1) // 2) * 2 * B2
    chol = sum(2 * j + 1 + (B2 - j - 1) * (2 * j + 1) for j in range(B2))
    return W * B * (gain + schur + chol)


def ops_tridiag_solve(W, B2, B):
    sweep = 2 * B2 * B2 + sum(2 * i + 1 for i in range(B2))
    return 2 * W * B * sweep


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------------- phases


def phase_device():
    emit("device", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())


def phase_build(signatures):
    t0 = time.time()
    built = _build.build_all(signatures)
    seconds = time.time() - t0
    report = {}
    for (name, sig), path in built.items():
        tag = name + ":" + ",".join(f"{k}={v}" for k, v in sig)
        info = _build.ptxas_report(path)
        report[tag] = {
            "so": str(path.relative_to(_build.build_dir().parent.parent))
            if path.is_relative_to(_build.build_dir().parent.parent)
            else str(path),
            **{k[:48]: v for k, v in info.items()},
        }
    emit("build", seconds=round(seconds, 2), libraries=report)


def main_path_problem(batch):
    """Honest batch, equilibrated by the kernel, with the main path's packs."""
    settings = dataclasses.replace(Settings(), **BENCH)
    base = build_honest_batch(batch, W, N, torch.float32, "cuda")
    scaled, scaling = admm_lane.ruiz_equilibrate_lane(base, settings.scaling)
    packs = admm_lane.build_const_packs(scaled, scaling)
    rb = torch.full((batch,), settings.rho, dtype=torch.float32, device="cuda")
    rho_vec = _rho_vec(rb, scaled.l, scaled.u)
    return settings, base, scaled, scaling, packs, rho_vec


def check_ruiz(base, iters, batch):
    Dk, Ek, ck = ruiz_kernel.ruiz_scalings_kernel(base, iters)
    Dp, Ep, cp = ruiz_kernel._ruiz_scalings_plain(base, iters)
    torch.cuda.synchronize()
    errs = [rel_err(a / b, torch.ones_like(b))
            for a, b in ((Dk, Dp), (Ek, Ep), (ck, cp))]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_kernels():
    settings, base, scaled, scaling, packs, rho_vec = main_path_problem(BATCH)
    sig = admm_fused.layout_signature(scaled)
    NX = sig["NX"]
    B = BATCH
    out = []

    # ---- Ruiz: D, E, c elementwise relative to the plain version.
    abs_err, r_err = check_ruiz(base, settings.scaling, B)
    odd = build_honest_batch(200, W, N, torch.float32, "cuda")
    odd_err = check_ruiz(odd, settings.scaling, 200)[1]
    k_ms = time_ms(lambda: ruiz_kernel.ruiz_scalings_kernel(base, settings.scaling))
    p_ms = time_ms(lambda: ruiz_kernel._ruiz_scalings_plain(base, settings.scaling))
    rp = ruiz_kernel._ruiz_kernel_packs(base)
    b_ms, b_by = bound(
        nbytes(*rp[:4]) + nbytes(rp[4][0], rp[5][0], rp[6]),
        ops_ruiz(W, N, NX, B, settings.scaling))
    out.append(dict(
        name="ruiz", max_abs_err=abs_err, max_rel_err=r_err,
        odd_batch_rel_err=odd_err, tol=TOL_RUIZ,
        tol_note="D, E, c elementwise relative to the plain version",
        ok=bool(r_err <= TOL_RUIZ and odd_err <= TOL_RUIZ),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=f"W={W} N={N} B={B} iters={settings.scaling}"))

    # ---- KKT factor: packed chol against kkt_blocks -> tridiag -> pack.
    coef = packs["coef"]
    ck, _ = kkt_factor.factor_packed_lane(scaled, rho_vec, settings.sigma, coef=coef)
    cp, _ = kkt_factor.factor_packed_lane_plain(scaled, rho_vec, settings.sigma)
    c64, _ = kkt_factor.factor_packed_lane_plain(
        cast(scaled, torch.float64), rho_vec.double(), settings.sigma)
    torch.cuda.synchronize()
    abs_err, r_err = rel_err(ck, cp)
    odd_s, odd_sc = admm_lane.ruiz_equilibrate_lane(odd, settings.scaling)
    odd_rho = _rho_vec(torch.full((200,), settings.rho, device="cuda"),
                       odd_s.l, odd_s.u)
    odd_err = rel_err(
        kkt_factor.factor_packed_lane(odd_s, odd_rho, settings.sigma)[0],
        kkt_factor.factor_packed_lane_plain(odd_s, odd_rho, settings.sigma)[0],
    )[1]
    k_ms = time_ms(lambda: kkt_factor.factor_packed_lane(
        scaled, rho_vec, settings.sigma, coef=coef))
    p_ms = time_ms(lambda: kkt_factor.factor_packed_lane_plain(
        scaled, rho_vec, settings.sigma), reps=5, warm=1)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    b_ms, b_by = bound(nbytes(coef, rho_vec, Pd, Pl, ck),
                       ops_factor(W, N, NX, B))
    out.append(dict(
        name="kkt_factor", max_abs_err=abs_err, max_rel_err=r_err,
        odd_batch_rel_err=odd_err, tol=TOL_FACTOR,
        tol_note="max abs error over max |plain|; f32 reassociation over a "
                 "100-step recurrence",
        kernel_vs_f64=rel_err(ck.double(), c64)[1],
        plain_vs_f64=rel_err(cp.double(), c64)[1],
        ok=bool(r_err <= TOL_FACTOR and odd_err <= TOL_FACTOR),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=f"W={W} N={N} B={B}"))

    # ---- ADMM chunk: 2 iterations + accumulators from a non-trivial state
    # with a mixed done mask; the kernel works in place on its own copy.
    lu = admm_fused.build_lu_pack(scaled)
    term_packs = (packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])
    st = admm_lane.init_state_lane(
        scaled, settings, None, None, scaling,
        rho_bar=torch.full((B,), settings.rho, device="cuda"),
        rho_vec=rho_vec, factor=(ck, None))
    none_done = torch.zeros(B, dtype=torch.bool, device="cuda")
    state0 = admm_fused.pack_state(scaled, st.x, st.z, st.y)
    args = dict(coef=coef, lu=lu, packed_factor=(ck, None))
    admm_fused.fused_admm_chunk(  # 10 kernel iterations from cold
        scaled, rho_vec, none_done, settings, state_pack=state0, n_iter=10,
        **args)
    done = (torch.arange(B, device="cuda") % 5) == 3

    scaled64 = cast(scaled, torch.float64)
    d64 = lambda t: None if t is None else t.double()  # noqa: E731

    def compare(n_iter, tp):
        """Kernel and plain version (both f32) from the same state, and the
        plain version in f64 on the same f32 inputs as the yardstick."""
        sk = state0.clone()
        sk, acck = admm_fused.fused_admm_chunk(
            scaled, rho_vec, done, settings, state_pack=sk,
            term_packs=tp, n_iter=n_iter, **args)
        sp, accp = admm_fused.fused_admm_chunk_plain(
            scaled, rho_vec, done, settings, state_pack=state0,
            term_packs=tp, n_iter=n_iter, **args)
        s64, acc64 = admm_fused.fused_admm_chunk_plain(
            scaled64, d64(rho_vec), done, settings, state_pack=d64(state0),
            term_packs=None if tp is None else tuple(d64(t) for t in tp),
            n_iter=n_iter, packed_factor=(d64(ck), None))
        torch.cuda.synchronize()
        B2, Rp = 2 * N, scaled.rows_per_waypoint_padded
        sect = {"x": slice(0, B2), "z": slice(B2, B2 + Rp),
                "y": slice(B2 + Rp, B2 + 2 * Rp)}
        errs = {k: rel_err(sk[:, s], sp[:, s]) for k, s in sect.items()}
        vs64 = {k: (rel_err(sk[:, s].double(), s64[:, s])[1],
                    rel_err(sp[:, s].double(), s64[:, s])[1])
                for k, s in sect.items()}
        frozen_same = torch.equal(sk[..., done], state0[..., done])
        acc_errs = {}
        if tp is not None:
            # xsum / ysum cancel thousands of signed terms: their error is
            # held against the sum of magnitudes, not against the sum.
            scales = {"xsum": s64[:, sect["x"]].abs().sum((0, 1)).max().item(),
                      "ysum": s64[:, sect["y"]].abs().sum((0, 1)).max().item()}
            for name, row in _ACC.items():
                sc = scales.get(name)
                acc_errs[name] = rel_err(acck[row], accp[row], sc)
                vs64["acc." + name] = (
                    rel_err(acck[row].double(), acc64[row], sc)[1],
                    rel_err(accp[row].double(), acc64[row], sc)[1])
        return errs, acc_errs, frozen_same, vs64

    def holds(vs):
        """Kernel within TOL_CHUNK of the f64 run (the plain f32 version's
        own distance from it is recorded beside it)."""
        return all(k <= TOL_CHUNK for k, _ in vs.values())

    errs, acc_errs, frozen_same, vs64 = compare(2, term_packs)
    warm_errs, _, warm_frozen, warm_vs64 = compare(
        settings.termination_warmup, None)
    # The same comparison at an odd batch (tail mask).
    odd_packs = admm_lane.build_const_packs(odd_s, odd_sc)
    odd_ck, _ = kkt_factor.factor_packed_lane(odd_s, odd_rho, settings.sigma)
    odd_st = torch.zeros((W, admm_fused.state_rows(odd_s)[1], 200), device="cuda")
    odd_args = dict(coef=odd_packs["coef"], lu=admm_fused.build_lu_pack(odd_s),
                    packed_factor=(odd_ck, None),
                    term_packs=(odd_packs["EEinv"], odd_packs["varc"],
                                odd_packs["Pdp"], odd_packs["Plf"]))
    odd_done = torch.zeros(200, dtype=torch.bool, device="cuda")
    ok_, oacc = admm_fused.fused_admm_chunk(
        odd_s, odd_rho, odd_done, settings, state_pack=odd_st.clone(), **odd_args)
    op_, oaccp = admm_fused.fused_admm_chunk_plain(
        odd_s, odd_rho, odd_done, settings, state_pack=odd_st, **odd_args)
    odd_err = max(rel_err(ok_, op_)[1],
                  max(rel_err(oacc[r], oaccp[r])[1] for r in _ACC.values()))

    scratch = state0.clone()
    k_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=scratch,
        term_packs=term_packs, n_iter=2, **args))
    warm_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=scratch,
        n_iter=settings.termination_warmup, **args), reps=5, warm=1)
    p_ms = time_ms(lambda: admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0,
        term_packs=term_packs, n_iter=2, **args), reps=5, warm=1)
    q_int = scaled._interleave(scaled.q_vec)
    inputs = nbytes(ck, coef, q_int, lu, rho_vec, *term_packs, done, state0)
    outputs = nbytes(state0) + 24 * B * 4
    b_ms, b_by = bound(inputs + outputs, ops_chunk(W, N, NX, B, 2, True))
    # Bytes one launch really streams: every pass re-reads its packs.
    Tp, CRp, SRp, PNp = ck.shape[1], coef.shape[1], state0.shape[1], 8
    Rp = scaled.rows_per_waypoint_padded
    per_iter = (2 * Tp + 2 * PNp + 2 * CRp + 2 * N + 2 * Rp + 3 * SRp
                + 4 * N + 2 * Rp) * 4 * W * B
    term_extra = (2 * Rp + 40 + PNp) * 4 * W * B
    streamed_ms = (2 * per_iter + term_extra) / HBM_BYTES_PER_S * 1e3
    state_err = max(e[1] for e in errs.values())
    acc_err = max(e[1] for e in acc_errs.values())
    warm_err = max(e[1] for e in warm_errs.values())
    out.append(dict(
        name="admm_chunk",
        max_abs_err=max(e[0] for e in errs.values()),
        max_rel_err=state_err, acc_max_rel_err=acc_err,
        acc_rel_err={k: v[1] for k, v in acc_errs.items()},
        warmup_form_rel_err=warm_err, odd_batch_rel_err=odd_err,
        kernel_and_plain_vs_f64=vs64, warmup_kernel_and_plain_vs_f64=warm_vs64,
        frozen_problems_untouched=bool(frozen_same and warm_frozen),
        tol=TOL_CHUNK,
        tol_note="the kernel (f32, hrec algebra) is held against the plain "
                 "version run in f64 on the same f32 inputs, per section "
                 "(x, z, y) and per accumulator row, as max abs error over "
                 "max |f64| (xsum/ysum: over the sum of magnitudes); the "
                 "plain f32 version's own distance from f64 is recorded "
                 "beside it.  An f32 KKT solve carries about cond(K) * 2^-24 "
                 "in either form, so kernel and plain f32 differ by 2-3e-4 "
                 "while both sit that far from f64; the kernel-vs-plain "
                 "figures (max_abs_err, max_rel_err) are for information",
        ok=bool(holds(vs64) and holds(warm_vs64) and odd_err <= TOL_CHUNK
                and frozen_same and warm_frozen),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, streamed_ms=streamed_ms,
        warmup_form_ms=warm_ms,
        shape=f"W={W} N={N} B={B} n_iter=2 emit_term (warm-up form: "
              f"n_iter={settings.termination_warmup})"))
    out.append(check_chunk_dxdy(
        scaled, scaled64, settings, rho_vec, done, state0, args, ck, q_int,
        lu, NX))
    out.append(check_residuals(scaled, scaling, settings, rho_vec, done,
                               state0, args, packs, lu, NX))
    row, gk = check_factor_gain(scaled, scaled64, rho_vec, settings, coef, ck,
                                NX)
    out.append(row)
    out.append(check_chunk_gain(
        scaled, scaled64, settings, rho_vec, done, state0, args, ck, gk,
        term_packs, q_int, lu, NX))
    out.extend(check_tridiag(scaled, rho_vec, settings))
    for row in out:
        row["ptxas"] = ptxas_of(row["name"], sig)
    emit("kernels", kernels=out)
    bad = [k["name"] for k in out if not k["ok"]]
    if bad:
        fail(f"kernel(s) outside tolerance of the plain version: {bad}")
    return out


def check_chunk_dxdy(scaled, scaled64, settings, rho_vec, done, state0, args,
                     ck, q_int, lu, NX):
    """The chunk's delta-writing form: state and deltas of 2 iterations
    against the plain version run in f64 on the same f32 inputs."""
    B = state0.shape[-1]
    B2, Rp = 2 * N, scaled.rows_per_waypoint_padded
    sk, dk = admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=state0.clone(), n_iter=2,
        emit_dxdy=True, **args)
    sp, dp = admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0, n_iter=2,
        emit_dxdy=True, **args)
    s64, d64 = admm_fused.fused_admm_chunk_plain(
        scaled64, rho_vec.double(), done, settings,
        state_pack=state0.double(), n_iter=2, emit_dxdy=True,
        packed_factor=(ck.double(), None))
    # One iteration: the deltas are against the input state.
    s1, d1 = admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=state0.clone(), n_iter=1,
        emit_dxdy=True, **args)
    _, d1_64 = admm_fused.fused_admm_chunk_plain(
        scaled64, rho_vec.double(), done, settings,
        state_pack=state0.double(), n_iter=1, emit_dxdy=True,
        packed_factor=(ck.double(), None))
    torch.cuda.synchronize()
    sect = {"x": slice(0, B2), "z": slice(B2, B2 + Rp),
            "y": slice(B2 + Rp, B2 + 2 * Rp)}
    dsect = {"dx": (slice(0, B2), "x"), "dy": (slice(B2, B2 + Rp), "y")}
    scale = {k: s64[:, sl].abs().max().item() for k, sl in sect.items()}
    vs64 = {k: (rel_err(sk[:, sl].double(), s64[:, sl])[1],
                rel_err(sp[:, sl].double(), s64[:, sl])[1])
            for k, sl in sect.items()}
    # Deltas: error over the STATE's scale (they shrink as the solve converges).
    for k, (sl, of) in dsect.items():
        vs64[k] = (rel_err(dk[:, sl].double(), d64[:, sl], scale[of])[1],
                   rel_err(dp[:, sl].double(), d64[:, sl], scale[of])[1])
        vs64[k + "_n_iter1"] = (
            rel_err(d1[:, sl].double(), d1_64[:, sl], scale[of])[1], None)
    frozen_zero = bool((dk[..., done] == 0).all() and (d1[..., done] == 0).all()
                       and torch.equal(sk[..., done], state0[..., done]))
    pads_zero = bool((dk[:, B2 + Rp:] == 0).all())
    scratch = state0.clone()
    k_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=scratch, n_iter=2,
        emit_dxdy=True, **args))
    p_ms = time_ms(lambda: admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0, n_iter=2,
        emit_dxdy=True, **args), reps=5, warm=1)
    Plf = kkt_factor.build_p_vel_packs(scaled)[1]
    moved = nbytes(ck, args["coef"], q_int, lu, rho_vec, Plf, done, state0,
                   state0, dk)
    b_ms, b_by = bound(moved, ops_chunk(W, N, NX, B, 2, False))
    worst = max(v[0] for v in vs64.values())
    return dict(
        name="admm_chunk_dxdy",
        max_abs_err=max(rel_err(sk, sp)[0], rel_err(dk, dp)[0]),
        max_rel_err=worst, kernel_and_plain_vs_f64=vs64,
        frozen_problems_zero_and_untouched=frozen_zero,
        pad_rows_zero=pads_zero, tol=TOL_CHUNK,
        tol_note="state sections and the deltas dx, dy of the last of 2 "
                 "iterations (and of a single iteration) against the plain "
                 "version run in f64 on the same f32 inputs, as max abs error "
                 "over max |f64 state section| (an f32 KKT solve carries "
                 "about cond(K) * 2^-24 in either form); max_abs_err is "
                 "kernel against plain f32, for information",
        ok=bool(worst <= TOL_CHUNK and frozen_zero and pads_zero),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"W={W} N={N} B={B} n_iter=2 emit_dxdy")


def check_residuals(scaled, scaling, settings, rho_vec, done, state0, args,
                    packs, lu, NX):
    """The streaming residual kernel on the packs the delta-writing chunk
    produced, against its plain version on the same packs."""
    B = state0.shape[-1]
    sp, dp = admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=state0.clone(), n_iter=2,
        emit_dxdy=True, **args)
    rowc = torch.cat([packs["EEinv"], lu], dim=1)
    rp = (rowc, packs["varc"], packs["Pdp"], packs["Plf"], packs["norm_Dq"],
          scaling.cinv)
    coef = args["coef"]

    def kernel_acc(state):
        acc = torch.empty((24, B), dtype=torch.float32, device="cuda")
        residuals._launch_residuals(
            _build.library("residuals", admm_fused.layout_signature(scaled)),
            coef, rp[2], rp[3], state, dp, rowc, rp[1], acc)
        return acc

    acck = kernel_acc(sp)
    accp = residuals.termination_accumulators_plain(
        scaled, sp, dp, rowc, rp[1])
    acc64 = residuals.termination_accumulators_plain(
        cast(scaled, torch.float64), sp.double(), dp.double(), rowc.double(),
        rp[1].double())
    tq = residuals.termination_quantities_kernel(scaled, sp, dp, coef, rp)
    torch.cuda.synchronize()
    x, _, y = admm_fused.unpack_state(scaled, sp.double())
    dx, dy = admm_fused.unpack_dxdy(scaled, dp.double())
    Rp = scaled.rows_per_waypoint_padded
    E, Einv, lo, hi = (rowc[:, k * Rp:(k + 1) * Rp].reshape(-1, B).double()
                       for k in range(4))
    edy = E * dy
    tight_u = (Einv * hi) < 1e25
    tight_l = (Einv * lo) > -1e25
    mags = {  # sums are held against the sum of their terms' magnitudes
        "xsum": x.abs().sum(0), "ysum": y.abs().sum(0),
        "q_dot": (scaled.q.double() * dx).abs().sum(0),
        "support": (torch.where(tight_u, Einv * hi * edy.clamp(min=0), 0.0).abs()
                    + torch.where(tight_l, Einv * lo * edy.clamp(max=0), 0.0).abs()
                    ).sum(0),
    }
    errs, vs64 = {}, {}
    for name, row in _ACC.items():
        sc = mags[name].max().item() if name in mags else None
        errs[name] = rel_err(acck[row], accp[row], sc)
        vs64[name] = (rel_err(acck[row].double(), acc64[row], sc)[1],
                      rel_err(accp[row].double(), acc64[row], sc)[1])
    worst_max = max(v[1] for k, v in errs.items() if k not in RESID_SUMS)
    worst_sum = max(v[1] for k, v in errs.items() if k in RESID_SUMS)
    pad_rows_zero = bool((acck[len(_ACC):] == 0).all())
    # A NaN planted in one problem's state must surface as blew_up there,
    # and nowhere else.
    bad = sp.clone()
    bad[W // 2, 3, 7] = float("nan")
    tq_bad = residuals.termination_quantities_kernel(scaled, bad, dp, coef, rp)
    nan_carried = bool(tq_bad.blew_up[7]) and int(tq_bad.blew_up.sum()) == 1
    no_false_alarm = not bool(tq.blew_up.any())
    k_ms = time_ms(lambda: kernel_acc(sp))
    p_ms = time_ms(lambda: residuals.termination_accumulators_plain(
        scaled, sp, dp, rowc, rp[1]), reps=5, warm=1)
    moved = nbytes(coef, rp[2], rp[3], sp, dp, rowc, rp[1], acck)
    b_ms, b_by = bound(moved, ops_residuals(W, N, NX, B))
    return dict(
        name="residuals",
        max_abs_err=max(v[0] for k, v in errs.items() if k not in RESID_SUMS),
        max_rel_err=worst_max, sums_max_rel_err=worst_sum,
        acc_rel_err={k: v[1] for k, v in errs.items()},
        kernel_and_plain_vs_f64=vs64, pad_rows_zero=pad_rows_zero,
        nan_carried_to_blew_up=nan_carried, no_false_alarm=no_false_alarm,
        tol=TOL_RESID_MAX, tol_sums=TOL_RESID_SUM,
        tol_note="each of the 18 accumulator rows against the plain version "
                 "on the same f32 packs: maxima as max abs error over max "
                 "|plain| (f32 reassociation in cancelling residuals), the "
                 "four sums (support, q_dot, xsum, ysum) over the sum of "
                 "their terms' magnitudes (they cancel thousands of signed "
                 "terms, summed in another order)",
        ok=bool(worst_max <= TOL_RESID_MAX and worst_sum <= TOL_RESID_SUM
                and pad_rows_zero and nan_carried and no_false_alarm),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"W={W} N={N} B={B}")


# Where each kernel row's registers and spills are read: (source, entry
# function name as ptxas prints it, demangled prefix).
PTXAS = {
    "ruiz": ("ruiz", "ruiz_"),
    "kkt_factor": ("kkt_factor", "kkt_factor_kernel"),
    "kkt_factor_gain": ("kkt_factor", "kkt_factor_kernel"),
    "admm_chunk": ("admm_chunk", "admm_chunk_kernelILi1ELb0E"),
    "admm_chunk_dxdy": ("admm_chunk", "admm_chunk_kernelILi2ELb0E"),
    "admm_chunk_gain": ("admm_chunk", "admm_chunk_kernelILi"),
    "residuals": ("residuals", "residuals"),
    "tridiag_factor": ("tridiag", "tridiag_factor_kernel"),
    "tridiag_solve": ("tridiag", "tridiag_solve_kernel"),
}


def ptxas_of(name, sig):
    """Registers / stack / spills of a kernel row's entry functions, from
    the saved ``-Xptxas -v`` output of its build (the gain row: the three
    ``GAIN = true`` instantiations)."""
    source, prefix = PTXAS[name]
    if source == "tridiag":
        sig = {"B2": 2 * N}
    _, path = _build._target(source, sig, False)
    rep = _build.ptxas_report(path)
    gain_only = name == "admm_chunk_gain"
    return {k[:40]: v for k, v in rep.items()
            if k.startswith(prefix) and (not gain_only or "Lb1E" in k[:40])}


def check_factor_gain(scaled, scaled64, rho_vec, settings, coef, ck, NX):
    """The factor kernel's gain write (``emit_gain=True``): packed chol and
    packed G_t against the plain version run in f64 on the same f32 inputs.
    Returns the row and the kernel's gain pack."""
    B = rho_vec.shape[-1]
    sigma = settings.sigma
    cg, gk = kkt_factor.factor_packed_lane(scaled, rho_vec, sigma, coef=coef,
                                           emit_gain=True)
    c64, g64 = kkt_factor.factor_packed_lane_plain(
        scaled64, rho_vec.double(), sigma, emit_gain=True)
    cp, gp = kkt_factor.factor_packed_lane_plain(scaled, rho_vec, sigma,
                                                 emit_gain=True)
    torch.cuda.synchronize()
    errs = {"chol": rel_err(cg.double(), c64), "gain": rel_err(gk.double(), g64)}
    plain_vs_f64 = {"chol": rel_err(cp.double(), c64)[1],
                    "gain": rel_err(gp.double(), g64)[1]}
    chol_as_hrec = bool(torch.equal(cg, ck))
    last_row_zero = bool((gk[-1] == 0).all())
    k_ms = time_ms(lambda: kkt_factor.factor_packed_lane(
        scaled, rho_vec, sigma, coef=coef, emit_gain=True))
    p_ms = time_ms(lambda: kkt_factor.factor_packed_lane_plain(
        scaled, rho_vec, sigma, emit_gain=True), reps=5, warm=1)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    b_ms, b_by = bound(nbytes(coef, rho_vec, Pd, Pl, cg, gk),
                       ops_factor(W, N, NX, B))
    worst = max(e[1] for e in errs.values())
    row = dict(
        name="kkt_factor_gain", max_abs_err=max(e[0] for e in errs.values()),
        max_rel_err=worst, rel_err={k: e[1] for k, e in errs.items()},
        plain_f32_vs_f64=plain_vs_f64, chol_equals_hrec_form=chol_as_hrec,
        last_gain_row_zero=last_row_zero, tol=TOL_FACTOR,
        tol_note="packed chol and packed gain, each as max abs error over max "
                 "|f64| against the plain version run in f64 on the same f32 "
                 "inputs (f32 reassociation over a 100-step recurrence); the "
                 "plain f32 version's own distance is recorded beside it",
        ok=bool(worst <= TOL_FACTOR and chol_as_hrec and last_row_zero),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=f"W={W} N={N} B={B} emit_gain")
    return row, gk


def check_chunk_gain(scaled, scaled64, settings, rho_vec, done, state0, args,
                     ck, gk, term_packs, q_int, lu, NX):
    """The chunk kernel's gain form in its three modes (accumulators at
    n_iter=2, the warm-up form at n_iter=21, deltas at n_iter=2), each
    against the plain version run in f64 on the same f32 inputs."""
    B = state0.shape[-1]
    B2, Rp = 2 * N, scaled.rows_per_waypoint_padded
    gargs = dict(args, packed_factor=(ck, gk))
    f64_args = dict(packed_factor=(ck.double(), gk.double()))
    rho64 = rho_vec.double()
    tp64 = tuple(t.double() for t in term_packs)
    sect = {"x": slice(0, B2), "z": slice(B2, B2 + Rp),
            "y": slice(B2 + Rp, B2 + 2 * Rp)}
    modes = {
        "term": (dict(n_iter=2, term_packs=term_packs),
                 dict(n_iter=2, term_packs=tp64)),
        "plain": (dict(n_iter=settings.termination_warmup),
                  dict(n_iter=settings.termination_warmup)),
        "dxdy": (dict(n_iter=2, emit_dxdy=True), dict(n_iter=2, emit_dxdy=True)),
    }
    vs64, frozen, vs_hrec = {}, True, {}
    for mode, (kw, kw64) in modes.items():
        sk, ek = admm_fused.fused_admm_chunk(
            scaled, rho_vec, done, settings, state_pack=state0.clone(),
            **gargs, **kw)
        sh, _ = admm_fused.fused_admm_chunk(
            scaled, rho_vec, done, settings, state_pack=state0.clone(),
            **args, **kw)
        s64, e64 = admm_fused.fused_admm_chunk_plain(
            scaled64, rho64, done, settings, state_pack=state0.double(),
            **f64_args, **kw64)
        torch.cuda.synchronize()
        scale = {k: s64[:, sl].abs().max().item() for k, sl in sect.items()}
        for k, sl in sect.items():
            vs64[f"{mode}.{k}"] = rel_err(sk[:, sl].double(), s64[:, sl])
            vs_hrec[f"{mode}.{k}"] = rel_err(sk[:, sl], sh[:, sl])[1]
        if mode == "term":
            scales = {"xsum": s64[:, sect["x"]].abs().sum((0, 1)).max().item(),
                      "ysum": s64[:, sect["y"]].abs().sum((0, 1)).max().item()}
            for name, row in _ACC.items():
                vs64[f"term.acc.{name}"] = rel_err(
                    ek[row].double(), e64[row], scales.get(name))
        if mode == "dxdy":
            for k, (sl, of) in {"dx": (slice(0, B2), "x"),
                                "dy": (slice(B2, B2 + Rp), "y")}.items():
                vs64[f"dxdy.{k}"] = rel_err(ek[:, sl].double(), e64[:, sl],
                                            scale[of])
            frozen = frozen and bool((ek[..., done] == 0).all())
        frozen = frozen and torch.equal(sk[..., done], state0[..., done])
    scratch = state0.clone()

    def launch(**kw):
        return lambda: admm_fused.fused_admm_chunk(
            scaled, rho_vec, done, settings, state_pack=scratch, **gargs, **kw)

    k_ms = time_ms(launch(n_iter=2, term_packs=term_packs))
    warm_ms = time_ms(launch(n_iter=settings.termination_warmup), reps=5,
                      warm=1)
    dxdy_ms = time_ms(launch(n_iter=2, emit_dxdy=True))
    hrec_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=scratch,
        term_packs=term_packs, n_iter=2, **args))
    p_ms = time_ms(lambda: admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0,
        term_packs=term_packs, n_iter=2, **gargs), reps=5, warm=1)
    inputs = nbytes(ck, gk, args["coef"], q_int, lu, rho_vec, *term_packs,
                    done, state0)
    b_ms, b_by = bound(inputs + nbytes(state0) + 24 * B * 4,
                       ops_chunk(W, N, NX, B, 2, True))
    worst = max(v[1] for v in vs64.values())
    return dict(
        name="admm_chunk_gain", max_abs_err=max(v[0] for v in vs64.values()),
        max_rel_err=worst, kernel_vs_f64={k: v[1] for k, v in vs64.items()},
        gain_vs_hrec_kernel=vs_hrec, frozen_problems_untouched=frozen,
        tol=TOL_CHUNK,
        tol_note="each mode's state sections (x, z, y), accumulator rows "
                 "(xsum/ysum over the sum of magnitudes) and deltas (over the "
                 "state section's scale) against the plain version run in "
                 "f64 on the same f32 inputs and gain pack, as max abs error "
                 "over max |f64|; an f32 KKT solve carries about "
                 "cond(K) * 2^-24, as in the hrec rows",
        ok=bool(worst <= TOL_CHUNK and frozen),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, warmup_form_ms=warm_ms, dxdy_form_ms=dxdy_ms,
        hrec_form_ms_same_call=hrec_ms,
        shape=f"W={W} N={N} B={B} gain; ms: n_iter=2 emit_term (warm-up "
              f"form n_iter={settings.termination_warmup}, dxdy n_iter=2)")


def dense_kkt(diag, lower):
    """The dense ``(B, W*B2, W*B2)`` matrix of a block-tridiagonal batch
    (for the library yardstick only)."""
    Wd, B2, _, B = diag.shape
    M = torch.zeros((B, Wd * B2, Wd * B2), dtype=diag.dtype,
                    device=diag.device)
    for t in range(Wd):
        s = slice(t * B2, (t + 1) * B2)
        M[:, s, s] = diag[t].permute(2, 0, 1)
        if t + 1 < Wd:
            n = slice((t + 1) * B2, (t + 2) * B2)
            low = lower[t].permute(2, 0, 1)
            M[:, n, s] = low
            M[:, s, n] = low.transpose(1, 2)
    return M


def check_tridiag(scaled, rho_vec, settings):
    """The block-tridiagonal factor and solve kernels on the honest class's
    KKT blocks (the unfused path's factor), each against the plain version
    run in f64 on the same f32 inputs; the library yardstick is the dense
    Cholesky of the same matrices and the dense solve on it."""
    diag, lower = (t.contiguous() for t in scaled.kkt_blocks(
        rho_vec, settings.sigma))
    Wd, B2, _, B = diag.shape
    ck, gk = tridiag_kernel.factor_lane_major(diag, lower)
    c64, g64 = tridiag_kernel.factor_lane_major_plain(diag.double(),
                                                      lower.double())
    gen = torch.Generator(device="cuda").manual_seed(0)
    rhs = torch.randn((Wd, B2, B), generator=gen, device="cuda")
    xk = tridiag_kernel.solve_lane_major(ck, gk, rhs)
    x64 = tridiag_kernel.solve_lane_major_plain(ck.double(), gk.double(),
                                                rhs.double())
    # Tail mask, and a planted block that is not positive definite.
    odd = 200
    oc, og = tridiag_kernel.factor_lane_major(
        diag[..., :odd].contiguous(), lower[..., :odd].contiguous())
    odd_err = max(rel_err(oc.double(), c64[..., :odd])[1],
                  rel_err(og.double(), g64[..., :odd])[1])
    bad = diag.clone()
    bad[Wd // 2, :, :, 7] = -torch.eye(B2, device="cuda")
    bc, _ = tridiag_kernel.factor_lane_major(bad, lower)
    low = torch.ones(B2, B2, dtype=torch.bool, device="cuda").tril()
    planted = bc[..., 7][:, low]  # (W, B2(B2+1)/2) of the bad problem
    others = torch.cat([bc[..., :7], bc[..., 8:]], dim=-1)
    nan_only_there = bool(torch.isnan(planted[Wd // 2:]).all()
                          and torch.isfinite(planted[:Wd // 2]).all()
                          and torch.isfinite(others).all())
    torch.cuda.synchronize()
    iu = torch.triu_indices(B2, B2, offset=1, device="cuda")
    upper_zero = bool((ck[:, iu[0], iu[1]] == 0).all())
    f_errs = {"chol": rel_err(ck.double(), c64), "gain": rel_err(gk.double(), g64)}
    s_err = rel_err(xk.double(), x64)
    pc, pg = tridiag_kernel.factor_lane_major_plain(diag, lower)
    plain_vs_f64 = {"chol": rel_err(pc.double(), c64)[1],
                    "gain": rel_err(pg.double(), g64)[1],
                    "x": rel_err(tridiag_kernel.solve_lane_major_plain(
                        ck, gk, rhs).double(), x64)[1]}
    f_ms = time_ms(lambda: tridiag_kernel.factor_lane_major(diag, lower))
    s_ms = time_ms(lambda: tridiag_kernel.solve_lane_major(ck, gk, rhs))
    fp_ms = time_ms(lambda: tridiag_kernel.factor_lane_major_plain(
        diag, lower), reps=5, warm=1)
    sp_ms = time_ms(lambda: tridiag_kernel.solve_lane_major_plain(
        ck, gk, rhs), reps=5, warm=1)
    # Library yardstick: dense Cholesky and solve of the same matrices.
    M = dense_kkt(diag, lower)
    lib_f_ms = time_ms(lambda: torch.linalg.cholesky(M), reps=3, warm=1)
    L = torch.linalg.cholesky(M)
    rhs_d = rhs.permute(2, 0, 1).reshape(B, Wd * B2, 1)
    lib_s_ms = time_ms(lambda: torch.cholesky_solve(rhs_d, L), reps=5, warm=1)
    x_lib = torch.cholesky_solve(rhs_d, L).reshape(B, Wd, B2).permute(1, 2, 0)
    lib_vs_f64 = rel_err(x_lib.double(), x64)[1]
    del M, L
    torch.cuda.empty_cache()
    # The kernels read only the lower triangle of diag (factor) and of chol
    # (solve); chol is written whole, its zero upper triangle included.
    fb_ms, fb_by = bound(tril_bytes(diag) + nbytes(lower, ck, gk),
                         ops_tridiag_factor(Wd, B2, B))
    sb_ms, sb_by = bound(tril_bytes(ck) + nbytes(gk, rhs, xk),
                         ops_tridiag_solve(Wd, B2, B))
    f_worst = max(e[1] for e in f_errs.values())
    note = ("max abs error over max |f64| against the plain version run in "
            "f64 on the same f32 inputs (f32 reassociation along a 100-step "
            "recurrence of 12x12 steps); the plain f32 version's own "
            "distance is recorded beside it")
    shape = f"W={Wd} B2={B2} B={B}"
    return [
        dict(name="tridiag_factor", max_abs_err=max(e[0] for e in f_errs.values()),
             max_rel_err=f_worst, rel_err={k: e[1] for k, e in f_errs.items()},
             plain_f32_vs_f64=plain_vs_f64, odd_batch_rel_err=odd_err,
             upper_triangle_zero=upper_zero, non_spd_gives_nan_there=nan_only_there,
             tol=TOL_TRIDIAG, tol_note=note,
             ok=bool(f_worst <= TOL_TRIDIAG and odd_err <= TOL_TRIDIAG
                     and upper_zero and nan_only_there),
             ms=f_ms, plain_ms=fp_ms, bound_ms=fb_ms, bound_by=fb_by,
             library_ms=lib_f_ms,
             library_note="torch.linalg.cholesky of the dense (B, W*B2, W*B2) "
                          "f32 matrices (same factor: block-bidiagonal)",
             shape=shape),
        dict(name="tridiag_solve", max_abs_err=s_err[0], max_rel_err=s_err[1],
             library_vs_f64=lib_vs_f64, tol=TOL_TRIDIAG, tol_note=note,
             ok=bool(s_err[1] <= TOL_TRIDIAG),
             ms=s_ms, plain_ms=sp_ms, bound_ms=sb_ms, bound_by=sb_by,
             library_ms=lib_s_ms,
             library_note="torch.cholesky_solve on the dense factor",
             shape=shape),
    ]


def cast(qp, dtype):
    return qp.replace(**{k: getattr(qp, k).to(dtype) for k in _ARRAY_FIELDS})


def host_residual_check(qp, res, idx, settings):
    """OSQP's termination criterion recomputed in float64 on the host for
    the problems ``idx``; returns the worst residual/tolerance ratios."""
    sub = cast(qp.replace(**{
        k: getattr(qp, k)[..., idx].cpu() for k in _ARRAY_FIELDS
    }), torch.float64)
    x = res.x[idx].cpu().double().T.contiguous()
    y = res.y[idx].cpu().double().T.contiguous()
    z = res.z[idx].cpu().double().T.contiguous()
    Ax, Px, ATy = sub.A_matvec(x), sub.P_matvec(x), sub.AT_matvec(y)
    amax = lambda v: v.abs().amax(dim=0)  # noqa: E731
    prim = amax(Ax - z)
    dual = amax(Px + sub.q + ATy)
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(amax(Ax), amax(z))
    eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(amax(Px), amax(ATy)), amax(sub.q))
    box = torch.maximum(sub.l - z, z - sub.u).clamp(min=0).amax(dim=0)
    return ((prim / eps_p).max().item(), (dual / eps_d).max().item(),
            box.max().item())


def reset_counts():
    ruiz_kernel.ruiz_equilibrate_lane_kernel.launches = 0
    kkt_factor.factor_packed_lane.launches = 0
    kkt_factor.factor_packed_lane.launches_gain = 0
    admm_fused.fused_admm_chunk.launches = 0
    admm_fused.fused_admm_chunk.launches_dxdy = 0
    admm_fused.fused_admm_chunk.launches_gain = 0
    residuals.termination_quantities_kernel.launches = 0
    tridiag_kernel.factor_lane_major.launches = 0
    tridiag_kernel.solve_lane_major.launches = 0


def read_counts():
    return {
        "ruiz": ruiz_kernel.ruiz_equilibrate_lane_kernel.launches,
        "kkt_factor": kkt_factor.factor_packed_lane.launches,
        "kkt_factor_gain": kkt_factor.factor_packed_lane.launches_gain,
        "admm_chunk": admm_fused.fused_admm_chunk.launches,
        "admm_chunk_dxdy": admm_fused.fused_admm_chunk.launches_dxdy,
        "admm_chunk_gain": admm_fused.fused_admm_chunk.launches_gain,
        "residuals": residuals.termination_quantities_kernel.launches,
        "tridiag_factor": tridiag_kernel.factor_lane_major.launches,
        "tridiag_solve": tridiag_kernel.solve_lane_major.launches,
    }


def solve_phase(name, qp, settings, it_window=None, timed=True, host_check=16,
                need=LANE_KERNELS):
    B = qp.batch
    reset_counts()
    syncs0 = admm_lane.HOST_SYNCS
    res = admm_lane.solve_batched_lane(qp, settings)  # the main path, once
    torch.cuda.synchronize()
    counts = read_counts()
    syncs = admm_lane.HOST_SYNCS - syncs0
    status = res.status.cpu()
    iters = res.iterations.cpu().to(torch.float64)
    n_opt = int((status == int(ExitCode.kOptimal)).sum())
    p50, it_max = int(iters.median()), int(iters.max())
    finite = bool(torch.isfinite(res.x).all() and torch.isfinite(res.y).all())
    idx = torch.linspace(0, B - 1, host_check).long()
    prim_ratio, dual_ratio, box = host_residual_check(qp, res, idx, settings)
    rec = dict(
        batch=B, optimal=n_opt, iterations_p50=p50, iterations_max=it_max,
        launches=counts, host_syncs=syncs, finite=finite,
        shape_x=list(res.x.shape), f64_prim_res_over_eps=prim_ratio,
        f64_dual_res_over_eps=dual_ratio, f64_max_box_violation=box,
        prim_res_max=res.prim_res.max().item(),
        dual_res_max=res.dual_res.max().item(),
    )
    if timed:
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admm_lane.solve_batched_lane(qp, settings)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        rec.update(ms_per_batch=ms, qps_per_s=n_opt / (ms * 1e-3),
                   ms_all=[round(t * 1e3, 3) for t in times])
    emit(name, **rec)
    if n_opt != B:
        fail(f"{name}: {n_opt}/{B} optimal")
    if not finite or list(res.x.shape) != [B, 2 * W * N]:
        fail(f"{name}: solution not finite or of the wrong shape")
    # 2% slack: the solver decides in float32, the host recomputes in f64.
    if prim_ratio > 1.02 or dual_ratio > 1.02 or box > 1e-4:
        fail(f"{name}: float64 recomputation violates OSQP's criterion "
             f"(prim {prim_ratio:.3f}, dual {dual_ratio:.3f}, box {box:.2e})")
    if it_window and not (it_window[0] <= p50 <= it_window[1]
                          and it_max <= it_window[2]):
        fail(f"{name}: iterations p50 {p50} / max {it_max} outside {it_window}")
    if min(counts[k] for k in need) < 1:
        fail(f"{name}: a kernel of the path was never launched: {counts}")
    chunks = -(-(it_max - settings.termination_warmup)
               // settings.check_termination)
    if syncs != chunks:
        fail(f"{name}: {syncs} host syncs for {chunks} chunks")
    rec["result"] = res
    return rec


def phase_solve_unfused_term(honest, bench, fused_rec):
    """The honest class with ``term_fused="off"``: the chunk's delta-writing
    form and the streaming residual kernel decide termination.  Statuses and
    iteration counts must equal the fused path's, problem for problem."""
    settings = dataclasses.replace(bench, term_fused="off")
    rec = solve_phase("solve_unfused_term", honest, settings,
                      it_window=(25, 31, 35), need=UNFUSED_KERNELS)
    ref = (fused_rec["result"] if fused_rec else
           admm_lane.solve_batched_lane(honest, bench))
    res = rec["result"]
    same_status = int((res.status == ref.status).sum())
    same_iters = int((res.iterations == ref.iterations).sum())
    emit("solve_unfused_term_vs_fused", batch=honest.batch,
         same_status=same_status, same_iterations=same_iters,
         max_abs_dx=(res.x - ref.x).abs().max().item(),
         ms_per_batch=rec["ms_per_batch"],
         fused_ms_per_batch=fused_rec.get("ms_per_batch") if fused_rec else None)
    if same_status != honest.batch or same_iters != honest.batch:
        fail("solve_unfused_term: statuses or iteration counts differ from "
             f"the fused path ({same_status}/{same_iters} of {honest.batch} "
             "equal)")
    return rec


# ------------------------------------------------------------------ planner


def ur5e_solver(max_waypoints, obstacles, **settings):
    """The planner of the reference's fleet benchmarks: UR5e, wrist ball
    r=0.15, tool ball r=0.05 (gripper), workspace floor y >= -0.4."""
    INF = 1e30
    return GOMPSolver(
        max_waypoints=max_waypoints, time_step=0.1,
        settings=dataclasses.replace(Settings(), **PLANNER, **settings),
        pos_con=constraints.in_range(N, -2 * math.pi, 2 * math.pi),
        vel_con=constraints.in_range(N, -math.pi, math.pi),
        acc_con=constraints.in_range(N, -800 * math.pi / 180,
                                     800 * math.pi / 180),
        con_3d=constraints.Constraint(lower=np.array([-INF, -0.4, -INF]),
                                      upper=np.full(3, INF)),
        obstacles=obstacles,
        balls=[ur5e.make_ball("back6", 0.15),
               ur5e.make_ball("tool", 0.05, is_gripper=True)],
        segments=10, dtype=torch.float32,
    )


def fleet_queries(B, rng):
    starts = 0.02 * rng.standard_normal((B, N))
    end0 = np.zeros(N)
    end0[0] = math.pi
    return starts, end0[None] + 0.02 * rng.standard_normal((B, N))


def pct(t, q):
    return float(np.percentile(t.cpu().numpy(), q))


def audit_plans(solver, statuses, trajs, horizons, centers=None, radius=None):
    """Exact FK of every ``kOptimal`` plan, recomputed in float64 on the
    host, cut to its winning horizon: the gripper ball inside the workspace
    box, velocities equal to position differences over dt, and (with
    ``centers (B, 3)``) no waypoint and no segment between waypoints of
    either ball inside its OWN sphere's keep-out.  Returns the worst
    margins; negative means violated.  The planner accepted these plans in
    float32 with the slack ``ERROR``; 1e-5 more covers float32 FK."""
    WM = trajs.shape[1] // (2 * N)
    st = statuses.cpu().numpy()
    tr = trajs.cpu().double()
    hz = horizons.cpu().numpy()
    lo = torch.tensor(solver.con_3d.lower, dtype=torch.float64)
    hi = torch.tensor(solver.con_3d.upper, dtype=torch.float64)
    box, clear, dyn = math.inf, math.inf, 0.0
    for b in np.nonzero(st == int(ExitCode.kOptimal))[0]:
        w = int(hz[b])
        q = tr[b, : WM * N].reshape(WM, N)[:w]
        v = tr[b, WM * N:].reshape(WM, N)[:w]
        dyn = max(dyn, (v[:-1] - (q[1:] - q[:-1]) / solver.time_step)
                  .abs().max().item())
        for ball in solver.balls:
            pts = ball.fk_jac_batched(q)[0]  # (w, 3)
            if ball.is_gripper:
                box = min(box, (pts - ball.radius - lo).min().item(),
                          (hi - pts - ball.radius).min().item())
            if centers is not None:
                own = SphereObstacle.create(centers[b], radius)
                _, seg, _ = own.segment_closest(pts)
                d = min(own.distance(pts).min().item(), seg.min().item())
                clear = min(clear, d - (radius + ball.radius))
    return dict(n_audited=int((st == int(ExitCode.kOptimal)).sum()),
                workspace_margin=box, keepout_margin=clear,
                velocity_mismatch=dyn)


class CallTimer:
    """CUDA-event time spent inside named callables of the planner module
    (events around every call, summed after one synchronize)."""

    def __init__(self):
        self.events = collections.defaultdict(list)
        self.saved = []

    def wrap(self, key, fn):
        @functools.wraps(fn)  # keeps the kernel wrappers' launch counters
        def timed(*a, **kw):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*a, **kw)
            t1.record()
            self.events[key].append((t0, t1))
            return out
        return timed

    def patch(self, obj, name, key):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, self.wrap(key, getattr(obj, name)))

    def restore(self):
        for obj, name, fn in reversed(self.saved):
            setattr(obj, name, fn)

    def totals(self):
        torch.cuda.synchronize()
        return {k: dict(ms=sum(a.elapsed_time(b) for a, b in v), calls=len(v))
                for k, v in self.events.items()}


def planner_breakdown(solver, starts, ends):
    """One instrumented search: where its time goes, by CUDA events around
    the planner's calls (solves, QP assembly, re-linearization, exact-FK
    check)."""
    timer = CallTimer()
    timer.patch(planner, "solve_batched_lane", "solves")
    timer.patch(planner, "linearize_workspace", "linearize")
    for name in ("empty_trajectory_qp", "with_horizon_mask",
                 "with_gomp_boxes_masked"):
        timer.patch(planner, name, "assemble")
    make_ok = solver._is_solution_ok_masked_fn
    solver._is_solution_ok_masked_fn = lambda *a, **kw: timer.wrap(
        "exact_fk_check", make_ok(*a, **kw))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_batch_padded(starts, ends)
        totals = timer.totals()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        timer.restore()
        del solver._is_solution_ok_masked_fn
    totals["whole_search_ms"] = wall
    totals["other_ms"] = wall - sum(
        v["ms"] for v in totals.values() if isinstance(v, dict))
    return totals


def run_search(solver, starts, ends, **kw):
    reset_counts()
    p0, h0 = planner.PLANNER_SYNCS, admm_lane.HOST_SYNCS
    out = solver.run_batch_padded(starts, ends, **kw)
    torch.cuda.synchronize()
    return out, read_counts(), dict(
        planner_host_syncs=planner.PLANNER_SYNCS - p0,
        solver_host_syncs=admm_lane.HOST_SYNCS - h0)


def search_summary(out):
    st, _, hz, rounds, iters = out
    hist = collections.Counter(hz.cpu().tolist())
    return dict(
        optimal=int((st == int(ExitCode.kOptimal)).sum()),
        statuses=dict(collections.Counter(st.cpu().tolist())),
        horizons={str(k): hist[k] for k in sorted(hist)},
        scp_rounds_p50=pct(rounds, 50), scp_rounds_max=int(rounds.max()),
        admm_iters_p50=pct(iters, 50), admm_iters_max=int(iters.max()))


def phase_planner_full():
    """``run_batch_padded`` on 1024 UR5e queries, W_max=50, 10 segments, no
    obstacles, stock solver settings but rho/check_termination/scaling."""
    B = BATCH
    solver = ur5e_solver(50, [])
    starts, ends = fleet_queries(B, np.random.default_rng(0))
    out, counts, syncs = run_search(solver, starts, ends)  # the path, once
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_batch_padded(starts, ends)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    summary = search_summary(out)
    audit = audit_plans(solver, out[0], out[1], out[2])
    where = planner_breakdown(solver, starts, ends)
    # The same search with the termination reductions in their own kernel.
    solver.settings = dataclasses.replace(solver.settings, term_fused="off")
    out_u, counts_u, _ = run_search(solver, starts, ends)
    differ = {name: int((a != b).sum()) for name, a, b in zip(
        ("status", "trajectory", "horizon", "scp_rounds", "admm_iters"),
        out, out_u) if name != "trajectory"}
    finite = bool(torch.isfinite(out[1]).all())
    emit("planner_full", batch=B, **summary, ms_per_batch=ms,
         queries_per_s=summary["optimal"] / (ms * 1e-3),
         ms_all=[round(t * 1e3, 1) for t in times], **syncs, launches=counts,
         audit=audit, where_ms=where, unfused_launches=counts_u,
         unfused_differs_in=differ, finite=finite,
         shape_traj=list(out[1].shape))
    if summary["optimal"] != B:
        fail(f"planner_full: {summary['optimal']}/{B} optimal")
    if not 300 <= summary["admm_iters_p50"] <= 460:
        fail(f"planner_full: admm_iters p50 {summary['admm_iters_p50']} "
             "outside 300..460")
    if not finite or list(out[1].shape) != [B, 2 * 50 * N]:
        fail("planner_full: trajectories not finite or of the wrong shape")
    if audit["workspace_margin"] < -(ERROR + 1e-5):
        fail(f"planner_full: exact-FK audit: gripper ball leaves the "
             f"workspace box by {-audit['workspace_margin']:.2e}")
    if audit["velocity_mismatch"] > 0.2:
        fail("planner_full: velocities are not position differences over dt")
    if any(differ.values()):
        fail(f"planner_full: term_fused='off' changed the search: {differ}")
    if min(counts[k] for k in LANE_KERNELS) < 1 or min(
            counts_u[k] for k in UNFUSED_KERNELS) < 1:
        fail(f"planner_full: a kernel of the path was never launched: "
             f"{counts} / {counts_u}")
    return counts


def obstacle_fleet(B):
    """Queries and per-query sphere centres of the reference's fleet example
    (same generator, same order of draws)."""
    rng = np.random.default_rng(0)
    starts, ends = fleet_queries(B, rng)
    centers = np.array([0.0, -0.28, -0.55])[None] + np.stack(
        [0.03 * rng.standard_normal(3) for _ in range(B)])
    return starts, ends, centers


def phase_planner_obstacles():
    """A fleet where every query has its OWN sphere keep-out: the full
    search (W_max=30) and the fixed-horizon planner (W=30)."""
    RADIUS = 0.12
    shared = SphereObstacle.create([0.0, -0.28, -0.55], radius=RADIUS,
                                   dtype=torch.float32)
    solver = ur5e_solver(30, [shared], max_iter=300)

    def stack(centers):
        return [stack_obstacles([
            SphereObstacle.create(c, radius=RADIUS, dtype=torch.float32)
            for c in centers])]

    # The reference example's own eight queries, for comparison with its
    # CPU run.
    s8, e8, c8 = obstacle_fleet(8)
    out8 = solver.run_batch_padded(s8, e8, obstacles=stack(c8))
    emit("planner_obstacles_first8", statuses=out8[0].tolist(),
         horizons=out8[2].tolist(), scp_rounds=out8[3].tolist(),
         admm_iters=out8[4].tolist())

    B = BATCH
    starts, ends, centers = obstacle_fleet(B)
    obs = stack(centers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts, syncs = run_search(solver, starts, ends, obstacles=obs)
    ms = (time.perf_counter() - t0) * 1e3
    audit = audit_plans(solver, out[0], out[1], out[2], centers, RADIUS)
    t0 = time.perf_counter()
    st_l, tr_l, it_l = solver.run_batch_lane(starts, ends, waypoints=30,
                                             obstacles=obs)
    torch.cuda.synchronize()
    lane_ms = (time.perf_counter() - t0) * 1e3
    audit_l = audit_plans(solver, st_l, tr_l, torch.full_like(st_l, 30),
                          centers, RADIUS)
    allowed = {int(ExitCode.kOptimal), int(ExitCode.kOptimalInaccurate),
               int(ExitCode.kUnknown)}
    lane_statuses = dict(collections.Counter(st_l.cpu().tolist()))
    summary = search_summary(out)
    emit("planner_obstacles", batch=B, **summary, ms_first_search=ms, **syncs,
         launches=counts, audit=audit,
         lane=dict(statuses=lane_statuses, scp_iters_p50=pct(it_l, 50),
                   scp_iters_max=int(it_l.max()), ms=lane_ms, audit=audit_l))
    if not set(summary["statuses"]) | set(lane_statuses) <= allowed:
        fail(f"planner_obstacles: unexpected status in {summary['statuses']} "
             f"/ {lane_statuses}")
    if summary["optimal"] < 1:
        fail("planner_obstacles: no query is kOptimal")
    for name, a in (("search", audit), ("fixed horizon", audit_l)):
        if a["keepout_margin"] < -(ERROR + 1e-5):
            fail(f"planner_obstacles ({name}): a kOptimal plan enters its "
                 f"own sphere's keep-out by {-a['keepout_margin']:.2e}")
        if a["workspace_margin"] < -(ERROR + 1e-5):
            fail(f"planner_obstacles ({name}): gripper ball leaves the "
                 f"workspace box by {-a['workspace_margin']:.2e}")
    if not bool(torch.isfinite(out[1]).all() and torch.isfinite(tr_l).all()):
        fail("planner_obstacles: trajectories not finite")


# ---------------------------------------------------------------- fleet MPC


def fleet_deltas(ticks):
    """Per-tick goal shifts of ``benchmarks/mpc_fleet.py``:
    ``2e-4 sin(0.3 t + j)`` for joint j, the same for every controller."""
    t = torch.arange(ticks, dtype=torch.float32, device="cuda")[:, None, None]
    j = torch.arange(N, dtype=torch.float32, device="cuda")[None, :, None]
    return 2e-4 * torch.sin(0.3 * t + j)


def shift_at(index):
    """The benchmark's per-tick update: shift waypoint ``index``'s position
    bounds (values only)."""
    def shift(base, d):
        pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
        pos_l[index] += d
        pos_u[index] += d
        return base.replace(pos_l=pos_l, pos_u=pos_u)
    return shift


def fleet_breakdown(sess, deltas, shift, settings, fused):
    """One instrumented scan: where a tick's time goes, by CUDA events
    around the calls of the solve loop (chunk kernel, or the unfused
    iteration with its tridiagonal solve inside and the termination pass;
    the termination decision; the per-solve ``l``/``u`` pack; the tick's
    bounds update).  ``other`` is the whole scan less the outer calls."""
    timer = CallTimer()
    loop = ({"chunk_kernel": (admm_fused, "fused_admm_chunk")} if fused else
            {"unfused_iteration": (admm_lane, "_iteration"),
             "unfused_termination": (admm_lane, "_termination_quantities")})
    outer = {**loop,
             "decide": (admm_lane, "_termination_decide"),
             "lu_pack": (admm_fused, "build_lu_pack"),
             "bounds_update": (session_lane, "update_bounds_lane_apply")}
    for key, (mod, name) in outer.items():
        timer.patch(mod, name, key)
    timer.patch(tridiag_kernel, "solve_lane_major", "tridiag_solve (inside "
                "unfused_iteration)")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mpc_scan_lane(sess, deltas, shift, settings)
        totals = timer.totals()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        timer.restore()
    totals["whole_scan_ms"] = wall
    totals["other_ms"] = wall - sum(totals[k]["ms"] for k in outer
                                    if k in totals)
    return totals


# The benchmark shifts the LAST waypoint's position rows; with_gomp_boxes
# puts the goal equality at waypoint W-3 and leaves the last two loose.
GOAL = W - 3


def fleet_phase(name, qp, settings, need, ref=None):
    """``setup_lane`` → ``mpc_scan_lane`` over the benchmark's ticks, launch
    and sync counts held to the path's, the scan timed (median of 3 from the
    same session), then guarded bound updates and a short scan that moves
    the real goal."""
    B, T, ct = qp.batch, FLEET_TICKS, settings.check_termination
    fused = admm_lane._use_fused(qp, settings)
    factor_key = "kkt_factor" if fused else "tridiag_factor"
    deltas, shift = fleet_deltas(T), shift_at(-1)
    reset_counts()
    syncs0, refac0 = admm_lane.HOST_SYNCS, admm_lane.RHO_REFACTORS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = setup_lane(qp, settings)  # the main path: setup ...
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    at_setup = read_counts()
    end, (status, iters) = mpc_scan_lane(sess, deltas, shift, settings)  # ... scan
    torch.cuda.synchronize()
    counts = read_counts()
    syncs = admm_lane.HOST_SYNCS - syncs0
    refactors = admm_lane.RHO_REFACTORS - refac0
    st, it = status.cpu(), iters.cpu()
    n_opt = int((st == int(ExitCode.kOptimal)).sum())
    chunks = sum(-(-int(m) // ct) for m in it.max(dim=1).values)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mpc_scan_lane(sess, deltas, shift, settings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    scan_s = statistics.median(times)
    where = fleet_breakdown(sess, deltas, shift, settings, fused)
    # What comes out: one more warm solve, checked in f64 on the host.
    _, res = solve_lane(end, settings)
    idx = torch.linspace(0, B - 1, 16).long()
    prim_ratio, dual_ratio, box = host_residual_check(end.base, res, idx,
                                                      settings)
    # Guarded updates: classification-stable (no refactor), then problem 0's
    # goal equality turned into a box (exactly one batch refactor).
    reset_counts()
    s1 = admm_lane.HOST_SYNCS
    stable = update_bounds_lane(end, True, settings,
                                pos_l=end.base.pos_l + 1e-4,
                                pos_u=end.base.pos_u + 1e-4)
    stable_launches = read_counts()[factor_key]
    pos_u = end.base.pos_u.clone()
    pos_u[GOAL, :, 0] += 50.0
    flipped = update_bounds_lane(end, True, settings, pos_u=pos_u)
    flip_launches = read_counts()[factor_key] - stable_launches
    guard_syncs = admm_lane.HOST_SYNCS - s1
    _, res_flip = solve_lane(flipped, settings)
    flip_optimal = int((res_flip.status == int(ExitCode.kOptimal)).sum())
    # The same fleet with the goal equality itself moving (10 ticks).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (gst, git) = mpc_scan_lane(sess, fleet_deltas(10), shift_at(GOAL),
                                  settings)
    torch.cuda.synchronize()
    goal_ms = (time.perf_counter() - t0) * 1e3 / 10
    gst, git = gst.cpu(), git.cpu()
    rec = dict(
        batch=B, ticks=T, row_layout=qp.row_layout, fused=fused,
        factor_form=settings.factor_form, optimal=n_opt, total=B * T,
        tick0_iterations_p50=int(it[0].median()),
        tick0_iterations_max=int(it[0].max()),
        warm_iterations_p50=int(it[1:].median()),
        warm_iterations_max=int(it[1:].max()),
        warm_iterations_hist={str(k): v for k, v in sorted(
            collections.Counter(it[1:].flatten().tolist()).items())},
        ms_per_tick=scan_s / T * 1e3, resolves_per_s=B * T / scan_s,
        where_ms=where,
        scan_ms_all=[t * 1e3 for t in times], setup_ms=setup_ms,
        host_syncs=syncs, chunks=chunks, rho_refactors=refactors,
        launches_at_setup=at_setup, launches=counts,
        shifted_rows_loose=bool((qp.pos_l[-1] <= -1e25).all()
                                and (qp.pos_u[-1] >= 1e25).all()),
        f64_prim_res_over_eps=prim_ratio, f64_dual_res_over_eps=dual_ratio,
        f64_max_box_violation=box,
        guard=dict(stable_factor_launches=stable_launches,
                   stable_factor_kept=stable.factor is end.factor,
                   flip_factor_launches=flip_launches, host_syncs=guard_syncs,
                   flip_then_optimal=flip_optimal),
        goal_moving=dict(ticks=10, optimal=int((gst == 0).sum()),
                         warm_iterations_p50=int(git[1:].median()),
                         warm_iterations_max=int(git[1:].max()),
                         ms_per_tick=goal_ms))
    if ref is not None:
        rec.update(differ_status=int((st != ref[0]).sum()),
                   differ_iterations=int((it != ref[1]).sum()),
                   more_iterations=int((it > ref[1]).sum()),
                   fewer_iterations=int((it < ref[1]).sum()),
                   differ_iterations_at_tick0=int((it[0] != ref[1][0]).sum()))
    emit(name, **rec)
    if n_opt != B * T:
        fail(f"{name}: {n_opt}/{B * T} optimal")
    if prim_ratio > 1.02 or dual_ratio > 1.02 or box > 1e-4:
        fail(f"{name}: float64 recomputation violates OSQP's criterion "
             f"(prim {prim_ratio:.3f}, dual {dual_ratio:.3f}, box {box:.2e})")
    want_ruiz = 1 if qp.row_layout == "waypoint" else 0
    if at_setup["ruiz"] != want_ruiz or counts["ruiz"] != want_ruiz:
        fail(f"{name}: Ruiz kernel launches {counts['ruiz']}, want {want_ruiz}")
    if at_setup[factor_key] != 1 or counts[factor_key] != 1 + refactors:
        fail(f"{name}: {counts[factor_key]} factor launches for 1 setup + "
             f"{refactors} rho adaptations (unguarded updates must not "
             "refactor)")
    if syncs != chunks:
        fail(f"{name}: {syncs} host syncs for {chunks} chunks")
    if fused and counts["admm_chunk"] != chunks:
        fail(f"{name}: {counts['admm_chunk']} chunk launches for {chunks}")
    if not fused and (counts["admm_chunk"] != 0
                      or counts["tridiag_solve"] != chunks * ct):
        fail(f"{name}: unfused path launched the chunk kernel "
             f"{counts['admm_chunk']} times and the tridiagonal solve "
             f"{counts['tridiag_solve']} times for {chunks * ct} iterations")
    gain = fused and settings.factor_form == "gain"
    if (counts["kkt_factor_gain"], counts["admm_chunk_gain"]) != (
            (counts["kkt_factor"], counts["admm_chunk"]) if gain else (0, 0)):
        fail(f"{name}: gain-form launches {counts} do not match the form")
    g = rec["guard"]
    if (g["stable_factor_launches"] != 0 or not g["stable_factor_kept"]
            or g["flip_factor_launches"] != 1 or g["host_syncs"] != 2
            or g["flip_then_optimal"] != B):
        fail(f"{name}: guarded updates: {g}")
    if min(counts[k] for k in need) < 1:
        fail(f"{name}: a kernel of the path was never launched: {counts}")
    rec["result"] = (st, it)
    return rec


def phase_fleet(want, launches):
    honest = build_honest_batch(BATCH, W, N, torch.float32, "cuda")
    base = dataclasses.replace(Settings(), **FLEET)
    ref = None
    if "mpc_fleet" in want:
        ref = fleet_phase("mpc_fleet", honest, base, LANE_KERNELS)["result"]
    if "mpc_fleet_gain" in want:
        rec = fleet_phase("mpc_fleet_gain", honest,
                          dataclasses.replace(base, factor_form="gain"),
                          GAIN_KERNELS, ref)
        launches.update({k: rec["launches"][k]
                         for k in ("kkt_factor_gain", "admm_chunk_gain")})
    if "mpc_fleet_unfused" in want:
        rec = fleet_phase("mpc_fleet_unfused", honest,
                          dataclasses.replace(base, fused_chunk="off"),
                          ("ruiz",) + TRIDIAG_KERNELS, ref)
        launches.update({k: rec["launches"][k] for k in TRIDIAG_KERNELS})
        fleet_phase("mpc_fleet_unfused_type",
                    honest.replace(row_layout="type"), base, TRIDIAG_KERNELS,
                    ref)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of: " + PHASES)
    ap.add_argument("--out", default=None, help="also write records here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is "
              "false", file=sys.stderr)
        sys.exit(2)
    full = opts.phases == "all"
    want = set(PHASES.split(",")) if full else set(opts.phases.split(","))
    t_start = time.time()
    torch.manual_seed(0)
    phase_device()
    # Layout signatures: honest class and the sphere fleet (two balls, one
    # obstacle), box-only, and the obstacle-free planner (gripper rows only).
    honest_sig = {"NDIM": N, "NX": 5}
    if "build" in want:
        sigs = [honest_sig, {"B2": 2 * N}]
        if "box" in want:
            sigs.append({"NDIM": N, "NX": 0})
        if "planner_full" in want:
            sigs.append({"NDIM": N, "NX": 3})
        phase_build(sigs)
    kernels = phase_kernels() if "kernels" in want else []
    bench = dataclasses.replace(Settings(), **BENCH)
    launches = {}
    fused_rec = None
    if want & {"solve", "solve_unfused_term"}:
        honest = build_honest_batch(BATCH, W, N, torch.float32, "cuda")
    if "solve" in want:
        fused_rec = solve_phase("solve", honest, bench, it_window=(25, 31, 35))
        launches.update({k: fused_rec["launches"][k] for k in LANE_KERNELS})
    if "solve_unfused_term" in want:
        rec = phase_solve_unfused_term(honest, bench, fused_rec)
        launches.update({k: rec["launches"][k]
                         for k in ("admm_chunk_dxdy", "residuals")})
    if "solve_stock" in want:
        stock = build_honest_batch(256, W, N, torch.float32, "cuda")
        rec = solve_phase("solve_stock", stock, Settings(), timed=False)
        if rec["launches"]["kkt_factor"] < 2:
            fail("solve_stock: the rho-adaptation refactor never launched "
                 "the factor kernel again")
    if "box" in want:
        box = build_box_batch(BATCH, W, N, torch.float32, "cuda")
        solve_phase("box", box, bench, timed=False)
    if "planner_full" in want:
        phase_planner_full()
    if "planner_obstacles" in want:
        phase_planner_obstacles()
    if want & {"mpc_fleet", "mpc_fleet_gain", "mpc_fleet_unfused"}:
        phase_fleet(want, launches)

    csrc = "osqp_solver_tpu_torch/csrc/"
    ops = "osqp_solver_tpu/ops/"
    sources = {
        "ruiz": (csrc + "ruiz.cu", ops + "ruiz_pallas.py:433"),
        "kkt_factor": (csrc + "kkt_factor.cu", ops + "kkt_factor_pallas.py:312"),
        "admm_chunk": (csrc + "admm_chunk.cu", ops + "admm_fused.py:1130"),
        "admm_chunk_dxdy": (csrc + "admm_chunk.cu", ops + "admm_fused.py:1130"),
        "residuals": (csrc + "residuals.cu", ops + "residuals_pallas.py:470"),
        "kkt_factor_gain": (csrc + "kkt_factor.cu",
                            ops + "kkt_factor_pallas.py:312"),
        "admm_chunk_gain": (csrc + "admm_chunk.cu", ops + "admm_fused.py:1130"),
        "tridiag_factor": (csrc + "tridiag.cu", ops + "pallas_tridiag.py:426"),
        "tridiag_solve": (csrc + "tridiag.cu", ops + "pallas_tridiag.py:243"),
    }
    table = []
    for k in kernels:
        src, replaces = sources[k["name"]]
        table.append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(k["name"], 0),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    RECORDS["seconds_total"] = round(time.time() - t_start, 1)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(RECORDS, f, indent=1)
    if full and any(t["launches"] < 1 for t in table):
        fail("a kernel of the main path was launched no time on its path")
    print(json.dumps({"seconds_total": RECORDS["seconds_total"]}), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(RECORDS["device"]["nvidia_smi"], flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
