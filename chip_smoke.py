#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``osqp_solver_tpu_torch``).

Run it from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``osqp_solver_tpu_torch/csrc`` (six
sources and the fast-math check; three layout signatures of the lane kernels, the Ruiz and residual
kernels also in their block-P form, the tridiagonal one at B2=8 to 600,
the lane sources also at N=4, 7, 9, 10, 12, 16, 17, 24, 32, 40, 64, 100,
256 and 300, and the dense one; all
compilers started together), holds each kernel — the
chunk kernel in its accumulator, warm-up and delta-writing forms, each in
the ``hrec`` and the ``gain`` factor form, the factor kernel with and
without its gain write, the block-tridiagonal factor and solve, the dense
Cholesky factor and solve, and the block-P forms of Ruiz and the residual
kernel with the gain chunk fed ``pack_factor`` of the block-tridiagonal
factor — against its plain PyTorch version on the card at its main path's
shape (honest GOMP class, W=100, N=6, B=1024; dense QPs n=64, m=96, B=1024,
and the dense kernels also at n=160, 512 and 2048; float32; the chunk
kernel also at B=1022, where its last block of 4 problems is half empty),
times both (the Ruiz and factor kernels also alone, on packs built
beforehand, at B=8, and at the edges of their launch plans: B=1022, W=4,
W=50, and Ruiz with its rows in device memory; the tridiagonal factor and
solve alone at B=1024, 1022, 8 and 1 and at W=10 (the factor also at W=50),
and the solve with w_t in device memory, and both at B2=18, 20, 22, 24, 28
and 32 (N=9 to 16; W=100, B=1024) and at B=1, W=802 (each launch repeated:
equal bits); the
residual kernel alone at B=1024, 1022 and 8; and the rounded square root,
reciprocal and division they share, bit for bit against ``sqrtf`` and the
division on every float from 2^-100 to 2^100 and many quotients), then
drives the port's entry points:

* ``solve_batched_lane`` on a 1024-problem honest batch (``solve``), the same
  with ``term_fused="off"`` (``solve_unfused_term``: delta-writing chunk +
  streaming residual kernel, counts equal to ``solve``, and the two forms'
  termination accumulators equal bit for bit), a 256-problem batch
  with stock settings (ρ adaptation refactors) and a box-only batch;
* ``solve_batched_lane`` on W=3 batches (``solve_w3``: box-only and honest,
  B=1024), below the Ruiz kernel's 4 waypoints: Ruiz in plain torch, as the
  reference gates its kernel, the factor and chunk kernels as at any W;
* ``GOMPSolver.run_batch_padded``, the full time-scaling search, on 1024
  UR5e queries at W_max=50 (``planner_full``; fused and unfused termination
  give equal results, and so do, bit for bit, the accumulators of every
  fused termination chunk of a search and those of the delta form +
  residual kernel; every plan audited by exact FK in float64 on the host);
* ``run_batch_padded`` and ``run_batch_lane`` on a fleet with per-query
  sphere keep-outs (``planner_obstacles``; every optimal plan audited
  against its own sphere);
* ``setup_lane`` → ``mpc_scan_lane`` on the fleet of
  ``benchmarks/mpc_fleet.py`` (1024 controllers x 50 ticks, honest class)
  in the default ``hrec`` form (``mpc_fleet``), with ``factor_form="gain"``
  (``mpc_fleet_gain``) and on the unfused path with its tridiagonal kernels,
  reached by ``fused_chunk="off"`` and by the ``"type"`` row layout
  (``mpc_fleet_unfused``), with guarded bound updates;
* the generic path: ``ops/admm.py::solve_batched`` on BASELINE config 2
  (1024 dense random box QPs, n=64, m=96: ``dense``), ``ops/session.py``'s
  ``setup`` → ``mpc_scan`` on config 4 (1000 bound shifts of an n=8 QP:
  ``dense_session``), and on the trajectory container ``solve`` (config 1,
  W=10) and a session (config 4b, the honest W=100 QP, 200 goal shifts:
  ``trajectory_generic``), held to the JAX package's iteration counts on the
  same problems (``tools/jax_reference_counts.py``);
* the block-P lane path: ``solve_batched_lane`` on the honest class with a
  seeded objective that fills every ``P_diag`` block and the upper triangle
  of every ``P_lower`` block (``solve_block_p``, held to the JAX f32
  counts), on the unchanged honest batch declared ``p_structure="block"``
  (``solve_block_p_declared``), and ``setup_lane`` → ``mpc_scan_lane`` on
  the block-P batch with a moving goal (``mpc_fleet_block_p``); no plain
  version may run on the card there;
* the single-query planner on sessions over the trajectory container: the
  reference example (``solver-example.cpp``: UR5e, W_max=802, 10 segments,
  stock settings) through ``GOMPSolver.run`` and ``run_padded``
  (``planner_run``: kOptimal, exact-FK audit, start and goal FK, the two
  ``.data`` files), and ``run_batch`` against ``run_batch_lane`` on
  256 fleet queries at W=50 (``planner_batch``);
* the lane kernels above 6 joints (``lane_sizes``): at N=7, 9, 10, 12 and
  16 (a box batch with the honest class's ball rows, W=100, B=1024) every
  lane kernel against its plain version in f64 and repeated bit for bit,
  with its registers and spills, and the lane solve fused (both
  termination forms, equal counts; the gain form) and unfused;
* the lane driver's settings of this slice: ``with_auto_refine``'s
  ``kkt_refine=1`` on the honest class at W=1100 (``solve_refine``: the
  tridiagonal solve twice per iteration) and through ``run_batch_lane`` on
  64 queries of the full search at W=1100 (``planner_long``, held to the
  JAX f32 run), ``polish=True`` fused and unfused (``solve_polish``), and
  ``anderson=4`` fused, with unfused termination, unfused and with ρ
  adaptation firing (``solve_anderson``, held to the JAX f32 run);
* the lane kernels above 16 joints (``lane_wide``): their wide forms at
  N=17, 24, 32, 40 and 64 (W=100, B=256), 100 (W=50, B=64), 256 (W=20,
  B=8) and 300 (W=10, B=8) as ``lane_sizes`` holds them (groups of 64 to
  512 threads, at N=300 each thread owning two columns; from N=64 the
  plans put rings and windows in the device-memory workspace), at N=300
  also a session's setup and one tick and a polished solve (this slice's
  main path: its launches are the kernel table's), at N=32 also with
  their rings and windows forced into the workspace (equal bits), the
  block-P builds and solve at N=17 and 32, the tridiagonal pair alone
  at B2=34, 48, 64, 96, 130, 200, 512 and 600, on chip and in the
  workspace, and at one problem (B2=80, W=100 and B2=512, W=20) with the
  KKT factor at one problem (N=40, W=100 and N=256, W=20), the two
  factors' library yardstick beside each (``torch.linalg.cholesky`` of the
  dense matrices; the solve's ``torch.cholesky_solve``);
* generic DH arms: the presets' float32 kinematics and batched DLS IK
  against float64 on the host (``dh_arms``), and this slice's main path
  (``planner_dh``): the full search of ``benchmarks/planner_batch.py
  --robot iiwa14|scara --full`` on 1024 queries (every query optimal, the
  first 64 held to the JAX f32 run, every plan audited by exact FK in
  float64, and every lane kernel of its N=7 and N=4 builds held to its
  plain version in f64 on the search's first batch) and
  ``examples/dh_robot_example.py``'s problem through ``run``;
* this slice's main path, the user-facing entry points: the port's five
  examples (``osqp_solver_tpu_torch/examples``), each ``main()`` at its
  default flags on the card in a temporary directory (``examples``: the
  solver example in both ``--mode padded`` and ``--mode exact``, its plan
  through ``planner_run``'s checks; each exits 0 by its own criterion and
  launches its path's kernels and no plain version; statuses and horizons
  beside the JAX f32 CPU runs), and ``ConstraintBuilder``'s QPs (256 at
  W=30: the UR5e, two balls, the example's boxes and lines; n=360) solved
  through ``ops/admm.solve_batched`` on the dense kernels in float32 and
  held to the port's float64 CPU solve of a seeded subset
  (``builder_dense``).  The kernel table's launch counts are this path's
  where it launches a kernel, else the earlier phases' (``planner_dh``'s
  first; ``launches_by_path`` gives every path's; each row's ``wide``
  gives its times above 16 joints);
* ``parallel/``, this slice's main path: ``benchmarks/long_horizon.py``'s
  QP (W=10,000, N=6, box rows, ``check_termination=25``) through
  ``ops/admm.solve`` on the plain ``TrajectoryQP`` (the tridiagonal kernels
  at batch 1, W=10,000) and on ``as_chunked(qp)`` (62 chunks: the interiors
  as the kernels' batch), both kOptimal, iterations beside the JAX f32 CPU
  run's and held equal to them, the kernels at W=10,000 and the split's
  KKT solve held to float64 on the host (two wrong splits beside it must
  fail) and timed beside the split's pieces (``horizon_long``); the sharded
  entry points (``solve_batch_sharded`` on ``dense``'s batch,
  ``solve_horizon_sharded`` on that QP with 62 local chunks,
  ``run_batch_padded_sharded`` on ``planner_full``'s queries) in a world of
  one rank over NCCL, held to the one-process calls, and
  ``parallel.multihost``'s command line in a world of one
  (``parallel_one``), and in two ranks spawned on the one card over gloo
  (``--rank-worker``; the horizon as 2 ranks x 31 chunks, collective
  payloads the same at W=5,000 and 10,000), each rank's half held to the
  one-process calls on that half and its statuses to ``parallel_one``'s
  (``parallel_ranks``);
* this slice's main path, the reference example's own size batched: the
  honest class at W=802, B=512 through ``solve_batched_lane`` at
  ``benchmarks/w802_lane.py``'s settings, with the termination fused and
  not (``w802``: every problem optimal, counts equal between the two, the
  first 16 problems' p50 beside the JAX f32 CPU run's, every kernel of the
  path alone at that shape against float64, with its launch plan), and the
  flagship full search of ``benchmarks/planner_batch.py --full --waypoints
  802`` on 512 queries (``planner_w802``: counts held to the JAX package's
  record of the same search and its first 8 queries to the JAX f32 CPU
  run, every plan audited by exact FK).  The Ruiz, KKT factor, chunk and
  residual rows' launches are this path's; the other rows' an earlier
  path's.

It checks statuses, ADMM iteration counts, OSQP's residual criterion
recomputed in float64 on the host, and that every kernel was really launched
by its path.  One JSON line per phase; the last three lines are the kernel
table, the card's name and power limit, and the verdict.  Exits non-zero
without a CUDA device or when any phase fails.  ``--phases build,kernels``
runs a subset; ``--out FILE`` also writes every phase's record to a JSON
file; ``--ref-tree DIR`` (an earlier checkout, e.g. ``git archive 8554bbc |
tar -x -C DIR``) also builds that tree's tridiagonal factor and solve and
residual kernels and runs them on the same inputs, compared bit for bit and
timed (the factor must equal that tree's bit for bit), and its N=6 lane
kernels (Ruiz, the KKT factor in both forms, the chunk in four forms) and
B2=18 and 20 tridiagonal pair, which must equal this tree's bit for bit;
with ``lane_wide`` also its builds up to N=32, whose machine code
(``cuobjdump -sass``) must equal this tree's (the wide builds of the two
factors, redesigned: their tridiagonal solve kernels alone), and its wide
KKT and tridiagonal factors timed beside this tree's on the same inputs
(``ref_ms``).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
from osqp_solver_tpu_torch.models.robot import ball_fk_jac
from osqp_solver_tpu_torch.models import dh_robot, ur5e
from osqp_solver_tpu_torch.utils.types import NoInverseKinematicSolution
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as gadmm
from osqp_solver_tpu_torch.ops import admm_fused, admm_lane, kkt_factor
from osqp_solver_tpu_torch.ops import dense_kernel, session_lane
from osqp_solver_tpu_torch.ops import session as gsession
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
# Dense Cholesky factor and solve (f32 kernel) against the plain version in
# f64 on the same f32 inputs: the tolerances of tests/test_pallas_dense.py.
TOL_DENSE_FACTOR, TOL_DENSE_SOLVE = 2e-4, 2e-3
# The dense rows are timed over this many calls back to back (kernel, plain
# version and library call alike): at ~0.1 ms a single call's time is
# mostly the host's enqueue.
DENSE_INNER = 20
# (n, B) of the dense kernels' large cases: the factor's device-memory
# branch (n > 336) and a size above the earlier solve's n <= 1816.
DENSE_LARGE = ((512, 8), (2048, 2))
RESID_SUMS = ("support", "q_dot", "xsum", "ysum")
PLANNER = dict(rho=0.04, check_termination=3, scaling=3)
# The reference's own problem (solver-example.cpp:13: W_max=802), batched:
# the honest class at W=802 through solve_batched_lane at
# benchmarks/w802_lane.py's settings (w802), and the full search of
# benchmarks/planner_batch.py --full --waypoints 802 --ct 3 --rho 0.02
# --scaling 3 (planner_w802), B=512 each, float32.
W802_W, W802_BATCH = 802, 512
W802_SETTINGS = dict(check_termination=3, rho=0.02, adaptive_rho_interval=60)
PLANNER_W802 = dict(PLANNER, rho=0.02)
# The problems and queries tools/jax_reference_counts.py runs in JAX.
W802_REF_PROBLEMS, PLANNER_W802_REF_QUERIES = 16, 8
LANE_KERNELS = ("ruiz", "kkt_factor", "admm_chunk")
# The block-P lane path: Ruiz and residuals in their block forms, the gain
# chunk fed the packed block-tridiagonal factor.
BLOCK_KERNELS = ("ruiz_block", "tridiag_factor", "admm_chunk_block",
                 "residuals_block")
UNFUSED_KERNELS = LANE_KERNELS + ("admm_chunk_dxdy", "residuals")
GAIN_KERNELS = LANE_KERNELS + ("kkt_factor_gain", "admm_chunk_gain")
TRIDIAG_KERNELS = ("tridiag_factor", "tridiag_solve")
# benchmarks/mpc_fleet.py: 1024 controllers x 50 ticks, honest W=100 class.
FLEET = dict(rho=0.05, check_termination=5, adaptive_rho_interval=51)
FLEET_TICKS = 50
PHASES = ("build,kernels,solve,solve_unfused_term,solve_stock,box,solve_w3,"
          "planner_full,planner_obstacles,mpc_fleet,mpc_fleet_gain,"
          "mpc_fleet_unfused,dense,dense_session,trajectory_generic,"
          "solve_block_p,solve_block_p_declared,mpc_fleet_block_p,"
          "planner_run,planner_batch,lane_sizes,solve_refine,planner_long,"
          "solve_polish,solve_anderson,lane_wide,dh_arms,planner_dh,"
          "examples,builder_dense,horizon_long,parallel_one,parallel_ranks,"
          "w802,planner_w802")
# The block-P fleet: fewer ticks than the vel-diag fleets, for time, at the
# settings the block-P batch is solved at (BENCH) without the warm-up chunk:
# at the fleet benchmark's stock ones (scaling 10, rho 0.05) its cold ticks
# take several times longer and some end kOptimalInaccurate.
BLOCK_FLEET_TICKS = 20
BLOCK_FLEET = dict(BENCH, termination_warmup=0)
RECORDS = {}
OUT = None  # --out: the records are written there, on failure too
# --ref-tree: the root of an earlier checkout of this repository (for
# example ``git archive 8554bbc | tar -x -C DIR``): its tridiagonal factor
# and solve and residual kernels are built beside this tree's and run on the
# same inputs in the kernels phase, compared bit for bit and timed in the
# same call.
REF_TREE = None


def emit(phase, **fields):
    RECORDS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    if OUT:
        with open(OUT, "w") as f:
            json.dump(dict(RECORDS, failed=msg), f, indent=1, default=str)
    sys.exit(1)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps=7, warm=2, inner=1):
    """Median device time of ``fn`` in ms (CUDA events, warmed), each sample
    over ``inner`` calls back to back (more than one keeps the stream busy
    while the host enqueues, so that a call's host overhead is not timed)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_ms(fn):
    """Host time of ``fn`` in ms, the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


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


def ops_ruiz(W, N, NX, B, iters, block=False):
    R = 4 * N + NX
    per_wp = N * (51 + 3 * NX) + 3 * NX * N + 5 * R + 20 * N
    if block:  # P over full blocks: six sweeps of a 2N x 2N block
        B2 = 2 * N
        per_wp += 12 * B2 * B2 + 14 * B2 - 20 * N
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


def ops_residuals(W, N, NX, B, block=False):
    B2, R = 2 * N, 4 * N + NX
    Rp = -(-R // 8) * 8
    a_rows = 5 * N + N + N + 3 * N + 2 * N * NX
    at = 2 * N * (5 + 2 * NX) + 8 * N
    # P x and P dx: the velocity diagonals, or three full-block products each
    p_ops = 12 * B2 * B2 + 4 * B2 if block else 10 * N
    return W * B * (2 * a_rows + 30 * Rp + at + p_ops + 16 * B2)


def ops_tridiag_factor(W, B2, B):
    gain = B2 * sum(2 * j + 1 for j in range(B2))
    schur = (B2 * (B2 + 1) // 2) * 2 * B2
    chol = sum(2 * j + 1 + (B2 - j - 1) * (2 * j + 1) for j in range(B2))
    return W * B * (gain + schur + chol)


def ops_tridiag_solve(W, B2, B):
    sweep = 2 * B2 * B2 + sum(2 * i + 1 for i in range(B2))
    return 2 * W * B * sweep


def ops_dense_factor(n, B):
    """Right-looking Cholesky: a square root and n-j-1 divides per column,
    a multiply-subtract per entry of the trailing lower triangle."""
    return B * sum(1 + (n - j - 1) + 2 * sum(n - k for k in range(j + 1, n))
                   for j in range(n))


def ops_dense_solve(n, B):
    """Forward axpy sweep and backward dot sweep: one divide per row and a
    multiply-add per strictly-lower entry in each."""
    return B * 2 * sum(1 + 2 * (n - j - 1) for j in range(n))


def dense_factor_bytes(n, B):
    """The lower triangle of M read, all of Lt (zeros included) written."""
    return (n * (n + 1) // 2 + n * n) * B * 4


def dense_solve_bytes(n, B):
    """The lower triangle of Lt and rhs read, x written."""
    return (n * (n + 1) // 2 + 2 * n) * B * 4


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------ generic path: problems
# BASELINE config 2 (benchmarks/run_all.py:107-117): dense random box QPs,
# drawn with numpy (the machine with the card has no JAX) from one seed.
DENSE_N, DENSE_M, DENSE_SEED = 64, 96, 0
# BASELINE config 4 (run_all.py:186-213): 1000 sequential bound shifts,
# all checked; the first 200 of them timed again.
SESSION_STEPS, SESSION_TIMED = 1000, 200
# BASELINE config 4b (run_all.py:215-266), cut from 1000 to 200 goal shifts.
GOAL_STEPS = 200
INF_BOUND = 1e30


def dense_problems(batch, seed=DENSE_SEED, n=DENSE_N, m=DENSE_M):
    """Config 2's problems as float32 numpy arrays, batch-LEADING (the JAX
    package's vmapped layout): ``P = M Mᵀ/n + 0.1 I``, ``q``, ``A``
    standard normal, bounds ``A x0 ± (|e| + 0.1)`` around a random point."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((batch, n, n))
    q = rng.standard_normal((batch, n))
    A = rng.standard_normal((batch, m, n))
    x0 = rng.standard_normal((batch, n))
    margin = np.abs(rng.standard_normal((batch, m))) + 0.1
    P = Mx @ Mx.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    Ax0 = np.einsum("bmn,bn->bm", A, x0)
    return tuple(a.astype(np.float32)
                 for a in (P, q, A, Ax0 - margin, Ax0 + margin))


def session_problem(steps=SESSION_STEPS):
    """Config 4: the n=8 identity QP with box [-1, 1] and the shifts
    ``linspace(0, 0.3)`` of both bounds, float32 numpy."""
    n = 8
    eye = np.eye(n, dtype=np.float32)
    qp = (eye, np.zeros(n, np.float32), eye, -np.ones(n, np.float32),
          np.ones(n, np.float32))
    shifts = np.linspace(0.0, 0.3, steps)[:, None] * np.ones(n)
    return qp, shifts.astype(np.float32)


def shift_box(base, s):
    """Config 4's update: both bounds of every row shifted by ``s``."""
    return base.replace(l=-1.0 + s, u=1.0 + s)


def trajectory_config1(device):
    """Config 1: the W=10, N=6 trajectory QP of ``build_trajectory_batch``
    (problem 0), built in float64 and rounded to float32."""
    from osqp_solver_tpu_torch.gomp import trajectory_qp as tq

    Wc, Nc = 10, 6
    kw = dict(dtype=torch.float64, device=device)
    j = torch.arange(Nc, **kw)
    qp = tq.empty_trajectory_qp(Wc, Nc, (), 0, **kw)
    full = lambda v: torch.full((Nc,), v, **kw)  # noqa: E731
    qp = tq.with_gomp_boxes(
        qp, 0.02 * torch.sin(j), 1.0 + 0.02 * torch.cos(j * 1.3),
        (full(-10.0), full(10.0)), (full(-1.0), full(1.0)),
        (full(-2.0), full(2.0)))
    return qp.map_arrays(lambda a: a.float())


# benchmarks/long_horizon.py: ONE W=10,000, N=6 box-only trajectory QP,
# float32, Settings(check_termination=25); the chunked form at auto_chunks.
HORIZON_W, HORIZON_SETTINGS = 10000, dict(check_termination=25)


def long_horizon_qp(device, waypoints=HORIZON_W):
    """``benchmarks/long_horizon.py``'s problem (start 0, end 1; position
    ±10, velocity ±1, acceleration ±2), built in float64 and rounded to
    float32."""
    from osqp_solver_tpu_torch.parallel.multihost import build_horizon_problem

    qp = build_horizon_problem(waypoints, N, torch.float64, "cpu")
    return qp.map_arrays(lambda a: a.float().to(device))


def trajectory_config4b(device):
    """Config 4b: the honest W=100 UR5e QP (two balls, one line obstacle),
    linearized at the linspace warm start, built in float64 and rounded to
    float32."""
    from osqp_solver_tpu_torch.gomp import trajectory_qp as tq
    from osqp_solver_tpu_torch.gomp.geometry import HorizontalLine
    from osqp_solver_tpu_torch.gomp.trajectory import calc_warm_start_batched

    Wc, Nc, DT = 100, 6, 0.1
    kw = dict(dtype=torch.float64, device=device)
    balls = (ur5e.make_ball("back6", 0.15),
             ur5e.make_ball("tool", 0.05, is_gripper=True))
    start = torch.zeros(Nc, **kw)
    end = torch.tensor([math.pi, 0, 0, 0, 0, 0], **kw)
    full = lambda v: torch.full((Nc,), v, **kw)  # noqa: E731
    acc = 800 * math.pi / 180 * DT**2
    qp = tq.empty_trajectory_qp(Wc, Nc, (False, True), 1, **kw)
    qp = tq.with_gomp_boxes(
        qp, start, end, (full(-2 * math.pi), full(2 * math.pi)),
        (full(-math.pi * DT), full(math.pi * DT)), (full(-acc), full(acc)))
    qp = tq.linearize_workspace(
        qp, balls, [HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15),
                                          **kw)],
        (torch.tensor([-INF_BOUND, -0.4, -INF_BOUND], **kw),
         torch.full((3,), INF_BOUND, **kw)),
        calc_warm_start_batched(start, end, Wc))
    return qp.map_arrays(lambda a: a.float())


def goal_deltas(steps=GOAL_STEPS):
    """Config 4b's per-step goal shifts ``1e-4 sin(k)``, float32 numpy."""
    d = 1e-4 * np.sin(np.arange(steps))[:, None] * np.ones(6)
    return d.astype(np.float32)


def shift_goal(base, d):
    """Config 4b's update (``apply_goal_shift``): the LAST waypoint's
    position bounds move by ``d`` (rows that are loose, +-1e30)."""
    pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
    pos_l[-1] += d
    pos_u[-1] += d
    return base.replace(pos_l=pos_l, pos_u=pos_u)


# ------------------------------------------------ block-P lane batch
# The objective of the block-P phases: the GOMP smoothness term plus a
# seeded sum of squares that fills every entry of each P_diag block and the
# upper triangle of each P_lower block (rows of waypoint t+1, columns of t).
# With s = (q_scale on the N positions, 1 on the N velocities) of a waypoint:
#   sum_t 1/2 (s x_t)' M_t M_t' (s x_t)
#   + sum_{t, r} 1/2 w ((s x_{t+1})[r] - sum_{c >= r} beta_{t,r,c} (s x_t)[c])^2.
# PSD by construction; the coupling blocks are upper-triangular, the side on
# which the packed gain of admm_fused.pack_factor is exact (ROADMAP.md,
# queue C).  The weights keep the honest class's statuses (1024/1024 optimal
# in the JAX package) and its float32 iteration counts stable: heavier
# weights, on the positions above all, lengthen the solves several times
# and leave many problems' counts to float32 rounding.
BLOCK_P_SEED, BLOCK_P_M, BLOCK_P_W, BLOCK_P_Q = 5, 0.03, 0.03, 0.03


def block_p_terms(W, N, B, seed=BLOCK_P_SEED, m_scale=BLOCK_P_M,
                  w=BLOCK_P_W, q_scale=BLOCK_P_Q):
    """The sum of squares above as its Hessian blocks, float64 numpy,
    batch-trailing: ``(dP_diag (W, 2N, 2N, B), dP_lower (W-1, 2N, 2N, B))``
    (``M_t`` entries ``m_scale`` x standard normal, ``beta`` uniform in
    [-1, 1] on and above the diagonal)."""
    rng = np.random.default_rng(seed)
    B2 = 2 * N
    M = m_scale * rng.standard_normal((W, B2, B2, B))
    beta = rng.uniform(-1.0, 1.0, (W - 1, B2, B2, B))
    beta *= np.triu(np.ones((B2, B2)))[None, :, :, None]
    dPd = np.einsum("tikb,tjkb->tijb", M, M)
    dPd[1:] += w * np.eye(B2)[None, :, :, None]
    dPd[:-1] += w * np.einsum("trib,trjb->tijb", beta, beta)
    s = np.r_[np.full(N, q_scale), np.ones(N)]
    ss = np.outer(s, s)[None, :, :, None]
    return dPd * ss, -w * beta * ss


def with_block_p(qp, seed=BLOCK_P_SEED):
    """A float64 lane batch with :func:`block_p_terms` added to its P,
    declared ``p_structure="block"``."""
    dPd, dPl = block_p_terms(qp.waypoints, qp.n_dim, qp.batch, seed)
    kw = dict(dtype=qp.dtype, device=qp.device)
    return qp.replace(P_diag=qp.P_diag + torch.as_tensor(dPd, **kw),
                      P_lower=qp.P_lower + torch.as_tensor(dPl, **kw),
                      p_structure="block")


def block_p_batch(batch, device):
    """The honest class with the block-P objective, built in float64 on the
    CPU and rounded to float32 (the numbers ``tools/jax_reference_counts.py``
    hands to the JAX package), then moved to ``device``."""
    qp = with_block_p(build_honest_batch(batch, W, N, torch.float64, "cpu"))
    return cast(qp, torch.float32).to(device)


ITER_DIGITS = ("0123456789abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ")


def encode_iters(iters, ct, offset=0):
    """Iteration counts (``offset`` plus multiples of ``ct``: a warm-up
    chunk of ``termination_warmup`` iterations puts the checks at odd
    counts) as one digit each, ``(k - offset) // ct`` in base 62 (0-9, a-z,
    A-Z)."""
    return "".join(ITER_DIGITS[(int(k) - offset) // ct] for k in iters)


def decode_iters(code, ct, offset=0):
    return [ITER_DIGITS.index(ch) * ct + offset for ch in code]


def encode_statuses(status):
    """Exit codes (0..10) as one digit each."""
    return "".join(ITER_DIGITS[int(s)] for s in status)


def decode_statuses(code):
    return [ITER_DIGITS.index(ch) for ch in code]


# Lane batches below the Ruiz kernel's 4 waypoints (the reference's gate):
# the shortest horizon GOMP's builders make.
W3 = 3


def w3_batch(kind, device):
    """A W=3 lane batch of BATCH problems (``"box"``: box-only, all optimal;
    ``"honest"``: the honest class, primal infeasible in three steps), built
    in float64 on the CPU and rounded to float32 (the numbers
    ``tools/jax_reference_counts.py`` hands to the JAX package), then moved
    to ``device``."""
    build = {"box": build_box_batch, "honest": build_honest_batch}[kind]
    return cast(build(BATCH, W3, N, torch.float64, "cpu"),
                torch.float32).to(device)


# The lane driver's settings of this slice.  Anderson
# acceleration at the cadence of the reference's own tests
# (tests/test_admm_lane.py), and with ρ adaptation firing (its :461).
ANDERSON = dict(anderson=4, check_termination=3)
ANDERSON_RHO = dict(ANDERSON, rho=10.0, adaptive_rho_interval=6)
# Long horizons: float32 above 1024 waypoints takes one refinement step per
# KKT solve (with_auto_refine).
LONG_W, LONG_QUERIES, REFINE_BATCH = 1100, 64, 256


def honest_f32(batch, Wd, device):
    """The honest class built in float64 on the CPU and rounded to float32
    (the numbers ``tools/jax_reference_counts.py`` hands to the JAX
    package), then moved to ``device``."""
    return cast(build_honest_batch(batch, Wd, N, torch.float64, "cpu"),
                torch.float32).to(device)


def long_queries():
    """The first LONG_QUERIES queries of the full search (planner_full's,
    ``bench.py:321-344``)."""
    return fleet_queries(LONG_QUERIES, np.random.default_rng(0))


# -------------------------------------------------------------------- phases


def phase_device():
    emit("device", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())


def ref_signatures(want=()):
    """The sources and signatures built from --ref-tree: the N=6 lane
    kernels, the tridiagonal pair at every B2 of TRIDIAG_SIZES up to 32 and,
    with ``lane_sizes`` in ``want``, the Ruiz, factor and chunk kernels at
    every N of LANE_SIZES."""
    lane = {"NDIM": N, "NX": 5}
    out = [("tridiag", {"B2": 2 * N}), ("residuals", dict(lane, BLOCK_P=0)),
           ("residuals", dict(lane, BLOCK_P=1)),
           ("ruiz", dict(lane, BLOCK_P=0)), ("kkt_factor", lane),
           ("admm_chunk", lane)]
    out += [("tridiag", {"B2": b2}) for b2 in sorted(
        {b2 for b2, _, _ in TRIDIAG_SIZES.values() if 2 * N < b2 <= 32})]
    if "lane_sizes" in want:
        for n in LANE_SIZES:
            sz = {"NDIM": n, "NX": 5}
            out += [("ruiz", dict(sz, BLOCK_P=0)), ("kkt_factor", sz),
                    ("admm_chunk", sz)]
    if "lane_wide" in want:  # the wide builds up to N=32: their machine code
        for n in (s_ for s_ in WIDE_SIZES if s_ <= 32):
            sz = {"NDIM": n, "NX": 5}
            out += [("ruiz", dict(sz, BLOCK_P=0)), ("admm_chunk", sz),
                    ("residuals", dict(sz, BLOCK_P=0))]
        # The two factors' wide builds, timed beside this tree's (their
        # wide forms were redesigned: no machine code to compare).
        out += [("kkt_factor", {"NDIM": n, "NX": 5}) for n in WIDE_SIZES]
        out += [("tridiag", {"B2": b2}) for b2 in sorted(
            {2 * n for n in WIDE_SIZES} | {b2 for b2, _, _ in
                                            WIDE_TRIDIAG.values()})]
    return out


def same_code_expected(name, sig):
    """Whether a --ref-tree build must compile to this tree's machine code:
    every build but the wide forms (2N or B2 above 32) of the KKT factor
    and the tridiagonal pair, whose factors were redesigned (the latter's
    solve kernels must still be equal)."""
    size = 2 * sig["NDIM"] if "NDIM" in sig else sig.get("B2", 0)
    return not (name in ("kkt_factor", "tridiag") and size > 32)


def sass_lines(path):
    """The functions and instructions of ``cuobjdump -sass`` of a library
    (found beside the nvcc that built it, or on PATH), each line's runs of
    spaces made one (the listing pads its columns to the widest
    instruction of the whole library, so a kernel added beside another
    moves the other's columns).  Fails the run where cuobjdump cannot be
    found."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        tool = shutil.which("cuobjdump")
        if tool is None:
            fail("build: --ref-tree compares machine code with cuobjdump, "
                 "which is neither beside nvcc nor on PATH")
    return [" ".join(ln.split()) for ln in subprocess.run(
        [str(tool), "-sass", str(path)], capture_output=True, text=True,
        check=True).stdout.splitlines() if "/*" in ln or "Function :" in ln]


def sass_differs(a, b, only=None):
    """Whether two libraries' device code differs, line for line; ``only``:
    the functions whose names hold that text alone (each library's must be
    there)."""
    code = [sass_lines(p_) for p_ in (a, b)]
    if only is not None:
        code = [[ln for fn, lines in sorted(sass_functions(c).items())
                 if only in fn for ln in lines] for c in code]
        if not code[0]:
            return True
    return code[0] != code[1]


def sass_functions(lines):
    """``sass_lines`` split by function: ``{name: its lines}``."""
    out, name = {}, None
    for ln in lines:
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
        out.setdefault(name, []).append(ln)
    return out


def ref_csrc():
    return Path(REF_TREE) / "osqp_solver_tpu_torch" / "csrc"


@functools.lru_cache(maxsize=None)
def ref_library(name, sig_items):
    """A kernel library of --ref-tree (built in the build phase)."""
    return ctypes.CDLL(str(_build.finish_build(
        _build.start_build(name, dict(sig_items), csrc=ref_csrc()))))


def phase_build(signatures, want=()):
    t0 = time.time()
    ref = [(n, s, _build.start_build(n, s, csrc=ref_csrc()))
           for n, s in (ref_signatures(want) if REF_TREE else [])]
    # This tree's builds of every --ref-tree signature too: their machine
    # code is compared below.
    built = _build.build_all(list(signatures) + [s for _, s, _ in ref])
    sass = {}
    for n, s, h in ref:
        key = tuple(sorted(s.items()))
        built[("ref_" + n, key)] = _build.finish_build(h)
        tag = n + ":" + ",".join(f"{k}={v}" for k, v in key)
        if same_code_expected(n, s) or n == "tridiag":
            # The wide tridiagonal builds: their solve kernels alone.
            sass[tag] = sass_differs(
                built[("ref_" + n, key)], built[(n, key)],
                None if same_code_expected(n, s) else "tridiag_solve")
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
    emit("build", seconds=round(seconds, 2), libraries=report,
         **({"ref_tree_sass_differs": sass} if REF_TREE else {}))
    if any(sass.values()):
        fail(f"build: device code differs from --ref-tree's: "
             f"{[k for k, v in sass.items() if v]}")


def build_signatures(want):
    """The layout signatures the phases of ``want`` launch: the honest class
    and the sphere fleet (two balls, one obstacle), box-only, and the
    obstacle-free planner (gripper rows only); the kernels that read P
    (Ruiz, residuals) add the P form, BLOCK_P."""
    honest_sig = {"NDIM": N, "NX": 5}
    sigs = [{"B2": 2 * N}, {}] + [
        {"B2": b2} for b2, _, _ in TRIDIAG_SIZES.values() if b2 != 2 * N]
    if "lane_sizes" in want:
        sigs += [s_ for n in LANE_SIZES for s_ in size_signatures(n)]
    if "lane_wide" in want:
        sigs += [s_ for n in WIDE_SIZES for s_ in size_signatures(n)]
        sigs += [{"NDIM": n, "NX": 5, "BLOCK_P": 1}
                 for n in WIDE_BLOCK_SIZES]
        sigs += [{"B2": b2} for b2, _, _ in WIDE_TRIDIAG.values()]
    if "planner_dh" in want:  # the iiwa14 and the SCARA, two balls
        for n in (7, 4):
            sigs += [{"NDIM": n, "NX": 3},
                     {"NDIM": n, "NX": 3, "BLOCK_P": 0}, {"B2": 2 * n}]
    if "examples" in want:  # the DH example's iiwa14 through run
        sigs.append({"B2": 14})
    if "parallel_one" in want:  # multihost's worker: N=3 planners
        sigs += MULTIHOST_SIGNATURES
    for nx in (5, 0, 3):  # honest; box; planner_full
        if nx == 5 or (nx == 0 and "box" in want) or (
                nx == 3 and want & {"planner_full", "planner_batch",
                                    "examples", "parallel_one",
                                    "parallel_ranks", "planner_w802"}):
            sigs += [{"NDIM": N, "NX": nx},
                     {"NDIM": N, "NX": nx, "BLOCK_P": 0}]
    sigs.append(dict(honest_sig, BLOCK_P=1))
    return sigs


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


# ------------------------------------------ Ruiz and factor kernels alone
# The wrappers also build packs and buffers on every call; these time the
# launch itself on packs built beforehand, and hold the kernels against
# their plain versions at the edges of their launch plans.


def ruiz_alone(qp, iters):
    """One launch of ``csrc/ruiz.cu`` on packs and outputs built
    beforehand."""
    packs = ruiz_kernel._ruiz_kernel_packs(qp)
    lib = _build.library("ruiz", admm_fused.p_signature(qp))
    return lambda: ruiz_kernel._launch_ruiz(lib, *packs, iters)


def factor_alone(scaled, rho_vec, sigma, emit_gain=False):
    """One launch of ``csrc/kkt_factor.cu`` on the coefficient, rho and P
    packs and the outputs, all built beforehand."""
    W_, Rp, B = (scaled.waypoints, scaled.rows_per_waypoint_padded,
                 scaled.batch)
    coef = admm_fused.build_coef_pack(scaled)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    rho3 = rho_vec.reshape(W_, Rp, B).contiguous()
    Tp = admm_fused._tri_maps(2 * scaled.n_dim)[2]
    cholp = torch.empty((W_, Tp, B), device="cuda")
    gainp = torch.empty_like(cholp) if emit_gain else None
    lib = _build.library("kkt_factor", admm_fused.layout_signature(scaled))
    return lambda: kkt_factor._launch_factor(lib, coef, rho3, Pd, Pl, cholp,
                                             sigma, gainp)


def lane_plan(name, W_, B):
    """The launch plan of the Ruiz or factor kernel (``name``: a kernel
    row) for W_ waypoints and a batch of B on this card."""
    sig = {"NDIM": N, "NX": 5}
    if name.startswith("ruiz"):
        lib = _build.library("ruiz", dict(sig, BLOCK_P=int(
            name.endswith("_block"))))
        return ruiz_kernel.plan(lib, W_, B)
    return kkt_factor.plan(_build.library("kkt_factor", sig), W_, B)


# Launches back to back per timed sample of a kernel alone: a single
# launch's time includes the host's enqueue (ctypes and the plan), tens of
# microseconds.
ALONE_INNER = 20
LONG_LAUNCH_MS = 5.0


def alone_ms(make, *args, **kw):
    """Device time of one launch alone (``make`` gives the launch): ``(ms
    over ALONE_INNER launches back to back, ms of a single launch)``, the
    second as the starting tree's kernels were first timed; a launch longer
    than LONG_LAUNCH_MS is timed single only (both values)."""
    launch = make(*args, **kw)
    single = time_ms(launch)
    if single > LONG_LAUNCH_MS:  # back to back adds nothing; keep it short
        return single, single
    return time_ms(launch, inner=ALONE_INNER), single


@functools.lru_cache(maxsize=None)
def fast_math_mismatches():
    """``csrc/fast_math_check.cu`` on this card: ``(the floats from 2^-100
    to 2^100 whose sqrt_rn or rcp_rn differ from sqrtf or 1.0f / x, the
    quotients of its check whose div_rn differs from the division)`` —
    ``lane_platform.cuh``'s square root and reciprocal of the Ruiz and
    factor kernels, and the division of the tridiagonal solve."""
    fn = _build.library("fast_math_check", {}).fast_math_mismatches
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 2)()
    _build.check(fn(out), "fast_math_mismatches")
    return tuple(out)


# The edge cases of the plans: a batch whose last block is part empty, the
# Ruiz gate's fewest waypoints, and the planner's longest horizon.
EDGE_CASES = {"B1022": (1022, W), "W4": (BATCH, 4), "W50": (BATCH, 50)}


def ruiz_vs_f64(qp, iters):
    """The Ruiz kernel and its plain version (f32) against the plain version
    run in f64 on the same f32 inputs, elementwise relative
    (``|x / f64 - 1|``, max over D, E, c), and the kernel against the plain
    f32 version (max abs)."""
    got = ruiz_kernel.ruiz_scalings_kernel(qp, iters)
    plain = ruiz_kernel._ruiz_scalings_plain(qp, iters)
    ref = ruiz_kernel._ruiz_scalings_plain(cast(qp, torch.float64), iters)
    torch.cuda.synchronize()

    def ratio(a, b):
        return rel_err(a.double() / b, torch.ones_like(b))[0]
    return (max(ratio(a, b) for a, b in zip(got, ref)),
            max(ratio(a, b) for a, b in zip(plain, ref)),
            max(rel_err(a, b)[0] for a, b in zip(got, plain)))


def ruiz_off_chip(qp, iters):
    """The Ruiz kernel on ``qp`` with its constant rows and D/E in device
    memory, the placement the plan takes where they do not fit in shared
    memory (forced here by a budget of one byte): the plan, the launch
    alone's ms (as the row's ``ms``) and ``rel_err``, ``|kernel / plain -
    1|`` elementwise, max over D, E, c, against the plain version in f32
    (vel-diag, as its row) or run in f64 on the same f32 inputs (block P,
    as its row)."""
    lib = _build.library("ruiz", admm_fused.p_signature(qp))
    p = ruiz_kernel.plan(lib, qp.waypoints, qp.batch, budget=1)
    packs = ruiz_kernel._ruiz_kernel_packs(qp)

    def launch():
        ruiz_kernel._launch_ruiz(lib, *packs, iters, budget=1)
    launch()
    got = [t.clone() for t in ruiz_kernel._unpack_scalings(qp, *packs[4:])]
    block = qp.p_structure == "block"
    ref = ruiz_kernel._ruiz_scalings_plain(
        cast(qp, torch.float64) if block else qp, iters)
    torch.cuda.synchronize()
    err = max(rel_err(a.double() / b.double(), torch.ones_like(b.double()))[0]
              for a, b in zip(got, ref))
    return dict(plan=p, rel_err=err, ms=time_ms(launch, inner=ALONE_INNER),
                shape=f"W={qp.waypoints} B={qp.batch}")


def ruiz_edge_cases(iters, block=False):
    """The Ruiz kernel at each of EDGE_CASES against its plain version:
    vel-diag relative to the plain f32 version (as the main row), block P
    relative to the plain version in f64 (as its row)."""
    out = {}
    for name, (batch, w) in EDGE_CASES.items():
        qp = build_honest_batch(batch, w, N, torch.float32, "cuda")
        if block:
            qp = cast(with_block_p(cast(qp, torch.float64)), torch.float32)
            out[name] = ruiz_vs_f64(qp, iters)[0]
        else:
            out[name] = check_ruiz(qp, iters, batch)[1]
    return out


def factor_edge_cases(settings, emit_gain=False):
    """The factor kernel at each of EDGE_CASES against its plain version
    (f32, max abs error over max |plain|, chol and gain packs)."""
    out = {}
    for name, (batch, w) in EDGE_CASES.items():
        base = build_honest_batch(batch, w, N, torch.float32, "cuda")
        scaled, _ = admm_lane.ruiz_equilibrate_lane(base, settings.scaling)
        rb = torch.full((batch,), settings.rho, device="cuda")
        rho_vec = _rho_vec(rb, scaled.l, scaled.u)
        got = kkt_factor.factor_packed_lane(scaled, rho_vec, settings.sigma,
                                            emit_gain=emit_gain)
        ref = kkt_factor.factor_packed_lane_plain(
            scaled, rho_vec, settings.sigma, emit_gain=emit_gain)
        torch.cuda.synchronize()
        out[name] = max(rel_err(a, b)[1] for a, b in zip(got, ref)
                        if a is not None)
    return out


def ref_lane_compare(base, scaled, rho_vec, settings, packs, state0, done,
                     ck, cg, gg, Nj=N):
    """The lane kernels of --ref-tree beside this tree's at ``Nj`` joints
    (the main shape's inputs at N=6, ``size_batch``'s in ``lane_sizes``):
    the Ruiz kernel, the KKT factor in both forms, and the chunk in its
    accumulator, delta, warm-up and gain forms.  Per kernel the values that
    differ bit for bit (which must be none) and both trees' times alone (20
    launches back to back)."""
    sig = {"NDIM": Nj, "NX": 5}
    ref = lambda name, s_: ref_library(  # noqa: E731
        name, tuple(sorted(s_.items())))
    mine = lambda name, s_: _build.library(name, s_)  # noqa: E731
    it, B = settings.scaling, base.batch
    rp = ruiz_kernel._ruiz_kernel_packs(base)
    coef, lu = packs["coef"], admm_fused.build_lu_pack(scaled)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    rho3 = rho_vec.reshape(W, -1, B).contiguous()
    q_int = scaled._interleave(scaled.q_vec).contiguous()
    done_f = done.to(torch.float32).contiguous()
    ee, varc, Pdp = packs["EEinv"], packs["varc"], packs["Pdp"]
    Plf = packs["Plf"]

    def ruiz(lib):
        out = [t.clone() for t in rp[4:]]
        return (lambda: ruiz_kernel._launch_ruiz(lib, *rp[:4], *out, it),
                out)

    def factor(gain):
        def make(lib):
            out = [torch.empty_like(ck)] + ([torch.empty_like(ck)] if gain
                                            else [])
            return (lambda: kkt_factor._launch_factor(
                lib, coef, rho3, Pd, Pl, out[0], settings.sigma,
                out[1] if gain else None), out)
        return make

    def chunk(mode, n_iter, gain=False):
        def make(lib):
            state = state0.clone()
            w = torch.empty((W, 2 * Nj, B), device="cuda")
            acc = torch.empty((24, B), device="cuda") if mode == 1 else None
            dxdy = (torch.empty((W, admm_fused.dxdy_rows(scaled)[1], B),
                                device="cuda") if mode == 2 else None)
            pf = (cg, gg) if gain else (ck, None)

            def launch():
                state.copy_(state0)
                admm_fused._launch_chunk(
                    lib, pf[0], coef, q_int, lu, rho3, Plf,
                    ee if mode == 1 else None, varc if mode == 1 else None,
                    Pdp if mode == 1 else None, done_f, state, w, acc,
                    n_iter, settings.sigma, settings.alpha, dxdy=dxdy,
                    gainp=pf[1])
            return launch, [t for t in (state, acc, dxdy) if t is not None]
        return make

    cases = {
        "ruiz": ("ruiz", dict(sig, BLOCK_P=0), ruiz),
        "kkt_factor": ("kkt_factor", sig, factor(False)),
        "kkt_factor_gain": ("kkt_factor", sig, factor(True)),
        "admm_chunk": ("admm_chunk", sig, chunk(1, 2)),
        "admm_chunk_dxdy": ("admm_chunk", sig, chunk(2, 2)),
        "admm_chunk_warmup": ("admm_chunk", sig,
                              chunk(0, settings.termination_warmup)),
        "admm_chunk_gain": ("admm_chunk", sig, chunk(1, 2, gain=True)),
    }
    out = {}
    for name, (src, s_, make) in cases.items():
        la, oa = make(mine(src, s_))
        lb, ob = make(ref(src, s_))
        la()
        lb()
        torch.cuda.synchronize()
        nd = [bits_differing(a, b) for a, b in zip(oa, ob)]
        out[name] = dict(bits_differing=sum(n for n, _ in nd),
                         max_abs_diff=max(d for _, d in nd),
                         ms=time_ms(la, inner=ALONE_INNER),
                         ref_ms=time_ms(lb, inner=ALONE_INNER))
    return out


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
    edge = ruiz_edge_cases(settings.scaling)
    off = ruiz_off_chip(base, settings.scaling)
    w_ms = time_ms(lambda: ruiz_kernel.ruiz_scalings_kernel(base, settings.scaling))
    k_ms, k1_ms = alone_ms(ruiz_alone, base, settings.scaling)
    few = build_honest_batch(8, W, N, torch.float32, "cuda")
    p_ms = time_ms(lambda: ruiz_kernel._ruiz_scalings_plain(base, settings.scaling))
    rp = ruiz_kernel._ruiz_kernel_packs(base)
    b_ms, b_by = bound(  # the packs read once, D, E and c written once
        nbytes(*rp), ops_ruiz(W, N, NX, B, settings.scaling))
    fm_bad = fast_math_mismatches()[0]
    out.append(dict(
        name="ruiz", max_abs_err=abs_err, max_rel_err=r_err,
        odd_batch_rel_err=odd_err, edge_cases_rel_err=edge, tol=TOL_RUIZ,
        tol_note="D, E, c elementwise relative to the plain version",
        fast_math_mismatches=fm_bad, rows_off_chip=off,
        ok=bool(r_err <= TOL_RUIZ and odd_err <= TOL_RUIZ
                and max(edge.values()) <= TOL_RUIZ and fm_bad == 0
                and off["rel_err"] <= TOL_RUIZ
                and not off["plan"]["rows_in_shared"]),
        ms=k_ms, single_launch_ms=k1_ms, wrapper_ms=w_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        B8_ms=alone_ms(ruiz_alone, few, settings.scaling)[0],
        plan=lane_plan("ruiz", W, B), plan_B8=lane_plan("ruiz", W, 8),
        plan_W50=lane_plan("ruiz", 50, B),
        shape=f"W={W} N={N} B={B} iters={settings.scaling}; ms: the launch "
              "alone on packs built beforehand, wrapper_ms: the wrapper"))

    # ---- KKT factor: packed chol against kkt_blocks -> tridiag -> pack.
    coef = packs["coef"]
    ck, _ = kkt_factor.factor_packed_lane(scaled, rho_vec, settings.sigma, coef=coef)
    cp, _ = kkt_factor.factor_packed_lane_plain(scaled, rho_vec, settings.sigma)
    c64, _ = kkt_factor.factor_packed_lane_plain(
        cast(scaled, torch.float64), rho_vec.double(), settings.sigma)
    torch.cuda.synchronize()
    abs_err, r_err = rel_err(ck, cp)
    odd_s, _ = admm_lane.ruiz_equilibrate_lane(odd, settings.scaling)
    odd_rho = _rho_vec(torch.full((200,), settings.rho, device="cuda"),
                       odd_s.l, odd_s.u)
    odd_err = rel_err(
        kkt_factor.factor_packed_lane(odd_s, odd_rho, settings.sigma)[0],
        kkt_factor.factor_packed_lane_plain(odd_s, odd_rho, settings.sigma)[0],
    )[1]
    edge = factor_edge_cases(settings)
    w_ms = time_ms(lambda: kkt_factor.factor_packed_lane(
        scaled, rho_vec, settings.sigma, coef=coef))
    k_ms, k1_ms = alone_ms(factor_alone, scaled, rho_vec, settings.sigma)
    few_s, few_rho = chunk_start(8, settings, 0)[:2]
    p_ms = time_ms(lambda: kkt_factor.factor_packed_lane_plain(
        scaled, rho_vec, settings.sigma), reps=5, warm=1)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    b_ms, b_by = bound(nbytes(coef, rho_vec, Pd, Pl, ck),
                       ops_factor(W, N, NX, B))
    out.append(dict(
        name="kkt_factor", max_abs_err=abs_err, max_rel_err=r_err,
        odd_batch_rel_err=odd_err, edge_cases_rel_err=edge, tol=TOL_FACTOR,
        tol_note="max abs error over max |plain|; f32 reassociation over a "
                 "100-step recurrence",
        kernel_vs_f64=rel_err(ck.double(), c64)[1],
        plain_vs_f64=rel_err(cp.double(), c64)[1],
        ok=bool(r_err <= TOL_FACTOR and odd_err <= TOL_FACTOR
                and max(edge.values()) <= TOL_FACTOR),
        ms=k_ms, single_launch_ms=k1_ms, wrapper_ms=w_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        B8_ms=alone_ms(factor_alone, few_s, few_rho, settings.sigma)[0],
        plan=lane_plan("kkt_factor", W, B),
        plan_B8=lane_plan("kkt_factor", W, 8),
        shape=f"W={W} N={N} B={B}; ms: the launch alone on packs built "
              "beforehand, wrapper_ms: the wrapper"))

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

    def compare(n_iter, tp):
        return chunk_vs_f64(scaled, rho_vec, done, settings, state0, args,
                            n_iter, tp)

    def holds(vs):
        """Kernel within TOL_CHUNK of the f64 run (the plain f32 version's
        own distance from it is recorded beside it)."""
        return all(k <= TOL_CHUNK for k, _ in vs.values())

    errs, acc_errs, frozen_same, vs64 = compare(2, term_packs)
    warm_errs, _, warm_frozen, warm_vs64 = compare(
        settings.termination_warmup, None)
    # The same comparison at an odd batch (tail mask).
    o_s, o_rho, o_tp, o_args, o_st = chunk_start(200, settings, 0)
    odd_done = torch.zeros(200, dtype=torch.bool, device="cuda")
    ok_, oacc = admm_fused.fused_admm_chunk(
        o_s, o_rho, odd_done, settings, state_pack=o_st.clone(),
        term_packs=o_tp, **o_args)
    op_, oaccp = admm_fused.fused_admm_chunk_plain(
        o_s, o_rho, odd_done, settings, state_pack=o_st, term_packs=o_tp,
        **o_args)
    odd_err = max(rel_err(ok_, op_)[1],
                  max(rel_err(oacc[r], oaccp[r])[1] for r in _ACC.values()))
    # A batch whose last block is part empty (several problems per block).
    ragged = check_chunk_ragged(settings, sig)
    # Eight problems: how much of the time is one problem's chain.
    few_s, few_rho, few_tp, few_args, few_st = chunk_start(8, settings, 0)
    few_done = torch.zeros(8, dtype=torch.bool, device="cuda")
    few_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        few_s, few_rho, few_done, settings, state_pack=few_st, n_iter=2,
        term_packs=few_tp, **few_args))
    few_warm_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        few_s, few_rho, few_done, settings, state_pack=few_st,
        n_iter=settings.termination_warmup, **few_args), reps=5, warm=1)

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
        ragged_batch=ragged,
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
                and frozen_same and warm_frozen and ragged["ok"]),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, streamed_ms=streamed_ms,
        warmup_form_ms=warm_ms,
        ms_per_iteration=warm_ms / settings.termination_warmup,
        B8_ms=few_ms, B8_warmup_form_ms=few_warm_ms,
        B8_ms_per_iteration=few_warm_ms / settings.termination_warmup,
        plan=chunk_plan(sig, B, 1, False),
        plan_warmup_form=chunk_plan(sig, B, 0, False),
        plan_B200=chunk_plan(sig, 200, 1, False),
        plan_B8=chunk_plan(sig, 8, 1, False),
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
    ref_lane = None
    if REF_TREE:
        ref_lane = ref_lane_compare(base, scaled, rho_vec, settings, packs,
                                    state0, done, ck, ck, gk)
    out.extend(check_dense())
    out.extend(check_block_p(settings, NX))
    for row in out:
        row["ptxas"] = ptxas_of(row["name"], sig)
    rows = {row["name"]: row for row in out}
    # The factor's library yardstick: the dense Cholesky of the same
    # assembled KKT matrices, timed in the tridiagonal factor's row.
    for name in ("kkt_factor", "kkt_factor_gain"):
        rows[name]["library_ms"] = rows["tridiag_factor"]["library_ms"]
        rows[name]["library_note"] = (
            "torch.linalg.cholesky of the dense (B, W*B2, W*B2) f32 KKT "
            "matrices (the tridiag_factor row's time): factor only, no "
            "assembly")
    # Every build of the chunk kernel (hrec and gain x three modes).
    rows["admm_chunk"]["ptxas_all_builds"] = ptxas_of("admm_chunk_all", sig)
    emit("kernels", kernels=out,
         **({"ref_tree_lane_N6": ref_lane} if ref_lane else {}))
    bad = [k["name"] for k in out if not k["ok"]]
    if bad:
        fail(f"kernel(s) outside tolerance of the plain version: {bad}")
    if ref_lane and any(v["bits_differing"] for v in ref_lane.values()):
        fail(f"the N=6 lane kernels differ from --ref-tree's: {ref_lane}")
    return out


def chunk_vs_f64(scaled, rho_vec, done, settings, state0, args, n_iter, tp):
    """Kernel and plain version (both f32) from the same state, and the
    plain version in f64 on the same f32 inputs as the yardstick.  Returns
    the kernel-vs-plain errors of the state sections and accumulator rows,
    whether the frozen problems' state is untouched, and per section / row
    the (kernel, plain f32) distances from f64."""
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    ck = args["packed_factor"][0]
    sk = state0.clone()
    sk, acck = admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=sk,
        term_packs=tp, n_iter=n_iter, **args)
    sp, accp = admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0,
        term_packs=tp, n_iter=n_iter, **args)
    s64, acc64 = admm_fused.fused_admm_chunk_plain(
        cast(scaled, torch.float64), d64(rho_vec), done, settings,
        state_pack=d64(state0),
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


def chunk_start(batch, settings, warm_iters=10):
    """The honest class at ``batch`` with the main path's packs, and a
    packed state after ``warm_iters`` kernel iterations from the solver's
    initial state: (scaled, rho_vec, term_packs, args, state); ``args``
    (stencil, bounds, hrec factor) is what every chunk call takes."""
    _, _, scaled, scaling, packs, rho_vec = main_path_problem(batch)
    coef = packs["coef"]
    ck, _ = kkt_factor.factor_packed_lane(scaled, rho_vec, settings.sigma,
                                          coef=coef)
    st = admm_lane.init_state_lane(
        scaled, settings, None, None, scaling,
        rho_bar=torch.full((batch,), settings.rho, device="cuda"),
        rho_vec=rho_vec, factor=(ck, None))
    state = admm_fused.pack_state(scaled, st.x, st.z, st.y)
    args = dict(coef=coef, lu=admm_fused.build_lu_pack(scaled),
                packed_factor=(ck, None))
    if warm_iters:
        admm_fused.fused_admm_chunk(
            scaled, rho_vec,
            torch.zeros(batch, dtype=torch.bool, device="cuda"), settings,
            state_pack=state, n_iter=warm_iters, **args)
    term_packs = (packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])
    return scaled, rho_vec, term_packs, args, state


def check_chunk_ragged(settings, sig, batch=1022):
    """The chunk kernel at a batch its plan splits into blocks of several
    problems with the last block part empty (4-byte copies; the empty
    groups still take part in every barrier and group sync): 2 iterations
    with the accumulators from a non-trivial state, every fifth problem
    and the batch's last one frozen, held to the plain version in f64 at
    TOL_CHUNK."""
    plan = chunk_plan(sig, batch, 1, False)
    scaled, rho_vec, term_packs, args, state0 = chunk_start(batch, settings)
    ar = torch.arange(batch, device="cuda")
    done = (ar % 5 == 3) | (ar == batch - 1)
    _, _, frozen_same, vs64 = chunk_vs_f64(
        scaled, rho_vec, done, settings, state0, args, 2, term_packs)
    worst = max(k for k, _ in vs64.values())
    tail = plan["Q"] > 1 and batch % plan["Q"] != 0
    return dict(batch=batch, plan=plan, last_block_part_empty=tail,
                kernel_vs_f64=worst, kernel_and_plain_vs_f64=vs64,
                frozen_problems_untouched=bool(frozen_same),
                ok=bool(tail and worst <= TOL_CHUNK and frozen_same))


def term_compare(scaled, rho_vec, done, settings, chunk, **kw):
    """One MODE_TERM chunk (``kw`` holds its ``term_packs`` and
    ``state_pack``) and, from a copy of its input state, the delta form
    followed by the residual kernel (``csrc/residuals.cu``).  Returns the
    term chunk's outputs and, per item (the state, each accumulator row),
    the count of values that differ bit for bit (NaN equals NaN)."""
    s_copy = kw["state_pack"].clone()
    out, acc = chunk(scaled, rho_vec, done, settings, **kw)
    su, dd = chunk(scaled, rho_vec, done, settings,
                   **dict(kw, term_packs=None, state_pack=s_copy,
                          emit_dxdy=True))
    ee, varc, Pdp, Plf = kw["term_packs"]
    acc_u = torch.empty_like(acc)
    residuals._launch_residuals(
        _build.library("residuals", admm_fused.p_signature(scaled)),
        kw["coef"], Pdp, Plf, su, dd, torch.cat([ee, kw["lu"]], dim=1), varc,
        acc_u)
    ne = (acc != acc_u) & ~(acc.isnan() & acc_u.isnan())
    per_row = ne.sum(1).tolist()
    differ = {name: per_row[r] for name, r in _ACC.items() if per_row[r]}
    n_state = int((out != su).sum())
    if n_state:
        differ["state"] = n_state
    return (out, acc), differ


def term_bits_equal(settings, batch=BATCH, starts=(10, 40)):
    """The fused termination against the unfused one on the honest class
    (``term_compare``), in the hrec and the gain form, at states after each
    count of ``starts`` iterations, every fifth problem frozen.  The state
    written and every accumulator row must agree bit for bit: the two paths
    then decide termination from the same float32 values."""
    scaled, rho_vec, term_packs, args, state = chunk_start(batch, settings,
                                                           starts[0])
    ck = args["packed_factor"][0]
    _, gk = kkt_factor.factor_packed_lane(scaled, rho_vec, settings.sigma,
                                          coef=args["coef"], emit_gain=True)
    done = (torch.arange(batch, device="cuda") % 5) == 3
    differ, cases = {}, 0
    for k, n in enumerate(starts):
        if k:
            admm_fused.fused_admm_chunk(
                scaled, rho_vec, done, settings, state_pack=state,
                n_iter=n - starts[k - 1], **args)
        for form, factor in (("hrec", (ck, None)), ("gain", (ck, gk))):
            _, d = term_compare(
                scaled, rho_vec, done, settings, admm_fused.fused_admm_chunk,
                **dict(args, packed_factor=factor), state_pack=state.clone(),
                n_iter=2, term_packs=term_packs)
            cases += 1
            differ.update({f"{form}@{n}.{k_}": v for k_, v in d.items()})
    return dict(batch=batch, cases=cases, starts=list(starts),
                forms=["hrec", "gain"], differing=differ, ok=not differ)


def search_term_bits(solver, starts, ends):
    """The search once more with every MODE_TERM chunk it launches checked
    by ``term_compare`` (``ops/admm_lane.py`` looks the wrapper up at each
    solve).  Returns the launches checked and the differing values summed
    over them by item."""
    chunk = admm_fused.fused_admm_chunk
    differ, calls = collections.Counter(), 0

    def checked(scaled, rho_vec, done, settings, **kw):
        nonlocal calls
        if kw.get("term_packs") is None:
            return chunk(scaled, rho_vec, done, settings, **kw)
        res, d = term_compare(scaled, rho_vec, done, settings, chunk, **kw)
        calls += 1
        differ.update(d)
        return res

    checked.__dict__.update(chunk.__dict__)  # the wrapper's launch counters
    admm_fused.fused_admm_chunk = checked
    try:
        solver.run_batch_padded(starts, ends)
        torch.cuda.synchronize()
    finally:
        admm_fused.fused_admm_chunk = chunk
    return dict(term_launches=calls, differing=dict(differ),
                ok=bool(calls and not differ))


def chunk_plan(sig, B, mode, gain):
    """The chunk kernel's launch plan on this card for a batch of B
    (``admm_chunk_plan``): threads per problem, problems per block, stages,
    shared bytes, blocks, threads per block, slot values per problem, tile
    row stride and bytes per staging copy."""
    fn = _build.library("admm_chunk", sig).admm_chunk_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 9)()
    fn(B, torch.cuda.get_device_properties(0).multi_processor_count, mode,
       int(gain), out)
    keys = ("G", "Q", "stages", "shared_bytes", "blocks", "threads_per_block",
            "slot_values", "tile_stride", "copy_bytes")
    return dict(zip(keys, list(out)))


def chunk_workspace(sig, B, mode, gain, budget=0):
    """The bytes of device-memory workspace a chunk launch of this build
    asks for on this card (``admm_chunk_workspace_bytes``; 0: the ring on
    chip)."""
    fn = _build.library("admm_chunk", sig).admm_chunk_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(B, mode, int(gain), budget))


def check_chunk_dxdy(scaled, scaled64, settings, rho_vec, done, state0, args,
                     ck, q_int, lu, NX, gk=None, name="admm_chunk_dxdy"):
    """The chunk's delta-writing form: state and deltas of 2 iterations
    against the plain version run in f64 on the same f32 inputs.  ``gk``:
    the gain pack (the gain form; ``args`` carry it too), as the block-P
    path runs it."""
    B = state0.shape[-1]
    pf64 = (ck.double(), None if gk is None else gk.double())
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
        packed_factor=pf64)
    # One iteration: the deltas are against the input state.
    s1, d1 = admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=state0.clone(), n_iter=1,
        emit_dxdy=True, **args)
    _, d1_64 = admm_fused.fused_admm_chunk_plain(
        scaled64, rho_vec.double(), done, settings,
        state_pack=state0.double(), n_iter=1, emit_dxdy=True,
        packed_factor=pf64)
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
    warm_ms = time_ms(lambda: admm_fused.fused_admm_chunk(
        scaled, rho_vec, done, settings, state_pack=scratch,
        n_iter=settings.termination_warmup, **args), reps=5, warm=1)
    p_ms = time_ms(lambda: admm_fused.fused_admm_chunk_plain(
        scaled, rho_vec, done, settings, state_pack=state0, n_iter=2,
        emit_dxdy=True, **args), reps=5, warm=1)
    # The hrec form reads the velocity diagonal of P_lower, the gain form G.
    extra = kkt_factor.build_p_vel_packs(scaled)[1] if gk is None else gk
    moved = nbytes(ck, args["coef"], q_int, lu, rho_vec, extra, done, state0,
                   state0, dk)
    b_ms, b_by = bound(moved, ops_chunk(W, N, NX, B, 2, False))
    worst = max(v[0] for v in vs64.values())
    return dict(
        name=name,
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
        warmup_form_ms=warm_ms,
        ms_per_iteration=warm_ms / settings.termination_warmup,
        plan=chunk_plan(admm_fused.layout_signature(scaled), B, 2, gk is not None),
        shape=f"W={W} N={N} B={B} n_iter=2 emit_dxdy"
              + ("" if gk is None else f" gain, P {scaled.p_structure}")
              + f" (warm-up form: n_iter={settings.termination_warmup})")


def check_residuals(scaled, scaling, settings, rho_vec, done, state0, args,
                    packs, lu, NX, row_name="residuals"):
    """The streaming residual kernel on the packs the delta-writing chunk
    produced, against its plain version on the same packs (the form of
    ``scaled.p_structure``)."""
    block = scaled.p_structure != "vel_diag"
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
            _build.library("residuals", admm_fused.p_signature(scaled)),
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
    if block:  # the block form is held against the f64 run
        worst_max = max(v[0] for k, v in vs64.items() if k not in RESID_SUMS)
        worst_sum = max(v[0] for k, v in vs64.items() if k in RESID_SUMS)
    else:
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
    lib = _build.library("residuals", admm_fused.p_signature(scaled))
    batches = resid_batches(lib, block, (coef, rp[2], rp[3], sp, dp, rowc,
                                         rp[1]), acck)
    k_ms, k1_ms = batches["B1024"]["ms"], time_ms(lambda: kernel_acc(sp))
    p_ms = time_ms(lambda: residuals.termination_accumulators_plain(
        scaled, sp, dp, rowc, rp[1]), reps=5, warm=1)
    moved = nbytes(coef, rp[2], rp[3], sp, dp, rowc, rp[1], acck)
    b_ms, b_by = bound(moved, ops_residuals(W, N, NX, B, block))
    acc_abs = {k: (rel_err(acck[r].double(), acc64[r])[0] if block
                   else errs[k][0]) for k, r in _ACC.items()}
    return dict(
        name=row_name,
        max_abs_err=max(v for k, v in acc_abs.items() if k not in RESID_SUMS),
        max_rel_err=worst_max, sums_max_rel_err=worst_sum,
        acc_rel_err={k: v[1] for k, v in errs.items()},
        kernel_and_plain_vs_f64=vs64, pad_rows_zero=pad_rows_zero,
        nan_carried_to_blew_up=nan_carried, no_false_alarm=no_false_alarm,
        tol=TOL_RESID_MAX, tol_sums=TOL_RESID_SUM,
        tol_note="each of the 18 accumulator rows against the plain version "
                 + ("run in f64 on the same f32 packs" if block else
                    "on the same f32 packs") +
                 ": maxima as max abs error over max |plain| (f32 "
                 "reassociation in cancelling residuals), the four sums "
                 "(support, q_dot, xsum, ysum) over the sum of their terms' "
                 "magnitudes (they cancel thousands of signed terms, summed "
                 "in another order)",
        batches=batches,
        ok=bool(worst_max <= TOL_RESID_MAX and worst_sum <= TOL_RESID_SUM
                and pad_rows_zero and nan_carried and no_false_alarm
                and all(v["equal_to_B1024"] for v in batches.values())),
        ms=k_ms, single_launch_ms=k1_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, plan=batches["B1024"]["plan"],
        shape=f"W={W} N={N} B={B} P {scaled.p_structure}; ms: the launch "
              "alone, 20 back to back; single_launch_ms: one wrapper call "
              "with its output's allocation")


# The residual kernel's batches: the main shape, a last block part empty,
# and a small batch (one problem a block).
RESID_BATCHES = (1024, 1022, 8)


def ref_resid_launch(block, packs, acc):
    """One launch of --ref-tree's residual kernel on the packs, into
    ``acc`` (its C signature: with a sums scratch where the tree plans its
    launch, else without)."""
    lib = ref_library("residuals", (("BLOCK_P", int(block)), ("NDIM", N),
                                    ("NX", 5)))
    fn = lib.residuals_launch
    Wd, _, B = packs[3].shape
    sums = ([acc.new_empty((Wd, 4, B))] if hasattr(lib, "residuals_plan")
            else [])
    fn.argtypes = [ctypes.c_void_p] * (8 + len(sums)) + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _build.ptr
    return lambda: _build.check(
        fn(*(p(t) for t in list(packs) + sums), p(acc), Wd, B,
           _build.stream(acc.device)), "ref residuals_launch")


def resid_batches(lib, block, packs, acc_full):
    """The residual kernel alone at each of RESID_BATCHES (the packs cut
    from the main shape's): its plan, its time over 20 launches back to
    back, whether its accumulators equal the main shape's for the same
    problems bit for bit and, with --ref-tree, that tree's kernel on the
    same packs: its time and the values that differ bit for bit."""
    out = {}
    for batch in RESID_BATCHES:
        cut = [t[..., :batch].contiguous() for t in packs]
        acc = torch.empty((24, batch), device="cuda")
        launch = lambda: residuals._launch_residuals(lib, *cut, acc)
        launch()
        torch.cuda.synchronize()
        rec = dict(plan=residuals.plan(lib, batch),
                   equal_to_B1024=bits_differing(acc, acc_full[:, :batch])[0]
                   == 0,
                   ms=time_ms(launch, inner=ALONE_INNER))
        if REF_TREE:
            acc_r = torch.empty_like(acc)
            ref = ref_resid_launch(block, cut, acc_r)
            ref()
            rec["ref_bits_differing"], rec["ref_max_abs_diff"] = (
                bits_differing(acc, acc_r))
            rec["ref_ms"] = time_ms(ref, inner=ALONE_INNER)
        out[f"B{batch}"] = rec
    return out


# Where each kernel row's registers and spills are read: (source, entry
# function name as ptxas prints it, demangled prefix).
PTXAS = {
    "ruiz": ("ruiz", "ruiz_"),
    "kkt_factor": ("kkt_factor", "kkt_factor_kernelILb0E"),
    "kkt_factor_gain": ("kkt_factor", "kkt_factor_kernelILb1E"),
    "admm_chunk": ("admm_chunk", "admm_chunk_kernelILi1ELb0E"),
    "admm_chunk_dxdy": ("admm_chunk", "admm_chunk_kernelILi2ELb0E"),
    "admm_chunk_gain": ("admm_chunk", "admm_chunk_kernelILi"),
    "residuals": ("residuals", "residuals"),
    "ruiz_block": ("ruiz", "ruiz_"),
    "residuals_block": ("residuals", "residuals"),
    "admm_chunk_block": ("admm_chunk", "admm_chunk_kernelILi2ELb1E"),
    "admm_chunk_all": ("admm_chunk", "admm_chunk_kernel"),
    "tridiag_factor": ("tridiag", "tridiag_factor_kernel"),
    "tridiag_solve": ("tridiag", "tridiag_solve_kernel"),
    "dense_factor": ("dense", "dense_factor_kernel"),
    "dense_solve": ("dense", "dense_solve_kernel"),
}


def ptxas_of(name, sig):
    """Registers / stack / spills of a kernel row's entry functions, from
    the saved ``-Xptxas -v`` output of its build (the gain row: the three
    ``GAIN = true`` instantiations)."""
    source, prefix = PTXAS[name]
    if source == "tridiag":
        sig = {"B2": 2 * N}
    elif source == "dense":
        sig = {}
    elif "BLOCK_P" in _build.KERNELS[source]:
        sig = dict(sig, BLOCK_P=int(name.endswith("_block")))
    _, path = _build._target(source, sig, None)
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
    edge = factor_edge_cases(settings, emit_gain=True)
    w_ms = time_ms(lambda: kkt_factor.factor_packed_lane(
        scaled, rho_vec, sigma, coef=coef, emit_gain=True))
    k_ms, k1_ms = alone_ms(factor_alone, scaled, rho_vec, sigma,
                           emit_gain=True)
    few_s, few_rho = chunk_start(8, settings, 0)[:2]
    few_ms = alone_ms(factor_alone, few_s, few_rho, sigma, emit_gain=True)[0]
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
        edge_cases_rel_err=edge,
        ok=bool(worst <= TOL_FACTOR and chol_as_hrec and last_row_zero
                and max(edge.values()) <= TOL_FACTOR),
        ms=k_ms, single_launch_ms=k1_ms, wrapper_ms=w_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, B8_ms=few_ms,
        plan=lane_plan("kkt_factor", W, B),
        plan_B8=lane_plan("kkt_factor", W, 8),
        shape=f"W={W} N={N} B={B} emit_gain; ms: the launch alone on packs "
              "built beforehand, wrapper_ms: the wrapper")
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
        ms_per_iteration=warm_ms / settings.termination_warmup,
        hrec_form_ms_same_call=hrec_ms,
        plan=chunk_plan(admm_fused.layout_signature(scaled), B, 1, True),
        plan_warmup_form=chunk_plan(admm_fused.layout_signature(scaled), B,
                                    0, True),
        plan_dxdy_form=chunk_plan(admm_fused.layout_signature(scaled), B, 2,
                                  True),
        shape=f"W={W} N={N} B={B} gain; ms: n_iter=2 emit_term (warm-up "
              f"form n_iter={settings.termination_warmup}, dxdy n_iter=2)")


def check_block_p(settings, NX):
    """The block-P forms at the main shape, on the block-P batch: Ruiz and
    the residual kernel against their plain versions run in f64 on the same
    f32 inputs, and the gain chunk (delta-writing form) fed
    ``pack_factor`` of the block-tridiagonal factor kernel, as the block-P
    path runs it."""
    B, iters = BATCH, settings.scaling
    bp = block_p_batch(B, "cuda")

    err, plain_err, vs_plain = ruiz_vs_f64(bp, iters)
    odd_err = ruiz_vs_f64(block_p_batch(200, "cuda"), iters)[0]
    edge = ruiz_edge_cases(iters, block=True)
    off = ruiz_off_chip(bp, iters)
    w_ms = time_ms(lambda: ruiz_kernel.ruiz_scalings_kernel(bp, iters))
    k_ms, k1_ms = alone_ms(ruiz_alone, bp, iters)
    few_ms = alone_ms(ruiz_alone, block_p_batch(8, "cuda"), iters)[0]
    p_ms = time_ms(lambda: ruiz_kernel._ruiz_scalings_plain(bp, iters))
    rp = ruiz_kernel._ruiz_kernel_packs(bp)
    b_ms, b_by = bound(  # the packs read once, D, E and c written once
        nbytes(*rp), ops_ruiz(W, N, NX, B, iters, block=True))
    rows = [dict(
        name="ruiz_block", max_abs_err=err, max_rel_err=err,
        plain_f32_vs_f64=plain_err, kernel_vs_plain_f32=vs_plain,
        odd_batch_rel_err=odd_err, edge_cases_rel_err=edge,
        rows_off_chip=off, tol=TOL_RUIZ,
        tol_note="D, E, c elementwise relative to the plain version run in "
                 "f64 on the same f32 inputs (|kernel / f64 - 1|)",
        ok=bool(err <= TOL_RUIZ and odd_err <= TOL_RUIZ
                and max(edge.values()) <= TOL_RUIZ
                and off["rel_err"] <= TOL_RUIZ
                and not off["plan"]["rows_in_shared"]),
        ms=k_ms, single_launch_ms=k1_ms, wrapper_ms=w_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, B8_ms=few_ms,
        plan=lane_plan("ruiz_block", W, B),
        plan_B8=lane_plan("ruiz_block", W, 8),
        shape=f"W={W} N={N} B={B} iters={iters} P block (full |P_diag|, "
              "|P_lower| packs); ms: the launch alone on packs built "
              "beforehand, wrapper_ms: the wrapper")]

    # A state from 10 iterations from cold, then a mixed done mask.
    scaled, scaling = admm_lane.ruiz_equilibrate_lane(bp, iters)
    packs = admm_lane.build_const_packs(scaled, scaling)
    rb = torch.full((B,), settings.rho, device="cuda")
    rho_vec = _rho_vec(rb, scaled.l, scaled.u)
    pf = admm_lane._packed_factor(scaled, rho_vec, settings)
    lu = admm_fused.build_lu_pack(scaled)
    st = admm_lane.init_state_lane(scaled, settings, None, None, scaling,
                                   rho_bar=rb, rho_vec=rho_vec, factor=pf)
    state0 = admm_fused.pack_state(scaled, st.x, st.z, st.y)
    args = dict(coef=packs["coef"], lu=lu, packed_factor=pf)
    admm_fused.fused_admm_chunk(
        scaled, rho_vec, torch.zeros(B, dtype=torch.bool, device="cuda"),
        settings, state_pack=state0, n_iter=10, emit_dxdy=True, **args)
    done = (torch.arange(B, device="cuda") % 5) == 3
    q_int = scaled._interleave(scaled.q_vec)
    rows.append(check_chunk_dxdy(
        scaled, cast(scaled, torch.float64), settings, rho_vec, done, state0,
        args, pf[0], q_int, lu, NX, gk=pf[1], name="admm_chunk_block"))
    rows.append(check_residuals(scaled, scaling, settings, rho_vec, done,
                                state0, args, packs, lu, NX,
                                row_name="residuals_block"))
    return rows


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
    f_ms, f1_ms = alone_ms(factor_alone_tridiag, diag, lower)
    fw_ms = time_ms(lambda: tridiag_kernel.factor_lane_major(diag, lower))
    f_cases = factor_cases(diag, lower)
    s_ms, s1_ms = alone_ms(solve_alone, ck, gk, rhs)
    sw_ms = time_ms(lambda: tridiag_kernel.solve_lane_major(ck, gk, rhs))
    cases = solve_cases(diag, lower, rhs)
    off = solve_off_chip(ck, gk, rhs, xk, x64)
    div_bad = fast_math_mismatches()[1]
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
    sizes = tridiag_sizes()
    main = dict(B2=B2, W=Wd, batch=B)
    f_sizes = {"B2_12": dict(main, max_abs_err=max(e[0] for e in f_errs.values()),
                             rel_err=f_worst, ms=f_ms, plain_ms=fp_ms,
                             bound_ms=fb_ms, bound_by=fb_by,
                             library_ms=lib_f_ms),
               **{k: v["factor"] for k, v in sizes.items()}}
    s_sizes = {"B2_12": dict(main, max_abs_err=s_err[0], rel_err=s_err[1],
                             ms=s_ms, plain_ms=sp_ms, bound_ms=sb_ms,
                             bound_by=sb_by, library_ms=lib_s_ms),
               **{k: v["solve"] for k, v in sizes.items()}}
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
             tol=TOL_TRIDIAG, tol_note=note, cases=f_cases,
             sizes=f_sizes,
             ok=bool(f_worst <= TOL_TRIDIAG and odd_err <= TOL_TRIDIAG
                     and upper_zero and nan_only_there
                     and all(c["ok"] for c in f_cases.values())
                     and all(c["ok"] for c in sizes.values())),
             ms=f_ms, single_launch_ms=f1_ms, wrapper_ms=fw_ms,
             B8_ms=f_cases["B8"]["ms"], plain_ms=fp_ms, bound_ms=fb_ms,
             bound_by=fb_by, library_ms=lib_f_ms,
             library_note="torch.linalg.cholesky of the dense (B, W*B2, W*B2) "
                          "f32 matrices (same factor: block-bidiagonal)",
             plan=f_cases["B1024"]["plan"],
             shape=shape + "; ms: the launch alone on inputs and outputs "
                           "built beforehand, wrapper_ms: the wrapper"),
        dict(name="tridiag_solve", max_abs_err=s_err[0], max_rel_err=s_err[1],
             library_vs_f64=lib_vs_f64, tol=TOL_TRIDIAG, tol_note=note,
             cases=cases, w_in_x=off, div_rn_mismatches=div_bad,
             sizes=s_sizes,
             ok=bool(s_err[1] <= TOL_TRIDIAG and div_bad == 0
                     and all(c["ok"] for c in cases.values()) and off["ok"]
                     and all(c["ok"] for c in sizes.values())),
             ms=s_ms, single_launch_ms=s1_ms, wrapper_ms=sw_ms, plain_ms=sp_ms,
             bound_ms=sb_ms, bound_by=sb_by, library_ms=lib_s_ms,
             library_note="torch.cholesky_solve on the dense factor",
             plan=cases["B1024"]["plan"],
             shape=shape + "; ms: the launch alone on inputs and output "
                           "built beforehand, wrapper_ms: the wrapper"),
    ]


# The tridiagonal kernels at other sizes than the main path's: B2=18 and 20
# (N=9 and 10: entry tables of 16 bits, a warp per problem, the solve's
# triangle read from the stage) at the main shape, and one problem at the
# reference example's W_max=802 (the planner_run phase's largest segment).
TRIDIAG_SIZES = {"B2_18": (18, W, BATCH), "B2_20": (20, W, BATCH),
                 "W802_B1": (12, 802, 1), "B2_18_W802_B1": (18, 802, 1),
                 "B2_22": (22, W, BATCH), "B2_24": (24, W, BATCH),
                 "B2_28": (28, W, BATCH), "B2_32": (32, W, BATCH)}


def spd_blocks(B2, Wd, B, seed=0):
    """A batch of block-tridiagonal symmetric positive definite f32
    matrices (diagonally dominant blocks) and a right-hand side, on the
    card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((Wd, B2, B2, B), generator=gen, device="cuda")
    eye = torch.eye(B2, device="cuda")[None, :, :, None]
    diag = (torch.einsum("wikb,wjkb->wijb", a, a) + 2.0 * B2 * eye)
    lower = 0.5 * torch.randn((Wd - 1, B2, B2, B), generator=gen,
                              device="cuda")
    rhs = torch.randn((Wd, B2, B), generator=gen, device="cuda")
    return diag.contiguous(), lower, rhs


def tridiag_sizes(sizes=None, budget=0):
    """The factor and the solve at each of ``sizes`` (TRIDIAG_SIZES), on a
    seeded SPD batch: against the plain version run in f64 on the same f32
    inputs (at the main shape's tolerance), the launch plans, the time
    alone, the plain version's time and the bound; with the ptxas report of
    the build; with --ref-tree, up to B2=32, the tree's kernels on the same
    inputs (equal bits).  ``budget``: the shared bytes the launches may use
    (1: the wide forms' rings in device memory).  ``{size: {"factor":
    {...}, "solve": {...}, "ok": bool}}``."""
    out = {}
    for name, (B2, Wd, B) in (sizes or TRIDIAG_SIZES).items():
        diag, lower, rhs = spd_blocks(B2, Wd, B)
        lib = _build.library("tridiag", {"B2": B2})
        def factor():
            c, g = torch.empty_like(diag), torch.empty_like(lower)
            tridiag_kernel._launch(lib, "factor", diag, lower, c, g,
                                   budget=budget)
            return c, g

        def solve(c, g):
            x = torch.empty_like(rhs)
            tridiag_kernel._launch(lib, "solve", c, g, rhs, x, budget=budget)
            return x
        ck, gk = factor()
        xk = solve(ck, gk)
        c64, g64 = tridiag_kernel.factor_lane_major_plain(diag.double(),
                                                          lower.double())
        x64 = tridiag_kernel.solve_lane_major_plain(ck.double(), gk.double(),
                                                    rhs.double())
        # The same launches again: the results must not change by a bit.
        ck2, gk2 = factor()
        xk2 = solve(ck, gk)
        torch.cuda.synchronize()
        f_again = bits_differing(ck, ck2)[0] + bits_differing(gk, gk2)[0]
        s_again = bits_differing(xk, xk2)[0]
        ce, ge = rel_err(ck.double(), c64), rel_err(gk.double(), g64)
        se = rel_err(xk.double(), x64)
        iu = torch.triu_indices(B2, B2, offset=1, device="cuda")
        upper_zero = bool((ck[:, iu[0], iu[1]] == 0).all())
        fb = bound(tril_bytes(diag) + nbytes(lower, ck, gk),
                   ops_tridiag_factor(Wd, B2, B))
        sb = bound(tril_bytes(ck) + nbytes(gk, rhs, xk),
                   ops_tridiag_solve(Wd, B2, B))
        reps = dict(reps=3, warm=1)
        shape = dict(B2=B2, W=Wd, batch=B)
        _, path = _build._target("tridiag", {"B2": B2}, None)
        ptx = _build.ptxas_report(path)
        f_ok = max(ce[1], ge[1]) <= TOL_TRIDIAG and upper_zero and not f_again
        s_ok = se[1] <= TOL_TRIDIAG and not s_again
        ref = {}
        yard = library_yardstick(diag, lower, rhs) if B2 > 32 else {}
        if REF_TREE and B2 > 32 and not budget:
            # The earlier tree's wide factor on the same inputs, timed.
            rl = ref_library("tridiag", (("B2", B2),))
            rc, rg = torch.empty_like(ck), torch.empty_like(gk)
            ref = dict(factor=dict(ref_ms=time_ms(
                lambda: tridiag_kernel._launch(rl, "factor", diag, lower,
                                               rc, rg), **reps)))
        if REF_TREE and B2 <= 32 and Wd == W:
            # The parent's forms up to B2 = 32 are kept: equal bits there.
            cr, gr = torch.empty_like(ck), torch.empty_like(gk)
            fl = ref_factor_alone(diag, lower, cr, gr)
            xr = torch.empty_like(xk)
            sl = ref_solve_alone(ck, gk, rhs, xr)
            fl()
            sl()
            torch.cuda.synchronize()
            fb_ = {"chol": bits_differing(ck, cr)[0],
                   "gain": bits_differing(gk, gr)[0]}
            sb_ = bits_differing(xk, xr)[0]
            ref = dict(
                factor=dict(ref_bits_differing=fb_,
                            ref_ms=time_ms(fl, inner=ALONE_INNER)),
                solve=dict(ref_bits_differing={"x": sb_},
                           ref_ms=time_ms(sl, inner=ALONE_INNER)))
            f_ok = f_ok and not (fb_["chol"] or fb_["gain"])
            s_ok = s_ok and not sb_
        out[name] = dict(
            factor=dict(
                shape, max_abs_err=max(ce[0], ge[0]),
                rel_err=max(ce[1], ge[1]), upper_triangle_zero=upper_zero,
                bits_differing_run_to_run=f_again,
                ms=(time_ms(factor, inner=ALONE_INNER) if budget else
                    alone_ms(factor_alone_tridiag, diag, lower)[0]),
                plain_ms=time_ms(lambda: tridiag_kernel.factor_lane_major_plain(
                    diag, lower), **reps),
                bound_ms=fb[0], bound_by=fb[1],
                library_ms=yard.get("library_ms"),
                library_batch=yard.get("library_batch"),
                library_error=yard.get("library_error"),
                plan=tridiag_kernel.factor_plan(lib, B, budget),
                device_launches=tridiag_kernel.factor_device_launches(
                    tridiag_kernel.factor_plan(lib, B, budget), Wd),
                ptxas={k[:40]: v for k, v in ptx.items()
                       if k.startswith("tridiag_factor_kernel")},
                **ref.get("factor", {}), ok=bool(f_ok)),
            solve=dict(
                shape, max_abs_err=se[0], rel_err=se[1],
                bits_differing_run_to_run=s_again,
                ms=(time_ms(lambda: solve(ck, gk), inner=ALONE_INNER)
                    if budget else alone_ms(solve_alone, ck, gk, rhs)[0]),
                plain_ms=time_ms(lambda: tridiag_kernel.solve_lane_major_plain(
                    ck, gk, rhs), **reps),
                bound_ms=sb[0], bound_by=sb[1],
                library_ms=yard.get("library_solve_ms"),
                library_batch=yard.get("library_batch"),
                library_error=yard.get("library_error"),
                plan=tridiag_kernel.plan(lib, Wd, B, budget),
                ptxas={k[:40]: v for k, v in ptx.items()
                       if k.startswith("tridiag_solve_kernel")},
                **ref.get("solve", {}), ok=bool(s_ok)),
            ok=bool(f_ok and s_ok))
        del diag, lower, rhs, ck, gk, xk, ck2, gk2, xk2, c64, g64, x64
        torch.cuda.empty_cache()
    return out


# The solve's batches and horizons: the main shape, a last block part
# empty, small batches (fewer problems per block), one problem, and config
# 1's horizon.
SOLVE_CASES = {"B1024": (1024, W), "B1022": (1022, W), "B8": (8, W),
               "B1": (1, W), "W10_B1024": (1024, 10), "W10_B1": (1, 10)}


# The factor's: the solve's and the planner's longest horizon.
FACTOR_CASES = dict(SOLVE_CASES, W50_B1024=(1024, 50))


def factor_alone_tridiag(diag, lower):
    """One launch of the factor kernel on inputs and outputs built
    beforehand."""
    lib = _build.library("tridiag", {"B2": diag.shape[1]})
    chol, gain = torch.empty_like(diag), torch.empty_like(lower)
    return lambda: tridiag_kernel._launch(lib, "factor", diag, lower, chol,
                                          gain)


def ref_factor_alone(diag, lower, chol, gain):
    """One launch of --ref-tree's factor kernel into ``chol`` and ``gain``
    (the same C signature in every tree)."""
    Wd, B2, _, B = diag.shape
    fn = ref_library("tridiag", (("B2", B2),)).tridiag_factor_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _build.ptr
    return lambda: _build.check(
        fn(p(diag), p(lower), p(chol), p(gain), Wd, B,
           _build.stream(diag.device)), "ref tridiag_factor_launch")


def factor_cases(diag, lower):
    """The factor kernel at each of FACTOR_CASES (the blocks cut from the
    main shape's) against the plain version run in f64 on the same f32
    inputs (chol and gain, the worse of the two), with its plan, its time
    alone and, with --ref-tree, that tree's kernel on the same inputs: its
    time and the values of chol and gain that differ bit for bit, which
    must be none."""
    lib = _build.library("tridiag", {"B2": diag.shape[1]})
    out = {}
    for name, (batch, w) in FACTOR_CASES.items():
        d = diag[:w, ..., :batch].contiguous()
        lo = lower[:w - 1, ..., :batch].contiguous()
        c, g = tridiag_kernel.factor_lane_major(d, lo)
        c64, g64 = tridiag_kernel.factor_lane_major_plain(d.double(),
                                                          lo.double())
        err = max(rel_err(c.double(), c64)[1], rel_err(g.double(), g64)[1])
        rec = dict(batch=batch, W=w, plan=tridiag_kernel.factor_plan(
            lib, batch), rel_err=err,
            ms=alone_ms(factor_alone_tridiag, d, lo)[0])
        same = True
        if REF_TREE:
            cr, gr = torch.empty_like(c), torch.empty_like(g)
            launch = ref_factor_alone(d, lo, cr, gr)
            launch()
            (nc, dc), (ng, dg) = bits_differing(c, cr), bits_differing(g, gr)
            rec["ref_bits_differing"] = {"chol": nc, "gain": ng}
            rec["ref_max_abs_diff"] = max(dc, dg)
            rec["ref_ms"] = time_ms(launch, inner=ALONE_INNER)
            same = nc == 0 and ng == 0
        rec["ok"] = bool(err <= TOL_TRIDIAG and same)
        out[name] = rec
    return out


def solve_alone(chol, gain, rhs, budget=0):
    """One launch of the solve kernel on inputs and an output built
    beforehand (``budget`` as ``tridiag_kernel.plan``)."""
    lib = _build.library("tridiag", {"B2": chol.shape[1]})
    x = torch.empty_like(rhs)
    return lambda: tridiag_kernel._launch(lib, "solve", chol, gain, rhs, x,
                                          budget=budget)


def ref_solve_alone(chol, gain, rhs, x):
    """One launch of --ref-tree's solve kernel into ``x`` (its C signature:
    with a budget where the tree plans its solve, else without)."""
    Wd, B2, _, B = chol.shape
    lib = ref_library("tridiag", (("B2", B2),))
    fn = lib.tridiag_solve_launch
    budget = [0] if hasattr(lib, "tridiag_solve_plan") else []
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (2 + len(
        budget)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _build.ptr
    return lambda: _build.check(
        fn(p(chol), p(gain), p(rhs), p(x), Wd, B, *budget,
           _build.stream(x.device)), "ref tridiag_solve_launch")


def bits_differing(a, b):
    """Values of two equal-shaped tensors that differ bit for bit (NaN
    equals NaN), and the largest |a - b| among them."""
    ne = (a != b) & ~(a.isnan() & b.isnan())
    n = int(ne.sum())
    return n, (a[ne] - b[ne]).abs().max().item() if n else 0.0


def solve_cases(diag, lower, rhs):
    """The solve kernel at each of SOLVE_CASES (the blocks, the batch cut
    from the main shape's, factored by the kernel) against the plain
    version run in f64 on the same f32 inputs, with its plan, its time
    alone and, with --ref-tree, that tree's kernel on the same inputs: its
    time and the values that differ bit for bit."""
    lib = _build.library("tridiag", {"B2": diag.shape[1]})
    out = {}
    for name, (batch, w) in SOLVE_CASES.items():
        d = diag[:w, ..., :batch].contiguous()
        lo = lower[:w - 1, ..., :batch].contiguous()
        r = rhs[:w, :, :batch].contiguous()
        c, g = tridiag_kernel.factor_lane_major(d, lo)
        x = tridiag_kernel.solve_lane_major(c, g, r)
        x64 = tridiag_kernel.solve_lane_major_plain(c.double(), g.double(),
                                                    r.double())
        err = rel_err(x.double(), x64)[1]
        rec = dict(batch=batch, W=w, plan=tridiag_kernel.plan(lib, w, batch),
                   rel_err=err, ms=alone_ms(solve_alone, c, g, r)[0])
        if REF_TREE:
            xr = torch.empty_like(r)
            launch = ref_solve_alone(c, g, r, xr)
            launch()
            rec["ref_bits_differing"], rec["ref_max_abs_diff"] = (
                bits_differing(x, xr))
            rec["ref_ms"] = time_ms(launch, inner=ALONE_INNER)
        rec["ok"] = bool(err <= TOL_TRIDIAG)
        out[name] = rec
    return out


def solve_off_chip(chol, gain, rhs, x_on, x64):
    """The solve with w_t kept in x between the sweeps, the placement its
    plan takes where w does not fit in shared memory (forced here by a
    budget of one byte): the plan, the time alone, the distance from f64
    and the values that differ bit for bit from the on-chip placement."""
    Wd, B2, _, B = chol.shape
    lib = _build.library("tridiag", {"B2": B2})
    x = torch.empty_like(rhs)
    launch = lambda: tridiag_kernel._launch(lib, "solve", chol, gain, rhs, x,
                                            budget=1)
    launch()
    torch.cuda.synchronize()
    err = rel_err(x.double(), x64)[1]
    differ = bits_differing(x, x_on)[0]
    p = tridiag_kernel.plan(lib, Wd, B, budget=1)
    return dict(plan=p, rel_err=err, bits_differing_from_on_chip=differ,
                ms=time_ms(launch, inner=ALONE_INNER),
                ok=bool(err <= TOL_TRIDIAG and not differ
                        and not p["w_on_chip"]))


def dense_kkt_inputs(batch, n, m, seed):
    """The reduced KKT matrices of config 2's first ρ (its scaled problems)
    and a right-hand side, as the dense path hands them to its kernels."""
    qps = convert.dense_qp_from_numpy(
        *dense_problems(batch, seed, n, m), device="cuda")
    scaled, _ = gadmm.equilibrate(qps, Settings())
    rb = torch.full((batch,), Settings().rho, device="cuda")
    M = scaled.kkt_matrix(_rho_vec(rb, scaled.l, scaled.u), Settings().sigma)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return M, torch.randn((n, batch), generator=gen, device="cuda")


def dense_case(M, rhs):
    """Kernel factor and solve against the plain version run in f64 on the
    same f32 inputs: (factor rel err, solve rel err, Lt, x)."""
    Lt = dense_kernel.factor_lane_major(M)
    x = dense_kernel.solve_lane_major(Lt, rhs)
    L64 = dense_kernel.factor_lane_major_plain(M.double())
    x64 = dense_kernel.solve_lane_major_plain(Lt.double(), rhs.double())
    torch.cuda.synchronize()
    return rel_err(Lt.double(), L64), rel_err(x.double(), x64), Lt, x


def upper_zero_of(Lt):
    """Whether ``Lt[j, i]`` is zero for every i < j (above L's diagonal)."""
    n = Lt.shape[0]
    iu = torch.ones(n, n, dtype=torch.bool, device=Lt.device).tril(-1)
    return bool((Lt[iu] == 0).all())


def spd_lane_major(n, batch, seed):
    """Random SPD matrices ``a aᵀ/n + I/2`` (``tests/test_pallas_dense.py``'s
    family), lane-major ``(n, n, B)`` float32 on the card, and a
    right-hand side: the large-n cases, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((batch, n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    M = a @ a.transpose(1, 2) / n + 0.5 * torch.eye(n, device="cuda",
                                                    dtype=torch.float64)
    rhs = torch.randn((n, batch), generator=gen, device="cuda")
    return M.float().permute(1, 2, 0).contiguous(), rhs


def dense_plans(n, B):
    """The launch plans ``csrc/dense.cu`` takes on this card at (n, B)."""
    lib = dense_kernel._lib()
    budget, sms = dense_kernel.device_limits(lib, torch.device("cuda"))
    return {which: dense_kernel.plan(lib, which, n, B, budget,
                                     dense_kernel.BLOCK_THREADS, sms)
            for which in ("factor", "solve")}


def library_ms(M, rhs):
    """``torch.linalg.cholesky`` and ``torch.cholesky_solve`` on the same
    batch, batch-leading: the library yardsticks (ms)."""
    Mb = M.permute(2, 0, 1).contiguous()
    Lb = torch.linalg.cholesky(Mb)
    rb = rhs.T.contiguous().unsqueeze(-1)
    return (time_ms(lambda: torch.linalg.cholesky(Mb), inner=DENSE_INNER),
            time_ms(lambda: torch.cholesky_solve(rb, Lb), inner=DENSE_INNER))


def check_dense():
    """The dense Cholesky factor and solve kernels (B6) on the main path's
    inputs (config 2: n=64, m=96, B=1024), at the reference kernel's
    largest size (n=160, B=256), and beyond it: n=512 (the factor's
    device-memory branch) and n=2048 (above the earlier kernel's n <= 1816),
    each against the plain version run in f64 on the same f32 inputs;
    library yardsticks ``torch.linalg.cholesky`` and ``torch.cholesky_solve``
    on the same batch at n=64 and n=160."""
    n, B = DENSE_N, BATCH
    M, rhs = dense_kkt_inputs(B, n, DENSE_M, DENSE_SEED)
    f_err, s_err, Lt, _ = dense_case(M, rhs)
    Mg, rg = dense_kkt_inputs(256, 160, 240, 1)
    big = dense_case(Mg, rg)
    # Tail of a block (B=200), one problem (B=1), n=1, and a planted
    # non-positive pivot at column 20 of problem 7.
    odd = dense_case(M[..., :200].contiguous(), rhs[:, :200].contiguous())
    one = dense_case(M[..., :1].contiguous(), rhs[:, :1].contiguous())
    tiny = dense_case(M[:1, :1].contiguous() + 1.0, rhs[:1].contiguous())
    # Beyond the shared-memory triangle (n > 336) and the old limit.
    large = {f"n{nl}_B{bl}": dense_case(*spd_lane_major(nl, bl, nl))
             for nl, bl in DENSE_LARGE}
    bad = M.clone()
    bad[20, 20, 7] = -1.0
    bL = dense_kernel.factor_lane_major(bad)
    bx = dense_kernel.solve_lane_major(bL, rhs)
    # Lt[j, i] holds L[i, j]: the factor's lower triangle is i >= j.
    low = torch.ones(n, n, dtype=torch.bool, device="cuda").triu()
    col = torch.arange(n, device="cuda")[:, None].expand(n, n)
    planted = bL[..., 7]
    others = torch.cat([bL[..., :7], bL[..., 8:]], dim=-1)
    nan_there = bool(torch.isnan(planted[low & (col >= 20)]).all()
                     and torch.isfinite(planted[low & (col < 20)]).all()
                     and torch.isfinite(others).all()
                     and torch.isnan(bx[:, 7]).all()
                     and torch.isfinite(bx[:, :7]).all()
                     and torch.isfinite(bx[:, 8:]).all())
    upper_zero = all(upper_zero_of(L) for L in (Lt, *(c[2] for c in
                                                      large.values())))
    cases = ((f_err, s_err), big, odd, one, tiny, *large.values())
    f_ok = max(c[0][1] for c in cases)
    s_ok = max(c[1][1] for c in cases)
    tm = functools.partial(time_ms, inner=DENSE_INNER)
    f_ms = tm(lambda: dense_kernel.factor_lane_major(M))
    s_ms = tm(lambda: dense_kernel.solve_lane_major(Lt, rhs))
    single = {"factor": time_ms(lambda: dense_kernel.factor_lane_major(M)),
              "solve": time_ms(lambda: dense_kernel.solve_lane_major(Lt, rhs))}
    M64, Lt64, rhs64 = M.double(), Lt.double(), rhs.double()
    fp_ms = tm(lambda: dense_kernel.factor_lane_major_plain(M64))
    sp_ms = tm(lambda: dense_kernel.solve_lane_major_plain(Lt64, rhs64))
    lib_f_ms, lib_s_ms = library_ms(M, rhs)
    Lg = big[2]
    big_ms = {"factor": tm(lambda: dense_kernel.factor_lane_major(Mg)),
              "solve": tm(lambda: dense_kernel.solve_lane_major(Lg, rg))}
    big_lib = dict(zip(("factor", "solve"), library_ms(Mg, rg)))
    # Eight problems: the time of one problem's chain of column steps.
    M8, r8, L8 = (t[..., :8].contiguous() for t in (M, rhs, Lt))
    few_ms = {"factor": tm(lambda: dense_kernel.factor_lane_major(M8)),
              "solve": tm(lambda: dense_kernel.solve_lane_major(L8, r8))}
    fb_ms, fb_by = bound(dense_factor_bytes(n, B), ops_dense_factor(n, B))
    sb_ms, sb_by = bound(dense_solve_bytes(n, B), ops_dense_solve(n, B))
    plans = {f"n{nn}_B{bb}": dense_plans(nn, bb)
             for nn, bb in ((n, B), (160, 256), *DENSE_LARGE)}
    note = ("max abs error over max |f64| against the plain version run in "
            "f64 on the same f32 inputs (the solve from the kernel's own "
            "factor); worst of n=64 B=1024, n=160 B=256, B=200, B=1, n=1, "
            + ", ".join(f"n={a} B={b}" for a, b in DENSE_LARGE))
    shape = f"n={n} B={B} (also n=160 B=256)"
    rel = lambda k: {key: c[k][1] for key, c in large.items()}  # noqa: E731
    return [
        dict(name="dense_factor", max_abs_err=f_err[0], max_rel_err=f_ok,
             rel_err_n160=big[0][1], rel_err_large=rel(0),
             upper_triangle_zero=upper_zero,
             non_spd_gives_nan_there=nan_there, tol=TOL_DENSE_FACTOR,
             tol_note=note,
             ok=bool(f_ok <= TOL_DENSE_FACTOR and upper_zero and nan_there),
             ms=f_ms, plain_ms=fp_ms, bound_ms=fb_ms, bound_by=fb_by,
             library_ms=lib_f_ms, ms_single_call=single["factor"],
             timing_note=f"ms, plain_ms, library_ms: CUDA events over "
                         f"{DENSE_INNER} calls back to back; ms_single_call: "
                         "one call between the events, as the other rows",
             library_note="torch.linalg.cholesky of the (B, n, n) f32 batch",
             n160_B256=dict(ms=big_ms["factor"],
                            library_ms=big_lib["factor"], bound_ms=bound(
                 dense_factor_bytes(160, 256), ops_dense_factor(160, 256))[0]),
             n64_B8_ms=few_ms["factor"],
             plans={k: v["factor"] for k, v in plans.items()},
             shape=shape),
        dict(name="dense_solve", max_abs_err=s_err[0], max_rel_err=s_ok,
             rel_err_n160=big[1][1], rel_err_large=rel(1),
             tol=TOL_DENSE_SOLVE, tol_note=note,
             ok=bool(s_ok <= TOL_DENSE_SOLVE),
             ms=s_ms, plain_ms=sp_ms, bound_ms=sb_ms, bound_by=sb_by,
             library_ms=lib_s_ms, ms_single_call=single["solve"],
             library_note="torch.cholesky_solve on the library's factor",
             n160_B256=dict(ms=big_ms["solve"],
                            library_ms=big_lib["solve"], bound_ms=bound(
                 dense_solve_bytes(160, 256), ops_dense_solve(160, 256))[0]),
             n64_B8_ms=few_ms["solve"],
             plans={k: v["solve"] for k, v in plans.items()},
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
    ruiz_kernel.ruiz_equilibrate_lane_kernel.launches_block = 0
    admm_fused.fused_admm_chunk.launches_block = 0
    residuals.termination_quantities_kernel.launches_block = 0
    kkt_factor.factor_packed_lane.launches = 0
    kkt_factor.factor_packed_lane.launches_gain = 0
    admm_fused.fused_admm_chunk.launches = 0
    admm_fused.fused_admm_chunk.launches_dxdy = 0
    admm_fused.fused_admm_chunk.launches_gain = 0
    residuals.termination_quantities_kernel.launches = 0
    tridiag_kernel.factor_lane_major.launches = 0
    tridiag_kernel.solve_lane_major.launches = 0
    dense_kernel.factor_lane_major.launches = 0
    dense_kernel.solve_lane_major.launches = 0


def read_counts():
    return {
        "ruiz": ruiz_kernel.ruiz_equilibrate_lane_kernel.launches,
        "kkt_factor": kkt_factor.factor_packed_lane.launches,
        "kkt_factor_gain": kkt_factor.factor_packed_lane.launches_gain,
        "admm_chunk": admm_fused.fused_admm_chunk.launches,
        "admm_chunk_dxdy": admm_fused.fused_admm_chunk.launches_dxdy,
        "admm_chunk_gain": admm_fused.fused_admm_chunk.launches_gain,
        "residuals": residuals.termination_quantities_kernel.launches,
        "ruiz_block": ruiz_kernel.ruiz_equilibrate_lane_kernel.launches_block,
        "admm_chunk_block": admm_fused.fused_admm_chunk.launches_block,
        "residuals_block":
            residuals.termination_quantities_kernel.launches_block,
        "tridiag_factor": tridiag_kernel.factor_lane_major.launches,
        "tridiag_solve": tridiag_kernel.solve_lane_major.launches,
        "dense_factor": dense_kernel.factor_lane_major.launches,
        "dense_solve": dense_kernel.solve_lane_major.launches,
    }


class PlainCalls:
    """Counts calls of the kernels' plain versions while active: on a CUDA
    batch the wrappers must launch their kernels, never these."""
    TARGETS = ((ruiz_kernel, "_ruiz_scalings_plain"),
               (kkt_factor, "factor_packed_lane_plain"),
               (admm_fused, "fused_admm_chunk_plain"),
               (residuals, "termination_accumulators_plain"),
               (tridiag_kernel, "factor_lane_major_plain"),
               (tridiag_kernel, "solve_lane_major_plain"))

    def __enter__(self):
        self.calls, self.saved = collections.Counter(), []
        for mod, name in self.TARGETS:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def solve_phase(name, qp, settings, it_window=None, timed=True, host_check=16,
                need=LANE_KERNELS):
    B = qp.batch
    reset_counts()
    syncs0, refac0 = admm_lane.HOST_SYNCS, admm_lane.RHO_REFACTORS
    res = admm_lane.solve_batched_lane(qp, settings)  # the main path, once
    torch.cuda.synchronize()
    counts = read_counts()
    syncs = admm_lane.HOST_SYNCS - syncs0
    refactors = admm_lane.RHO_REFACTORS - refac0
    status = res.status.cpu()
    iters = res.iterations.cpu().to(torch.float64)
    n_opt = int((status == int(ExitCode.kOptimal)).sum())
    p50, it_max = int(iters.median()), int(iters.max())
    finite = bool(torch.isfinite(res.x).all() and torch.isfinite(res.y).all())
    idx = torch.linspace(0, B - 1, host_check).long()
    prim_ratio, dual_ratio, box = host_residual_check(qp, res, idx, settings)
    rec = dict(
        batch=B, optimal=n_opt, iterations_p50=p50, iterations_max=it_max,
        launches=counts, host_syncs=syncs, rho_refactors=refactors,
        finite=finite,
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
    rec["chunks"] = chunks
    rec["result"] = res
    return rec


def check_block_launches(name, rec, settings, chunks, warmups):
    """The block-P path's launches: the block Ruiz once, the
    block-tridiagonal factor once per setup plus once per ρ refactor, no
    stencil factor, the gain chunk once per chunk (plus the warm-up ones) on
    the block-P batch, the block residual kernel once per chunk; no plain
    version called."""
    c = rec["launches"]
    want = dict(ruiz=1, ruiz_block=1, kkt_factor=0,
                tridiag_factor=1 + rec["rho_refactors"],
                admm_chunk=chunks + warmups,
                admm_chunk_block=chunks + warmups,
                admm_chunk_gain=chunks + warmups,
                admm_chunk_dxdy=chunks, residuals=chunks,
                residuals_block=chunks)
    bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
    if bad:
        fail(f"{name}: launches (got, want) {bad}")
    if rec["plain_calls"]:
        fail(f"{name}: plain versions called on the card: "
             f"{rec['plain_calls']}")


def phase_solve_block_p(bp, bench):
    """The honest class with the block-P objective through
    ``solve_batched_lane``: 1024/1024 optimal, the JAX f32 run's p50, at
    most 5 % of problems at another count, the block-P kernels launched as
    the path runs them and no plain version."""
    with PlainCalls() as plain:
        rec = solve_phase("solve_block_p", bp, bench, need=BLOCK_KERNELS)
    rec["plain_calls"] = dict(plain.calls)
    it = rec["result"].iterations.cpu()
    ref = torch.tensor(decode_iters(BLOCK_P_REF["code"], BLOCK_P_REF["ct"],
                                    BLOCK_P_REF["offset"]))
    differ = int((it != ref).sum())
    summary = dict(
        batch=bp.batch, optimal=rec["optimal"],
        iterations_p50=rec["iterations_p50"],
        reference_p50=int(ref.median()), iterations_max=rec["iterations_max"],
        reference_max=int(ref.max()), differ_iterations=differ,
        more_iterations=int((it > ref).sum()),
        fewer_iterations=int((it < ref).sum()),
        launches=rec["launches"], chunks=rec["chunks"],
        rho_refactors=rec["rho_refactors"], plain_calls=rec["plain_calls"],
        ms_per_batch=rec["ms_per_batch"])
    emit("solve_block_p_vs_reference", **summary)
    if (rec["iterations_p50"] != int(ref.median())
            or differ > DENSE_ITER_DIFF_SHARE * bp.batch):
        fail(f"solve_block_p: p50 {rec['iterations_p50']} (reference "
             f"{int(ref.median())}), {differ} of {bp.batch} problems at "
             "another count")
    check_block_launches("solve_block_p", rec, bench, rec["chunks"],
                         int(bench.termination_warmup > 0))
    return rec


def phase_solve_w3(bench):
    """``solve_batched_lane`` on W=3 batches (B=1024, f32, BENCH settings):
    below the Ruiz kernel's 4 waypoints the path equilibrates with the plain
    torch version, as the reference does on the TPU, and runs the factor and
    the fused chunk kernels as at any W.  Box-only: held to the JAX f32 run
    on the same problems, every status equal, 1024/1024 optimal, the
    reference's p50 with at most 5 % of problems at another count.  Honest
    (primal infeasible in three steps): every problem primal infeasible
    (exact or inaccurate), as in JAX; its counts and exact codes are
    recorded beside JAX's, not held: the certificate's iteration follows
    f32 rounding (in f64 the two packages agree problem for problem, p50 35;
    in f32 JAX gives p50 41 and the port on the CPU 45).  Ruiz kernel
    launches 0, the chunk kernel once per chunk (and the warm-up), one sync
    per chunk, no plain version but Ruiz's."""
    infeasible = (int(ExitCode.kPrimalInfeasible),
                  int(ExitCode.kPrimalInfeasibleInaccurate))
    warmups = int(bench.termination_warmup > 0)
    recs = {}
    for kind in ("box", "honest"):
        qp = w3_batch(kind, "cuda")
        ref = W3_REF[kind]
        reset_counts()
        syncs0, refac0 = admm_lane.HOST_SYNCS, admm_lane.RHO_REFACTORS
        with PlainCalls() as plain:
            res = admm_lane.solve_batched_lane(qp, bench)  # the main path
            torch.cuda.synchronize()
        counts = read_counts()
        syncs = admm_lane.HOST_SYNCS - syncs0
        refactors = admm_lane.RHO_REFACTORS - refac0
        status, it = res.status.cpu(), res.iterations.cpu()
        ref_it = torch.tensor(decode_iters(ref["code"], ref["ct"],
                                           ref["offset"]), dtype=it.dtype)
        ref_st = torch.tensor(decode_statuses(ref["statuses"]),
                              dtype=status.dtype)
        it_max = int(it.max())
        chunks = -(-(it_max - bench.termination_warmup)
                   // bench.check_termination)
        rec = dict(
            W=W3, batch=qp.batch, optimal=int((status == 0).sum()),
            statuses={str(k): v for k, v in sorted(
                collections.Counter(status.tolist()).items())},
            same_status=int((status == ref_st).sum()),
            iterations_p50=int(it.median()), iterations_max=it_max,
            reference_p50=int(ref_it.median()),
            reference_max=int(ref_it.max()),
            differ_iterations=int((it != ref_it).sum()),
            launches=counts, host_syncs=syncs, rho_refactors=refactors,
            chunks=chunks, plain_calls=dict(plain.calls),
            finite=bool(torch.isfinite(res.x).all()),
            shape_x=list(res.x.shape))
        if kind == "box":
            rec["f64_prim_dual_box"] = host_residual_check(
                qp, res, torch.linspace(0, qp.batch - 1, 16).long(), bench)
            rec["ms_per_batch"] = statistics.median(
                host_ms(lambda: admm_lane.solve_batched_lane(qp, bench))
                for _ in range(3))
        recs[kind] = rec
    emit("solve_w3", **recs)
    for kind, rec in recs.items():
        ref_st = decode_statuses(W3_REF[kind]["statuses"])
        if kind == "box":
            ok_status = rec["same_status"] == rec["batch"] == rec["optimal"]
        else:
            ok_status = (set(ref_st) <= set(infeasible) and set(
                int(k) for k in rec["statuses"]) <= set(infeasible))
        if not ok_status:
            fail(f"solve_w3 ({kind}): statuses {rec['statuses']}, "
                 f"{rec['same_status']} equal to the reference's")
        if kind == "box" and (
                rec["iterations_p50"] != rec["reference_p50"]
                or rec["differ_iterations"] > DENSE_ITER_DIFF_SHARE * BATCH):
            fail(f"solve_w3 ({kind}): p50 {rec['iterations_p50']} (reference "
                 f"{rec['reference_p50']}), {rec['differ_iterations']} "
                 "problems at another count")
        if not rec["finite"] or rec["shape_x"] != [BATCH, 2 * W3 * N]:
            fail(f"solve_w3 ({kind}): solution not finite or of the wrong "
                 "shape")
        if kind == "box" and max(rec["f64_prim_dual_box"][:2]) > 1.02:
            fail(f"solve_w3 (box): float64 recomputation violates OSQP's "
                 f"criterion {rec['f64_prim_dual_box']}")
        c = rec["launches"]
        want = dict(ruiz=0, ruiz_block=0,
                    kkt_factor=1 + rec["rho_refactors"],
                    admm_chunk=rec["chunks"] + warmups)
        bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
        if bad or rec["host_syncs"] != rec["chunks"]:
            fail(f"solve_w3 ({kind}): launches (got, want) {bad}, "
                 f"{rec['host_syncs']} syncs for {rec['chunks']} chunks")
        if rec["plain_calls"] != {"_ruiz_scalings_plain": 1}:
            fail(f"solve_w3 ({kind}): plain versions called "
                 f"{rec['plain_calls']}, want Ruiz's alone")
    return recs


def phase_solve_block_p_declared(honest, bench, fused_rec):
    """The unchanged honest batch declared ``p_structure="block"``: the
    block forms on vel-diag data.  All optimal; how many problems end at
    another count than phase ``solve`` (f32 sums of 12 products where the
    vel-diag form takes one, and the residual kernel in place of the fused
    accumulators), and the cost of the block forms on the same problems."""
    with PlainCalls() as plain:
        rec = solve_phase("solve_block_p_declared",
                          honest.replace(p_structure="block"), bench,
                          need=BLOCK_KERNELS)
    rec["plain_calls"] = dict(plain.calls)
    ref = (fused_rec["result"] if fused_rec else
           admm_lane.solve_batched_lane(honest, bench))
    res = rec["result"]
    emit("solve_block_p_declared_vs_solve", batch=honest.batch,
         same_status=int((res.status == ref.status).sum()),
         differ_iterations=int((res.iterations != ref.iterations).sum()),
         more_iterations=int((res.iterations > ref.iterations).sum()),
         max_abs_dx=(res.x - ref.x).abs().max().item(),
         ms_per_batch=rec["ms_per_batch"],
         solve_ms_per_batch=fused_rec.get("ms_per_batch") if fused_rec
         else None)
    check_block_launches("solve_block_p_declared", rec, bench, rec["chunks"],
                         int(bench.termination_warmup > 0))
    return rec


def phase_fleet_block_p(bp):
    """``setup_lane`` → ``mpc_scan_lane`` on the block-P batch: 1024
    controllers, the goal equality moving each tick (as ``goal_moving`` of
    the fleet phases), every pair optimal, one Ruiz and one factor at setup
    and none per tick (beyond ρ refactors), no plain version."""
    settings = dataclasses.replace(Settings(), **BLOCK_FLEET)
    B, T, ct = bp.batch, BLOCK_FLEET_TICKS, settings.check_termination
    deltas, shift = fleet_deltas(T), shift_at(GOAL)
    with PlainCalls() as plain:
        reset_counts()
        syncs0, refac0 = admm_lane.HOST_SYNCS, admm_lane.RHO_REFACTORS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = setup_lane(bp, settings)  # the main path: setup ...
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        at_setup = read_counts()
        end, (status, iters) = mpc_scan_lane(sess, deltas, shift, settings)
        torch.cuda.synchronize()
        counts = read_counts()
        syncs = admm_lane.HOST_SYNCS - syncs0
        refactors = admm_lane.RHO_REFACTORS - refac0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mpc_scan_lane(sess, deltas, shift, settings)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        _, res = solve_lane(end, settings)
    st, it = status.cpu(), iters.cpu()
    n_opt = int((st == int(ExitCode.kOptimal)).sum())
    chunks = sum(-(-int(m) // ct) for m in it.max(dim=1).values)
    idx = torch.linspace(0, B - 1, 16).long()
    prim_ratio, dual_ratio, box = host_residual_check(end.base, res, idx,
                                                      settings)
    scan_s = statistics.median(times)
    rec = dict(
        batch=B, ticks=T, update="goal equality (waypoint W-3) moved",
        factor_form_effective="gain", optimal=n_opt, total=B * T,
        tick0_iterations_p50=int(it[0].median()),
        tick0_iterations_max=int(it[0].max()),
        warm_iterations_p50=int(it[1:].median()),
        warm_iterations_max=int(it[1:].max()),
        ms_per_tick=scan_s / T * 1e3, resolves_per_s=B * T / scan_s,
        scan_ms_all=[t * 1e3 for t in times], setup_ms=setup_ms,
        host_syncs=syncs, chunks=chunks, rho_refactors=refactors,
        launches_at_setup=at_setup, launches=counts,
        plain_calls=dict(plain.calls),
        f64_prim_res_over_eps=prim_ratio, f64_dual_res_over_eps=dual_ratio,
        f64_max_box_violation=box)
    emit("mpc_fleet_block_p", **rec)
    name = "mpc_fleet_block_p"
    if n_opt != B * T:
        fail(f"{name}: {n_opt}/{B * T} optimal")
    if prim_ratio > 1.02 or dual_ratio > 1.02 or box > 1e-4:
        fail(f"{name}: float64 recomputation violates OSQP's criterion "
             f"(prim {prim_ratio:.3f}, dual {dual_ratio:.3f}, box {box:.2e})")
    if (at_setup["ruiz_block"], at_setup["tridiag_factor"]) != (1, 1):
        fail(f"{name}: setup launched {at_setup}")
    if syncs != chunks:
        fail(f"{name}: {syncs} host syncs for {chunks} chunks")
    check_block_launches(name, rec, settings, chunks, 0)
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
    bits = term_bits_equal(bench)
    emit("solve_unfused_term_bits", **bits)
    if not bits["ok"]:
        fail("solve_unfused_term: fused accumulators differ from the delta "
             f"form + residual kernel: {bits['differing']}")
    return rec


# ------------------------------------------------------------------ planner


def ur5e_solver(max_waypoints, obstacles, **settings):
    """The planner of the reference's fleet benchmarks: UR5e, wrist ball
    r=0.15, tool ball r=0.05 (gripper), workspace floor y >= -0.4."""
    INF = 1e30
    return GOMPSolver(
        max_waypoints=max_waypoints, time_step=0.1,
        settings=dataclasses.replace(Settings(), **{**PLANNER, **settings}),
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
    N = solver.n_dim
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
            pts = ball_fk_jac(ball, q, jacobian=False)[0]  # (w, 3)
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
    # Every term chunk of a search against the delta form + residual kernel.
    term_bits = search_term_bits(solver, starts, ends)
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
         unfused_differs_in=differ, term_bits=term_bits, finite=finite,
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
    if not term_bits["ok"]:
        fail("planner_full: fused accumulators differ from the delta form + "
             f"residual kernel: {term_bits}")
    if min(counts[k] for k in LANE_KERNELS) < 1 or min(
            counts_u[k] for k in UNFUSED_KERNELS) < 1:
        fail(f"planner_full: a kernel of the path was never launched: "
             f"{counts} / {counts_u}")
    return counts


# The reference example (solver-example.cpp, as examples/solver_example.py
# builds it): start 0, end (π, 0, 0, 0, 0, 0), W_max=802, dt=0.1, 10
# segments, no obstacles, stock Settings(), float32.
EXAMPLE = dict(max_waypoints=802, time_step=0.1, segments=10)
EXAMPLE_START = np.zeros(N)
EXAMPLE_END = np.array([math.pi, 0.0, 0.0, 0.0, 0.0, 0.0])
# The JAX package on the same problem in float32 on the CPU
# (tools/jax_reference_counts.py planner_run): per call the status, the
# winning horizon and every segment's (waypoints, scp_iterations,
# admm_iterations, status).  Recorded beside the port's, not held: in f32
# the counts of the segments without a plan follow rounding.
_JAX_FEASIBLE = [[w, 1, 25, 0] for w in (802, 721, 641, 561, 481, 401, 320)]
JAX_PLANNER_RUN = {
    "run_padded": dict(status="kOptimal", winning_waypoints=320,
                       stats=_JAX_FEASIBLE + [[240, 1, 100, 1], [160, 1, 75, 1],
                                              [80, 1, 100, 1]]),
    "run": dict(status="kOptimal", winning_waypoints=320,
                stats=_JAX_FEASIBLE + [[240, 1, 100, 1], [160, 1, 75, 1],
                                       [80, 1, 125, 1]]),
}


def example_solver(device="cuda"):
    """The reference example's planner: UR5e, wrist ball r=0.15, tool ball
    r=0.05 (the gripper), pos ±2π, vel ±π, acc ±800π/180, the workspace
    floor y >= -0.4, the analytic IK as ``gripper_ik`` (stored, unused)."""
    return GOMPSolver(
        **EXAMPLE,
        pos_con=constraints.in_range(N, -2 * math.pi, 2 * math.pi),
        vel_con=constraints.in_range(N, -math.pi, math.pi),
        acc_con=constraints.in_range(N, -math.pi * 800 / 180,
                                     math.pi * 800 / 180),
        con_3d=constraints.in_range(3, [-constraints.INF, -0.4,
                                        -constraints.INF], None),
        obstacles=[],
        balls=[ur5e.make_ball("back6", 0.15),
               ur5e.make_ball("tool", 0.05, is_gripper=True)],
        gripper_ik=ur5e.inverse_kinematics_position,
        dtype=torch.float32, device=device,
    )


def data_files_ok(ctrl, xyz, n, W):
    """The reference example's ``.data`` contents: ``W`` lines each, ``n``
    ``%g`` numbers a control line, ``(x, y, z)`` a position line."""
    import re

    num = r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?"
    c_lines, x_lines = ctrl.splitlines(), xyz.splitlines()
    return bool(len(c_lines) == len(x_lines) == W and all(
        re.fullmatch(rf"{num}( {num}){{{n - 1}}}", ln) for ln in c_lines)
        and all(re.fullmatch(rf"\({num}, {num}, {num}\)", ln)
                for ln in x_lines))


def check_data_files(q, points):
    """Write the two ``.data`` files of ``q (W, 6)`` and its FK points
    ``(W, 3)`` to a temporary directory, as the reference example does, and
    check their lines: six ``%g`` numbers, and ``(x, y, z)``."""
    import tempfile

    from osqp_solver_tpu_torch.utils.trajectory_io import (
        write_trajectory_files,
    )

    with tempfile.TemporaryDirectory() as d:
        ctrl, xyz = Path(d) / "output_trajectory_ctrl.data", Path(
            d) / "output_trajectory_xyz.data"
        write_trajectory_files(q, points, ctrl, xyz)
        c_text, x_text = ctrl.read_text(), xyz.read_text()
    c_lines, x_lines = c_text.splitlines(), x_text.splitlines()
    return dict(lines=len(c_lines), first_ctrl=c_lines[0] if c_lines else "",
                first_xyz=x_lines[0] if x_lines else "",
                ok=data_files_ok(c_text, x_text, 6, len(q)))


def plan_checks(solver, res):
    """One plan of ``run``/``run_padded`` checked as the reference example
    reads it: status, the winning horizon's shape, the exact-FK audit in
    float64 on the host, start and goal FK against the ground truth, and
    the ``.data`` files."""
    traj = np.asarray(res.trajectory, dtype=np.float64)
    won = [st.waypoints for st in res.stats if st.status == int(
        ExitCode.kOptimal)]
    Ww = min(won) if won else 0
    shape_ok = bool(won) and traj.shape == (2 * Ww * N,)
    finite = bool(np.isfinite(traj).all())
    rec = dict(status=res.status.name, winning_waypoints=Ww,
               stats=[list(st) for st in res.stats], finite=finite,
               shape=list(traj.shape), shape_ok=shape_ok)
    if not (shape_ok and finite):
        return rec
    t = torch.from_numpy(traj)
    audit = audit_plans(solver, torch.tensor([int(res.status)]), t[None],
                        torch.tensor([Ww]))
    q = t[: Ww * N].reshape(Ww, N)
    fk = ur5e.forward_kinematics
    truth = fk(torch.from_numpy(np.stack([EXAMPLE_START, EXAMPLE_END])))
    from osqp_solver_tpu_torch.gomp.trajectory import (
        map_joint_trajectory_to_xyz,
    )

    points = map_joint_trajectory_to_xyz(t, fk, N)
    rec.update(
        audit=audit,
        start_fk_err=(points[0] - truth[0]).abs().max().item(),
        goal_fk_err=(points[Ww - 3] - truth[1]).abs().max().item(),
        fk_summary=dict(start=points[0].tolist(), middle=points[
            min(10, Ww - 1)].tolist(), goal=points[Ww - 3].tolist()),
        data_files=check_data_files(q.numpy(), points.numpy()))
    return rec


def phase_planner_run():
    """The reference example on the card: ``run`` (one session per
    horizon) and ``run_padded`` (one W_max-shaped session layout), each
    once as the path with the launch counters from 0, then timed; where
    the time goes (device time inside the tridiagonal kernels, host
    reads)."""
    solver = example_solver()
    lib = _build.library("tridiag", {"B2": 2 * N})
    rec = dict(jax_f32_cpu=JAX_PLANNER_RUN,
               solve_plan_W802_B1=tridiag_kernel.plan(lib, 802, 1),
               factor_plan_B1=tridiag_kernel.factor_plan(lib, 1))
    for name in ("run", "run_padded"):
        call = getattr(solver, name)
        reset_counts()
        p0, h0 = planner.PLANNER_SYNCS, gadmm.HOST_SYNCS
        with PlainCalls() as plain:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(EXAMPLE_START, EXAMPLE_END)  # the path, once
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        r = plan_checks(solver, res)
        r.update(wall_ms=wall, launches={k: counts[k] for k in
                                         TRIDIAG_KERNELS},
                 all_launches=counts, plain_calls=dict(plain.calls),
                 planner_host_syncs=planner.PLANNER_SYNCS - p0,
                 solver_host_syncs=gadmm.HOST_SYNCS - h0,
                 scp_rounds=sum(st.scp_iterations for st in res.stats),
                 admm_iterations=sum(st.admm_iterations for st in res.stats))
        # Timed again, and once with CUDA events around the two kernels'
        # wrappers (their device time) inside the host-clock wall.
        r["wall_ms_again"] = host_ms(lambda: call(EXAMPLE_START, EXAMPLE_END))
        timer = CallTimer()
        timer.patch(tridiag_kernel, "factor_lane_major", "tridiag_factor")
        timer.patch(tridiag_kernel, "solve_lane_major", "tridiag_solve")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(EXAMPLE_START, EXAMPLE_END)
            totals = timer.totals()
            whole = (time.perf_counter() - t0) * 1e3
        finally:
            timer.restore()
        kern = sum(v["ms"] for v in totals.values())
        r["where_ms"] = dict(totals, whole_ms=whole, kernels_ms=kern,
                             outside_kernels_ms=whole - kern)
        rec[name] = r
    emit("planner_run", **rec)
    for name in ("run", "run_padded"):
        r = rec[name]
        if r["status"] != "kOptimal":
            fail(f"planner_run: {name} ended {r['status']}")
        if not (r["finite"] and r["shape_ok"]):
            fail(f"planner_run: {name}: trajectory not finite or of the "
                 f"wrong shape {r['shape']}")
        if r["audit"]["workspace_margin"] < -(ERROR + 1e-5):
            fail(f"planner_run: {name}: exact-FK audit: the gripper ball "
                 f"leaves the workspace by {-r['audit']['workspace_margin']}")
        if r["audit"]["velocity_mismatch"] > 0.2:
            fail(f"planner_run: {name}: velocities are not position "
                 "differences over dt")
        if max(r["start_fk_err"], r["goal_fk_err"]) > 1e-3:
            fail(f"planner_run: {name}: start/goal FK off the ground truth "
                 f"({r['start_fk_err']:.2e}, {r['goal_fk_err']:.2e})")
        if not r["data_files"]["ok"]:
            fail(f"planner_run: {name}: .data files: {r['data_files']}")
        if min(r["launches"].values()) < 1 or r["plain_calls"]:
            fail(f"planner_run: {name}: launches {r['launches']}, plain "
                 f"versions {r['plain_calls']}")
        if r["planner_host_syncs"] != r["scp_rounds"]:
            fail(f"planner_run: {name}: {r['planner_host_syncs']} planner "
                 f"reads for {r['scp_rounds']} SCP rounds")
    return {k: rec["run"]["launches"][k] + rec["run_padded"]["launches"][k]
            for k in TRIDIAG_KERNELS}


def phase_planner_batch():
    """``run_batch`` (one session with a trailing batch dim) against
    ``run_batch_lane`` on 256 UR5e fleet queries at W=50, as the JAX
    package's tests/test_planner.py::test_run_batch_lane_matches_run_batch
    holds them: equal statuses, every query optimal, SCP rounds within 2,
    every plan through the exact-FK audit."""
    B, Wb = 256, 50
    solver = ur5e_solver(Wb, [])
    starts, ends = fleet_queries(B, np.random.default_rng(1))
    reset_counts()
    p0 = planner.PLANNER_SYNCS
    with PlainCalls() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_v, tr_v, it_v = solver.run_batch(starts, ends, Wb)  # the path
        torch.cuda.synchronize()
        ms_v = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    syncs = planner.PLANNER_SYNCS - p0
    t0 = time.perf_counter()
    st_l, tr_l, it_l = solver.run_batch_lane(starts, ends, Wb)
    torch.cuda.synchronize()
    ms_l = (time.perf_counter() - t0) * 1e3
    hz = torch.full((B,), Wb)
    audit_v = audit_plans(solver, st_v, tr_v, hz)
    audit_l = audit_plans(solver, st_l, tr_l, hz)
    rounds_diff = int((it_v - it_l).abs().max())
    same = bool(torch.equal(st_v, st_l))
    n_opt = int((st_v == int(ExitCode.kOptimal)).sum())
    emit("planner_batch", batch=B, waypoints=Wb, run_batch_ms=ms_v,
         run_batch_lane_ms=ms_l, optimal=n_opt, statuses_equal=same,
         scp_rounds_max_diff=rounds_diff,
         scp_rounds_p50=pct(it_v.float(), 50), scp_rounds_max=int(it_v.max()),
         max_traj_diff=(tr_v - tr_l).abs().max().item(),
         planner_host_syncs=syncs, launches=counts,
         plain_calls=dict(plain.calls), audit_run_batch=audit_v,
         audit_run_batch_lane=audit_l,
         finite=bool(torch.isfinite(tr_v).all()))
    if not same or n_opt != B:
        fail(f"planner_batch: statuses equal {same}, {n_opt}/{B} optimal")
    if rounds_diff > 2:
        fail(f"planner_batch: SCP rounds differ by {rounds_diff} > 2")
    for a in (audit_v, audit_l):
        if a["n_audited"] != B or a["workspace_margin"] < -(ERROR + 1e-5) \
                or a["velocity_mismatch"] > 0.2:
            fail(f"planner_batch: exact-FK audit failed: {a}")
    if min(counts[k] for k in TRIDIAG_KERNELS) < 1 or plain.calls:
        fail(f"planner_batch: launches {counts}, plain versions "
             f"{dict(plain.calls)}")


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


# ------------------------------------------------------------ generic path
# Per-problem (per-step) ADMM iteration counts of the JAX package's float32
# CPU run on the same problems (tools/jax_reference_counts.py), in
# encode_iters form.
DENSE_REF = dict(p50=50, max=150, code=(
    "2222223432223223423332242222322342323233222323222323232322323224"
    "2513223233223324322322222333424323522222323422322523213222223232"
    "2222232222342222422222223222434222222222323222332223442323322522"
    "3233222223222222223422223322222222342333223222233423222222322223"
    "2222223223223222242432222332222222243222222132222222223222223222"
    "3222232232223222322222423222221222332336222324222222232223222242"
    "2222222222223222222522322223222233232332222224223322232232322232"
    "3222322223323232222323322222232222222322222232223222223322422222"
    "2352244233332222322322224223323322222222222333222322232353213233"
    "3222222222232322222222322321222222232222222232433622223223322222"
    "2222242332223222223222222322332222322222222322422322223222432342"
    "2323322224222223223433223222222232232322222222322232223222322222"
    "2322223222222233442323232222322222423232322223222223222223222232"
    "3222322222223323223222222222232232222332443222222221342232123223"
    "2222422222322242222223222432231332224322222222332232232222222223"
    "3232222325231422223233223322122223323222423222322332232223232223"))
SESSION_REF_ITERS = 25  # every one of the 1000 re-solves
CONFIG1_REF_ITERS = 25
GOAL_REF = dict(ct=5, code=(
    "e211111111111112111112111121111211112111121111121111211112111112"
    "1111211112111121111121111211112111121111211112111121111211111211"
    "1121111211112111121111211112111121111211111211112111121111211112"
    "11112111"))
# Share of config 2's problems whose iteration count may differ from the
# reference's: float32 on the card and on the CPU round differently.
DENSE_ITER_DIFF_SHARE = 0.05
# solve_block_p: the JAX package's float32 CPU counts on the same 1024
# block-P problems (tools/jax_reference_counts.py solve_block_p): 1024/1024
# optimal, p50 37 (lower median), max 59; checks at 21 + 2k iterations.
BLOCK_P_REF = dict(ct=2, offset=1, code=(
    "hhifekhnkhoihkeljhlqikhfqniihllkmmkfhqifkighhigijgghpgdgiiikfjkj"
    "gmhmgifjijmjjnfjhogiqklihjjfjgikfemklfjehnnhnimihnggiggkigfmjfhj"
    "njklingliijlkikiphjihmlkiefpnnienkkmmhohfgkgnmikhhhlijomhihikjge"
    "gjkgikhlhkkhgiifljeilmmghiiljihfhggffijgehegflfmeogigkfjlhjhlnlh"
    "gkkhhelfkhgiffhilfikggihfgjhfjmgllgjehjfjgkjgphiikfljljieilfkmoh"
    "khhmhjjjfghkjelilmfmflgfijfgfifkpigjlmkgpnlglhiijigfhgjljphgjngj"
    "kjmlnnfggiiolkifmigiigigijiielgjmghiljgikhkhjkjkoiklfhknhgifoggm"
    "ngmkikekkghkikkhlfgkhjmifjlhfjlggdjfifiiggiiihipjnjfigjqjogjkifh"
    "kgifitolhokgmhhngjihkgrkkoigflilgikihhlmikilikjgihgkglfikklkigkn"
    "hgmoflhhlfjhmifgfifoiihklhhhhfehhofolkgihgrkhjlgijioijjhggjiggih"
    "gkjjikpigjkjhhlhjlnkjfihjihgpjggilomhfigoejinghnfkjhiljfhgkigfig"
    "fiilijkglihhljmfgilklhjlggfdngjjifkkgijhhnjihfjfkglkfhifkmhljmfh"
    "mkhjhknmggifjeffngnghknikgikqiijominkihgenlfggfhhgojjljohfmjplpi"
    "giijjlmiofllgfkjijigggimklilknkgngjnniihklifmpfifktihipjiolhiimh"
    "gjlghkhrkgjjjfjkghghhfkkjmjfikhfiiiikjhiikeigggnfjgmmggjhnmihfjh"
    "llgmgljgekihmhgomkgpohnkhiqkljghghfgiljmiigijkgihhijqmflnklgjknl"))

# The JAX package's float32 runs on the CPU of solve_anderson's and
# solve_polish's batch (``tools/jax_reference_counts.py solve_anderson
# solve_polish``): p50 and histogram of the iterations at ANDERSON and at
# ANDERSON_RHO (1024/1024 optimal at both), and how many problems its
# polish moved at the bench.py settings (statuses equal to the unpolished
# run's).
ANDERSON_REF = {
    "base": dict(p50=42, max=48, hist={"36": 306, "39": 16, "42": 649,
                                       "45": 24, "48": 29}),
    "rho": dict(p50=63, max=105, hist={
        "33": 1, "39": 5, "42": 38, "45": 130, "48": 47, "51": 32, "54": 24,
        "57": 89, "60": 51, "63": 419, "66": 38, "69": 30, "72": 54,
        "75": 17, "78": 10, "81": 12, "84": 10, "87": 6, "93": 5, "96": 1,
        "99": 2, "102": 2, "105": 1}),
}
POLISH_REF = dict(polished=0, same_status=1024)
# ``tools/jax_reference_counts.py planner_long``: run_batch_lane of the JAX
# package at W=1100 in float32 on planner_long's 64 queries: exit codes and
# SCP rounds per query in encode_statuses form (64/64 optimal, one round
# each).
PLANNER_LONG_REF = dict(statuses="0" * 64, rounds="1" * 64)

# solve_w3: the JAX package's float32 CPU run on the same W=3 batches
# (tools/jax_reference_counts.py solve_w3): iteration counts in
# encode_iters form (checks at 21 + 2k) and exit codes in
# encode_statuses form.  Box: 1024/1024 optimal at 23 iterations;
# honest: 1024 primal infeasible (codes 1 and 4), p50 41, max 83.
W3_REF = {
    "box": dict(ct=2, offset=1, code="b" * 1024,
                statuses="0" * 1024),
    "honest": dict(ct=2, offset=1, code=(
        "lnghjmkhlrkkqtittlngjqglhjjgtkhilogjjktshttsttiijktognqmgikgimgi"
        "hkmkgFthhmgihhpnlimjjtFtimftiigqhjCnmkhjsisjmtmjkljjhogkgFktrokh"
        "iiqgjltjrlhgtlhkhqhkknthkgilrntjmjjggihftjtmglmgthotngihtthkkmth"
        "FFtkgthmjnghufmstjkkkhFmqihtrgkhttghtmjiitgopiglhtrtgkkghgritjht"
        "giiiptkyyqngpkjirlgjhtghoktjniiitjphthhFziiotogikomhtgimoEthnglj"
        "gtgoztFhojtqhigoggirttvthlipgilrkptgmgmgglgjjhtjktrhqrpohnkkjmgt"
        "hrtglkljgFgjjhifhkgogkgiFhisjjitpqhgtokitkltgntttmrkttmihighugkf"
        "DutsjgholtgltFtirjhlitthjggqnniiwfmihgEgkiqjgitjipjottfijkjhitng"
        "jhliithhkmlgkhhggklhmthttisnjtikqhjttfjttlgiffgttknlpFoqhiltlhnn"
        "lmlnjoktjpjtjoiilhiphihlkhhijljlmltitgttjhgjtnmjnggtzgjhtiqllmih"
        "jntkspjgmkAulktotjjrihlpltzhktnFrjlhojtkghighgnhtjglrihhhmhkhkkD"
        "hhhtskgggliifmwntrpgtlFgqgtkjgztmgjhgghghhjitoiFqiijhighkgmjoqng"
        "pkjmpgjAjggsjptthitkqiggtoiminqtsttisqihmjjginjjklipthzgmhiirpgh"
        "jpptlgikjhmqhhisinggjoihtglgllgglkmmkkFgnlilinilgkjgroFpFtthhksj"
        "iptipgtfhtqitFuiqgiohfshtoitnotoFqgnjgltitllttlthrptigimthkkhhgh"
        "ijhtlmgjthttFihtFftgvjtgqFlsthqlhklkmqjghhtnlqkhionoyklokivjthhi"),
        statuses=(
        "1111111111111414411111111111111111111141144114111141111111111111"
        "1111141111111111111114441114111111111111111111111111111114141111"
        "1111114111114111111111411111114111111111414111114114111144111141"
        "4141111111111111411111411111111144114111141111111414111111114114"
        "1111141111111111111114111141111141114114111141111111411111411111"
        "1411144111411111111144141111111111411111111111411411111111111114"
        "1141111114111111111111114111111411114111411411441111111111111111"
        "1141111114114441111114411111111111111111111111411111441111111411"
        "1111141111111111111114141111111111144114411111144111141111141111"
        "1111111411141111111111111111111111414144111141111114111141111111"
        "1141111111111141111111111411141411111141111111114111111111111111"
        "1114111111111111411141411141111411111111111141141111111111111111"
        "1111111111111144114111114111111114411111111111111111411111111111"
        "1114111111111111111111114111111111111141111111111111114144411111"
        "1141114114114411111111114114114141111114141144141111111141111111"
        "1114111111411114114111411411411111111111114111111111111111114111")),
}

def host_residual_check_generic(qp, res, idx, settings):
    """OSQP's criterion recomputed in float64 on the host through the
    operator protocol, for problems ``idx`` of a container and its result
    (both with one batch dim, or both without); the worst
    residual/tolerance ratios and the worst box violation."""
    if not qp.batch_shape:
        qp = qp.map_arrays(lambda a: a.unsqueeze(-1))
        res = dataclasses.replace(res, x=res.x[None], y=res.y[None],
                                  z=res.z[None])
    sub = qp.map_arrays(lambda a: a[..., idx].cpu().double())
    x, y, z = (getattr(res, k)[idx].cpu().double().T for k in "xyz")
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


def generic_where_ms(run):
    """One instrumented ``run()`` of the generic path: CUDA-event time in
    the dense and tridiagonal kernels, in the rest of each ADMM iteration
    (matvecs and elementwise glue), in the termination pass, in the ρ
    refactors and in equilibration; ``other`` is the run less those."""
    timer = CallTimer()
    parts = {"iteration": (gadmm, "_admm_iteration"),
             "termination": (gadmm, "_termination"),
             "rho_refactor": (gadmm, "_adapt_rho"),
             "equilibrate": (gadmm, "equilibrate")}
    for key, (mod, name) in parts.items():
        timer.patch(mod, name, key)
    for mod in (dense_kernel, tridiag_kernel):
        timer.patch(mod, "solve_lane_major", "solve_kernel")
        timer.patch(mod, "factor_lane_major", "factor_kernel")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        totals = timer.totals()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        timer.restore()
    get = lambda k: totals.get(k, {}).get("ms", 0.0)  # noqa: E731
    totals["iteration_glue_ms"] = get("iteration") - get("solve_kernel")
    totals["whole_ms"] = wall
    totals["other_ms"] = wall - sum(get(k) for k in parts)
    return totals


def generic_counts(before_syncs, before_refactors):
    torch.cuda.synchronize()
    return (read_counts(), gadmm.HOST_SYNCS - before_syncs,
            gadmm.RHO_REFACTORS - before_refactors)


def dense_option_checks():
    """The generic path's options on the card, 64 problems each: polish (a
    second factor launch and 1 + ``polish_refine_iter`` more solves),
    ``kkt_refine=1`` (two solves per iteration), the CG backend (no dense
    kernel at all), and a badly scaled batch with ``scaling=0`` whose ρ
    adapts (a refactor per adapting chunk).  Every problem must end
    kOptimal."""
    base = Settings()
    P, q, A, l, u = dense_problems(64, seed=5)
    scale = np.tile(np.array([1, 1e3, 1, 1e-3, 1, 30, 1, 0.1], np.float32), 8)
    mixed = (P * scale[:, None, None], q * scale[:, None], A, l, u)
    cases = {
        "polish": ((P, q, A, l, u), dict(polish=True)),
        "kkt_refine": ((P, q, A, l, u), dict(kkt_refine=1)),
        "cg": ((P, q, A, l, u), dict(kkt_method="cg")),
        "adapting_scaling0": (mixed, dict(scaling=0)),
    }
    out, bad = {}, []
    for name, (arrays, kw) in cases.items():
        settings = dataclasses.replace(base, **kw)
        qps = convert.dense_qp_from_numpy(*arrays, device="cuda")
        reset_counts()
        s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
        res = gadmm.solve_batched(qps, settings)
        counts, syncs, refactors = generic_counts(s0, r0)
        its = int(res.iterations.max())
        n_opt = int((res.status == int(ExitCode.kOptimal)).sum())
        f, sv = counts["dense_factor"], counts["dense_solve"]
        polish_solves = its + 1 + settings.polish_refine_iter
        want = {"polish": (2 + refactors, polish_solves),
                "kkt_refine": (1 + refactors, 2 * its),
                "cg": (0, 0),
                "adapting_scaling0": (1 + refactors, its)}[name]
        out[name] = dict(optimal=n_opt, iterations_max=its, host_syncs=syncs,
                         rho_refactors=refactors, dense_factor=f,
                         dense_solve=sv, want_factor_solve=list(want))
        if (n_opt != 64 or (f, sv) != want
                or (name == "adapting_scaling0" and refactors < 1)):
            bad.append(name)
    return out, bad


def phase_dense():
    """BASELINE config 2 on the generic path: ``solve_batched`` on 1024
    dense random box QPs (n=64, m=96, f32, ``Settings()``)."""
    settings = Settings()
    B, ct = BATCH, settings.check_termination
    qps = convert.dense_qp_from_numpy(*dense_problems(B), device="cuda")
    reset_counts()
    s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
    res = gadmm.solve_batched(qps, settings)  # the main path, once
    counts, syncs, refactors = generic_counts(s0, r0)
    it = res.iterations.cpu()
    n_opt = int((res.status == int(ExitCode.kOptimal)).sum())
    ref = torch.tensor(decode_iters(DENSE_REF["code"], ct)[:B], dtype=it.dtype)
    differ = int((it != ref).sum())
    p50, it_max = int(it.double().median()), int(it.max())
    idx = torch.linspace(0, B - 1, 16).long()
    prim_ratio, dual_ratio, box = host_residual_check_generic(
        qps, res, idx, settings)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gadmm.solve_batched(qps, settings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    where = generic_where_ms(lambda: gadmm.solve_batched(qps, settings))
    options, bad_options = dense_option_checks()
    finite = bool(torch.isfinite(res.x).all() and torch.isfinite(res.y).all())
    rec = dict(
        batch=B, n=DENSE_N, m=DENSE_M, optimal=n_opt, iterations_p50=p50,
        iterations_max=it_max, reference_p50=DENSE_REF["p50"],
        reference_max=DENSE_REF["max"], differ_iterations=differ,
        more_iterations=int((it > ref).sum()),
        fewer_iterations=int((it < ref).sum()),
        iterations_hist={str(k): v for k, v in sorted(
            collections.Counter(it.tolist()).items())},
        launches=counts, host_syncs=syncs, rho_refactors=refactors,
        finite=finite, shape_x=list(res.x.shape),
        f64_prim_res_over_eps=prim_ratio, f64_dual_res_over_eps=dual_ratio,
        f64_max_box_violation=box, ms_per_batch=ms,
        qps_per_s=n_opt / (ms * 1e-3), ms_all=[t * 1e3 for t in times],
        where_ms=where, options=options)
    emit("dense", **rec)
    if bad_options:
        fail(f"dense: option checks failed: {bad_options}: {options}")
    if n_opt != B:
        fail(f"dense: {n_opt}/{B} optimal")
    if not finite or list(res.x.shape) != [B, DENSE_N]:
        fail("dense: solution not finite or of the wrong shape")
    if p50 != DENSE_REF["p50"] or differ > DENSE_ITER_DIFF_SHARE * B:
        fail(f"dense: iterations p50 {p50} (reference {DENSE_REF['p50']}), "
             f"{differ}/{B} problems differ from the reference")
    if prim_ratio > 1.02 or dual_ratio > 1.02 or box > 1e-4:
        fail(f"dense: float64 recomputation violates OSQP's criterion "
             f"(prim {prim_ratio:.3f}, dual {dual_ratio:.3f}, box {box:.2e})")
    chunks = -(-it_max // ct)
    if syncs != chunks:
        fail(f"dense: {syncs} host syncs for {chunks} chunks")
    if (counts["dense_factor"] != 1 + refactors
            or counts["dense_solve"] != chunks * ct):
        fail(f"dense: {counts['dense_factor']} factor launches for 1 setup + "
             f"{refactors} refactors, {counts['dense_solve']} solve launches "
             f"for {chunks * ct} iterations")
    return rec


def phase_dense_session():
    """BASELINE config 4: ``session.setup`` then ``mpc_scan`` over 1000
    sequential bound shifts of the n=8 identity QP, on the cached factor."""
    settings = Settings()
    ct = settings.check_termination
    qp_np, shifts_np = session_problem()
    qp = convert.dense_qp_from_numpy(*qp_np, device="cuda")
    shifts = torch.tensor(shifts_np, device="cuda")
    reset_counts()
    s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = gsession.setup(qp, settings)  # the main path: setup ...
    end, (xs, status, iters) = gsession.mpc_scan(  # ... and scan
        sess, shifts, shift_box, settings)
    counts, syncs, refactors = generic_counts(s0, r0)
    first_s = time.perf_counter() - t0
    # Timed: the first SESSION_TIMED steps again, from the same session.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gsession.mpc_scan(sess, shifts[:SESSION_TIMED], shift_box, settings)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    it, st = iters.cpu(), status.cpu()
    n_opt = int((st == int(ExitCode.kOptimal)).sum())
    # x* = 0 at every step: the box [-1 + s, 1 + s] holds it for s <= 0.3.
    x_err = xs.abs().max().item()
    rec = dict(steps=SESSION_STEPS, n=8, optimal=n_opt,
               iterations_hist={str(k): v for k, v in sorted(
                   collections.Counter(it.tolist()).items())},
               reference_iterations=SESSION_REF_ITERS,
               differ_iterations=int((it != SESSION_REF_ITERS).sum()),
               max_abs_x=x_err, launches=counts, host_syncs=syncs,
               rho_refactors=refactors, first_scan_s=first_s,
               timed_steps=SESSION_TIMED,
               resolves_per_s=SESSION_TIMED / scan_s,
               ms_per_resolve=scan_s / SESSION_TIMED * 1e3)
    emit("dense_session", **rec)
    total = int(it.sum())
    if n_opt != SESSION_STEPS or rec["differ_iterations"]:
        fail(f"dense_session: {n_opt} optimal, {rec['differ_iterations']} "
             "re-solves with iteration counts other than the reference's")
    if x_err > 1e-2:
        fail(f"dense_session: |x| up to {x_err:.2e}, the optimum is 0")
    if counts["dense_factor"] != 1 + refactors or refactors:
        fail(f"dense_session: {counts['dense_factor']} factor launches, "
             f"{refactors} refactors: the cached factor must serve the scan")
    if counts["dense_solve"] != total or syncs != total // ct:
        fail(f"dense_session: {counts['dense_solve']} solve launches and "
             f"{syncs} syncs for {total} iterations")
    return rec


def phase_trajectory_generic():
    """The generic path on the trajectory container: config 1 (W=10, one
    ``solve``) and config 4b (the honest W=100 UR5e QP, one session,
    ``check_termination=5``, 200 goal shifts), with the block-tridiagonal
    kernels as its factor and solve."""
    settings = Settings()
    qp1 = trajectory_config1("cuda")
    reset_counts()
    s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
    res1 = gadmm.solve(qp1, settings)  # the main path: one solve ...
    counts1, syncs1, ref1 = generic_counts(s0, r0)
    it1 = int(res1.iterations)
    ms1 = time_ms(lambda: gadmm.solve(qp1, settings))
    chk1 = host_residual_check_generic(qp1, res1, [0], settings)

    s4b = dataclasses.replace(settings, check_termination=5)
    qp4b = trajectory_config4b("cuda")
    deltas = torch.tensor(goal_deltas(), device="cuda")
    reset_counts()
    s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
    sess = gsession.setup(qp4b, s4b)  # ... and a session scan
    end, (xs, status, iters) = gsession.mpc_scan(sess, deltas, shift_goal,
                                                 s4b)
    counts4, syncs4, ref4 = generic_counts(s0, r0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gsession.mpc_scan(sess, deltas, shift_goal, s4b)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    it, st = iters.cpu(), status.cpu()
    ref = torch.tensor(decode_iters(GOAL_REF["code"], GOAL_REF["ct"]))
    _, res_end = gsession.solve(end, s4b)
    chk4 = host_residual_check_generic(
        gsession._user_view(end, end.base), res_end, [0], s4b)
    rec = dict(
        config1=dict(W=10, status=int(res1.status), iterations=it1,
                     reference_iterations=CONFIG1_REF_ITERS,
                     launches=counts1, host_syncs=syncs1, rho_refactors=ref1,
                     ms_per_solve=ms1, f64_prim_dual_box=chk1),
        config4b=dict(
            W=100, steps=GOAL_STEPS, optimal=int((st == 0).sum()),
            iterations_hist={str(k): v for k, v in sorted(
                collections.Counter(it.tolist()).items())},
            reference_hist={str(k): v for k, v in sorted(
                collections.Counter(ref.tolist()).items())},
            differ_iterations=int((it != ref).sum()),
            launches=counts4, host_syncs=syncs4, rho_refactors=ref4,
            shifted_rows_loose=bool((qp4b.pos_l[-1] <= -1e25).all()
                                    and (qp4b.pos_u[-1] >= 1e25).all()),
            ms_per_resolve=scan_s / GOAL_STEPS * 1e3,
            resolves_per_s=GOAL_STEPS / scan_s, f64_prim_dual_box=chk4))
    emit("trajectory_generic", **rec)
    c1, c4 = rec["config1"], rec["config4b"]
    if c1["status"] != 0 or it1 != CONFIG1_REF_ITERS:
        fail(f"trajectory_generic (config 1): status {c1['status']}, "
             f"{it1} iterations (reference {CONFIG1_REF_ITERS})")
    # The shifted rows are loose, so every warm step re-solves the same
    # problem, and WHICH step needs a second chunk follows the float32
    # rounding of the carried iterate: the cold step and the histogram of
    # the warm ones are held to the reference, step by step is recorded.
    if (c4["optimal"] != GOAL_STEPS or int(it[0]) != int(ref[0])
            or c4["iterations_hist"] != c4["reference_hist"]):
        fail(f"trajectory_generic (config 4b): {c4['optimal']} optimal, "
             f"first step {int(it[0])} iterations (reference {int(ref[0])}), "
             f"histogram {c4['iterations_hist']} (reference "
             f"{c4['reference_hist']})")
    for name, chk in (("config 1", chk1), ("config 4b", chk4)):
        if chk[0] > 1.02 or chk[1] > 1.02 or chk[2] > 1e-4:
            fail(f"trajectory_generic ({name}): float64 recomputation "
                 f"violates OSQP's criterion {chk}")
    total = int(it.sum())
    for name, counts, syncs, refs, iters_, ct in (
            ("config 1", counts1, syncs1, ref1, it1,
             settings.check_termination),
            ("config 4b", counts4, syncs4, ref4, total, 5)):
        if (counts["tridiag_factor"] != 1 + refs
                or counts["tridiag_solve"] != iters_
                or syncs != iters_ // ct or counts["dense_solve"]):
            fail(f"trajectory_generic ({name}): launches {counts}, {syncs} "
                 f"syncs, {refs} refactors for {iters_} iterations")
    return rec


# ---------------------------------------------------------------------------
# Queue A2 and the lane kernels above 6 joints (C1).
# ---------------------------------------------------------------------------
# The joint counts the lane kernels are proven at: N=7 (the iiwa14), 9 and
# 10 (the 16-bit Schur tables of the tridiagonal factor), 12 and 16 (the
# rows of a step split among a warp's lanes: every kernel's large form).
LANE_SIZES = (7, 9, 10, 12, 16)
SIZE_SEED = 12
# Above 16 joints (lane_wide): the wide forms (a group of 64 threads at
# N=17-32, 128 at N=33-64, 256 at N=65-128 and 512 above, one problem a
# block) at W=100, B=256, and at N=100, 256 and 300 at the sizes whose f32
# factor array and f64 plain versions fit beside each other on the card
# (200^2 x 4 x 50 x 64 = 512 MB, 512^2 x 4 x 20 x 8 = 168 MB, 600^2 x 4 x
# 10 x 8 = 115 MB); N=40 is a partial group of 128 (a humanoid's joint
# count), 100 one of 256, 256 a full group of 512, and at N=300 (several
# arms planned as one QP) the 512 threads own the 600 columns, 88 of them
# a second one.  At N=32 also with their rings and windows
# forced into the device-memory workspace; from N=64 the plans put rings
# and windows there unforced (WIDE_UNFORCED); the tridiagonal pair alone up
# to B2=600, on chip and in the workspace.  At N=300 the lane path also
# takes a session's setup and one tick, and a polished solve (COLS_SIZES).
WIDE_SIZES = (17, 24, 32, 40, 64, 100, 256, 300)
WIDE_BATCH = 256
WIDE_SHAPES = {n: (W, WIDE_BATCH) for n in WIDE_SIZES} | {
    100: (50, 64), 256: (20, 8), 300: (10, 8)}
COLS_SIZES = (300,)
WORKSPACE_SIZES = (32,)
WIDE_UNFORCED = {
    64: ("admm_chunk_gain", "tridiag_factor", "tridiag_solve"),
    100: ("admm_chunk", "admm_chunk_dxdy", "admm_chunk_gain",
          "tridiag_factor", "tridiag_solve"),
    256: ("kkt_factor", "admm_chunk", "admm_chunk_dxdy", "admm_chunk_gain",
          "tridiag_factor", "tridiag_solve"),
    300: ("kkt_factor", "admm_chunk", "admm_chunk_dxdy", "admm_chunk_gain",
          "residuals", "tridiag_factor", "tridiag_solve")}
WIDE_TRIDIAG = {f"B2_{b2}": (b2, W, WIDE_BATCH)
                for b2 in (34, 48, 64, 96)} | {
    "B2_130": (130, 50, 64), "B2_200": (200, 50, 64), "B2_512": (512, 20, 8),
    "B2_600": (600, 10, 8), "B2_80_B1": (80, W, 1), "B2_512_B1": (512, 20, 1)}
WIDE_TRIDIAG_WORKSPACE = {"B2_64_workspace": (64, W, WIDE_BATCH),
                          "B2_96_workspace": (96, W, WIDE_BATCH)}


def size_batch(Nj, batch=BATCH, Wd=W, seed=SIZE_SEED):
    """A box-only batch of ``Nj`` joints (``build_box_batch``) with the
    honest class's row structure added as the tests' random batches add it
    (``tests/test_torch_helpers.py``): a wrist ball and a gripper ball, the
    gripper's three workspace rows and one obstacle row per ball, seeded
    Jacobians, finite one- and two-sided bounds that the box solution keeps
    inactive (|J q| stays below 0.1 N max|q|).  NX = 5, as the honest
    class: the same builds of the lane kernels, at another NDIM."""
    qp = build_box_batch(batch, Wd, Nj, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + Nj)
    kw = dict(dtype=torch.float32, device="cuda")
    jac = lambda *shape: 0.2 * torch.rand(  # noqa: E731
        shape, generator=gen, **kw) - 0.1
    ws_jac = jac(2, Wd, 3, Nj, batch)
    ws_jac[0] = 0.0  # the wrist ball is no gripper: no workspace rows
    bound = 0.1 * Nj * 1.1 + 1.0
    return qp.replace(
        gripper_flags=(False, True), n_obstacles=1,
        ws_jac=ws_jac,
        ws_l=torch.full((2, Wd, 3, batch), -bound, **kw),
        ws_u=torch.full((2, Wd, 3, batch), bound, **kw),
        obs_jac=jac(2, 1, Wd, Nj, batch),
        obs_l=torch.full((2, 1, Wd, batch), -bound, **kw),
        obs_u=torch.full((2, 1, Wd, batch), INF_BOUND, **kw))


def size_signatures(Nj):
    """The builds a lane solve at ``Nj`` joints runs: the four lane sources
    (NX = 5) and the tridiagonal pair."""
    lane = {"NDIM": Nj, "NX": 5}
    return [lane, dict(lane, BLOCK_P=0), {"B2": 2 * Nj}]


def repeat_bits(launch, outs):
    """Launch again (``launch()`` returns new outputs) and count the values
    that differ bit for bit from ``outs``."""
    again = launch()
    torch.cuda.synchronize()
    return sum(bits_differing(a, b)[0] for a, b in zip(outs, again)
               if a is not None)


# The dense yardstick's f32 matrices take at most this many bytes: above
# it the batch of the library call is cut (``library_batch``).
LIBRARY_BYTES = 4 << 30


def library_yardstick(diag, lower, rhs):
    """The library times beside the wide tridiagonal and KKT factors and the
    tridiagonal solve: ``torch.linalg.cholesky`` of the dense ``(B, W*B2,
    W*B2)`` f32 matrices of the block-tridiagonal batch (the same factor),
    and ``torch.cholesky_solve`` on that factor, the batch cut to the first
    ``library_batch`` problems where the matrices pass LIBRARY_BYTES.  A
    library call the card refuses leaves its time None and its error in
    ``library_error``."""
    Wd, B2, _, B = diag.shape
    n = Wd * B2
    b = int(min(B, max(1, LIBRARY_BYTES // (4 * n * n))))
    M = dense_kkt(diag[..., :b], lower[..., :b])
    out = dict(library_ms=None, library_solve_ms=None, library_batch=b)
    try:
        out["library_ms"] = time_ms(lambda: torch.linalg.cholesky(M),
                                    reps=3, warm=1)
        L = torch.linalg.cholesky(M)
        del M
        r = rhs[..., :b].permute(2, 0, 1).reshape(b, n, 1).contiguous()
        out["library_solve_ms"] = time_ms(
            lambda: torch.cholesky_solve(r, L), reps=3, warm=1)
    except RuntimeError as exc:  # a refused library call is no kernel fault
        out["library_error"] = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def kkt_factor_records(scaled, scaled64, rho_vec, settings, coef, Nj):
    """The KKT factor in both forms (``kkt_factor``, ``kkt_factor_gain``) on
    ``scaled``'s packs against its plain version run in f64, each launch
    repeated (equal bits), timed through its wrapper beside its plain
    version and its bound, with its plan; with --ref-tree above 16 joints
    also that tree's kernel on the same packs (``ref_ms``).  Returns
    ``((cholp, cholp of the gain form, gainp), records)``."""
    Wd, B = scaled.waypoints, scaled.batch
    sig = admm_fused.layout_signature(scaled)
    NX = sig["NX"]
    fac = lambda g: kkt_factor.factor_packed_lane(  # noqa: E731
        scaled, rho_vec, settings.sigma, coef=coef, emit_gain=g)
    ck, _ = fac(False)
    cg, gg = fac(True)
    c64, g64 = kkt_factor.factor_packed_lane_plain(
        scaled64, rho_vec.double(), settings.sigma, emit_gain=True)
    cp, gp = kkt_factor.factor_packed_lane_plain(
        scaled, rho_vec, settings.sigma, emit_gain=True)
    torch.cuda.synchronize()
    out = {}
    for name, got, plain, want64, g in (
            ("kkt_factor", [ck], [cp], [c64], False),
            ("kkt_factor_gain", [cg, gg], [cp, gp], [c64, g64], True)):
        e = max(rel_err(a.double(), r)[1] for a, r in zip(got, want64))
        ep = max(rel_err(a.double(), r)[1] for a, r in zip(plain, want64))
        rep = repeat_bits(lambda g=g: fac(g), got)
        b_ms, b_by = bound(nbytes(coef, rho_vec, *kkt_factor.build_p_vel_packs(
            scaled), *got), ops_factor(Wd, Nj, NX, B))
        out[name] = dict(vs_f64=e, plain_vs_f64=ep, tol=TOL_FACTOR,
                         bits_differing_run_to_run=rep,
                         ms=time_ms(lambda g=g: fac(g)),
                         plain_ms=time_ms(
                             lambda g=g: kkt_factor.factor_packed_lane_plain(
                                 scaled, rho_vec, settings.sigma,
                                 emit_gain=g), reps=3, warm=1),
                         bound_ms=b_ms, bound_by=b_by,
                         plan=kkt_factor.plan(_build.library(
                             "kkt_factor", sig), Wd, B),
                         ok=bool(e <= TOL_FACTOR and not rep))
        out[name]["device_launches"] = kkt_factor.device_launches(
            out[name]["plan"], Wd)
        if REF_TREE and Nj > 16:
            # Both trees' launches alone on the same packs (the wrapper's
            # packing apart).
            Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
            rho3 = rho_vec.reshape(Wd, -1, B).contiguous()
            o = [torch.empty_like(ck) for _ in range(1 + g)]
            for key, lb in (("launch_ms", _build.library("kkt_factor", sig)),
                            ("ref_ms", ref_library(
                                "kkt_factor", tuple(sorted(sig.items()))))):
                out[name][key] = time_ms(
                    lambda g=g, o=o, lb=lb: kkt_factor._launch_factor(
                        lb, coef, rho3, Pd, Pl, o[0], settings.sigma,
                        o[1] if g else None))
    return (ck, cg, gg), out


# The two factors alone at one problem above 16 joints: the single-query
# run's shape at N=40 (W=100) and N=256 (W=20).
WIDE_B1 = {40: W, 256: 20}


def factors_b1():
    """The KKT factor (both forms) and the tridiagonal factor at one
    problem (WIDE_B1, ``size_batch`` with B=1, f32, the bench.py
    settings), each against its plain version in f64, repeated bit for
    bit, timed beside its plain version, its bound and the library
    yardstick (``kkt_factor_records``, ``library_yardstick``)."""
    bench = dataclasses.replace(Settings(), **BENCH)
    out = {}
    for Nj, Wd in WIDE_B1.items():
        qp = size_batch(Nj, batch=1, Wd=Wd)
        scaled, scaling = admm_lane.ruiz_equilibrate_lane(qp, bench.scaling)
        packs = admm_lane.build_const_packs(scaled, scaling)
        rho_vec = _rho_vec(torch.full((1,), bench.rho, device="cuda"),
                           scaled.l, scaled.u)
        _, rec = kkt_factor_records(scaled, cast(scaled, torch.float64),
                                    rho_vec, bench, packs["coef"], Nj)
        diag, lower = (t.contiguous() for t in scaled.kkt_blocks(
            rho_vec, bench.sigma))
        rhs = torch.randn((Wd, 2 * Nj, 1), device="cuda")
        yard = library_yardstick(diag, lower, rhs)
        for r in rec.values():
            r.update(library_ms=yard["library_ms"],
                     library_batch=yard["library_batch"],
                     library_error=yard.get("library_error"))
        out[f"N{Nj}_W{Wd}_B1"] = rec
        del qp, scaled, packs
        torch.cuda.empty_cache()
    return out


def size_kernels(Nj, qp, settings, ref=True, warmup=False):
    """Every lane kernel of the path at ``Nj`` joints against its plain
    version run in f64 on the same f32 inputs, at the kernels phase's
    tolerances, each launch repeated (equal bits) and timed through its
    wrapper (``ms``; the chunk: its 2 iterations), with its launch plan and
    the ptxas report of each build: Ruiz; the KKT factor (both forms); the
    chunk (the accumulator form, the delta form and the gain form, and with
    ``warmup`` the form that only advances the state, 2 iterations from a
    state 10 iterations in, every fifth problem frozen); the residual
    kernel on the delta form's packs; the tridiagonal factor and solve on
    the batch's KKT blocks.  The builds are the batch's (its waypoints and
    rows); ``ref``: with --ref-tree, also that tree's kernels at N <= 16
    (``size_batch``'s builds)."""
    B, B2, Wd = qp.batch, 2 * Nj, qp.waypoints
    sig = admm_fused.layout_signature(qp)
    NX = sig["NX"]
    out = {}
    it = settings.scaling
    # Ruiz: D, E, c elementwise relative to f64.
    rk, rp_, _ = ruiz_vs_f64(qp, it)
    first = ruiz_kernel.ruiz_scalings_kernel(qp, it)
    out["ruiz"] = dict(vs_f64=rk, plain_vs_f64=rp_, tol=TOL_RUIZ,
                       bits_differing_run_to_run=repeat_bits(
                           lambda: ruiz_kernel.ruiz_scalings_kernel(qp, it),
                           first),
                       ms=time_ms(lambda: ruiz_kernel.ruiz_scalings_kernel(
                           qp, it)),
                       plan=ruiz_kernel.plan(_build.library(
                           "ruiz", dict(sig, BLOCK_P=0)), Wd, B))
    out["ruiz"]["ok"] = bool(rk <= TOL_RUIZ
                             and not out["ruiz"]["bits_differing_run_to_run"])
    slow = dict(reps=3, warm=1)  # the plain versions' times
    out["ruiz"]["plain_ms"] = time_ms(
        lambda: ruiz_kernel._ruiz_scalings_plain(qp, it), **slow)
    out["ruiz"]["bound_ms"], out["ruiz"]["bound_by"] = bound(
        nbytes(*ruiz_kernel._ruiz_kernel_packs(qp)),
        ops_ruiz(Wd, Nj, NX, B, it))
    scaled, scaling = admm_lane.ruiz_equilibrate_lane(qp, it)
    scaled64 = cast(scaled, torch.float64)
    packs = admm_lane.build_const_packs(scaled, scaling)
    coef = packs["coef"]
    rho_vec = _rho_vec(torch.full((B,), settings.rho, device="cuda"),
                       scaled.l, scaled.u)
    # KKT factor, both forms.
    (ck, cg, gg), recs = kkt_factor_records(scaled, scaled64, rho_vec,
                                            settings, coef, Nj)
    out.update(recs)
    # The chunk kernel from a warm state, every fifth problem frozen.
    st = admm_lane.init_state_lane(
        scaled, settings, None, None, scaling,
        rho_bar=torch.full((B,), settings.rho, device="cuda"),
        rho_vec=rho_vec, factor=(ck, None))
    lu = admm_fused.build_lu_pack(scaled)
    state0 = admm_fused.pack_state(scaled, st.x, st.z, st.y)
    none_done = torch.zeros(B, dtype=torch.bool, device="cuda")
    admm_fused.fused_admm_chunk(
        scaled, rho_vec, none_done, settings, state_pack=state0, n_iter=10,
        coef=coef, lu=lu, packed_factor=(ck, None))
    done = (torch.arange(B, device="cuda") % 5) == 3
    term_packs = (packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])
    Rp = scaled.rows_per_waypoint_padded
    sect = {"x": slice(0, B2), "z": slice(B2, B2 + Rp),
            "y": slice(B2 + Rp, B2 + 2 * Rp)}
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    forms = [("admm_chunk", (ck, None), term_packs, False),
             ("admm_chunk_dxdy", (ck, None), None, True),
             ("admm_chunk_gain", (cg, gg), term_packs, False)]
    if warmup:
        forms.append(("admm_chunk_warmup", (ck, None), None, False))
    for name, pf, tp, dxdy in forms:
        def launch(pf=pf, tp=tp, dxdy=dxdy):
            return admm_fused.fused_admm_chunk(
                scaled, rho_vec, done, settings, state_pack=state0.clone(),
                n_iter=2, term_packs=tp, emit_dxdy=dxdy, coef=coef, lu=lu,
                packed_factor=pf)
        sk, extra = launch()
        s64, e64 = admm_fused.fused_admm_chunk_plain(
            scaled64, rho_vec.double(), done, settings,
            state_pack=state0.double(), n_iter=2,
            term_packs=None if tp is None else tuple(d64(t) for t in tp),
            emit_dxdy=dxdy, coef=coef.double(), lu=lu.double(),
            packed_factor=tuple(d64(t) for t in pf))
        # The plain version in f32 on the same inputs: what f32 arithmetic
        # gives beside the kernel's error.
        s32, e32 = admm_fused.fused_admm_chunk_plain(
            scaled, rho_vec, done, settings, state_pack=state0.clone(),
            n_iter=2, term_packs=tp, emit_dxdy=dxdy, coef=coef, lu=lu,
            packed_factor=pf)
        torch.cuda.synchronize()

        def errs_of(st, ex):
            errs = {k: rel_err(st[:, sl].double(), s64[:, sl])[1]
                    for k, sl in sect.items()}
            if dxdy:
                scale = {k: s64[:, sl].abs().max().item()
                         for k, sl in sect.items()}
                errs["dx"] = rel_err(ex[:, :B2].double(), e64[:, :B2],
                                     scale["x"])[1]
                errs["dy"] = rel_err(ex[:, B2:B2 + Rp].double(),
                                     e64[:, B2:B2 + Rp], scale["y"])[1]
            elif tp is not None:
                # xsum / ysum against their sums of magnitudes; the loose
                # rows' largest E dy against the largest of all rows
                # (normEdy), as the infeasibility test compares them: in
                # f64 they can be ~0, and any f32 sum leaves noise there.
                edy = e64[_ACC["normEdy"]].abs().max().item()
                mags = {"xsum": s64[:, sect["x"]].abs().sum((0, 1)).max()
                        .item(),
                        "ysum": s64[:, sect["y"]].abs().sum((0, 1)).max()
                        .item(), "loose_pos": edy, "loose_neg": edy}
                for acc_name, row in _ACC.items():
                    errs["acc." + acc_name] = rel_err(
                        ex[row].double(), e64[row], mags.get(acc_name))[1]
            return errs
        errs, plain_errs = errs_of(sk, extra), errs_of(s32, e32)
        del s32, e32
        frozen = torch.equal(sk[..., done], state0[..., done])
        rep = repeat_bits(launch, (sk, extra))
        worst = max(errs.values())
        b_ms, b_by = bound(
            nbytes(*pf, coef, scaled.q_vec, lu, rho_vec, done, state0,
                   *(tp or ()), state0, *([] if extra is None else [extra])),
            ops_chunk(Wd, Nj, NX, B, 2, tp is not None))
        mode = 1 if tp is not None else 2 if dxdy else 0
        gain = pf[1] is not None
        out[name] = dict(vs_f64=errs, max_vs_f64=worst, tol=TOL_CHUNK,
                         plain_vs_f64=plain_errs,
                         plain_max_vs_f64=max(plain_errs.values()),
                         plan=dict(chunk_plan(sig, B, mode, gain),
                                   workspace_bytes=chunk_workspace(
                                       sig, B, mode, gain)),
                         frozen_problems_untouched=frozen,
                         bits_differing_run_to_run=rep,
                         ms=time_ms(launch),
                         plain_ms=time_ms(
                             lambda pf=pf, tp=tp, dxdy=dxdy:
                             admm_fused.fused_admm_chunk_plain(
                                 scaled, rho_vec, done, settings,
                                 state_pack=state0, n_iter=2, term_packs=tp,
                                 emit_dxdy=dxdy, coef=coef, lu=lu,
                                 packed_factor=pf), **slow),
                         bound_ms=b_ms, bound_by=b_by,
                         ok=bool(worst <= TOL_CHUNK and frozen and not rep))
        if name == "admm_chunk_dxdy":
            sp_k, dp_k = sk, extra
    # The residual kernel on the delta form's packs.
    rowc = torch.cat([packs["EEinv"], lu], dim=1)
    rlib = _build.library("residuals", dict(sig, BLOCK_P=0))

    def resid():
        acc = torch.empty((24, B), device="cuda")
        residuals._launch_residuals(rlib, coef, packs["Pdp"], packs["Plf"],
                                    sp_k, dp_k, rowc, packs["varc"], acc)
        return (acc,)
    (acck,) = resid()
    acc64 = residuals.termination_accumulators_plain(
        scaled64, sp_k.double(), dp_k.double(), rowc.double(),
        packs["varc"].double())
    torch.cuda.synchronize()
    x, _, y = admm_fused.unpack_state(scaled, sp_k.double())
    dx, dy = admm_fused.unpack_dxdy(scaled, dp_k.double())
    E, Einv, lo, hi = (rowc[:, k * Rp:(k + 1) * Rp].reshape(-1, B).double()
                       for k in range(4))
    edy = E * dy
    sup = (torch.where((Einv * hi) < 1e25, Einv * hi * edy.clamp(min=0), 0.0)
           .abs() + torch.where((Einv * lo) > -1e25,
                                Einv * lo * edy.clamp(max=0), 0.0).abs())
    mags = {"xsum": x.abs().sum(0).max().item(),
            "ysum": y.abs().sum(0).max().item(),
            "q_dot": (scaled.q.double() * dx).abs().sum(0).max().item(),
            "support": sup.sum(0).max().item()}
    rerr = {k: rel_err(acck[r].double(), acc64[r], mags.get(k))[1]
            for k, r in _ACC.items()}
    rep = repeat_bits(resid, (acck,))
    w_max = max(v for k, v in rerr.items() if k not in RESID_SUMS)
    w_sum = max(v for k, v in rerr.items() if k in RESID_SUMS)
    b_ms, b_by = bound(nbytes(coef, packs["Pdp"], packs["Plf"], sp_k, dp_k,
                              rowc, packs["varc"], acck),
                       ops_residuals(Wd, Nj, NX, B))
    out["residuals"] = dict(
        vs_f64=rerr, tol=TOL_RESID_MAX, tol_sums=TOL_RESID_SUM,
        bits_differing_run_to_run=rep, ms=time_ms(resid),
        plan=residuals.plan(rlib, B),
        plain_ms=time_ms(lambda: residuals.termination_accumulators_plain(
            scaled, sp_k, dp_k, rowc, packs["varc"]), **slow),
        bound_ms=b_ms, bound_by=b_by,
        ok=bool(w_max <= TOL_RESID_MAX and w_sum <= TOL_RESID_SUM
                and not rep))
    # The tridiagonal pair on the batch's KKT blocks.
    diag, lower = (t.contiguous() for t in scaled.kkt_blocks(
        rho_vec, settings.sigma))
    tc, tg = tridiag_kernel.factor_lane_major(diag, lower)
    gen = torch.Generator(device="cuda").manual_seed(Nj)
    rhs = torch.randn((Wd, B2, B), generator=gen, device="cuda")
    tx = tridiag_kernel.solve_lane_major(tc, tg, rhs)
    t64 = tridiag_kernel.factor_lane_major_plain(diag.double(),
                                                 lower.double())
    x64 = tridiag_kernel.solve_lane_major_plain(tc.double(), tg.double(),
                                                rhs.double())
    torch.cuda.synchronize()
    fe = max(rel_err(a.double(), r)[1] for a, r in zip((tc, tg), t64))
    se = rel_err(tx.double(), x64)[1]
    frep = repeat_bits(lambda: tridiag_kernel.factor_lane_major(diag, lower),
                       (tc, tg))
    srep = repeat_bits(
        lambda: (tridiag_kernel.solve_lane_major(tc, tg, rhs),), (tx,))
    fb = bound(tril_bytes(diag) + nbytes(lower, tc, tg),
               ops_tridiag_factor(Wd, B2, B))
    sb = bound(tril_bytes(tc) + nbytes(tg, rhs, tx),
               ops_tridiag_solve(Wd, B2, B))
    tlib = _build.library("tridiag", {"B2": B2})
    if B2 > 32:  # the wide forms: the library yardstick and --ref-tree's
        yard = library_yardstick(diag, lower, rhs)
        for name in ("kkt_factor", "kkt_factor_gain"):
            out[name].update(library_ms=yard["library_ms"],
                             library_batch=yard["library_batch"],
                     library_error=yard.get("library_error"))
        if REF_TREE:
            rl = ref_library("tridiag", (("B2", B2),))
            rc, rg = torch.empty_like(tc), torch.empty_like(tg)
            ref_f = dict(ref_ms=time_ms(lambda: tridiag_kernel._launch(
                rl, "factor", diag, lower, rc, rg)))
    out["tridiag_factor"] = dict(vs_f64=fe, tol=TOL_TRIDIAG,
                                 bits_differing_run_to_run=frep,
                                 plan=tridiag_kernel.factor_plan(tlib, B),
                                 plain_ms=time_ms(
                                     lambda: tridiag_kernel.
                                     factor_lane_major_plain(diag, lower),
                                     **slow),
                                 bound_ms=fb[0], bound_by=fb[1],
                                 ms=time_ms(lambda: tridiag_kernel.
                                            factor_lane_major(diag, lower)),
                                 **({"library_ms": yard["library_ms"],
                                     "library_batch": yard["library_batch"]}
                                    if B2 > 32 else {}),
                                 **(ref_f if B2 > 32 and REF_TREE else {}),
                                 ok=bool(fe <= TOL_TRIDIAG and not frep))
    out["tridiag_solve"] = dict(vs_f64=se, tol=TOL_TRIDIAG,
                                bits_differing_run_to_run=srep,
                                plan=tridiag_kernel.plan(tlib, Wd, B),
                                plain_ms=time_ms(
                                    lambda: tridiag_kernel.
                                    solve_lane_major_plain(tc, tg, rhs),
                                    **slow),
                                bound_ms=sb[0], bound_by=sb[1],
                                ms=time_ms(lambda: tridiag_kernel.
                                           solve_lane_major(tc, tg, rhs)),
                                **({"library_ms": yard["library_solve_ms"],
                                    "library_batch": yard["library_batch"]}
                                   if B2 > 32 else {}),
                                ok=bool(se <= TOL_TRIDIAG and not srep))
    if Nj in WORKSPACE_SIZES:
        out["workspace"] = workspace_bits(
            Nj, scaled, rho_vec, settings, packs, state0, done, ck, cg, gg,
            (coef, packs["Pdp"], packs["Plf"], sp_k, dp_k, rowc,
             packs["varc"]))
    if REF_TREE and ref and Nj <= 16:
        # The parent's lane kernels at this size, bit for bit and timed.
        out["ref_tree"] = ref_lane_compare(
            qp, scaled, rho_vec, settings, packs, state0, done, ck, cg, gg,
            Nj=Nj)
        bad_ref = {k: v["bits_differing"] for k, v in out["ref_tree"].items()
                   if v["bits_differing"]}
        if bad_ref:
            fail(f"lane_sizes (N{Nj}): values differing bit for bit from "
                 f"--ref-tree: {bad_ref}")
    # Registers and spills of every build at this size.
    ptx = {}
    for src, s_ in (("ruiz", dict(sig, BLOCK_P=0)), ("kkt_factor", sig),
                    ("admm_chunk", sig), ("residuals", dict(sig, BLOCK_P=0)),
                    ("tridiag", {"B2": B2})):
        rep_ = _build.ptxas_report(_build._target(src, s_, None)[1])
        ptx[src] = {k[:40]: {kk: v[kk] for kk in (
            "registers", "spill_store_bytes", "spill_load_bytes",
            "stack_bytes")} for k, v in rep_.items() if isinstance(v, dict)}
    return out, ptx


def workspace_bits(Nj, scaled, rho_vec, settings, packs, state0, done, ck,
                   cg, gg, resid_packs):
    """The wide forms with their rings and windows in the device-memory
    workspace (a one-byte shared-memory budget) beside the same launches on
    chip: the KKT factor in both forms, the chunk in its accumulator and
    gain forms (2 iterations), the residual kernel.  The arithmetic is the
    same, so every value must be equal bit for bit; both times alone."""
    sig = {"NDIM": Nj, "NX": 5}
    B = scaled.batch
    coef, lu = packs["coef"], admm_fused.build_lu_pack(scaled)
    Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
    rho3 = rho_vec.reshape(W, -1, B).contiguous()
    q_int = scaled._interleave(scaled.q_vec).contiguous()
    done_f = done.to(torch.float32).contiguous()

    def factor(gain):
        def make(budget):
            lib = _build.library("kkt_factor", sig)
            out = [torch.empty_like(ck) for _ in range(1 + gain)]
            return (lambda: kkt_factor._launch_factor(
                lib, coef, rho3, Pd, Pl, out[0], settings.sigma,
                out[1] if gain else None, budget=budget), out)
        return make

    def chunk(gain):
        def make(budget):
            lib = _build.library("admm_chunk", sig)
            state = state0.clone()
            w = torch.empty((W, 2 * Nj, B), device="cuda")
            acc = torch.empty((24, B), device="cuda")
            pf = (cg, gg) if gain else (ck, None)

            def launch():
                state.copy_(state0)
                admm_fused._launch_chunk(
                    lib, pf[0], coef, q_int, lu, rho3, packs["Plf"],
                    packs["EEinv"], packs["varc"], packs["Pdp"], done_f,
                    state, w, acc, 2, settings.sigma, settings.alpha,
                    gainp=pf[1], budget=budget)
            return launch, [state, acc]
        return make

    def resid(budget):
        lib = _build.library("residuals", dict(sig, BLOCK_P=0))
        acc = torch.empty((24, B), device="cuda")
        return (lambda: residuals._launch_residuals(lib, *resid_packs, acc,
                                                    budget=budget), [acc])

    out = {}
    for name, make in (("kkt_factor", factor(False)),
                       ("kkt_factor_gain", factor(True)),
                       ("admm_chunk", chunk(False)),
                       ("admm_chunk_gain", chunk(True)),
                       ("residuals", resid)):
        (la, oa), (lb, ob) = make(0), make(1)
        la()
        lb()
        torch.cuda.synchronize()
        nd = sum(bits_differing(a, b)[0] for a, b in zip(oa, ob))
        out[name] = dict(bits_differing=nd, ms_on_chip=time_ms(la),
                         ms_workspace=time_ms(lb))
    return out


def unforced_workspace(Nj, Wd, B):
    """The bytes of device-memory workspace that each lane build's plan at
    ``Nj`` joints (NX = 5) asks for at ``Wd`` waypoints and a batch of
    ``B`` under the card's own shared-memory limit (no forced budget): the
    KKT factor, the chunk in its accumulator, delta and gain forms, the
    residual kernel and the tridiagonal pair."""
    sig = {"NDIM": Nj, "NX": 5}
    tri = _build.library("tridiag", {"B2": 2 * Nj})
    return {
        "kkt_factor": kkt_factor.plan(_build.library("kkt_factor", sig), Wd,
                                      B)["workspace_bytes"],
        "admm_chunk": chunk_workspace(sig, B, 1, False),
        "admm_chunk_dxdy": chunk_workspace(sig, B, 2, False),
        "admm_chunk_gain": chunk_workspace(sig, B, 1, True),
        "residuals": residuals.plan(_build.library(
            "residuals", dict(sig, BLOCK_P=0)), B)["workspace_bytes"],
        "tridiag_factor": tridiag_kernel.factor_plan(tri, B)[
            "workspace_bytes"],
        "tridiag_solve": tridiag_kernel.plan(tri, Wd, B)["workspace_bytes"],
    }


SIZE_FORMS = {"hrec": {}, "hrec_term_off": dict(term_fused="off"),
              "gain": dict(factor_form="gain"),
              "unfused": dict(fused_chunk="off")}


def phase_lane_sizes():
    """The lane path at N = 7, 9, 10, 12 and 16 joints (``size_batch``: W=100,
    B=1024, f32, the bench.py settings): ``lane_path_sizes``."""
    return lane_path_sizes("lane_sizes", {n: (W, BATCH) for n in LANE_SIZES})


def lane_path_sizes(phase, shapes):
    """The lane path at each joint count of ``shapes`` (``{N: (W, B)}``:
    ``size_batch`` of B problems at W waypoints, f32, the bench.py
    settings): every kernel against its plain version in f64
    (``size_kernels``), then
    ``solve_batched_lane`` fused in the hrec form with fused and unfused
    termination (statuses and counts equal problem for problem), in the
    gain form, and on the unfused path; every form all optimal, the f64
    criterion within 2 % on 16 problems, the path's kernels launched and no
    plain version."""
    bench = dataclasses.replace(Settings(), **BENCH)
    recs = {}
    for Nj, (Wd, batch) in shapes.items():
        qp = size_batch(Nj, batch=batch, Wd=Wd)
        kern, ptx = size_kernels(Nj, qp, bench)
        ref = kern.pop("ref_tree", None)
        work = kern.pop("workspace", None)
        forms = {}
        for form, over in SIZE_FORMS.items():
            s = dataclasses.replace(bench, **over)
            reset_counts()
            syncs0 = admm_lane.HOST_SYNCS
            with PlainCalls() as plain:
                res = admm_lane.solve_batched_lane(qp, s)  # the path, once
                torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            it, st = res.iterations.cpu(), res.status.cpu()
            forms[form] = dict(
                optimal=int((st == 0).sum()), iterations_p50=int(it.median()),
                iterations_max=int(it.max()), launches=counts,
                host_syncs=admm_lane.HOST_SYNCS - syncs0,
                plain_calls=dict(plain.calls),
                f64_prim_dual_box=host_residual_check(
                    qp, res, torch.linspace(0, batch - 1, 16).long(), s),
                finite=bool(torch.isfinite(res.x).all()),
                status=st, iterations=it)
        a, b = forms["hrec"], forms["hrec_term_off"]
        same = dict(statuses=int((a["status"] != b["status"]).sum()),
                    iterations=int((a["iterations"] != b["iterations"]).sum()))
        for f in forms.values():
            f.pop("status"), f.pop("iterations")
        recs[f"N{Nj}"] = dict(W=Wd, batch=batch, kernels=kern, ptxas=ptx,
                              solves=forms, term_fused_vs_off_differ=same,
                              workspace_unforced=unforced_workspace(
                                  Nj, Wd, batch),
                              **({"ref_tree": ref} if ref else {}),
                              **({"workspace": work} if work else {}))
        del qp
        torch.cuda.empty_cache()
    emit(phase, sizes=list(shapes), **recs)
    need = {"hrec": ("ruiz", "kkt_factor", "admm_chunk"),
            "hrec_term_off": ("ruiz", "kkt_factor", "admm_chunk_dxdy",
                              "residuals"),
            "gain": ("ruiz", "kkt_factor_gain", "admm_chunk_gain"),
            "unfused": ("ruiz", "tridiag_factor", "tridiag_solve")}
    for key, rec in recs.items():
        batch = rec["batch"]
        bad = [k for k, v in rec["kernels"].items() if not v["ok"]]
        if bad:
            fail(f"{phase} ({key}): kernel(s) outside tolerance of the "
                 f"f64 plain version or not equal run to run: {bad}")
        if any(rec["term_fused_vs_off_differ"].values()):
            fail(f"{phase} ({key}): fused and unfused termination differ: "
                 f"{rec['term_fused_vs_off_differ']}")
        for form, f in rec["solves"].items():
            if f["optimal"] != batch or not f["finite"]:
                fail(f"{phase} ({key}, {form}): {f['optimal']}/{batch} "
                     "optimal")
            if max(f["f64_prim_dual_box"][:2]) > 1.02:
                fail(f"{phase} ({key}, {form}): float64 recomputation "
                     f"violates OSQP's criterion {f['f64_prim_dual_box']}")
            if f["plain_calls"] or min(f["launches"].get(k, 0)
                                       for k in need[form]) < 1:
                fail(f"{phase} ({key}, {form}): launches {f['launches']}, "
                     f"plain versions {f['plain_calls']}")
    return recs


WIDE_BLOCK_SIZES = (17, 32)


def wide_block_checks(Nj, batch=WIDE_BATCH):
    """The block-P builds above 16 joints on ``size_batch`` with the
    block-P objective (``with_block_p``, f32): the block Ruiz kernel and the
    block residual kernel (on a random state and deltas) against their
    plain versions in f64, each launch repeated bit for bit; then
    ``solve_batched_lane`` on the block-P path (block Ruiz, the tridiagonal
    factor, the gain chunk fed ``pack_factor``, the block residual kernel):
    every problem optimal, the path's kernels launched, no plain version."""
    bench = dataclasses.replace(Settings(), **BENCH)
    bp = cast(with_block_p(cast(size_batch(Nj, batch=batch),
                                torch.float64)), torch.float32)
    it = bench.scaling
    rk, rp_, _ = ruiz_vs_f64(bp, it)
    first = ruiz_kernel.ruiz_scalings_kernel(bp, it)
    out = {"ruiz_block": dict(
        vs_f64=rk, plain_vs_f64=rp_, tol=TOL_RUIZ,
        bits_differing_run_to_run=repeat_bits(
            lambda: ruiz_kernel.ruiz_scalings_kernel(bp, it), first),
        ms=time_ms(lambda: ruiz_kernel.ruiz_scalings_kernel(bp, it)))}
    scaled, scaling = admm_lane.ruiz_equilibrate_lane(bp, it)
    packs = admm_lane.build_const_packs(scaled, scaling)
    gen = torch.Generator(device="cuda").manual_seed(Nj)
    rnd = lambda k: torch.randn((k, batch), generator=gen,  # noqa: E731
                                device="cuda")
    sp = admm_fused.pack_state(scaled, rnd(scaled.n), rnd(scaled.m),
                               rnd(scaled.m))
    dp = admm_fused.pack_dxdy(scaled, rnd(scaled.n), rnd(scaled.m))
    rowc = torch.cat([packs["EEinv"], admm_fused.build_lu_pack(scaled)], 1)
    lib = _build.library("residuals", admm_fused.p_signature(scaled))

    def resid():
        acc = torch.empty((24, batch), device="cuda")
        residuals._launch_residuals(lib, packs["coef"], packs["Pdp"],
                                    packs["Plf"], sp, dp, rowc, packs["varc"],
                                    acc)
        return (acc,)
    (acck,) = resid()
    acc64 = residuals.termination_accumulators_plain(
        cast(scaled, torch.float64), sp.double(), dp.double(), rowc.double(),
        packs["varc"].double())
    torch.cuda.synchronize()
    # The maxima over max |f64|, the sums over their terms' magnitudes
    # (check_residuals' scales).
    x, _, y = admm_fused.unpack_state(scaled, sp.double())
    dx, dy = admm_fused.unpack_dxdy(scaled, dp.double())
    Rp = scaled.rows_per_waypoint_padded
    E, Einv, lo, hi = (rowc[:, k * Rp:(k + 1) * Rp].reshape(-1, batch)
                       .double() for k in range(4))
    edy = E * dy
    mags = {"xsum": x.abs().sum(0), "ysum": y.abs().sum(0),
            "q_dot": (scaled.q.double() * dx).abs().sum(0),
            "support": (torch.where((Einv * hi) < 1e25,
                                    Einv * hi * edy.clamp(min=0), 0.0).abs()
                        + torch.where((Einv * lo) > -1e25,
                                      Einv * lo * edy.clamp(max=0), 0.0).abs()
                        ).sum(0)}
    errs = {k: rel_err(acck[r].double(), acc64[r],
                       mags[k].max().item() if k in mags else None)[1]
            for k, r in _ACC.items()}
    rep = repeat_bits(resid, (acck,))
    w_max = max(v for k, v in errs.items() if k not in RESID_SUMS)
    w_sum = max(v for k, v in errs.items() if k in RESID_SUMS)
    out["ruiz_block"]["ok"] = bool(
        rk <= TOL_RUIZ and not out["ruiz_block"]["bits_differing_run_to_run"])
    out["residuals_block"] = dict(
        vs_f64=errs, tol=TOL_RESID_MAX, tol_sums=TOL_RESID_SUM,
        bits_differing_run_to_run=rep, ms=time_ms(resid),
        ok=bool(w_max <= TOL_RESID_MAX and w_sum <= TOL_RESID_SUM
                and not rep))
    reset_counts()
    with PlainCalls() as plain:
        res = admm_lane.solve_batched_lane(bp, bench)
        torch.cuda.synchronize()
    st = res.status.cpu()
    out["solve"] = dict(
        optimal=int((st == 0).sum()),
        iterations_p50=int(res.iterations.cpu().median()),
        launches={k: v for k, v in read_counts().items() if v},
        plain_calls=dict(plain.calls))
    return out


def cols_path_extras(Nj, Wd, batch):
    """The rest of the lane path at ``Nj`` joints (COLS_SIZES: each thread
    owns several columns) on ``size_batch`` (``Wd`` waypoints, ``batch``
    problems, f32, the bench.py settings): a session's setup and one tick
    (``setup_lane`` then ``solve_lane``) and ``solve_batched_lane`` with
    ``polish=True``; each all optimal, finite, the f64 criterion within 2 %
    on 16 problems, its kernels launched and no plain version."""
    bench = dataclasses.replace(Settings(), **BENCH)
    polished = dataclasses.replace(bench, polish=True)
    qp = size_batch(Nj, batch=batch, Wd=Wd)
    runs = {
        "session_tick": (lambda: solve_lane(setup_lane(qp, bench), bench)[1],
                         bench, ("ruiz", "kkt_factor", "admm_chunk")),
        "polish": (lambda: admm_lane.solve_batched_lane(qp, polished),
                   polished, ("ruiz", "kkt_factor", "admm_chunk",
                              "tridiag_factor", "tridiag_solve")),
    }
    out = {}
    for name, (run, s, need) in runs.items():
        reset_counts()
        with PlainCalls() as plain:
            res = run()  # the path, once
            torch.cuda.synchronize()
        st = res.status.cpu()
        out[name] = dict(
            optimal=int((st == 0).sum()),
            iterations_p50=int(res.iterations.cpu().median()),
            launches={k: v for k, v in read_counts().items() if v},
            plain_calls=dict(plain.calls), need=need,
            f64_prim_dual_box=host_residual_check(
                qp, res, torch.linspace(0, batch - 1, 16).long(), s),
            finite=bool(torch.isfinite(res.x).all()))
    del qp
    torch.cuda.empty_cache()
    return out


def phase_lane_wide():
    """The lane kernels above 16 joints: the lane path at N = 17, 24, 32,
    40, 64, 100, 256 and 300 (``lane_path_sizes`` at WIDE_SHAPES: every
    kernel in every form against its plain version in f64, each launch
    repeated bit for bit; the four solve forms all optimal; from N=64 rings
    and windows in the workspace unforced, as WIDE_UNFORCED says; at N=300
    also a session tick and a polished solve, ``cols_path_extras``), at
    N=32 the workspace placements equal bit for bit to the on-chip ones,
    and the tridiagonal pair alone at B2 = 34, 48, 64, 96, 130, 200, 512
    and 600 where the plans put them, and (64, 96) forced into the
    workspace.  Returns the records and the launches of the N=300 path
    (its four solve forms, the tick and the polished solve, each counted
    from zero)."""
    recs = lane_path_sizes("lane_wide", WIDE_SHAPES)
    extras = {f"N{n}": cols_path_extras(n, *WIDE_SHAPES[n])
              for n in COLS_SIZES}
    emit("lane_wide_cols", **extras)
    path = collections.Counter()
    for key, ext in extras.items():
        batch = recs[key]["batch"]
        for name, f in ext.items():
            if (f["optimal"] != batch or not f["finite"]
                    or max(f["f64_prim_dual_box"][:2]) > 1.02):
                fail(f"lane_wide ({key}, {name}): {f['optimal']}/{batch} "
                     f"optimal, f64 criterion {f['f64_prim_dual_box']}")
            if f["plain_calls"] or min(f["launches"].get(k, 0)
                                       for k in f["need"]) < 1:
                fail(f"lane_wide ({key}, {name}): launches {f['launches']}, "
                     f"plain versions {f['plain_calls']}")
            path.update(f["launches"])
        for f in recs[key]["solves"].values():
            path.update(f["launches"])
    tri = tridiag_sizes(WIDE_TRIDIAG)
    tri.update(tridiag_sizes(WIDE_TRIDIAG_WORKSPACE, budget=1))
    emit("lane_wide_tridiag", **tri)
    b1 = factors_b1()
    emit("lane_wide_factors_b1", **b1)
    bad = [f"{key}:{k}" for key, rec in b1.items() for k, v in rec.items()
           if not v["ok"]]
    if bad:
        fail(f"lane_wide: the KKT factor at one problem outside tolerance "
             f"of f64 or not equal run to run: {bad}")
    blocks = {f"N{n}": wide_block_checks(n) for n in WIDE_BLOCK_SIZES}
    emit("lane_wide_block_p", batch=WIDE_BATCH, **blocks)
    need = ("ruiz_block", "tridiag_factor", "admm_chunk_block",
            "residuals_block")
    for key, rec in blocks.items():
        bad = [k for k in ("ruiz_block", "residuals_block")
               if not rec[k]["ok"]]
        sv = rec["solve"]
        if bad or sv["optimal"] != WIDE_BATCH or sv["plain_calls"] or min(
                sv["launches"].get(k, 0) for k in need) < 1:
            fail(f"lane_wide ({key}, block P): kernels {bad}, solve {sv}")
    bad = [k for k, v in tri.items() if not v["ok"]]
    if bad:
        fail(f"lane_wide: tridiagonal pair outside tolerance or not equal "
             f"run to run at {bad}")
    for key, rec in recs.items():
        ws = rec.get("workspace", {})
        off = {k: v["bits_differing"] for k, v in ws.items()
               if v["bits_differing"]}
        if off:
            fail(f"lane_wide ({key}): the workspace placement differs from "
                 f"the on-chip one: {off}")
    for n, names in WIDE_UNFORCED.items():
        plans = recs[f"N{n}"]["workspace_unforced"]
        if min(plans[k] for k in names) <= 0:
            fail(f"lane_wide (N{n}): the plans were to put {names} in the "
                 f"device-memory workspace unforced: {plans}")
    return recs, tri, dict(path)


# ---------------------------------------------------------------------------
# Generic DH arms (queue A5): the presets' kinematics and the planner on them.
# ---------------------------------------------------------------------------
DH_PRESETS = ("UR5E", "UR10E", "IIWA14", "SCARA")
DH_SAMPLES, DH_SEED = 1024, 13
# float32 FK / Jacobians on the card against float64 on the host from the
# same float32 configurations (link lengths up to 1.4 m: ~1e-7 relative).
TOL_DH = 1e-5


def dh_configs(robot, B, rng, spread):
    """``B`` configurations within ``spread`` of zero (the prismatic joints
    within their 0.2 m stroke), float64 numpy."""
    q = rng.uniform(-spread, spread, (B, robot.n_joints))
    for i, t in enumerate(robot.joint_types):
        if t == "p":
            q[:, i] = rng.uniform(0.02, 0.18, B)
    return q


def phase_dh_arms():
    """The DH presets' kinematics on the card in float32: the SoA FK and
    Jacobians (``fk_pose_jacobian``), the matrix-path FK and the ``jacfwd``
    Jacobian of ``make_ball``'s callables, on DH_SAMPLES random
    configurations, against the same calls in float64 on the host; DLS
    position and pose IK round trips on DH_SAMPLES targets (the FK of random
    configurations, started 0.15 rad away), batched, with the converged
    share and the worst round-trip error of the converged; ``ik_checked``
    raising on an out-of-reach target."""
    rng = np.random.default_rng(DH_SEED)
    recs = {}
    for name in DH_PRESETS:
        robot = getattr(dh_robot, name)
        q32 = torch.from_numpy(dh_configs(robot, DH_SAMPLES, rng, 2.5)).to(
            "cuda", torch.float32)
        q64 = q32.double().cpu()
        got = robot.fk_pose_jacobian(q32)
        ref = robot.fk_pose_jacobian(q64)
        err = {k: (g.double().cpu() - r).abs().max().item() for k, g, r in
               zip(("point", "rotation", "jac_position", "jac_angular"),
                   got, ref)}
        err["point_fk_matrix"] = (robot.point_fk(q32).double().cpu()
                                  - robot.point_fk(q64)).abs().max().item()
        ball = robot.make_ball(radius=0.05, is_gripper=True)
        jv = torch.func.vmap(ball.jacobian)(q32[:64]).double().cpu()
        err["jacfwd_callable"] = (jv - ref[2][:64]).abs().max().item()
        # IK round trips: targets from configurations near zero.
        qt = torch.from_numpy(dh_configs(robot, DH_SAMPLES, rng, 0.8))
        p_t, R_t = robot.pose_fk(qt)
        q0 = (qt + 0.15).to("cuda", torch.float32)
        p32, R32 = p_t.to("cuda", torch.float32), R_t.to("cuda", torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp, okp = robot.position_ik(p32, q0=q0)
        torch.cuda.synchronize()
        ms_pos = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        qr, okr = robot.pose_ik(p32, R32, q0=q0)
        torch.cuda.synchronize()
        ms_pose = (time.perf_counter() - t0) * 1e3
        rt_pos = (robot.point_fk(qp.double().cpu()) - p_t).norm(dim=-1)
        rt_pose = (robot.point_fk(qr.double().cpu()) - p_t).norm(dim=-1)
        okp, okr = okp.cpu(), okr.cpu()
        raised = False
        try:
            dh_robot.ik_checked(robot, torch.tensor([9.0, 0.0, 0.0],
                                                    device="cuda"))
        except NoInverseKinematicSolution:
            raised = True
        recs[name] = dict(
            joints=robot.n_joints, joint_types="".join(robot.joint_types),
            max_abs_err_vs_f64=err, tol=TOL_DH,
            position_ik=dict(converged=float(okp.float().mean()),
                             worst_converged_error_m=float(
                                 rt_pos[okp].max()) if okp.any() else None,
                             ms=ms_pos),
            pose_ik=dict(converged=float(okr.float().mean()),
                         worst_converged_error_m=float(
                             rt_pose[okr].max()) if okr.any() else None,
                         ms=ms_pose),
            ik_checked_raises=raised)
    emit("dh_arms", samples=DH_SAMPLES, **recs)
    for name, r in recs.items():
        if max(r["max_abs_err_vs_f64"].values()) > TOL_DH:
            fail(f"dh_arms ({name}): float32 kinematics off the float64 "
                 f"host values: {r['max_abs_err_vs_f64']}")
        for kind in ("position_ik", "pose_ik"):
            k = r[kind]
            # A float32 round trip is converged within the f32 tolerance
            # (1e-4 m), and nearly every target near zero is reached.
            if k["converged"] < 0.9 or (k["worst_converged_error_m"] or 0.0) \
                    > 2e-4:
                fail(f"dh_arms ({name}): {kind} {k}")
        if not r["ik_checked_raises"]:
            fail(f"dh_arms ({name}): ik_checked did not raise out of reach")
    return recs


def dh_solver(robot, max_waypoints=50, **settings):
    """``benchmarks/planner_batch.py --robot <arm> --full``'s planner: a
    ball of r=0.15 at frame N-1 and the gripper ball r=0.05 at the tool,
    workspace floor y >= -0.4, the fleet benchmarks' joint bounds (the
    SCARA's stroke too), 10 segments, float32, at PLANNER's settings."""
    INF = 1e30
    n = robot.n_joints
    return GOMPSolver(
        max_waypoints=max_waypoints, time_step=0.1,
        settings=dataclasses.replace(Settings(), **{**PLANNER, **settings}),
        pos_con=constraints.in_range(n, -2 * math.pi, 2 * math.pi),
        vel_con=constraints.in_range(n, -math.pi, math.pi),
        acc_con=constraints.in_range(n, -800 * math.pi / 180,
                                     800 * math.pi / 180),
        con_3d=constraints.Constraint(lower=np.array([-INF, -0.4, -INF]),
                                      upper=np.full(3, INF)),
        obstacles=[],
        balls=[robot.make_ball(link=n - 1, radius=0.15),
               robot.make_ball(radius=0.05, is_gripper=True)],
        segments=10, dtype=torch.float32,
    )


def dh_queries(n, B, rng):
    """``benchmarks/planner_batch.py``'s queries for an arm of ``n``
    joints: starts near zero, ends near (π, 0, ..., 0)."""
    starts = 0.02 * rng.standard_normal((B, n))
    end0 = np.zeros(n)
    end0[0] = math.pi
    return starts, end0[None] + 0.02 * rng.standard_normal((B, n))


DH_REF_QUERIES = 64
# planner_dh: the JAX package's float32 CPU run of the same search on the
# first DH_REF_QUERIES queries (tools/jax_reference_counts.py planner_dh):
# exit codes and SCP rounds per query in encode_statuses form, and the
# p50 of ADMM iterations per query over the search.  Both arms: 64/64
# optimal at horizon 15 in 10 SCP rounds each.
PLANNER_DH_REF = {
    "IIWA14": dict(statuses="0" * 64, rounds="a" * 64, admm_iters_p50=345),
    "SCARA": dict(statuses="0" * 64, rounds="a" * 64, admm_iters_p50=342),
}
# The card's admm_iters p50 over all BATCH queries must lie within this
# share of the JAX run's.
DH_ITERS_BAND = 0.1


def dh_example():
    """``examples/dh_robot_example.py``'s problem on the card in float32:
    the iiwa14, a Cartesian goal solved by DLS IK into a joint
    configuration, ``run`` from zero to it (W_max=16, 3 segments; its
    session's tridiagonal kernels at B2=14), the example's checks: kOptimal
    and the gripper FK at waypoint W-3 within 1e-2 m of the goal."""
    robot = dh_robot.IIWA14
    n = robot.n_joints
    kw = dict(dtype=torch.float32, device="cuda")
    goal = robot.point_fk(torch.full((n,), 0.5, **kw))
    q_end, ok = robot.position_ik(goal, q0=torch.full((n,), 0.3, **kw))
    INF = 1e30
    solver = GOMPSolver(
        max_waypoints=16, time_step=0.1,
        pos_con=constraints.in_range(n, -3.0, 3.0),
        vel_con=constraints.in_range(n, -math.pi, math.pi),
        acc_con=constraints.in_range(n, -4 * math.pi, 4 * math.pi),
        con_3d=constraints.in_range(3, [-INF, -0.4, -INF], INF),
        obstacles=[],
        balls=[robot.make_ball(link=n - 1, radius=0.12),
               robot.make_ball(radius=0.05, is_gripper=True)],
        segments=3, dtype=torch.float32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls() as plain:
        res = solver.run(np.zeros(n), q_end.cpu().numpy())
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in read_counts().items() if v}
    W_ = res.trajectory.size // (2 * n)
    q = torch.from_numpy(np.asarray(res.trajectory[: W_ * n],
                                    dtype=np.float64).reshape(W_, n))
    err = float((robot.point_fk(q[W_ - 3]) - goal.double().cpu()).norm())
    return dict(ik_converged=bool(ok), status=res.status.name,
                horizon=W_, goal_error_m=err, ms=ms, launches=counts,
                plain_calls=dict(plain.calls),
                stats=[tuple(int(v) for v in s_) for s_ in res.stats])


def keep_first_solve(solver):
    """Wrap ``solver._solve`` so that it keeps the first batch it is given
    (the trailing container and the settings); the wrapper launches
    nothing.  Returns the list the batch goes into; ``del solver._solve``
    takes the wrapper off."""
    seen = []
    inner = solver._solve

    def keep(qp_t, settings, x, y):
        if not seen:
            seen.append((qp_t, settings))
        return inner(qp_t, settings, x, y)
    solver._solve = keep
    return seen


def phase_planner_dh():
    """The slice's path: ``run_batch_padded`` (the full search, its solves
    on the lane driver) on BATCH queries of ``benchmarks/planner_batch.py
    --robot iiwa14|scara --full`` (W_max=50, 10 segments, two balls, the
    floor y >= -0.4, queries from default_rng(0)), float32: every query
    optimal and the admm_iters p50 within DH_ITERS_BAND of the JAX run's;
    the first DH_REF_QUERIES queries' statuses equal to the JAX package's
    float32 CPU run and their SCP rounds within 2; an exact-FK audit in
    float64 on the host; the fused lane kernels launched and no plain
    version.  The search's first batch (W=50, B=BATCH, the builds at N=7
    and 4 with NX=3) then goes through ``size_kernels``: every lane kernel
    of those builds against its plain version in f64, each launch repeated
    bit for bit.  Then ``dh_example``."""
    recs = {}
    launches = collections.Counter()
    for name in ("IIWA14", "SCARA"):
        robot = getattr(dh_robot, name)
        solver = dh_solver(robot)
        starts, ends = dh_queries(robot.n_joints, BATCH,
                                  np.random.default_rng(0))
        first = keep_first_solve(solver)
        with PlainCalls() as plain:
            out, counts, syncs = run_search(solver, starts, ends)
        del solver._solve
        launches.update(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_batch_padded(starts, ends)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        summary = search_summary(out)
        audit = audit_plans(solver, out[0], out[1], out[2])
        st, rounds = out[0].cpu(), out[3].cpu()
        k = DH_REF_QUERIES
        rec = dict(joints=robot.n_joints, batch=BATCH, **summary,
                   ms_per_batch=ms, **syncs, launches=counts,
                   plain_calls=dict(plain.calls), audit=audit,
                   statuses_first=encode_statuses(st[:k].numpy()),
                   rounds_first=encode_statuses(rounds[:k].numpy()),
                   finite=bool(torch.isfinite(out[1]).all()))
        ref = PLANNER_DH_REF[name]
        if ref["statuses"] is not None:
            rs = torch.tensor(decode_statuses(ref["statuses"]))
            rr = torch.tensor(decode_statuses(ref["rounds"]))
            rec["same_status_first"] = int((st[:k] == rs).sum())
            rec["scp_rounds_max_diff_first"] = int(
                (rounds[:k] - rr).abs().max())
        qp_t, s_ = first[0]
        lane = planner.from_trailing(qp_t, row_layout="waypoint")
        rec["kernels"], rec["ptxas"] = size_kernels(robot.n_joints, lane, s_,
                                                    ref=False)
        rec["kernels_at"] = dict(W=lane.waypoints, batch=lane.batch,
                                 **admm_fused.layout_signature(lane))
        del first[:], lane, qp_t
        recs[name] = rec
    example = dh_example()
    emit("planner_dh", **recs, example=example)
    for name, rec in recs.items():
        if rec["optimal"] != BATCH or not rec["finite"]:
            fail(f"planner_dh ({name}): {rec['optimal']}/{BATCH} optimal")
        ref_it = PLANNER_DH_REF[name]["admm_iters_p50"]
        if abs(rec["admm_iters_p50"] - ref_it) > DH_ITERS_BAND * ref_it:
            fail(f"planner_dh ({name}): admm_iters p50 "
                 f"{rec['admm_iters_p50']} outside {DH_ITERS_BAND:.0%} of "
                 f"the JAX run's {ref_it}")
        bad = [k_ for k_, v in rec["kernels"].items() if not v["ok"]]
        if bad:
            fail(f"planner_dh ({name}): kernel(s) at the search's shape "
                 f"outside tolerance of the f64 plain version or not equal "
                 f"run to run: {bad}")
        if "same_status_first" in rec and (
                rec["same_status_first"] != DH_REF_QUERIES
                or rec["scp_rounds_max_diff_first"] > 2):
            fail(f"planner_dh ({name}): the first {DH_REF_QUERIES} queries "
                 f"differ from the JAX float32 run: {rec['statuses_first']} "
                 f"{rec['rounds_first']}")
        if rec["audit"]["workspace_margin"] < -(ERROR + 1e-5):
            fail(f"planner_dh ({name}): exact-FK audit: gripper ball leaves "
                 f"the workspace box by {-rec['audit']['workspace_margin']}")
        if rec["audit"]["velocity_mismatch"] > 0.2:
            fail(f"planner_dh ({name}): velocities are not position "
                 "differences over dt")
        if rec["plain_calls"] or min(rec["launches"][k_]
                                     for k_ in LANE_KERNELS) < 1:
            fail(f"planner_dh ({name}): launches {rec['launches']}, plain "
                 f"versions {rec['plain_calls']}")
    if not (example["ik_converged"] and example["status"] == "kOptimal"
            and example["goal_error_m"] < 1e-2):
        fail(f"planner_dh: the DH example's checks failed: {example}")
    if example["plain_calls"] or min(example["launches"].get(k_, 0) for k_
                                     in TRIDIAG_KERNELS) < 1:
        fail(f"planner_dh: the DH example's launches {example['launches']}, "
             f"plain versions {example['plain_calls']}")
    launches.update(example["launches"])
    return dict(launches)


def solve_counts(qp, settings):
    """One ``solve_batched_lane`` with the counters read around it: the
    result, the launches, the host reads, the ρ refactors, the polish
    factors and the plain versions called."""
    reset_counts()
    s0, r0 = admm_lane.HOST_SYNCS, admm_lane.RHO_REFACTORS
    p0 = admm_lane.POLISH_FACTORS
    with PlainCalls() as plain:
        res = admm_lane.solve_batched_lane(qp, settings)
        torch.cuda.synchronize()
    return res, dict(
        launches=read_counts(), host_syncs=admm_lane.HOST_SYNCS - s0,
        rho_refactors=admm_lane.RHO_REFACTORS - r0,
        polish_factors=admm_lane.POLISH_FACTORS - p0,
        plain_calls=dict(plain.calls))


def iteration_summary(res, settings, offset=0):
    it, st = res.iterations.cpu(), res.status.cpu()
    it_max = int(it.max())
    return dict(
        optimal=int((st == 0).sum()),
        statuses={str(k): v for k, v in sorted(
            collections.Counter(st.tolist()).items())},
        iterations_p50=int(it.median()), iterations_max=it_max,
        iterations_hist={str(k): v for k, v in sorted(
            collections.Counter(it.tolist()).items())},
        chunks=-(-(it_max - offset) // settings.check_termination),
        finite=bool(torch.isfinite(res.x).all()))


def phase_solve_refine():
    """The honest class at W=1100 (B=256, f32, stock settings) with
    ``with_auto_refine``'s bumped ``kkt_refine=1``: the unfused path, each
    iteration a tridiagonal solve and one refinement solve.  Every problem
    optimal, the f64 criterion within 2 % on 16 problems; launches: the
    tridiagonal factor once plus once per ρ refactor, the solve twice per
    iteration run, no stencil factor or chunk, no plain version; one host
    read per chunk."""
    s = gadmm.with_auto_refine(Settings(), LONG_W, torch.float32)
    qp = build_honest_batch(REFINE_BATCH, LONG_W, N, torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, c = solve_counts(qp, s)  # the main path, once
    ms = (time.perf_counter() - t0) * 1e3
    summ = iteration_summary(res, s)
    chk = host_residual_check(
        qp, res, torch.linspace(0, REFINE_BATCH - 1, 16).long(), s)
    rec = dict(W=LONG_W, batch=REFINE_BATCH, kkt_refine=s.kkt_refine,
               **summ, **c, f64_prim_dual_box=chk, ms=ms)
    emit("solve_refine", **rec)
    L = c["launches"]
    if s.kkt_refine != 1:
        fail(f"solve_refine: with_auto_refine gave kkt_refine={s.kkt_refine}")
    if summ["optimal"] != REFINE_BATCH or not summ["finite"]:
        fail(f"solve_refine: {summ['optimal']}/{REFINE_BATCH} optimal")
    if max(chk[:2]) > 1.02:
        fail(f"solve_refine: float64 recomputation violates OSQP's criterion "
             f"{chk}")
    want = dict(tridiag_factor=1 + c["rho_refactors"],
                tridiag_solve=2 * summ["iterations_max"], kkt_factor=0,
                admm_chunk=0, ruiz=1)
    bad = {k: (L[k], v) for k, v in want.items() if L[k] != v}
    if bad or c["plain_calls"] or c["host_syncs"] != summ["chunks"]:
        fail(f"solve_refine: launches (got, want) {bad}, plain versions "
             f"{c['plain_calls']}, {c['host_syncs']} syncs for "
             f"{summ['chunks']} chunks")
    return L


def phase_planner_long():
    """``run_batch_lane`` at W=1100 in f32 (the bumped ``kkt_refine=1``:
    the unfused lane solve) on the first 64 queries of the full search:
    statuses equal to the JAX f32 run's, SCP rounds within 2 of its, every
    optimal plan through the exact-FK audit, the tridiagonal kernels
    launched and no plain version."""
    solver = ur5e_solver(LONG_W, [])
    starts, ends = long_queries()
    reset_counts()
    p0 = planner.PLANNER_SYNCS
    with PlainCalls() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, tr, rounds = solver.run_batch_lane(starts, ends, LONG_W)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    ref_st = torch.tensor(decode_statuses(PLANNER_LONG_REF["statuses"]))
    ref_rounds = torch.tensor(decode_statuses(PLANNER_LONG_REF["rounds"]))
    st_c, rounds_c = st.cpu(), rounds.cpu()
    audit = audit_plans(solver, st_c, tr, torch.full((LONG_QUERIES,),
                                                     LONG_W))
    rec = dict(W=LONG_W, queries=LONG_QUERIES, ms=ms,
               optimal=int((st_c == 0).sum()),
               statuses={str(k): v for k, v in sorted(
                   collections.Counter(st_c.tolist()).items())},
               same_status=int((st_c == ref_st).sum()),
               reference_optimal=int((ref_st == 0).sum()),
               scp_rounds_max_diff=int((rounds_c - ref_rounds).abs().max()),
               scp_rounds_hist={str(k): v for k, v in sorted(
                   collections.Counter(rounds_c.tolist()).items())},
               planner_host_syncs=planner.PLANNER_SYNCS - p0,
               launches={k: v for k, v in counts.items() if v},
               plain_calls=dict(plain.calls), audit=audit,
               finite=bool(torch.isfinite(tr).all()))
    emit("planner_long", **rec)
    if rec["same_status"] != LONG_QUERIES:
        fail(f"planner_long: {rec['same_status']}/{LONG_QUERIES} statuses "
             "equal to the JAX f32 run's")
    if rec["scp_rounds_max_diff"] > 2:
        fail(f"planner_long: SCP rounds differ from JAX's by "
             f"{rec['scp_rounds_max_diff']} > 2")
    if (audit["workspace_margin"] < -(ERROR + 1e-5)
            or audit["velocity_mismatch"] > 0.2 or not rec["finite"]):
        fail(f"planner_long: exact-FK audit failed: {audit}")
    if (min(counts[k] for k in TRIDIAG_KERNELS) < 1 or counts["admm_chunk"]
            or counts["kkt_factor"] or plain.calls):
        fail(f"planner_long: launches {counts}, plain versions "
             f"{dict(plain.calls)}")
    return rec


def phase_solve_polish():
    """The honest class (W=100, B=1024, f32, the bench.py settings) with
    ``polish=True``, fused and unfused: statuses equal to the unpolished
    run's, how many problems the polish moved, the f64 criterion within
    2 % on 16 of the polished problems; polish's launches counted apart:
    one tridiagonal factor and ``1 + polish_refine_iter`` solves beyond
    the path's own."""
    qp = honest_f32(BATCH, W, "cuda")
    bench = dataclasses.replace(Settings(), **BENCH)
    recs = {}
    for form, over in (("fused", {}), ("unfused", dict(fused_chunk="off"))):
        s0 = dataclasses.replace(bench, **over)
        sp = dataclasses.replace(s0, polish=True)
        r0, c0 = solve_counts(qp, s0)
        r1, c1 = solve_counts(qp, sp)  # the main path, once
        moved = (r1.x != r0.x).any(dim=1)
        idx = torch.nonzero(moved).flatten().cpu()
        idx = (idx[torch.linspace(0, len(idx) - 1, min(16, len(idx))).long()]
               if len(idx) else torch.linspace(0, BATCH - 1, 16).long())
        L0, L1 = c0["launches"], c1["launches"]
        recs[form] = dict(
            **iteration_summary(r1, sp, sp.termination_warmup),
            same_status=int((r1.status == r0.status).sum()),
            polished=int(moved.sum()),
            reference_polished=POLISH_REF["polished"],
            f64_prim_dual_box_polished=host_residual_check(qp, r1, idx, sp),
            polish_launches={k: L1[k] - L0[k] for k in TRIDIAG_KERNELS},
            launches={k: v for k, v in L1.items() if v},
            polish_factors=c1["polish_factors"],
            rho_refactors=c1["rho_refactors"], host_syncs=c1["host_syncs"],
            plain_calls=c1["plain_calls"])
    emit("solve_polish", **recs)
    want = {"tridiag_factor": 1,
            "tridiag_solve": 1 + bench.polish_refine_iter}
    for form, rec in recs.items():
        if rec["same_status"] != BATCH:
            fail(f"solve_polish ({form}): {rec['same_status']}/{BATCH} "
                 "statuses equal to the unpolished run's")
        if max(rec["f64_prim_dual_box_polished"][:2]) > 1.02:
            fail(f"solve_polish ({form}): float64 recomputation violates "
                 f"OSQP's criterion {rec['f64_prim_dual_box_polished']}")
        if (rec["polish_launches"] != want or rec["polish_factors"] != 1
                or rec["plain_calls"]):
            fail(f"solve_polish ({form}): polish launches "
                 f"{rec['polish_launches']} (want {want}), "
                 f"{rec['polish_factors']} polish factors, plain versions "
                 f"{rec['plain_calls']}")
    return recs["fused"]["launches"]


def phase_solve_anderson():
    """The honest class (W=100, B=1024, f32) with ``anderson=4`` and
    ``check_termination=3``: fused with the chunk's termination fused and
    not (equal statuses and counts), unfused, and fused with ρ adaptation
    firing (``rho=10``, ``adaptive_rho_interval=6``).  Every form
    1024/1024 optimal, the f64 criterion within 2 % on 16 problems, p50
    within one chunk of the JAX f32 run's (``ANDERSON_REF``), one host read
    per chunk, no plain version."""
    qp = honest_f32(BATCH, W, "cuda")
    forms = {"fused": (ANDERSON, {}),
             "fused_term_off": (ANDERSON, dict(term_fused="off")),
             "unfused": (ANDERSON, dict(fused_chunk="off")),
             "rho_fused": (ANDERSON_RHO, {})}
    recs, results, main_launches = {}, {}, None
    for form, (over, port) in forms.items():
        s = dataclasses.replace(Settings(), **over, **port)
        res, c = solve_counts(qp, s)
        if form == "fused":  # this slice's main path
            main_launches = c["launches"]
        ref = ANDERSON_REF["rho" if form.startswith("rho") else "base"]
        summ = iteration_summary(res, s)
        recs[form] = dict(
            **summ, reference_p50=ref["p50"], reference_hist=ref["hist"],
            f64_prim_dual_box=host_residual_check(
                qp, res, torch.linspace(0, BATCH - 1, 16).long(), s),
            launches={k: v for k, v in c["launches"].items() if v},
            host_syncs=c["host_syncs"], rho_refactors=c["rho_refactors"],
            plain_calls=c["plain_calls"],
            ms=statistics.median(host_ms(
                lambda: admm_lane.solve_batched_lane(qp, s))
                for _ in range(3)))
        results[form] = res
    a, b = results["fused"], results["fused_term_off"]
    differ = dict(statuses=int((a.status != b.status).sum()),
                  iterations=int((a.iterations != b.iterations).sum()))
    emit("solve_anderson", **recs, term_fused_vs_off_differ=differ)
    if any(differ.values()):
        fail(f"solve_anderson: fused and unfused termination differ: "
             f"{differ}")
    for form, rec in recs.items():
        ct = ANDERSON["check_termination"]
        if rec["optimal"] != BATCH or not rec["finite"]:
            fail(f"solve_anderson ({form}): {rec['optimal']}/{BATCH} optimal")
        if max(rec["f64_prim_dual_box"][:2]) > 1.02:
            fail(f"solve_anderson ({form}): float64 recomputation violates "
                 f"OSQP's criterion {rec['f64_prim_dual_box']}")
        if abs(rec["iterations_p50"] - rec["reference_p50"]) > ct:
            fail(f"solve_anderson ({form}): p50 {rec['iterations_p50']}, JAX "
                 f"f32 {rec['reference_p50']}: more than one chunk apart")
        if rec["host_syncs"] != rec["chunks"] or rec["plain_calls"]:
            fail(f"solve_anderson ({form}): {rec['host_syncs']} syncs for "
                 f"{rec['chunks']} chunks, plain versions "
                 f"{rec['plain_calls']}")
    if recs["rho_fused"]["rho_refactors"] < 1:
        fail("solve_anderson (rho_fused): no ρ adaptation fired")
    return main_launches


# examples: the JAX package's float32 CPU runs of the same examples at their
# defaults (tools/jax_reference_counts.py examples): statuses in
# encode_statuses form, winning horizons and SCP rounds per query, recorded
# beside the port's (in f32 the planners with obstacles follow rounding:
# ROADMAP.md C4).
EXAMPLES_REF = {
    "fleet_planning": dict(statuses="00000000",
                           horizons=[18, 24, 24, 27, 18, 24, 24, 21],
                           scp_rounds=[17, 21, 15, 18, 13, 15, 15, 7]),
    "grasp": dict(statuses="00000000", horizons=[12, 12, 9, 9, 9, 15, 12, 12],
                  scp_rounds=[9, 9, 9, 9, 9, 8, 9, 9]),
    "dh_robot": dict(status="kOptimal", winning_waypoints=10,
                     stats=[[16, 1, 25, 0], [10, 1, 25, 0], [5, 1, 425, 6]]),
}
EXAMPLE_MODULES = ("solver_example", "dh_robot_example", "fleet_planning_example",
                   "grasp_example", "mpc_fleet_example")
# The kernels each example's path runs on the card.
EXAMPLE_KERNELS = {"solver_example": TRIDIAG_KERNELS,
                   "dh_robot_example": TRIDIAG_KERNELS,
                   "fleet_planning_example": LANE_KERNELS,
                   "grasp_example": LANE_KERNELS,
                   "mpc_fleet_example": LANE_KERNELS}


class PlainCallsDense(PlainCalls):
    """:class:`PlainCalls` with the dense kernels' plain versions too
    (counted as ``dense.factor_lane_major_plain``, ...)."""

    def __enter__(self):
        super().__enter__()
        for name in ("factor_lane_major_plain", "solve_lane_major_plain"):
            fn = getattr(dense_kernel, name)
            self.saved.append((dense_kernel, name, fn))

            def counted(*a, _fn=fn, _name="dense." + name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(dense_kernel, name, counted)
        return self


class ResultCapture:
    """Keeps what the planner's entry points return while active (the
    examples print their results; the phase reads them here): a list of
    ``(method, solver, result)``."""
    METHODS = ("run", "run_padded", "run_batch_padded")

    def __enter__(self):
        self.results, self.saved = [], []
        for name in self.METHODS:
            fn = getattr(GOMPSolver, name)
            self.saved.append((name, fn))

            def kept(solver, *a, _fn=fn, _name=name, **kw):
                out = _fn(solver, *a, **kw)
                self.results.append((_name, solver, out))
                return out
            setattr(GOMPSolver, name, kept)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(GOMPSolver, name, fn)
        return False


def run_example(name, argv=()):
    """``main(argv)`` of the port's example ``name`` on the card, in a
    temporary directory, once: the launch counters from 0 around it, the
    plain versions counted, the planner's results kept; its exit code,
    printed lines, ``.data`` files and wall time."""
    import contextlib
    import importlib
    import io
    import os
    import tempfile

    module = importlib.import_module(f"osqp_solver_tpu_torch.examples.{name}")
    out, cwd = io.StringIO(), os.getcwd()
    scans = []
    if name == "mpc_fleet_example":  # the example imports these by name
        scan, solve1 = module.mpc_scan_lane, module.solve_lane

        def kept_scan(*a, **kw):
            out_ = scan(*a, **kw)
            scans.append(out_[1])
            return out_

        def kept_solve(*a, **kw):
            r = solve1(*a, **kw)
            scans.append(r[1])
            return r
        module.mpc_scan_lane, module.solve_lane = kept_scan, kept_solve
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            reset_counts()
            with PlainCallsDense() as plain, ResultCapture() as cap, \
                    contextlib.redirect_stdout(out):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = module.main(list(argv))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            files = {p_.name: p_.read_text() for p_ in Path(d).glob("*.data")}
        finally:
            os.chdir(cwd)
            if name == "mpc_fleet_example":
                module.mpc_scan_lane, module.solve_lane = scan, solve1
    return dict(rc=rc, launches={k: v for k, v in counts.items() if v},
                plain_calls=dict(plain.calls), results=cap.results,
                scans=scans, wall_ms=wall, stdout=out.getvalue().splitlines(),
                files=files)


def batch_plan_record(out):
    """Statuses, horizons and finiteness of a ``run_batch_padded`` result."""
    st, trajs, hz, rounds, iters = (a.cpu() for a in out)
    return dict(statuses=encode_statuses(st.numpy()),
                optimal=int((st == 0).sum()), horizons=hz.tolist(),
                scp_rounds=rounds.tolist(), admm_iters=iters.tolist(),
                finite=bool(torch.isfinite(trajs).all()))


def phase_examples():
    """The port's five examples, ``main()`` at their default flags on the
    card (``solver_example`` in both ``--mode padded`` and ``--mode
    exact``): each exits 0 by its own criterion, launches every kernel of
    its path (``EXAMPLE_KERNELS``) and no plain version; the solver
    example's plan passes ``planner_run``'s checks (exact-FK audit, start
    and goal FK, ``.data`` lines), every plan is finite, and the statuses and
    horizons are recorded beside the JAX float32 CPU runs
    (``JAX_PLANNER_RUN``, ``EXAMPLES_REF``)."""
    recs, launches = {}, collections.Counter()
    runs = [("solver_example", ()), ("solver_example", ("--mode", "exact"))]
    runs += [(n, ()) for n in EXAMPLE_MODULES[1:]]
    for name, argv in runs:
        key = name + ("_exact" if argv else "")
        r = run_example(name, argv)
        launches.update(r["launches"])
        rec = dict(exit_code=r["rc"], wall_ms=r["wall_ms"],
                   launches=r["launches"], plain_calls=r["plain_calls"],
                   stdout=r["stdout"])
        if name in ("solver_example", "dh_robot_example"):
            _, solver, res = r["results"][-1]
            n = solver.n_dim
            traj = np.asarray(res.trajectory, dtype=np.float64)
            won = [st.waypoints for st in res.stats if st.status == 0]
            rec.update(status=res.status.name,
                       winning_waypoints=min(won) if won else 0,
                       stats=[list(map(int, st)) for st in res.stats],
                       finite=bool(np.isfinite(traj).all()))
        if name == "solver_example":
            rec.update(plan_checks(solver, res),
                       jax_f32_cpu=JAX_PLANNER_RUN["run" if argv
                                                   else "run_padded"])
            W_ = rec["winning_waypoints"]
            rec["example_data_files_ok"] = data_files_ok(
                r["files"].get("output_trajectory_ctrl.data", ""),
                r["files"].get("output_trajectory_xyz.data", ""), n, W_)
        elif name == "dh_robot_example":
            rec["jax_f32_cpu"] = EXAMPLES_REF.get("dh_robot")
        elif name == "mpc_fleet_example":
            res0, (st, it) = r["scans"][0], r["scans"][1]
            rec.update(cold_optimal=int((res0.status == 0).sum()),
                       optimal=int((st == 0).sum()), total=st.numel(),
                       finite=bool(torch.isfinite(res0.x).all()),
                       warm_iterations_p50=int(it.double().median()))
        else:
            _, _, out = r["results"][-1]
            rec.update(batch_plan_record(out), jax_f32_cpu=EXAMPLES_REF.get(
                name.replace("_example", "")))
        recs[key] = rec
    # A float64 request on the card gets the kernels' TypeError, never a
    # quiet plain path.
    refused = {}
    for name in ("solver_example", "dh_robot_example"):
        try:
            run_example(name, ("--f64", "--waypoints", "16", "--segments",
                               "2"))
            refused[name] = "ran"
        except TypeError as e:
            refused[name] = f"TypeError: {e}"
    recs["float64_refused"] = refused
    emit("examples", **recs)
    if any(not v.startswith("TypeError") for v in refused.values()):
        fail(f"examples: a float64 request on the card was not refused: "
             f"{refused}")
    for key, rec in recs.items():
        if key == "float64_refused":
            continue
        name = key.replace("_exact", "")
        if rec["exit_code"] != 0:
            fail(f"examples: {key} exited {rec['exit_code']}: "
                 f"{rec['stdout'][-3:]}")
        if not rec["finite"]:
            fail(f"examples: {key}: a plan is not finite")
        if min(rec["launches"].get(k, 0) for k in EXAMPLE_KERNELS[name]) < 1 \
                or rec["plain_calls"]:
            fail(f"examples: {key}: launches {rec['launches']}, plain "
                 f"versions {rec['plain_calls']}")
        if name == "solver_example":
            if rec["status"] != "kOptimal" or not rec["shape_ok"]:
                fail(f"examples: {key} ended {rec['status']}")
            if rec["audit"]["workspace_margin"] < -(ERROR + 1e-5) or \
                    rec["audit"]["velocity_mismatch"] > 0.2:
                fail(f"examples: {key}: exact-FK audit failed: "
                     f"{rec['audit']}")
            if max(rec["start_fk_err"], rec["goal_fk_err"]) > 1e-3:
                fail(f"examples: {key}: start/goal FK off the ground truth")
            if not (rec["data_files"]["ok"] and rec["example_data_files_ok"]):
                fail(f"examples: {key}: .data files")
    return dict(launches)


# builder_dense: ConstraintBuilder's QPs (the reference example's UR5e, its
# two balls, boxes and --obstacles lines) at W=30, solved as DenseQPs
# through ops/admm.solve_batched: BUILDER_BATCH on the card in float32,
# BUILDER_CPU of them (a seeded subset) on the CPU in float64.
BUILDER_W, BUILDER_BATCH, BUILDER_CPU, BUILDER_SEED = 30, 256, 32, 14
# |x_f32 - x_f64| allowed, in radians (radians per step for velocities):
# both stop at OSQP's eps_abs = eps_rel = 1e-3; the port's float32 plain
# versions on the CPU end 4.9e-4 from float64 on 16 of these problems (the
# same iteration counts), and the card's kernels round otherwise: ten times
# that.
BUILDER_X_TOL = 5e-3


def builder_problems(B=BUILDER_BATCH, W=BUILDER_W, seed=BUILDER_SEED):
    """``B`` dense QPs from ``ConstraintBuilder``, batch-leading numpy
    float64 ``(P, q, A, l, u)``: starts near zero, goals a base turn of up
    to 1.2 rad the way that keeps the tool off the floor y >= -0.4 and
    away from the lines in XY (the tool's y stays above -0.26, its x below
    -0.29), the other joints within 0.2 rad (every goal reachable in W-3
    steps under the acceleration limit), warm trajectories the straight
    line plus noise, P the smoothness objective, q zero; and the seconds
    the builds took."""
    from osqp_solver_tpu_torch import ConstraintBuilder, HorizontalLine
    from osqp_solver_tpu_torch.gomp.trajectory import smoothness_objective

    rng = np.random.default_rng(seed)
    starts = 0.02 * rng.standard_normal((B, N))
    goals = starts + rng.uniform(-0.2, 0.2, (B, N))
    goals[:, 0] = starts[:, 0] + rng.uniform(-1.2, 0.0, B)
    dt = EXAMPLE["time_step"]
    C = constraints
    pos = C.in_range(N, -2 * math.pi, 2 * math.pi)
    vel = C.scaled(C.in_range(N, -math.pi, math.pi), dt)
    acc = C.scaled(C.in_range(N, -math.pi * 800 / 180, math.pi * 800 / 180),
                   dt * dt)
    con3d = C.in_range(3, [-C.INF, -0.4, -C.INF], None)
    balls = [ur5e.make_ball("back6", 0.15),
             ur5e.make_ball("tool", 0.05, is_gripper=True)]
    lines = [HorizontalLine.create([0, 1], [0, 0, 0.6], True),
             HorizontalLine.create([0, 1], [0.3, 0, 0.5], False)]
    P = np.asarray(smoothness_objective(W, N), dtype=np.float64)
    t0 = time.perf_counter()
    ls, As, us = [], [], []
    for b in range(B):
        q = np.linspace(starts[b], goals[b], W) + 0.01 * rng.standard_normal(
            (W, N))
        traj = np.concatenate([q.reshape(-1), np.zeros(W * N)])
        l_, A_, u_ = (ConstraintBuilder(W, N, balls=balls, obstacles=lines)
                      .position(0, C.equal(starts[b]))
                      .positions(1, W - 2, pos)
                      .position(W - 3, C.equal(goals[b]))
                      .velocities(0, W - 4, vel)
                      .velocity(W - 3, C.eq_zero(N))
                      .accelerations(0, W - 4, acc)
                      .acceleration(W - 3, C.eq_zero(N))
                      .with_obstacles(con3d, traj)
                      .build())
        ls.append(l_)
        As.append(A_)
        us.append(u_)
    seconds = time.perf_counter() - t0
    n = P.shape[0]
    return (np.ascontiguousarray(np.broadcast_to(P, (B, n, n))),
            np.zeros((B, n)), np.stack(As), np.stack(ls), np.stack(us)), seconds


def phase_builder_dense():
    """``ConstraintBuilder``'s QPs solved as dense QPs (n=360) through
    ``ops/admm.solve_batched``: BUILDER_BATCH on the card in float32 (the
    dense factor and solve kernels launched, no plain version), held to the
    port's float64 CPU solve of a seeded subset: equal statuses, ``x``
    within BUILDER_X_TOL."""
    arrays, build_s = builder_problems()
    settings = Settings()
    B = arrays[1].shape[0]
    qps = convert.dense_qp_from_numpy(*arrays, device="cuda",
                                      dtype=torch.float32)
    reset_counts()
    s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
    with PlainCallsDense() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gadmm.solve_batched(qps, settings)  # the main path, once
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counts, syncs, refactors = generic_counts(s0, r0)
    idx = np.sort(np.random.default_rng(BUILDER_SEED).choice(
        B, BUILDER_CPU, replace=False))
    t0 = time.perf_counter()
    ref = gadmm.solve_batched(convert.dense_qp_from_numpy(
        *(a[idx] for a in arrays), device="cpu", dtype=torch.float64),
        settings, device="cpu")
    cpu_s = time.perf_counter() - t0
    st, it = res.status.cpu(), res.iterations.cpu()
    sub = torch.from_numpy(idx)
    same = int((st[sub] == ref.status).sum())
    x_err = float((res.x.cpu().double()[sub] - ref.x).abs().max())
    n, m = arrays[2].shape[2], arrays[2].shape[1]
    kern = {}
    Mf = torch.randn(n, n, B, device="cuda")
    Mf = torch.einsum("ikb,jkb->ijb", Mf, Mf) / n + torch.eye(
        n, device="cuda")[:, :, None]
    rhs = torch.randn(n, B, device="cuda")
    Lt = dense_kernel.factor_lane_major(Mf)
    kern["dense_factor_ms"] = time_ms(lambda: dense_kernel.factor_lane_major(
        Mf))
    kern["dense_solve_ms"] = time_ms(lambda: dense_kernel.solve_lane_major(
        Lt, rhs))
    rec = dict(
        batch=B, W=BUILDER_W, n=n, m=m, build_s=build_s, ms=ms,
        statuses={str(k): v for k, v in sorted(collections.Counter(
            st.tolist()).items())},
        optimal=int((st == 0).sum()), iterations_p50=int(it.median()),
        iterations_max=int(it.max()), cpu_subset=len(idx), cpu_s=cpu_s,
        cpu_statuses={str(k): v for k, v in sorted(collections.Counter(
            ref.status.tolist()).items())},
        cpu_iterations_p50=int(ref.iterations.median()),
        same_status=same, x_max_abs_err=x_err, x_tol=BUILDER_X_TOL,
        finite=bool(torch.isfinite(res.x).all()), launches=counts,
        host_syncs=syncs, rho_refactors=refactors,
        plain_calls=dict(plain.calls), kernels_at_n=kern)
    emit("builder_dense", **rec)
    if same != len(idx) or not rec["finite"]:
        fail(f"builder_dense: {same}/{len(idx)} statuses equal to the "
             f"float64 CPU run's")
    if x_err > BUILDER_X_TOL:
        fail(f"builder_dense: x off the float64 CPU run by {x_err:.3e} > "
             f"{BUILDER_X_TOL}")
    if min(counts["dense_factor"], counts["dense_solve"]) < 1 or plain.calls:
        fail(f"builder_dense: launches {counts}, plain versions "
             f"{dict(plain.calls)}")
    return {k: counts[k] for k in ("dense_factor", "dense_solve")}


# ------------------------------------------------------------- parallel/
# This slice's main path: the horizon split of one long trajectory QP on the
# card, and the sharded entry points over torch.distributed.

# The JAX package's float32 CPU run of horizon_long's problem
# (tools/jax_reference_counts.py long_horizon): iterations, both kOptimal.
HORIZON_REF = dict(sequential=25, chunked=25)
# x of the sequential and the chunked solve (and of the sharded solves
# against the chunked one), max abs.  Read on the NVIDIA H100 80GB HBM3 at
# 700 W: 9.06e-14 sequential against chunked, 4.77e-7 the one-rank sharded
# solve against the chunked one; the limit sits 20 times above the larger.
HORIZON_X_TOL = 1e-5
# The tridiagonal kernels at W=10,000, B=1 against the plain version in
# float64 on the host, on the same float32 inputs: max abs error over
# max |f64| (the factor as every tridiag row holds it; the solve over a
# 10,000-step chain of the KKT at its first rho).
TOL_HORIZON_FACTOR, TOL_HORIZON_SOLVE = TOL_TRIDIAG, 1e-3
# The Schur split's KKT solve (62 chunks) of the same random right-hand
# side against the same float64 solve, max abs error over max |f64|.  x of
# horizon_long's QP hardly depends on the split (its solution moves only
# within the last chunk), so this solve is what holds the split.  Two wrong
# splits run beside it, the interface columns U dropped and U 0.1 % off,
# and each must exceed the limit.
TOL_HORIZON_SPLIT = 2e-4
SPLIT_CONTROLS = {"U_dropped": 0.0, "U_off_0.1%": 1.001}
# Dense batch and planner: the sharded call against the one-process call on
# the same device (max abs over x / trajectories).
PAR_X_TOL = 1e-5


def long_kernel_checks(qp, settings):
    """The tridiagonal factor and solve alone at W=10,000, B=1 (the KKT of
    the problem at its first rho) against the plain version in float64 on
    the host, their plans, and their times beside the Schur split's pieces
    (K interiors as the batch, the interface columns, the reduced system)."""
    from osqp_solver_tpu_torch.ops.tridiag import (block_tridiag_factor,
                                                   block_tridiag_solve)
    from osqp_solver_tpu_torch.parallel import schur

    q1 = qp.map_arrays(lambda a: a.unsqueeze(-1))
    rho = _rho_vec(torch.full((1,), settings.rho, device="cuda"), q1.l, q1.u)
    diag, lower = q1.kkt_blocks(rho, settings.sigma)
    rhs = torch.randn(diag.shape[0], 2 * N, 1, device="cuda")
    chol, gain = tridiag_kernel.factor_lane_major(diag, lower)
    x = tridiag_kernel.solve_lane_major(chol, gain, rhs)
    f64 = block_tridiag_factor(diag.double().cpu(), lower.double().cpu())
    x64 = block_tridiag_solve(f64, rhs.double().cpu())
    ferr = max(rel_err(chol.double().cpu(), f64.chol)[1],
               rel_err(gain.double().cpu(), f64.gain)[1])
    serr = rel_err(x.double().cpu(), x64)
    lib = tridiag_kernel._lib(2 * N)
    Wd = diag.shape[0]
    B2 = 2 * N
    sf = schur.schur_factor(diag, lower, HORIZON_K)
    Wl, K = sf.chunks.Di.shape[0], sf.chunks.Di.shape[3]
    ic, ig = sf.interior.chol.flatten(3), sf.interior.gain.flatten(3)
    irhs = torch.randn(Wl, B2, K, device="cuda")
    cols = 2 * B2 * K
    cc = ic.unsqueeze(-1).expand(Wl, B2, B2, K, 2 * B2).reshape(
        Wl, B2, B2, cols)
    cg_ = ig.unsqueeze(-1).expand(Wl - 1, B2, B2, K, 2 * B2).reshape(
        Wl - 1, B2, B2, cols)
    crhs = torch.randn(Wl, B2, cols, device="cuda")
    Di = sf.chunks.Di.flatten(3).contiguous()
    Li = sf.chunks.Li.flatten(3).contiguous()
    ix = tridiag_kernel.solve_lane_major(ic, ig, irhs)
    cx = tridiag_kernel.solve_lane_major(cc, cg_, crhs)

    # The kernels read only the lower triangle of diag (factor) and of chol
    # (solve), as in check_tridiag.  The interface columns need the K
    # interior factors once, whatever the tiled layout reads, with the
    # 2*B2 right-hand sides and solutions of each chunk.
    def factor_bound(D, L, C, G):
        W_, B_ = D.shape[0], D.shape[3]
        return bound(tril_bytes(D) + nbytes(L, C, G),
                     ops_tridiag_factor(W_, B2, B_))

    def solve_bound(C, G, r, x_):
        W_, B_ = r.shape[0], r.shape[2]
        return bound(tril_bytes(C) + nbytes(G, r, x_),
                     ops_tridiag_solve(W_, B2, B_))

    def timed(ms, bnd, **kw):
        return dict(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], **kw)

    times = {
        "factor_W10000_B1": timed(
            time_ms(lambda: tridiag_kernel.factor_lane_major(diag, lower)),
            factor_bound(diag, lower, chol, gain), W=Wd, B=1),
        "solve_W10000_B1": timed(
            time_ms(lambda: tridiag_kernel.solve_lane_major(chol, gain,
                                                            rhs)),
            solve_bound(chol, gain, rhs, x), W=Wd, B=1),
        "schur_interiors_factor": timed(
            time_ms(lambda: tridiag_kernel.factor_lane_major(Di, Li)),
            factor_bound(Di, Li, ic, ig), W=Wl, B=K),
        "schur_interiors_solve": timed(
            time_ms(lambda: tridiag_kernel.solve_lane_major(ic, ig, irhs)),
            solve_bound(ic, ig, irhs, ix), W=Wl, B=K),
        "schur_interface_columns_solve": timed(
            time_ms(lambda: tridiag_kernel.solve_lane_major(cc, cg_, crhs)),
            bound(tril_bytes(ic) + nbytes(ig, crhs, cx),
                  ops_tridiag_solve(Wl, B2, cols)), W=Wl, B=cols,
            factor_copy_bytes=nbytes(cc, cg_)),  # tiled once per factor
        "schur_factor_whole": dict(
            ms=time_ms(lambda: schur.schur_factor(diag, lower, K))),
        "schur_solve_whole": dict(
            ms=time_ms(lambda: schur.schur_solve_cached(sf, rhs))),
        "sequential_solve_whole": dict(
            ms=time_ms(lambda: tridiag_kernel.solve_lane_major(chol, gain,
                                                               rhs))),
    }
    split_err = rel_err(schur.schur_solve_cached(sf, rhs).double().cpu(),
                        x64)[1]
    controls = {name: rel_err(schur.schur_solve_cached(dataclasses.replace(
        sf, U=sf.U * scale), rhs).double().cpu(), x64)[1]
        for name, scale in SPLIT_CONTROLS.items()}
    return dict(
        factor_rel_err=ferr, solve_rel_err=serr[1], solve_abs_err=serr[0],
        split_solve_rel_err=split_err, split_controls_rel_err=controls,
        finite=bool(torch.isfinite(chol).all() and torch.isfinite(x).all()),
        solve_plan=tridiag_kernel.plan(lib, Wd, 1),
        factor_plan=tridiag_kernel.factor_plan(lib, 1),
        interiors_solve_plan=tridiag_kernel.plan(lib, Wl, K),
        columns_solve_plan=tridiag_kernel.plan(lib, Wl, cols),
        times=times, chunks=K, interior_waypoints=Wl)


HORIZON_K = 62  # auto_chunks(10,000)


def phase_horizon_long():
    """``benchmarks/long_horizon.py``'s problem through ``ops/admm.solve``:
    the plain ``TrajectoryQP`` (the tridiagonal kernels at batch 1, W=10,000)
    and ``as_chunked(qp)`` at ``auto_chunks`` (the K interiors as the
    kernels' batch).  Returns the record, the launches of both solves
    together, and the two results."""
    from osqp_solver_tpu_torch.parallel.horizon import as_chunked, auto_chunks

    settings = dataclasses.replace(Settings(), **HORIZON_SETTINGS)
    qp = long_horizon_qp("cuda")
    K = auto_chunks(HORIZON_W)
    if K != HORIZON_K:
        fail(f"horizon_long: auto_chunks({HORIZON_W}) = {K}, "
             f"not {HORIZON_K}")
    chunked = as_chunked(qp)
    runs, ms = {}, {}
    with PlainCalls() as plain:
        for name, p in (("sequential", qp), ("chunked", chunked)):
            reset_counts()
            s0, r0 = gadmm.HOST_SYNCS, gadmm.RHO_REFACTORS
            res = gadmm.solve(p, settings)  # the main path, once each
            counts, syncs, refactors = generic_counts(s0, r0)
            runs[name] = dict(res=res, counts=counts, syncs=syncs,
                              refactors=refactors)
        for name, p in (("sequential", qp), ("chunked", chunked)):
            ms[name] = statistics.median(
                host_ms(lambda: gadmm.solve(p, settings)) for _ in range(3))
        kern = long_kernel_checks(qp, settings)
    seq, ch = runs["sequential"], runs["chunked"]
    err = (seq["res"].x - ch["res"].x).abs().max().item()
    rec = dict(
        waypoints=HORIZON_W, n_dim=N, chunks=K, settings=HORIZON_SETTINGS,
        runs={k: dict(status=int(v["res"].status),
                      iterations=int(v["res"].iterations),
                      launches=v["counts"], host_syncs=v["syncs"],
                      rho_refactors=v["refactors"])
              for k, v in runs.items()},
        jax_f32_iterations=HORIZON_REF, x_max_abs_diff=err,
        x_tol=HORIZON_X_TOL, ms_per_solve=ms, plain_calls=dict(plain.calls),
        kernels=kern)
    emit("horizon_long", **rec)
    for k, v in runs.items():
        r = v["res"]
        if int(r.status) != int(ExitCode.kOptimal):
            fail(f"horizon_long: {k} solve status {int(r.status)}")
        if not bool(torch.isfinite(r.x).all()) or list(r.x.shape) != [
                2 * HORIZON_W * N]:
            fail(f"horizon_long: {k} x not finite or of the wrong shape")
        c = v["counts"]
        if c["tridiag_factor"] < 1 or c["tridiag_solve"] < 1:
            fail(f"horizon_long: {k} did not launch the tridiagonal kernels: "
                 f"{c}")
    if sum(plain.calls.values()):
        fail(f"horizon_long: plain versions ran on the card: {plain.calls}")
    its = {k: int(v["res"].iterations) for k, v in runs.items()}
    if its != HORIZON_REF:
        fail(f"horizon_long: iterations {its}, the JAX float32 run's "
             f"{HORIZON_REF}")
    if err > HORIZON_X_TOL:
        fail(f"horizon_long: sequential and chunked x differ by {err:.2e}")
    it_seq = int(seq["res"].iterations)
    it_ch = int(ch["res"].iterations)
    # launches: one factor (two: interiors + reduced) per factorisation; one
    # solve (two) per iteration, the chunked factor one more (the columns)
    f_seq, f_ch = 1 + seq["refactors"], 1 + ch["refactors"]
    want = {"sequential": (f_seq, it_seq), "chunked": (2 * f_ch,
                                                       f_ch + 2 * it_ch)}
    got = {k: (v["counts"]["tridiag_factor"], v["counts"]["tridiag_solve"])
           for k, v in runs.items()}
    if got != want:
        fail(f"horizon_long: launches {got}, expected {want}")
    if not kern["finite"] or kern["factor_rel_err"] > TOL_HORIZON_FACTOR or \
            kern["solve_rel_err"] > TOL_HORIZON_SOLVE:
        fail(f"horizon_long: the tridiagonal kernels at W={HORIZON_W}, B=1: "
             f"factor {kern['factor_rel_err']:.2e}, solve "
             f"{kern['solve_rel_err']:.2e}")
    if kern["split_solve_rel_err"] > TOL_HORIZON_SPLIT or min(
            kern["split_controls_rel_err"].values()) <= TOL_HORIZON_SPLIT:
        fail(f"horizon_long: the Schur split's solve "
             f"{kern['split_solve_rel_err']:.2e} (limit {TOL_HORIZON_SPLIT}), "
             f"its wrong controls {kern['split_controls_rel_err']}")
    total = {k: seq["counts"][k] + ch["counts"][k] for k in seq["counts"]}
    return rec, total, {k: v["res"] for k, v in runs.items()}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_calls(mesh_b, mesh_h, local_chunks, want_payload=False):
    """The three sharded entry points of this slice on the card: the dense
    batch (config 2's, 1024 QPs at n=64), the long horizon split over the
    horizon axis with ``local_chunks`` per rank, and ``planner_full``'s
    full search.  Returns the results, the launches, the plain calls, the
    collective counts and the host times."""
    from osqp_solver_tpu_torch.parallel import (_comm, solve_batch_sharded,
                                                solve_horizon_sharded)

    long_s = dataclasses.replace(Settings(), **HORIZON_SETTINGS)
    qps = convert.dense_qp_from_numpy(*dense_problems(BATCH), device="cuda")
    qp = long_horizon_qp("cuda")
    solver = ur5e_solver(50, [])
    starts, ends = fleet_queries(BATCH, np.random.default_rng(0))
    out, comm, ms = {}, {}, {}
    with PlainCallsDense() as plain:
        reset_counts()
        _comm.reset()
        t0 = time.perf_counter()
        out["dense"] = solve_batch_sharded(qps, mesh_b, Settings())
        torch.cuda.synchronize()
        ms["dense"] = (time.perf_counter() - t0) * 1e3
        comm["dense"] = _comm.counts()
        _comm.reset()
        t0 = time.perf_counter()
        out["horizon"] = solve_horizon_sharded(qp, mesh_h, long_s,
                                               local_chunks=local_chunks)
        torch.cuda.synchronize()
        ms["horizon"] = (time.perf_counter() - t0) * 1e3
        comm["horizon"] = _comm.counts()
        _comm.reset()
        t0 = time.perf_counter()
        out["planner"] = solver.run_batch_padded_sharded(starts, ends, mesh_b)
        torch.cuda.synchronize()
        ms["planner"] = (time.perf_counter() - t0) * 1e3
        comm["planner"] = _comm.counts()
        counts = read_counts()
        if want_payload:  # the per-call payloads at half the horizon
            _comm.reset()
            half = solve_horizon_sharded(
                long_horizon_qp("cuda", HORIZON_W // 2), mesh_h, long_s,
                local_chunks=local_chunks)
            comm["horizon_half"] = _comm.counts()
            out["horizon_half_iterations"] = int(half.iterations)
    return out, counts, dict(plain.calls), comm, ms


def _payload(c):
    return {k: v["sizes"] for k, v in c.items() if k != "gather_result"}


# The kernels of ``parallel.multihost``'s worker (its N=3 planners with and
# without an obstacle, the Schur check's B2=4 system), built with the rest.
MULTIHOST_SIGNATURES = [{"NDIM": 3, "NX": 3}, {"NDIM": 3, "NX": 3, "BLOCK_P": 0},
                        {"NDIM": 3, "NX": 4}, {"NDIM": 3, "NX": 4, "BLOCK_P": 0},
                        {"B2": 6}, {"B2": 4}]


def multihost_cli():
    """``python -m osqp_solver_tpu_torch.parallel.multihost`` as a user runs
    it, a world of one rank at its default device (CUDA, NCCL): its own
    checks against its one-process solves.  Returns its verdict."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "verdict.json"
        try:
            pr = subprocess.run(
                [sys.executable, "-m", "osqp_solver_tpu_torch.parallel.multihost",
                 "--world-size", "1", "--rank", "0", "--master",
                 f"127.0.0.1:{_free_port()}", "--out", str(out)],
                cwd=Path(__file__).resolve().parent, capture_output=True,
                text=True, timeout=240)
        except subprocess.TimeoutExpired:
            fail("parallel_one: multihost did not finish in 240 s")
        if pr.returncode != 0 or not out.exists():
            fail(f"parallel_one: multihost exited {pr.returncode}:\n"
                 f"{(pr.stdout + pr.stderr)[-3000:]}")
        return json.loads(out.read_text())


def phase_parallel_one(long_results):
    """A world of one rank over NCCL on the card: the three sharded calls
    against the one-process ones (``solve_batched``, ``horizon_long``'s
    chunked solve, ``run_batch_padded``), every collective a real NCCL one;
    then ``parallel.multihost``'s command line in a world of one."""
    import torch.distributed as dist

    from osqp_solver_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(batch=1, horizon=1)
        out, counts, plain, comm, ms = parallel_calls(mesh, mesh, HORIZON_K)
    finally:
        dist.destroy_process_group()
    ref_d = gadmm.solve_batched(convert.dense_qp_from_numpy(
        *dense_problems(BATCH), device="cuda"), Settings())
    solver = ur5e_solver(50, [])
    starts, ends = fleet_queries(BATCH, np.random.default_rng(0))
    ref_p = solver.run_batch_padded(starts, ends)
    ref_h = long_results["chunked"]
    cmp = compare_parallel(out, ref_d, ref_h, ref_p)
    t0 = time.perf_counter()
    cli = multihost_cli()
    rec = dict(world=1, backend="nccl", launches=counts, plain_calls=plain,
               collectives=comm, ms_per_call=ms, **cmp, multihost_cli=cli,
               multihost_cli_s=time.perf_counter() - t0)
    emit("parallel_one", **rec)
    check_parallel("parallel_one", rec, counts, plain, strict_iters=True)
    if not cli["ok"] or cli["backend"] != "nccl":
        fail(f"parallel_one: multihost's verdict {cli}")
    return counts, out


def compare_parallel(out, ref_d, ref_h, ref_p):
    d, h, p = out["dense"], out["horizon"], out["planner"]
    return dict(
        dense=dict(
            optimal=int((d.status == 0).sum()),
            statuses_equal=bool(torch.equal(d.status, ref_d.status)),
            iterations_differ=int((d.iterations != ref_d.iterations).sum()),
            x_max_abs_diff=(d.x - ref_d.x).abs().max().item()),
        horizon=dict(
            status=int(h.status), iterations=int(h.iterations),
            ref_status=int(ref_h.status), ref_iterations=int(ref_h.iterations),
            x_max_abs_diff=(h.x - ref_h.x).abs().max().item()),
        planner=dict(
            optimal=int((p[0] == 0).sum()),
            statuses_equal=bool(torch.equal(p[0], ref_p[0])),
            horizons_equal=bool(torch.equal(p[2], ref_p[2])),
            scp_rounds_differ=int((p[3] != ref_p[3]).sum()),
            admm_iters_differ=int((p[4] != ref_p[4]).sum()),
            trajectory_max_abs_diff=(p[1] - ref_p[1]).abs().max().item()))


def check_parallel(name, rec, counts, plain, strict_iters):
    d, h, p = rec["dense"], rec["horizon"], rec["planner"]
    if sum(plain.values()):
        fail(f"{name}: plain versions ran on the card: {plain}")
    need = ("dense_factor", "dense_solve", "tridiag_factor",
            "tridiag_solve") + LANE_KERNELS
    if min(counts[k] for k in need) < 1:
        fail(f"{name}: a kernel of the path was never launched: {counts}")
    if d["optimal"] != BATCH or not d["statuses_equal"]:
        fail(f"{name}: dense {d}")
    if h["status"] != 0 or h["status"] != h["ref_status"] or \
            h["iterations"] != HORIZON_REF["chunked"] or \
            h["x_max_abs_diff"] > HORIZON_X_TOL:
        fail(f"{name}: horizon {h}")
    if not (p["statuses_equal"] and p["horizons_equal"]):
        fail(f"{name}: planner {p}")
    if strict_iters and (d["iterations_differ"] or p["admm_iters_differ"]
                         or p["scp_rounds_differ"]
                         or h["iterations"] != h["ref_iterations"]):
        fail(f"{name}: iteration counts differ: {d} {h} {p}")
    if strict_iters and (d["x_max_abs_diff"] > PAR_X_TOL
                         or p["trajectory_max_abs_diff"] > PAR_X_TOL):
        fail(f"{name}: solutions differ: {d} {p}")


PAR_RANKS, PAR_LOCAL_CHUNKS = 2, 31


def rank_worker(rank, world, master, out_dir):
    """One rank of ``parallel_ranks`` (``chip_smoke.py --rank-worker``):
    gloo on the one GPU; first the one-process calls on this rank's own
    slice of the dense batch and of the queries (they also warm the
    process), then the three sharded calls; results to ``out_dir``."""
    import torch.distributed as dist

    from osqp_solver_tpu_torch.parallel import make_mesh, multihost
    from osqp_solver_tpu_torch.parallel.mesh import batch_slice

    backend = multihost.initialize(master, world, rank, "cuda", timeout_s=240)
    try:
        mesh_b = make_mesh(batch=world, horizon=1)
        mesh_h = make_mesh(batch=1, horizon=world)
        sl = batch_slice(BATCH, mesh_b)
        own_d = gadmm.solve_batched(convert.dense_qp_from_numpy(
            *(a[sl] for a in dense_problems(BATCH)), device="cuda"),
            Settings())
        starts, ends = fleet_queries(BATCH, np.random.default_rng(0))
        own_p = ur5e_solver(50, []).run_batch_padded(starts[sl], ends[sl])
        out, counts, plain, comm, ms = parallel_calls(
            mesh_b, mesh_h, PAR_LOCAL_CHUNKS, want_payload=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    d, h, p = out["dense"], out["horizon"], out["planner"]
    # the sharded calls against the one-process calls on the same slice
    slice_equal = dict(
        dense=all(torch.equal(getattr(d, f)[sl], getattr(own_d, f))
                  for f in ("x", "status", "iterations")),
        planner=all(torch.equal(a[sl], b) for a, b in zip(p, own_p)))
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             dense_x=d.x.cpu().numpy(), dense_status=d.status.cpu().numpy(),
             dense_iters=d.iterations.cpu().numpy(),
             horizon_x=h.x.cpu().numpy(),
             **{f"planner_{i}": a.cpu().numpy() for i, a in enumerate(p)})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, world=world, backend=backend, launches=counts,
        plain_calls=plain, collectives=comm, ms_per_call=ms,
        horizon_status=int(h.status), horizon_iterations=int(h.iterations),
        horizon_half_iterations=out["horizon_half_iterations"],
        slice_equal=slice_equal,
        payload_same_at_half=_payload(comm["horizon"]) == _payload(
            comm["horizon_half"]))))


def phase_parallel_ranks(ref):
    """Two ranks spawned as processes on the one H100 over gloo: the same
    three calls (the horizon split into 2 ranks x 31 local chunks), each
    rank's results held to ``parallel_one``'s (``ref``)."""
    import tempfile

    master = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-worker",
             str(r), "--world-size", str(PAR_RANKS), "--master", master,
             "--worker-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PAR_RANKS)]
        logs = []
        try:
            for pr in procs:
                logs.append(pr.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for pr in procs:
                pr.kill()
            fail("parallel_ranks: a rank did not finish in 300 s")
        for r, pr in enumerate(procs):
            if pr.returncode != 0:
                fail(f"parallel_ranks: rank {r} exited {pr.returncode}:\n"
                     f"{logs[r][-3000:]}")
        ranks = []
        for r in range(PAR_RANKS):
            js = json.loads((Path(tmp) / f"rank{r}.json").read_text())
            arr = dict(np.load(Path(tmp) / f"rank{r}.npz"))
            ranks.append((js, arr))
    rd, rh, rp = ref["dense"], ref["horizon"], ref["planner"]
    per_rank = []
    for js, arr in ranks:
        st = torch.from_numpy(arr["dense_status"])
        it = torch.from_numpy(arr["dense_iters"])
        pst = torch.from_numpy(arr["planner_0"])
        cmp = dict(
            rank=js["rank"],
            dense_statuses_equal=bool(torch.equal(st, rd.status.cpu())),
            dense_iterations_differ=[int(i) for i in torch.nonzero(
                it != rd.iterations.cpu()).flatten()],
            dense_x_max_abs_diff=float(np.abs(
                arr["dense_x"] - rd.x.cpu().numpy()).max()),
            horizon_status=js["horizon_status"],
            horizon_iterations=js["horizon_iterations"],
            one_horizon_iterations=int(rh.iterations),
            horizon_x_max_abs_diff=float(np.abs(
                arr["horizon_x"] - rh.x.cpu().numpy()).max()),
            planner_statuses_equal=bool(torch.equal(pst, rp[0].cpu())),
            planner_horizons_differ=[int(i) for i in np.nonzero(
                arr["planner_2"] != rp[2].cpu().numpy())[0]],
            planner_admm_iters_differ=[int(i) for i in np.nonzero(
                arr["planner_4"] != rp[4].cpu().numpy())[0]],
            planner_trajectory_max_abs_diff=float(np.abs(
                arr["planner_1"] - rp[1].cpu().numpy()).max()),
            payload_same_at_half=js["payload_same_at_half"],
            slice_equal=js["slice_equal"],
            horizon_half_iterations=js["horizon_half_iterations"],
            launches=js["launches"], plain_calls=js["plain_calls"],
            collectives=js["collectives"], ms_per_call=js["ms_per_call"],
            backend=js["backend"])
        per_rank.append(cmp)
    emit("parallel_ranks", ranks=PAR_RANKS,
         local_chunks=PAR_LOCAL_CHUNKS, per_rank=per_rank)
    for c in per_rank:
        if c["backend"] != "gloo":
            fail(f"parallel_ranks: rank {c['rank']} ran {c['backend']}")
        if sum(c["plain_calls"].values()):
            fail(f"parallel_ranks: plain versions ran on the card: {c}")
        need = ("dense_factor", "dense_solve", "tridiag_factor",
                "tridiag_solve") + LANE_KERNELS
        if min(c["launches"][k] for k in need) < 1:
            fail(f"parallel_ranks: rank {c['rank']} launched no time a "
                 f"kernel of the path: {c['launches']}")
        if not (c["dense_statuses_equal"] and c["planner_statuses_equal"]
                and c["horizon_status"] == 0):
            fail(f"parallel_ranks: statuses differ: {c}")
        if c["horizon_iterations"] != HORIZON_REF["chunked"]:
            fail(f"parallel_ranks: rank {c['rank']}'s horizon solve took "
                 f"{c['horizon_iterations']} iterations, not "
                 f"{HORIZON_REF['chunked']}")
        # A rank's half batch goes through torch.bmm (cuBLAS) at another
        # batch count than the whole batch, which rounds otherwise in
        # float32 (tools/batch_invariance.py: the first operation whose
        # result moves is the bmm of DenseQP.AT_matvec and of
        # LaneTrajectoryQP.A_matvec), so iteration counts and horizons may
        # move (printed above); the sharded path itself must equal the
        # one-process calls on the same slice bit for bit.
        if not all(c["slice_equal"].values()):
            fail(f"parallel_ranks: rank {c['rank']}'s shard differs from the "
                 f"one-process calls on its slice: {c['slice_equal']}")
        if c["horizon_x_max_abs_diff"] > HORIZON_X_TOL:
            fail(f"parallel_ranks: horizon x differs: {c}")
        if not c["payload_same_at_half"]:
            fail(f"parallel_ranks: a collective payload grows with W: {c}")
    return per_rank


# ---------------------------------------------------------------------------
# The reference's own problem batched (W=802): the honest class through the
# lane driver (w802) and the full search (planner_w802).
# ---------------------------------------------------------------------------
# tools/jax_reference_counts.py w802: the JAX package in float32 on the CPU
# on the first W802_REF_PROBLEMS problems of w802's batch: exit codes
# (encode_statuses) and iteration counts (encode_iters) per problem.
W802_REF = dict(statuses="0" * 16, code="88a8aaa8a8a8aaa8", p50=30)
# tools/jax_reference_counts.py planner_w802: the same in the JAX search on
# the first PLANNER_W802_REF_QUERIES queries: exit code, winning horizon
# and SCP rounds per query.
PLANNER_W802_REF = dict(statuses=[0] * 8, horizons=[320] * 8,
                        rounds=[10, 11, 11, 10, 10, 11, 11, 10],
                        admm_iters=[309, 318, 318, 309, 309, 318, 318, 309])
# The JAX package's record of the same search on a TPU
# (benchmarks/artifacts/r5/runbook/planner_full_w802_b512.json): the
# counts the card's run is held to (not its times).
PLANNER_W802_RECORD = dict(horizon_p50=320, scp_rounds_p50=10,
                           admm_iters_p50=309)
W802_ITERS_BAND = 0.1
# The kernels of w802's path, each held alone at W=802, B=512.
W802_KERNELS = ("ruiz", "kkt_factor", "admm_chunk", "admm_chunk_warmup",
                "admm_chunk_dxdy", "residuals")
W802_FORMS = {"term_fused": {}, "term_off": dict(term_fused="off")}


def phase_w802():
    """The honest class at the reference example's W=802, B=512, f32
    (``honest_f32``: the numbers the JAX run gets), through
    ``solve_batched_lane`` at ``benchmarks/w802_lane.py``'s settings with
    the termination fused in the chunk and with ``term_fused="off"`` (the
    delta-writing chunk and the residual kernel): every problem optimal in
    both, statuses and counts equal problem for problem, the first
    W802_REF_PROBLEMS' p50 within one chunk of the JAX f32 run's, the f64
    criterion within 2 % on 16 problems, the path's kernels launched, no
    plain version, one host read a chunk; the batch timed (median of 7).
    Then each kernel of the path alone at this shape (``size_kernels``
    with the warm-up form) against its plain version in f64, each launch
    repeated bit for bit, with its launch plan."""
    s0 = dataclasses.replace(Settings(), **W802_SETTINGS)
    qp = honest_f32(W802_BATCH, W802_W, "cuda")
    idx = torch.linspace(0, W802_BATCH - 1, 16).long()
    recs, outs = {}, {}
    for form, over in W802_FORMS.items():
        s = dataclasses.replace(s0, **over)
        res, c = solve_counts(qp, s)  # the path, once
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admm_lane.solve_batched_lane(qp, s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        summ = iteration_summary(res, s)
        it = res.iterations.cpu()
        k = W802_REF_PROBLEMS
        recs[form] = dict(
            **summ, **c, f64_prim_dual_box=host_residual_check(qp, res, idx, s),
            ms_per_batch=ms, qps_per_s=summ["optimal"] / (ms * 1e-3),
            ms_all=[round(t * 1e3, 3) for t in times],
            iterations_p50_first=int(it[:k].median()),
            statuses_first=encode_statuses(res.status.cpu()[:k].numpy()),
            code_first=encode_iters(it[:k].numpy(), s.check_termination),
            shape_x=list(res.x.shape))
        outs[form] = (res.status.cpu(), it)
        del res
    a, b = outs["term_fused"], outs["term_off"]
    differ = dict(statuses=int((a[0] != b[0]).sum()),
                  iterations=int((a[1] != b[1]).sum()))
    kern, ptx = size_kernels(N, qp, s0, ref=False, warmup=True)
    emit("w802", W=W802_W, batch=W802_BATCH, settings=W802_SETTINGS, **recs,
         fused_vs_off_differ=differ, jax_f32_first=W802_REF, kernels=kern,
         ptxas=ptx)
    need = {"term_fused": LANE_KERNELS, "term_off": UNFUSED_KERNELS}
    for form, rec in recs.items():
        if rec["optimal"] != W802_BATCH or not rec["finite"] or rec[
                "shape_x"] != [W802_BATCH, 2 * W802_W * N]:
            fail(f"w802 ({form}): {rec['optimal']}/{W802_BATCH} optimal")
        if max(rec["f64_prim_dual_box"][:2]) > 1.02 or rec[
                "f64_prim_dual_box"][2] > 1e-4:
            fail(f"w802 ({form}): float64 recomputation violates OSQP's "
                 f"criterion {rec['f64_prim_dual_box']}")
        if rec["plain_calls"] or min(rec["launches"][k] for k in need[form]) < 1:
            fail(f"w802 ({form}): launches {rec['launches']}, plain versions "
                 f"{rec['plain_calls']}")
        if rec["host_syncs"] != rec["chunks"]:
            fail(f"w802 ({form}): {rec['host_syncs']} host reads for "
                 f"{rec['chunks']} chunks")
        if abs(rec["iterations_p50_first"] - W802_REF["p50"]) > \
                s0.check_termination:
            fail(f"w802 ({form}): iterations p50 of the first "
                 f"{W802_REF_PROBLEMS} {rec['iterations_p50_first']}, the "
                 f"JAX f32 run's {W802_REF['p50']}")
    if any(differ.values()):
        fail(f"w802: fused and unfused termination differ: {differ}")
    bad = [k for k, v in kern.items() if not v["ok"]]
    if bad:
        fail(f"w802: kernel(s) at W=802, B=512 outside tolerance of the f64 "
             f"plain version or not equal run to run: {bad}")
    launches = dict(recs["term_off"]["launches"])
    launches.update({k: v for k, v in recs["term_fused"]["launches"].items()
                     if k in LANE_KERNELS})
    return launches, kern


def phase_planner_w802():
    """The flagship full search: ``run_batch_padded`` on W802_BATCH UR5e
    queries of ``benchmarks/planner_batch.py --full --waypoints 802 --ct 3
    --rho 0.02 --scaling 3`` (``ur5e_solver``, ``fleet_queries``; the rest
    stock ``Settings()``: max_iter 4000, stall detection on), float32:
    every query optimal, the horizon and SCP-round p50 as the JAX
    package's record of the same search, admm_iters p50 within
    W802_ITERS_BAND of it, the first PLANNER_W802_REF_QUERIES queries'
    statuses and horizons as the JAX f32 CPU run's and their SCP rounds
    within 2, the exact-FK audit, fused and unfused termination equal, the
    lane kernels launched and no plain version, one planner read a round;
    ms per batch and queries/s the median of 2 calls after the first."""
    solver = ur5e_solver(W802_W, [], **PLANNER_W802)
    starts, ends = fleet_queries(W802_BATCH, np.random.default_rng(0))
    solves = count_solves(solver)
    with PlainCalls() as plain:
        out, counts, syncs = run_search(solver, starts, ends)  # the path
    del solver._solve
    ct = solver.settings.check_termination
    rounds_run = len(solves)
    chunks = sum(-(-int(it.max()) // ct) for it in solves)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_batch_padded(starts, ends)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    summary = search_summary(out)
    audit = audit_plans(solver, out[0], out[1], out[2])
    solver.settings = dataclasses.replace(solver.settings, term_fused="off")
    with PlainCalls() as plain_u:
        out_u, counts_u, _ = run_search(solver, starts, ends)
    differ = {name: int((a != b).sum()) for name, a, b in zip(
        ("status", "trajectory", "horizon", "scp_rounds", "admm_iters"),
        out, out_u) if name != "trajectory"}
    k = PLANNER_W802_REF_QUERIES
    st, hz, rounds = (t.cpu()[:k] for t in (out[0], out[2], out[3]))
    first = dict(statuses=st.tolist(), horizons=hz.tolist(),
                 rounds=rounds.tolist(), admm_iters=out[4].cpu()[:k].tolist())
    rec = dict(W_max=W802_W, batch=W802_BATCH, settings=PLANNER_W802,
               **summary, horizon_p50=pct(out[2], 50), ms_per_batch=ms,
               queries_per_s=summary["optimal"] / (ms * 1e-3),
               ms_all=[round(t * 1e3, 1) for t in times], **syncs,
               batch_scp_rounds=rounds_run, solver_chunks=chunks,
               launches=counts, plain_calls=dict(plain.calls),
               unfused_launches=counts_u,
               unfused_plain_calls=dict(plain_u.calls),
               unfused_differs_in=differ, audit=audit, first=first,
               jax_f32_first=PLANNER_W802_REF, record=PLANNER_W802_RECORD,
               finite=bool(torch.isfinite(out[1]).all()),
               shape_traj=list(out[1].shape))
    emit("planner_w802", **rec)
    if rec["optimal"] != W802_BATCH or not rec["finite"] or rec[
            "shape_traj"] != [W802_BATCH, 2 * W802_W * N]:
        fail(f"planner_w802: {rec['optimal']}/{W802_BATCH} optimal")
    ref = PLANNER_W802_RECORD
    if rec["horizon_p50"] != ref["horizon_p50"] or rec[
            "scp_rounds_p50"] != ref["scp_rounds_p50"]:
        fail(f"planner_w802: horizon p50 {rec['horizon_p50']}, SCP rounds "
             f"p50 {rec['scp_rounds_p50']}, the record's {ref}")
    if abs(rec["admm_iters_p50"] - ref["admm_iters_p50"]) > \
            W802_ITERS_BAND * ref["admm_iters_p50"]:
        fail(f"planner_w802: admm_iters p50 {rec['admm_iters_p50']} outside "
             f"{W802_ITERS_BAND:.0%} of the record's {ref['admm_iters_p50']}")
    jr = PLANNER_W802_REF
    if (first["statuses"] != jr["statuses"]
            or first["horizons"] != jr["horizons"]
            or max(abs(a - b) for a, b in zip(first["rounds"],
                                              jr["rounds"])) > 2):
        fail(f"planner_w802: the first {k} queries {first}, the JAX f32 "
             f"run's {jr}")
    if audit["workspace_margin"] < -(ERROR + 1e-5):
        fail(f"planner_w802: exact-FK audit: gripper ball leaves the "
             f"workspace box by {-audit['workspace_margin']:.2e}")
    if audit["velocity_mismatch"] > 0.2:
        fail("planner_w802: velocities are not position differences over dt")
    if any(differ.values()):
        fail(f"planner_w802: term_fused='off' changed the search: {differ}")
    if rec["plain_calls"] or rec["unfused_plain_calls"] or min(
            counts[k_] for k_ in LANE_KERNELS) < 1 or min(
            counts_u[k_] for k_ in UNFUSED_KERNELS) < 1:
        fail(f"planner_w802: launches {counts} / {counts_u}, plain versions "
             f"{rec['plain_calls']} / {rec['unfused_plain_calls']}")
    if syncs["planner_host_syncs"] != rounds_run or \
            syncs["solver_host_syncs"] != chunks:
        fail(f"planner_w802: {syncs} host reads for {rounds_run} SCP rounds "
             f"of the batch and {chunks} chunks of their solves")
    return counts


def count_solves(solver):
    """Wrap ``solver._solve`` (one call a batch SCP round) so that it keeps
    the iterations each call returned.  Returns that list; ``del
    solver._solve`` takes the wrapper off."""
    calls = []
    inner = solver._solve

    def counted(qp_t, settings, x, y):
        res = inner(qp_t, settings, x, y)
        calls.append(res.iterations)
        return res
    solver._solve = counted
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of: " + PHASES)
    ap.add_argument("--out", default=None, help="also write records here")
    ap.add_argument("--ref-tree", default=None,
                    help="root of an earlier checkout whose tridiagonal "
                         "factor and solve and residual kernels run beside "
                         "these")
    ap.add_argument("--rank-worker", type=int, default=None,
                    help=argparse.SUPPRESS)  # one rank of parallel_ranks
    ap.add_argument("--world-size", type=int, default=PAR_RANKS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--master", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-dir", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    global OUT, REF_TREE
    OUT, REF_TREE = opts.out, opts.ref_tree
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is "
              "false", file=sys.stderr)
        sys.exit(2)
    if opts.rank_worker is not None:
        rank_worker(opts.rank_worker, opts.world_size, opts.master,
                    opts.worker_dir)
        return
    full = opts.phases == "all"
    want = set(PHASES.split(",")) if full else set(opts.phases.split(","))
    t_start = time.time()
    torch.manual_seed(0)
    phase_device()
    if "build" in want:
        phase_build(build_signatures(want), want)
    kernels = phase_kernels() if "kernels" in want else []
    bench = dataclasses.replace(Settings(), **BENCH)
    launches = {}
    fused_rec = None
    if want & {"solve", "solve_unfused_term", "solve_block_p_declared"}:
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
    if "solve_w3" in want:
        phase_solve_w3(bench)
    if "planner_full" in want:
        phase_planner_full()
    if "planner_obstacles" in want:
        phase_planner_obstacles()
    if want & {"mpc_fleet", "mpc_fleet_gain", "mpc_fleet_unfused"}:
        phase_fleet(want, launches)
    if "dense" in want:
        rec = phase_dense()
        launches.update({k: rec["launches"][k]
                         for k in ("dense_factor", "dense_solve")})
    if "dense_session" in want:
        phase_dense_session()
    if "trajectory_generic" in want:
        phase_trajectory_generic()
    if want & {"solve_block_p", "mpc_fleet_block_p"}:
        bp = block_p_batch(BATCH, "cuda")
    if "solve_block_p" in want:
        rec = phase_solve_block_p(bp, bench)
        launches.update({k: rec["launches"][k] for k in
                         ("ruiz_block", "admm_chunk_block", "residuals_block")})
    if "solve_block_p_declared" in want:
        phase_solve_block_p_declared(honest, bench, fused_rec)
    if "mpc_fleet_block_p" in want:
        phase_fleet_block_p(bp)
    if "planner_run" in want:
        # This slice's main path: the tridiagonal rows' launches are its.
        launches.update(phase_planner_run())
    if "planner_batch" in want:
        phase_planner_batch()
    # This slice's paths (queue A2): their counts are the table's launches
    # where they run a kernel; every path's are recorded beside them.
    by_path = {}
    if "lane_sizes" in want:
        phase_lane_sizes()
    if "solve_refine" in want:
        by_path["solve_refine"] = phase_solve_refine()
    if "planner_long" in want:
        by_path["planner_long"] = phase_planner_long()["launches"]
    if "solve_polish" in want:
        by_path["solve_polish"] = phase_solve_polish()
    if "solve_anderson" in want:
        by_path["solve_anderson"] = phase_solve_anderson()
    for path in ("solve_polish", "solve_anderson", "solve_refine"):
        launches.update({k: v for k, v in by_path.get(path, {}).items()
                         if v})
    if "dh_arms" in want:
        phase_dh_arms()
    if "planner_dh" in want:
        # This slice's main path: its launches are the table's.
        by_path["planner_dh"] = phase_planner_dh()
        launches.update({k: v for k, v in by_path["planner_dh"].items()
                         if v})
    # This slice's main path: the five examples and the builder's dense
    # QPs; their launches are the table's where they run a kernel.
    if "examples" in want:
        by_path["examples"] = phase_examples()
    if "builder_dense" in want:
        by_path["builder_dense"] = phase_builder_dense()
    for path in ("examples", "builder_dense"):
        launches.update({k: v for k, v in by_path.get(path, {}).items()
                         if v})
    # This slice's main path: the long horizon on the card, sequential and
    # split (the tridiagonal rows' launches), and the sharded entry points
    # in a world of one rank and of two ranks on the one card.
    long_times, long_results = None, None
    if want & {"horizon_long", "parallel_one", "parallel_ranks"}:
        rec, by_path["horizon_long"], long_results = phase_horizon_long()
        long_times = rec["kernels"]["times"]
    par_out = None
    if want & {"parallel_one", "parallel_ranks"}:
        by_path["parallel_one"], par_out = phase_parallel_one(long_results)
    if "parallel_ranks" in want:
        phase_parallel_ranks(par_out)
    for path in ("horizon_long", "parallel_one"):
        launches.update({k: v for k, v in by_path.get(path, {}).items()
                         if v})
    # The repair above 16 joints: each kernel's wide form, timed per size.
    wide = {}
    if "lane_wide" in want:
        # This slice's main path: the lane path at N=300, each thread
        # several columns; its launches are the table's (set below, after
        # the later phases').
        recs, tri, by_path["lane_wide_N300"] = phase_lane_wide()
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_batch", "launch_ms", "ref_ms", "device_launches")
        for key, rec in recs.items():
            for name, k in rec["kernels"].items():
                wide.setdefault(name, {})[key] = {
                    f: k[f] for f in fields if f in k}
        for key, rec in tri.items():
            for part in ("factor", "solve"):
                wide.setdefault("tridiag_" + part, {})[key] = {
                    f: rec[part][f] for f in fields if f in rec[part]}
    # This slice's main path: the reference's own problem batched, through
    # the lane driver and through the full search; their launches are the
    # table's, and each row's time alone at W=802, B=512 beside it.
    w802 = {}
    if "w802" in want:
        by_path["w802"], kern802 = phase_w802()
        for name, k in kern802.items():
            row = "admm_chunk" if name == "admm_chunk_warmup" else name
            w802.setdefault(row, {})[
                "warmup_form" if name != row else "main"] = {
                f: k.get(f) for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "plan")}
    if "planner_w802" in want:
        by_path["planner_w802"] = phase_planner_w802()
    for path in ("w802", "planner_w802", "lane_wide_N300"):
        launches.update({k: v for k, v in by_path.get(path, {}).items()
                         if v})

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
        "dense_factor": (csrc + "dense.cu", ops + "pallas_dense.py:119"),
        "dense_solve": (csrc + "dense.cu", ops + "pallas_dense.py:151"),
        "ruiz_block": (csrc + "ruiz.cu", ops + "ruiz_pallas.py:433"),
        "admm_chunk_block": (csrc + "admm_chunk.cu",
                             ops + "admm_fused.py:1130"),
        "residuals_block": (csrc + "residuals.cu",
                            ops + "residuals_pallas.py:470"),
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
            **({"sizes": k["sizes"]} if "sizes" in k else {}),
            **({"wide": wide[k["name"]]} if k["name"] in wide else {}),
            **({"w802": w802[k["name"]]} if k["name"] in w802 else {}),
            # the W=10,000 batch-1 and Schur times (horizon_long)
            **({"long_horizon": {key: t for key, t in long_times.items()
                                 if k["name"].split("_")[1] in key}}
               if long_times and k["name"] in TRIDIAG_KERNELS else {}),
            "launches_by_path": {p_: c.get(k["name"], 0)
                                 for p_, c in by_path.items()},
        })
    RECORDS["seconds_total"] = round(time.time() - t_start, 1)
    RECORDS["kernel_table"] = table
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
    try:
        main()
    except Exception as exc:  # the records so far, then the traceback
        if OUT:
            with open(OUT, "w") as f:
                json.dump(dict(RECORDS, failed=repr(exc)), f, indent=1,
                          default=str)
        raise
