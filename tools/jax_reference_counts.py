#!/usr/bin/env python3
"""Iteration counts of the JAX package on the problems of ``chip_smoke.py``
(float32, CPU): the references its ``dense``, ``dense_session``,
``trajectory_generic``, ``solve_block_p``, ``solve_w3``, ``solve_anderson``
and ``planner_long`` phases hold the port to, the planner statistics its
``planner_run`` phase prints beside its own, and the unpolished and polished
statuses of ``solve_polish``'s batch.

The problems come from ``chip_smoke.py``'s own generators (numpy from a
seed for the dense configurations and the block-P objective; the port's
trajectory and honest-class builders in float64, rounded to float32), so
both packages solve the same float32 numbers.  Run from the repository root
on a machine with JAX:

    JAX_PLATFORMS=cpu python3 tools/jax_reference_counts.py [CONFIG ...]

(all configurations without arguments; ``solve_block_p`` alone takes a few
minutes, ``planner_run`` (the reference example at W_max=802: ``run_padded``,
one compile, and ``run``, one compile per horizon) about ten, and
``solve_anderson``, ``solve_polish`` and ``planner_long`` a few each).  Prints one JSON line per configuration; the ``code`` strings are
the per-problem (per-step) counts in ``chip_smoke.encode_iters`` form, and
``p50`` is the lower median, as ``torch.median`` takes it.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from osqp_solver_tpu.gomp.trajectory_qp import TrajectoryQP  # noqa: E402
from osqp_solver_tpu.gomp.trajectory_qp_lane import (  # noqa: E402
    LaneTrajectoryQP,
)
from osqp_solver_tpu.ops import admm  # noqa: E402
from osqp_solver_tpu.ops import admm_lane  # noqa: E402
from osqp_solver_tpu.ops import session as S  # noqa: E402
from osqp_solver_tpu.ops.qp import DenseQP  # noqa: E402
from osqp_solver_tpu_torch import convert  # noqa: E402


def summary(name, iters, ct, status, offset=0, **extra):
    iters = np.asarray(iters).reshape(-1)
    status = np.asarray(status).reshape(-1)
    print(json.dumps({
        "config": name, "n": int(iters.size),
        "optimal": int((status == 0).sum()),
        "p50": int(np.sort(iters)[(iters.size - 1) // 2]),
        "max": int(iters.max()),
        "min": int(iters.min()),
        "hist": {str(k): v for k, v in sorted(
            collections.Counter(iters.tolist()).items())},
        "ct": ct, "offset": offset,
        "code": cs.encode_iters(iters, ct, offset), **extra,
    }), flush=True)


def shift_goal(base, d):
    """``apply_goal_shift`` of ``benchmarks/run_all.py`` (config 4b)."""
    return base.replace(pos_l=base.pos_l.at[-1].add(d),
                        pos_u=base.pos_u.at[-1].add(d))


def jax_trajectory(qp):
    static, arrays = convert.trajectory_qp_to_numpy(qp)
    return TrajectoryQP(**static, **{k: jnp.asarray(v)
                                     for k, v in arrays.items()})


def planner_run():
    """The reference example (``chip_smoke.EXAMPLE``) through the JAX
    package's ``run_padded`` and ``run`` in float32: per call the status,
    the winning horizon, every segment's statistics and the wall time
    (compiles included)."""
    import time

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import ur5e

    solver = GOMPSolver(
        **cs.EXAMPLE,
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(6, -np.pi, np.pi),
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
        obstacles=[],
        balls=[ur5e.make_ball("back6", 0.15),
               ur5e.make_ball("tool", 0.05, is_gripper=True)],
        dtype=jnp.float32,
    )
    out = {}
    for name in ("run_padded", "run"):
        t0 = time.time()
        res = getattr(solver, name)(cs.EXAMPLE_START, cs.EXAMPLE_END)
        won = [st.waypoints for st in res.stats if st.status == 0]
        out[name] = dict(
            status=res.status.name, winning_waypoints=min(won) if won else 0,
            stats=[[int(v) for v in st] for st in res.stats],
            wall_s=round(time.time() - t0, 1))
    print(json.dumps({"config": "planner_run", **out}), flush=True)


def jax_lane(qp):
    static, arrays = convert.lane_qp_to_numpy(qp)
    return LaneTrajectoryQP(**static, **{k: jnp.asarray(v)
                                         for k, v in arrays.items()})


def solve_anderson(settings):
    """``chip_smoke.solve_anderson``'s batch (the honest class, W=100,
    B=1024) at its two settings: Anderson acceleration, and the same with ρ
    adaptation firing (the JAX package's plain path on the CPU)."""
    jqp = jax_lane(cs.honest_f32(cs.BATCH, cs.W, "cpu"))
    for name, over in (("solve_anderson", cs.ANDERSON),
                       ("solve_anderson_rho", cs.ANDERSON_RHO)):
        sa = dataclasses.replace(settings, **over, fused_chunk="off")
        r = jax.jit(lambda q: admm_lane.solve_batched_lane(q, sa))(jqp)
        summary(name, r.iterations, sa.check_termination, r.status,
                statuses=cs.encode_statuses(np.asarray(r.status)))


def solve_polish(settings):
    """``chip_smoke.solve_polish``'s batch at its settings, unpolished and
    polished: the statuses, and how many problems the polish moved."""
    jqp = jax_lane(cs.honest_f32(cs.BATCH, cs.W, "cpu"))
    base = dataclasses.replace(settings, **cs.BENCH, fused_chunk="off")
    r0 = jax.jit(lambda q: admm_lane.solve_batched_lane(q, base))(jqp)
    pol = dataclasses.replace(base, polish=True)
    r1 = jax.jit(lambda q: admm_lane.solve_batched_lane(q, pol))(jqp)
    moved = np.any(np.asarray(r1.x) != np.asarray(r0.x), axis=1)
    summary("solve_polish", r1.iterations, base.check_termination, r1.status,
            base.termination_warmup % base.check_termination,
            same_status=int((np.asarray(r1.status)
                             == np.asarray(r0.status)).sum()),
            polished=int(moved.sum()))


def planner_long():
    """``chip_smoke.planner_long``: ``run_batch_lane`` of the JAX package
    at W=1100 in float32 (one refinement step per KKT solve, its
    ``with_auto_refine``) on the first 64 queries of the full search, the
    UR5e of the fleet benchmarks: statuses and SCP rounds per query."""
    import time

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import ur5e

    solver = GOMPSolver(
        max_waypoints=cs.LONG_W, time_step=0.1, segments=10,
        settings=dataclasses.replace(admm.Settings(), **cs.PLANNER),
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(6, -np.pi, np.pi),
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
        obstacles=[],
        balls=[ur5e.make_ball("back6", 0.15),
               ur5e.make_ball("tool", 0.05, is_gripper=True)],
        dtype=jnp.float32,
    )
    starts, ends = cs.long_queries()
    t0 = time.time()
    st, _, rounds = solver.run_batch_lane(
        starts.astype(np.float32), ends.astype(np.float32),
        waypoints=cs.LONG_W)
    st, rounds = np.asarray(st), np.asarray(rounds)
    print(json.dumps({
        "config": "planner_long", "n": int(st.size),
        "optimal": int((st == 0).sum()),
        "statuses": cs.encode_statuses(st),
        "rounds": cs.encode_statuses(rounds),
        "wall_s": round(time.time() - t0, 1)}), flush=True)


def main():
    want = set(sys.argv[1:]) or {"dense", "dense_session",
                                 "trajectory_config1",
                                 "trajectory_config4b", "solve_block_p",
                                 "solve_w3", "planner_run", "solve_anderson",
                                 "solve_polish", "planner_long"}
    settings = admm.Settings()
    if "solve_anderson" in want:
        solve_anderson(settings)
    if "solve_polish" in want:
        solve_polish(settings)
    if "planner_long" in want:
        planner_long()
    if "planner_run" in want:
        planner_run()
    if "solve_w3" in want:
        # W=3 lane batches (below the Ruiz kernel's 4 waypoints), B=1024, at
        # the bench.py settings: the box-only class and the honest class
        # (primal infeasible in three steps); statuses per problem too.
        sb = dataclasses.replace(settings, **cs.BENCH, fused_chunk="off")
        for kind in ("box", "honest"):
            static, arrays = convert.lane_qp_to_numpy(cs.w3_batch(kind, "cpu"))
            jqp = LaneTrajectoryQP(**static, **{k: jnp.asarray(v)
                                                for k, v in arrays.items()})
            r = jax.jit(lambda q: admm_lane.solve_batched_lane(q, sb))(jqp)
            summary(f"solve_w3_{kind}", r.iterations, sb.check_termination,
                    r.status, sb.termination_warmup % sb.check_termination,
                    statuses=cs.encode_statuses(np.asarray(r.status)))

    if "solve_block_p" in want:
        # The honest class with the block-P objective at the bench.py
        # settings, B=1024; "off": the jnp path on the CPU (the Pallas chunk
        # gives the same counts in exact arithmetic on these upper-triangular
        # coupling blocks).
        static, arrays = convert.lane_qp_to_numpy(
            cs.block_p_batch(cs.BATCH, "cpu"))
        jqp = LaneTrajectoryQP(**static, **{k: jnp.asarray(v)
                                            for k, v in arrays.items()})
        sb = dataclasses.replace(settings, **cs.BENCH, fused_chunk="off")
        rb = jax.jit(lambda q: admm_lane.solve_batched_lane(q, sb))(jqp)
        summary("solve_block_p", rb.iterations, sb.check_termination,
                rb.status, sb.termination_warmup % sb.check_termination)

    if "dense" in want:
        # config 2: dense random box QPs, batch 1024
        P, q, A, l, u = cs.dense_problems(1024)
        qps = DenseQP(*(jnp.asarray(a) for a in (P, q, A, l, u)))
        r = jax.jit(lambda qps: admm.solve_batched(qps, settings))(qps)
        summary("dense", r.iterations, settings.check_termination, r.status)

    if "dense_session" in want:
        # config 4: n=8 session, 1000 bound shifts
        qp4, shifts = cs.session_problem()
        sess = S.setup(DenseQP(*(jnp.asarray(a) for a in qp4)), settings)
        _, (_, st4, it4) = jax.jit(lambda se, u: S.mpc_scan(
            se, u, cs.shift_box, settings))(sess, jnp.asarray(shifts))
        summary("dense_session", it4, settings.check_termination, st4)

    if "trajectory_config1" in want:
        # config 1: W=10 trajectory QP, one solve
        qp1 = jax_trajectory(cs.trajectory_config1("cpu"))
        r1 = jax.jit(lambda qp: admm.solve(qp, settings))(qp1)
        summary("trajectory_config1", r1.iterations,
                settings.check_termination, r1.status)

    if "trajectory_config4b" in want:
        # config 4b: honest W=100 session, goal shifts
        s4b = dataclasses.replace(settings, check_termination=5)
        qp4b = jax_trajectory(cs.trajectory_config4b("cpu"))
        sess4b = S.setup(qp4b, s4b)
        _, (_, st4b, it4b) = jax.jit(lambda se, u: S.mpc_scan(
            se, u, shift_goal, s4b))(sess4b, jnp.asarray(cs.goal_deltas()))
        summary("trajectory_config4b", it4b, s4b.check_termination, st4b)


if __name__ == "__main__":
    main()
