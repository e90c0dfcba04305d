#!/usr/bin/env python3
"""Iteration counts of the JAX package on the problems of ``chip_smoke.py``
(float32, CPU): the references its ``dense``, ``dense_session``,
``trajectory_generic``, ``solve_block_p``, ``solve_w3``, ``solve_anderson``,
``planner_long``, ``planner_dh``, ``w802`` and ``planner_w802`` phases hold
the port to (and ``planner_w802_f64``: its query 1 in float64, which
``tests/test_torch_planner_w802.py`` holds the port's float64 run to), the
iteration counts ``horizon_long`` prints beside its own (``long_horizon``),
the planner statistics its
``planner_run`` and ``examples`` phases print beside their own, the
unpolished and polished statuses of ``solve_polish``'s batch, and the
block-P fleet at a CPU-sized batch in both packages
(``mpc_fleet_block_p``: ``ROADMAP.md`` C2).

The problems come from ``chip_smoke.py``'s own generators (numpy from a
seed for the dense configurations and the block-P objective; the port's
trajectory and honest-class builders in float64, rounded to float32), so
both packages solve the same float32 numbers.  Run from the repository root
on a machine with JAX:

    JAX_PLATFORMS=cpu python3 tools/jax_reference_counts.py [CONFIG ...]

(all configurations without arguments; ``solve_block_p`` alone takes a few
minutes, ``planner_run`` (the reference example at W_max=802: ``run_padded``,
one compile, and ``run``, one compile per horizon) about ten, and
``solve_anderson``, ``solve_polish``, ``planner_long``, ``planner_dh``,
``w802`` and ``planner_w802`` a few each).  Prints one JSON line per
configuration; the ``code`` strings are the per-problem (per-step) counts
in ``chip_smoke.encode_iters`` form, and ``p50`` is the lower median, as ``torch.median`` takes it.
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


def long_horizon():
    """``chip_smoke.horizon_long``'s problem (``benchmarks/long_horizon.py``:
    W=10,000, N=6, box rows, float32, ``check_termination=25``) through
    ``admm.solve``, sequential and ``as_chunked`` at ``auto_chunks``."""
    from osqp_solver_tpu.parallel.horizon import as_chunked, auto_chunks

    qp = jax_trajectory(cs.long_horizon_qp("cpu"))
    s = dataclasses.replace(admm.Settings(), **cs.HORIZON_SETTINGS)
    for name, p in (("sequential", qp), ("chunked", as_chunked(qp))):
        r = jax.jit(lambda q: admm.solve(q, s))(p)
        summary(f"long_horizon_{name}", r.iterations, s.check_termination,
                r.status, waypoints=qp.waypoints,
                chunks=auto_chunks(qp.waypoints) if name == "chunked" else 1)


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


def planner_dh():
    """``chip_smoke.planner_dh``: the full search (``run_batch_padded``) of
    ``benchmarks/planner_batch.py --robot iiwa14|scara --full`` in the JAX
    package, float32, on the first ``chip_smoke.DH_REF_QUERIES`` of its
    queries: statuses and SCP rounds per query, and the p50 of ADMM
    iterations per query."""
    import time

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import dh_robot

    for name in ("IIWA14", "SCARA"):
        robot = getattr(dh_robot, name)
        n = robot.n_joints
        solver = GOMPSolver(
            max_waypoints=50, time_step=0.1, segments=10,
            settings=dataclasses.replace(admm.Settings(), **cs.PLANNER),
            pos_con=C.in_range(n, -2 * np.pi, 2 * np.pi),
            vel_con=C.in_range(n, -np.pi, np.pi),
            acc_con=C.in_range(n, -np.pi * 800 / 180, np.pi * 800 / 180),
            con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
            obstacles=[],
            balls=[robot.make_ball(link=n - 1, radius=0.15),
                   robot.make_ball(radius=0.05, is_gripper=True)],
            dtype=jnp.float32,
        )
        starts, ends = cs.dh_queries(n, cs.BATCH, np.random.default_rng(0))
        k = cs.DH_REF_QUERIES
        t0 = time.time()
        st, _, hz, rounds, iters = solver.run_batch_padded(
            starts[:k].astype(np.float32), ends[:k].astype(np.float32))
        st, rounds = np.asarray(st), np.asarray(rounds)
        print(json.dumps({
            "config": f"planner_dh_{name}", "n": int(st.size),
            "optimal": int((st == 0).sum()),
            "statuses": cs.encode_statuses(st),
            "rounds": cs.encode_statuses(rounds),
            "horizons": {str(k_): v for k_, v in sorted(collections.Counter(
                np.asarray(hz).tolist()).items())},
            "admm_iters_p50": int(np.sort(np.asarray(iters))[(k - 1) // 2]),
            "wall_s": round(time.time() - t0, 1)}), flush=True)


def w802():
    """``chip_smoke.w802``: the first ``chip_smoke.W802_REF_PROBLEMS``
    problems of its batch (the honest class at W=802, float32) at its
    settings (``benchmarks/w802_lane.py --ct 3 --rho 0.02``, adaptation
    at 60): statuses and iteration counts per problem."""
    jqp = jax_lane(cs.honest_f32(cs.W802_REF_PROBLEMS, cs.W802_W, "cpu"))
    s = dataclasses.replace(admm.Settings(), **cs.W802_SETTINGS,
                            fused_chunk="off")
    r = jax.jit(lambda q: admm_lane.solve_batched_lane(q, s))(jqp)
    summary("w802", r.iterations, s.check_termination, r.status,
            s.termination_warmup % s.check_termination,
            statuses=cs.encode_statuses(np.asarray(r.status)),
            waypoints=cs.W802_W)


def planner_w802(f64_queries=None):
    """``chip_smoke.planner_w802``: the full search (``run_batch_padded``)
    of ``benchmarks/planner_batch.py --full --waypoints 802 --ct 3 --rho
    0.02 --scaling 3`` in the JAX package, float32, on the first
    ``chip_smoke.PLANNER_W802_REF_QUERIES`` of its queries: statuses,
    winning horizons, SCP rounds and ADMM iterations per query.  With
    ``f64_queries``, in float64 on those queries instead (the figures
    ``tests/test_torch_planner_w802.py`` holds the port's float64 run to;
    x64 stays on for the rest of the process)."""
    import time

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import ur5e

    if f64_queries is not None:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float32 if f64_queries is None else jnp.float64
    solver = GOMPSolver(
        max_waypoints=cs.W802_W, time_step=0.1, segments=10,
        settings=dataclasses.replace(admm.Settings(), **cs.PLANNER_W802),
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(6, -np.pi, np.pi),
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
        obstacles=[],
        balls=[ur5e.make_ball("back6", 0.15),
               ur5e.make_ball("tool", 0.05, is_gripper=True)],
        dtype=dtype,
    )
    starts, ends = cs.fleet_queries(cs.W802_BATCH, np.random.default_rng(0))
    k = cs.PLANNER_W802_REF_QUERIES
    pick = list(range(k)) if f64_queries is None else list(f64_queries)
    cast = np.float32 if f64_queries is None else np.float64
    t0 = time.time()
    st, _, hz, rounds, iters = solver.run_batch_padded(
        starts[pick].astype(cast), ends[pick].astype(cast))
    print(json.dumps({
        "config": "planner_w802" + ("" if f64_queries is None else "_f64"),
        "queries": pick,
        "optimal": int((np.asarray(st) == 0).sum()),
        "statuses": [int(v) for v in np.asarray(st)],
        "horizons": [int(v) for v in np.asarray(hz)],
        "rounds": [int(v) for v in np.asarray(rounds)],
        "admm_iters": [int(v) for v in np.asarray(iters)],
        "wall_s": round(time.time() - t0, 1)}), flush=True)


def mpc_fleet_block_p(batch=64):
    """``chip_smoke.mpc_fleet_block_p``'s fleet at a CPU-sized batch (its
    block-P batch, ``BLOCK_FLEET_TICKS`` ticks of the moving goal), float32,
    at the fleet benchmark's stock settings (``chip_smoke.FLEET``: rho 0.05,
    scaling 10) and at the settings the phase runs (``BLOCK_FLEET``), in
    the JAX package and in the port on the CPU: how many (tick, problem)
    pairs end optimal, the statuses, and the cold and warm iteration counts.
    ``ROADMAP.md`` C2 asks whether the slow convergence at the stock
    settings is the reference's."""
    import torch

    from osqp_solver_tpu.ops import session_lane as jsess
    from osqp_solver_tpu_torch.ops import admm as tadmm
    from osqp_solver_tpu_torch.ops import session_lane as tsess

    bp = cs.block_p_batch(batch, "cpu")
    jqp = jax_lane(bp)
    T = cs.BLOCK_FLEET_TICKS
    t = np.arange(T, dtype=np.float32)[:, None, None]
    j = np.arange(cs.N, dtype=np.float32)[None, :, None]
    deltas = (2e-4 * np.sin(0.3 * t + j)).astype(np.float32)

    def jshift(base, d):
        return base.replace(pos_l=base.pos_l.at[cs.GOAL].add(d),
                            pos_u=base.pos_u.at[cs.GOAL].add(d))

    def tshift(base, d):
        pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
        pos_l[cs.GOAL] += d
        pos_u[cs.GOAL] += d
        return base.replace(pos_l=pos_l, pos_u=pos_u)

    def stats(name, pkg, st, it, ct):
        st, it = np.asarray(st), np.asarray(it)
        print(json.dumps({
            "config": f"mpc_fleet_block_p_{name}", "package": pkg,
            "batch": batch, "ticks": T, "optimal": int((st == 0).sum()),
            "total": int(st.size),
            "statuses": {str(k): v for k, v in sorted(collections.Counter(
                st.reshape(-1).tolist()).items())},
            "tick0_p50": int(np.sort(it[0])[(batch - 1) // 2]),
            "tick0_max": int(it[0].max()),
            "warm_p50": int(np.sort(it[1:].reshape(-1))[
                (it[1:].size - 1) // 2]),
            "warm_max": int(it[1:].max()), "ct": ct}), flush=True)

    for name, over in (("stock", cs.FLEET), ("block_fleet", cs.BLOCK_FLEET)):
        sj = dataclasses.replace(admm.Settings(), **over, fused_chunk="off")
        _, (st, it) = jax.jit(lambda q, d: jsess.mpc_scan_lane(
            jsess.setup_lane(q, sj), d, jshift, sj))(jqp, jnp.asarray(deltas))
        stats(name, "jax", st, it, sj.check_termination)
        stt = dataclasses.replace(tadmm.Settings(), **over)
        _, (st, it) = tsess.mpc_scan_lane(
            tsess.setup_lane(bp, stt, device="cpu"), torch.from_numpy(deltas),
            tshift, stt)
        stats(name, "port_cpu", st.numpy(), it.numpy(), stt.check_termination)


def examples():
    """The statuses and horizons the JAX package's examples reach at their
    default flags in float32 on the CPU, beside which ``chip_smoke.py``'s
    ``examples`` phase records the port's on the card: the fleet planning
    example (8 queries, W_max=30, its sphere), the grasp example (8 grasps,
    W_max=30) and the DH example (the iiwa14, W_max=16, 3 segments)."""
    import time

    from osqp_solver_tpu import GOMPSolver, SphereObstacle
    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.models import dh_robot, ur5e

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import grasp_example

    INF, N = 1e30, 6
    balls = [ur5e.make_ball("back6", 0.15),
             ur5e.make_ball("tool", 0.05, is_gripper=True)]
    common = dict(
        time_step=0.1,
        settings=dataclasses.replace(admm.Settings(), rho=0.04,
                                     check_termination=3, scaling=3,
                                     max_iter=300),
        pos_con=C.in_range(N, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(N, -np.pi, np.pi),
        acc_con=C.in_range(N, -800 * np.pi / 180, 800 * np.pi / 180),
        con_3d=C.Constraint(lower=np.array([-INF, -0.4, -INF]),
                            upper=np.full(3, INF)),
        balls=balls, segments=10, dtype=jnp.float32)

    def batch_record(name, solver, starts, ends, t0):
        st, _, hz, rounds, iters = solver.run_batch_padded(
            starts.astype(np.float32), ends.astype(np.float32))
        print(json.dumps({
            "config": f"examples_{name}",
            "statuses": cs.encode_statuses(np.asarray(st)),
            "horizons": [int(h) for h in np.asarray(hz)],
            "scp_rounds": [int(r) for r in np.asarray(rounds)],
            "admm_iters": [int(i) for i in np.asarray(iters)],
            "wall_s": round(time.time() - t0, 1)}), flush=True)

    # fleet_planning_example.py at its defaults
    t0 = time.time()
    rng = np.random.default_rng(0)
    starts = 0.02 * rng.standard_normal((8, N))
    end0 = np.zeros(N)
    end0[0] = np.pi
    ends = end0[None] + 0.02 * rng.standard_normal((8, N))
    sphere = SphereObstacle.create([0.0, -0.28, -0.55], radius=0.12)
    batch_record("fleet_planning", GOMPSolver(
        max_waypoints=30, obstacles=[sphere], **common), starts, ends, t0)

    # grasp_example.py at its defaults: the analytic IK's joint targets
    t0 = time.time()
    grasps = grasp_example.make_grasps(8, np.random.default_rng(7))
    q_ends = []
    for p, R in grasps:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        sols, valid = ur5e.inverse_kinematics(jnp.asarray(T, jnp.float32))
        sols = ur5e.wrap_to_pi(sols)
        d2 = jnp.where(valid, jnp.sum(sols ** 2, axis=1), jnp.inf)
        q_ends.append(np.asarray(sols[int(jnp.argmin(d2))]))
    batch_record("grasp", GOMPSolver(max_waypoints=30, obstacles=[],
                                     gripper_ik=ur5e.inverse_kinematics_position,
                                     **common),
                 np.zeros((8, N)), np.stack(q_ends), t0)

    # dh_robot_example.py at its defaults, in float32
    t0 = time.time()
    robot = dh_robot.IIWA14
    n = robot.n_joints
    goal = robot.point_fk(jnp.full((n,), 0.5, jnp.float32))
    q_end, ok = robot.position_ik(goal, q0=jnp.full((n,), 0.3, jnp.float32))
    solver = GOMPSolver(
        max_waypoints=16, time_step=0.1,
        pos_con=C.in_range(n, -3.0, 3.0),
        vel_con=C.in_range(n, -np.pi, np.pi),
        acc_con=C.in_range(n, -4 * np.pi, 4 * np.pi),
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], C.INF), obstacles=[],
        balls=[robot.make_ball(link=n - 1, radius=0.12),
               robot.make_ball(radius=0.05, is_gripper=True)],
        segments=3, dtype=jnp.float32)
    res = solver.run(np.zeros(n), np.asarray(q_end))
    won = [s.waypoints for s in res.stats if s.status == 0]
    print(json.dumps({
        "config": "examples_dh_robot", "ik_converged": bool(ok),
        "status": res.status.name, "horizon": min(won) if won else 0,
        "stats": [[int(v) for v in s] for s in res.stats],
        "wall_s": round(time.time() - t0, 1)}), flush=True)


def main():
    want = set(sys.argv[1:]) or {"dense", "dense_session",
                                 "trajectory_config1",
                                 "trajectory_config4b", "solve_block_p",
                                 "solve_w3", "planner_run", "solve_anderson",
                                 "solve_polish", "planner_long",
                                 "planner_dh", "examples",
                                 "mpc_fleet_block_p", "long_horizon",
                                 "w802", "planner_w802",
                                 "planner_w802_f64"}
    settings = admm.Settings()
    if "w802" in want:
        w802()
    if "planner_w802" in want:
        planner_w802()
    if "long_horizon" in want:
        long_horizon()
    if "solve_anderson" in want:
        solve_anderson(settings)
    if "solve_polish" in want:
        solve_polish(settings)
    if "planner_long" in want:
        planner_long()
    if "planner_dh" in want:
        planner_dh()
    if "examples" in want:
        examples()
    if "mpc_fleet_block_p" in want:
        mpc_fleet_block_p()
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

    if "planner_w802_f64" in want:  # last: it turns x64 on
        planner_w802(f64_queries=[1])


if __name__ == "__main__":
    main()
