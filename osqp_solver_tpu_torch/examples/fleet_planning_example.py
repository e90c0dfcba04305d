"""Fleet planning, the port's counterpart of
``examples/fleet_planning_example.py``: the reference's FULL
``run(start, end)`` time-scaling search (``gomp-solver.h:38-55``) for a
whole fleet of queries at once.

A batch of (start, end) joint-space queries is planned with
``GOMPSolver.run_batch_padded``: per query the 10-segment horizon-shrinking
search with the reference's warm-slicing quirk, masked per-query survival,
and a ``SphereObstacle`` keep-out in the workspace (with ``--per-query``,
each query its own).  The fleet setting ``Settings(max_iter=300)`` of the
JAX script.  The first optimal plan is audited by exact FK in float64 on
the host: its tool ball must clear its keep-out sphere.

Runs on the CUDA device unless ``--cpu`` is given; float32 everywhere, as
the JAX script.

Usage:  python -m osqp_solver_tpu_torch.examples.fleet_planning_example
        [--batch 8] [--waypoints 30] [--segments 10] [--max-iter 300]
        [--per-query] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .. import constraints as C
from ..gomp.geometry import SphereObstacle, stack_obstacles
from ..gomp.planner import GOMPSolver
from ..models import ur5e
from ..models.robot import ball_fk_jac
from ..ops.admm import Settings
from ..ops.status import ExitCode
from ._common import device_and_dtype, timed


def device_line(device) -> str:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return f"device: {device} ({name})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--waypoints", type=int, default=30)
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--per-query", action="store_true",
                    help="give every query its OWN keep-out pose (a fleet "
                         "of robot cells with different bin positions) via "
                         "stack_obstacles")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device, _ = device_and_dtype(args.cpu)
    dtype = torch.float32

    N, INF = 6, 1e30
    print(device_line(device))

    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    # Keep-out sphere on the tool's unconstrained optimum path (the
    # shortest-horizon plan swings the tool through ~(0, -0.29, -0.57)), so
    # the SCP loop must bulge every query's trajectory around it.
    sphere = SphereObstacle.create([0.0, -0.28, -0.55], radius=0.12)
    settings = dataclasses.replace(
        Settings(), rho=0.04, check_termination=3, scaling=3,
        max_iter=args.max_iter,
    )
    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=0.1,
        settings=settings,
        pos_con=C.in_range(N, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(N, -np.pi, np.pi),
        acc_con=C.in_range(N, -800 * np.pi / 180, 800 * np.pi / 180),
        con_3d=C.Constraint(
            lower=np.array([-INF, -0.4, -INF]), upper=np.full(3, INF)
        ),
        obstacles=[sphere],
        balls=balls,
        segments=args.segments,
        dtype=dtype,
        device=device,
    )

    rng = np.random.default_rng(0)
    B = args.batch
    starts = 0.02 * rng.standard_normal((B, N))
    end0 = np.zeros(N)
    end0[0] = np.pi
    ends = end0[None] + 0.02 * rng.standard_normal((B, N))

    # Per-query keep-out poses: every cell's sphere jittered around the
    # shared one; the audit then checks each query against its OWN sphere.
    per_query_spheres = None
    obstacles_kw = {}
    if args.per_query:
        per_query_spheres = [
            SphereObstacle.create(
                sphere.center.numpy() + 0.03 * rng.standard_normal(3),
                radius=float(sphere.radius),
            )
            for _ in range(B)
        ]
        obstacles_kw = {"obstacles": [stack_obstacles(per_query_spheres)]}
        print(f"per-query keep-outs: {B} spheres, 3 cm pose jitter")

    out, wall = timed(device, solver.run_batch_padded, starts, ends,
                      **obstacles_kw)
    statuses, trajs, horizons, rounds, admm_iters = (
        a.cpu().numpy() for a in out)
    st, hz, it = statuses, horizons, admm_iters
    n_opt = int((st == int(ExitCode.kOptimal)).sum())
    print(
        f"fleet of {B} full time-scaling queries in {wall:.2f}s "
        f"(compile+solve; steady-state is far faster — see "
        f"benchmarks/planner_batch.py --full)"
    )
    print(f"optimal: {n_opt}/{B}")
    print(
        "winning horizons: "
        + ", ".join(
            f"{w}x{int((hz == w).sum())}" for w in sorted(set(hz.tolist()))
        )
        + f"  (W_max={args.waypoints}, {args.segments} segments)"
    )
    print(
        f"ADMM iterations/query: p50={int(np.median(it))} "
        f"max={int(it.max())}  SCP rounds p50={int(np.median(rounds))}"
    )

    # Exact-FK audit of the first optimal query (float64 on the host): the
    # tool ball must clear ITS keep-out sphere at every live waypoint.
    b = int(np.argmax(st == int(ExitCode.kOptimal)))
    W = args.waypoints
    w = int(hz[b])
    q = torch.from_numpy(trajs[b][: W * N].astype(np.float64)).reshape(W, N)
    pts = ball_fk_jac(balls[1], q[:w], jacobian=False)[0].numpy()
    own = per_query_spheres[b] if per_query_spheres else sphere
    d = np.linalg.norm(pts - own.center.numpy(), axis=-1)
    margin = float(d.min() - (float(own.radius) + balls[1].radius))
    print(f"query {b}: tool keep-out clearance min = {margin:+.4f} m")
    if n_opt == 0 or margin < -1.5e-3:
        print("FAILED: no optimal plan or keep-out violated")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
