"""Orientation-constrained grasp planning, the port's counterpart of
``examples/grasp_example.py``: grasp pose -> IK -> fleet plan.

A set of tool GRASP POSES (position and full 3x3 orientation, tool-z down
with per-grasp yaw) is converted to joint targets with the analytic
8-branch UR5e IK (``models/ur5e.py::inverse_kinematics``), cross-checked
against the generic damped-least-squares pose IK
(``models/dh_robot.py::DHRobot.pose_ik``), and the fleet is planned from
home with the reference's full time-scaling search
(``GOMPSolver.run_batch_padded``).  Each plan is audited by exact FK: the
final waypoint's tool pose must match the requested grasp (position and
rotation angle); the first grasp's trajectory goes to the reference demo's
``.data`` files in the current directory.

Runs on the CUDA device unless ``--cpu`` is given; float32 everywhere, as
the JAX script.

Usage:  python -m osqp_solver_tpu_torch.examples.grasp_example
        [--grasps 8] [--waypoints 30] [--segments 10] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .. import constraints as C
from ..gomp.planner import GOMPSolver
from ..models import dh_robot, ur5e
from ..ops.admm import Settings
from ..ops.status import ExitCode
from ..utils.trajectory_io import write_trajectory_files
from ._common import device_and_dtype, timed
from .fleet_planning_example import device_line


def grasp_pose(p, yaw):
    """Tool-down grasp frame at ``p``: tool z = -z_base, x rotated by yaw."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, s, 0.0], [s, -c, 0.0], [0.0, 0.0, -1.0]])
    return p, R


def make_grasps(n, rng):
    """n reachable tool-down grasp poses on a ring around the base (kept
    clear of the demo's y >= -0.4 workspace floor)."""
    grasps = []
    angs = np.linspace(0.25, 2 * np.pi - 0.25, n)
    for ang in angs:
        r = 0.40 + 0.12 * float(rng.uniform())
        p = np.array([r * np.cos(ang), r * np.sin(ang),
                      -0.25 - 0.1 * float(rng.uniform())])
        p[1] = max(p[1], -0.30)  # stay off the workspace floor (y >= -0.4)
        grasps.append(grasp_pose(p, float(rng.uniform(-np.pi, np.pi))))
    return grasps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grasps", type=int, default=8)
    ap.add_argument("--waypoints", type=int, default=30)
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device, _ = device_and_dtype(args.cpu)
    dt = torch.float32
    kw = dict(dtype=dt, device=device)

    print(device_line(device))
    N, INF = 6, 1e30
    rng = np.random.default_rng(7)
    grasps = make_grasps(args.grasps, rng)
    home = np.zeros(N)

    def host(t):
        return t.detach().cpu().numpy()

    # --- grasp pose -> joint target: analytic 8-branch IK, DLS cross-check.
    q_ends, dls_dev = [], []
    for p, R in grasps:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        sols, valid = ur5e.inverse_kinematics(torch.as_tensor(T, **kw))
        sols = ur5e.wrap_to_pi(sols)
        d2 = torch.where(valid, ((sols - torch.as_tensor(home, **kw)) ** 2)
                         .sum(dim=1), torch.full_like(sols[:, 0], np.inf))
        q_a = host(sols[int(torch.argmin(d2))])

        # Cross-check: the generic DLS pose IK (seeded NEAR, not AT, the
        # analytic branch) must reach the same pose by another algorithm.
        q0 = torch.as_tensor(q_a + 0.15 * rng.standard_normal(N), **kw)
        q_d, ok = dh_robot.UR5E.pose_ik(torch.as_tensor(p, **kw),
                                        torch.as_tensor(R, **kw), q0=q0)
        if not bool(ok):
            print(f"error: DLS pose IK did not converge for grasp at {p}",
                  file=sys.stderr)
            return 1
        Ta = host(ur5e.tool_pose(torch.as_tensor(q_a, **kw)))
        Td = host(ur5e.tool_pose(q_d))
        dls_dev.append(np.linalg.norm(Ta[:3, 3] - Td[:3, 3]))
        q_ends.append(q_a)
    q_ends = np.stack(q_ends)
    print(
        f"IK: {len(grasps)} grasp poses -> joint targets "
        f"(analytic 8-branch; DLS pose-IK cross-check max tool-point "
        f"deviation {max(dls_dev):.2e} m)"
    )

    # --- plan the fleet from home with the full time-scaling search.
    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=0.1,
        settings=dataclasses.replace(
            Settings(), rho=0.04, check_termination=3, scaling=3, max_iter=300
        ),
        pos_con=C.in_range(N, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(N, -np.pi, np.pi),
        acc_con=C.in_range(N, -800 * np.pi / 180, 800 * np.pi / 180),
        con_3d=C.Constraint(
            lower=np.array([-INF, -0.4, -INF]), upper=np.full(3, INF)
        ),
        obstacles=[],
        balls=balls,
        gripper_ik=ur5e.inverse_kinematics_position,
        segments=args.segments,
        dtype=dt,
        device=device,
    )
    starts = np.tile(home, (len(grasps), 1))
    out, wall = timed(device, solver.run_batch_padded, starts, q_ends)
    st, trajs, hz = (host(a) for a in out[:3])
    n_opt = int((st == int(ExitCode.kOptimal)).sum())
    print(
        f"planned {len(grasps)} grasp approaches in {wall:.2f}s "
        f"(compile+solve), optimal {n_opt}/{len(grasps)}, winning horizon "
        f"p50={int(np.median(hz))}"
    )

    # --- exact-FK audit: final waypoint's tool pose vs the requested grasp.
    W = args.waypoints
    max_pos, max_ang = 0.0, 0.0
    for b, (p, R) in enumerate(grasps):
        if st[b] != int(ExitCode.kOptimal):
            continue
        w = int(hz[b])
        q = trajs[b][: W * N].reshape(W, N)[:w]
        Tf = host(ur5e.tool_pose(torch.as_tensor(q[-1], **kw)))
        max_pos = max(max_pos, float(np.linalg.norm(Tf[:3, 3] - p)))
        c = np.clip((np.trace(R.T @ Tf[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        max_ang = max(max_ang, float(np.arccos(c)))
    print(
        f"grasp-pose audit over optimal plans: max tool position error "
        f"{max_pos:.2e} m, max orientation error {np.degrees(max_ang):.3f} deg"
    )

    # The reference demo's output for the first optimal grasp
    # (solver-example.cpp:73-96).
    b = int(np.argmax(st == int(ExitCode.kOptimal)))
    w = int(hz[b])
    q = trajs[b][: W * N].reshape(W, N)[:w]

    def fk(qi):
        return host(ur5e.forward_kinematics(torch.as_tensor(qi, **kw)))

    points = fk(q)
    write_trajectory_files(
        q, points, "output_trajectory_ctrl.data", "output_trajectory_xyz.data"
    )
    print("\nSummary:")
    print(f"Ground-truth start {fk(home)} -> optimized start {points[0]}")
    print(f"Middle position after optimization: {points[min(10, w - 1)]}")
    print(f"Ground-truth grasp point {grasps[b][0]} -> optimized end "
          f"{points[-1]}")

    ok = n_opt > 0 and max_pos < 5e-3 and max_ang < np.radians(1.0)
    print("OK" if ok else "FAILED: grasp pose not reached")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
