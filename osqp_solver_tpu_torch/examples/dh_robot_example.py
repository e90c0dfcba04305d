"""Generic-arm demo, the port's counterpart of
``examples/dh_robot_example.py``: plan with a 7-DOF KUKA iiwa14 (or the
UR10e, UR5e, SCARA) from a Cartesian goal.

The goal XYZ is solved into a joint configuration with the numeric DLS IK
(``models/dh_robot.py``), then planned from zero by the GOMP stack (SCP,
workspace floor, time scaling) through ``GOMPSolver.run``.

Runs on the CUDA device unless ``--cpu`` is given.  Dtype: float32 on the
card, whose kernels take float32 only (``--f64`` there raises their
``TypeError``); float64 on the CPU, the JAX script's dtype.

Usage:  python -m osqp_solver_tpu_torch.examples.dh_robot_example
        [--robot iiwa14|ur10e|ur5e|scara] [--waypoints 16] [--segments 3]
        [--cpu] [--f64]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import constraints as C
from ..gomp.planner import GOMPSolver
from ..models import dh_robot
from ._common import device_and_dtype, timed

ROBOTS = {"iiwa14": dh_robot.IIWA14, "ur10e": dh_robot.UR10E,
          "ur5e": dh_robot.UR5E, "scara": dh_robot.SCARA}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", choices=tuple(ROBOTS), default="iiwa14")
    ap.add_argument("--waypoints", type=int, default=16)
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--f64", action="store_true",
                    help="ask for float64 on the card (the kernels refuse)")
    args = ap.parse_args(argv)
    device, dtype = device_and_dtype(args.cpu, f64=args.f64)

    robot = ROBOTS[args.robot]  # the SCARA: 4-DOF RRPR (prismatic Z)
    n = robot.n_joints
    print(f"robot: {robot.name} ({n} DOF)")

    # Cartesian goal -> joint configuration via the numeric DLS IK.
    kw = dict(dtype=dtype, device=device)
    q_start = np.zeros(n)
    seed = np.full(n, 0.5)
    q0_ik = np.full(n, 0.3)
    for i, t in enumerate(getattr(robot, "joint_types", ())):
        if t == "p":  # prismatic strokes are meters, not radians
            seed[i], q0_ik[i] = 0.1, 0.05
    goal_xyz = robot.point_fk(torch.as_tensor(seed, **kw))
    q_end, ok = robot.position_ik(goal_xyz, q0=torch.as_tensor(q0_ik, **kw))
    if not bool(ok):
        print("error: IK did not converge on the Cartesian goal",
              file=sys.stderr)
        return 1
    goal_xyz = goal_xyz.cpu().numpy()
    q_end = q_end.cpu().numpy()
    print(f"goal xyz: {goal_xyz.round(3)} -> q_end: {q_end.round(3)}")

    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=0.1,
        pos_con=C.in_range(n, -3.0, 3.0),
        vel_con=C.in_range(n, -np.pi, np.pi),
        acc_con=C.in_range(n, -4 * np.pi, 4 * np.pi),
        # workspace floor on the gripper ball, as in the reference example
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], C.INF),
        obstacles=[],
        balls=[
            robot.make_ball(link=n - 1, radius=0.12),
            robot.make_ball(radius=0.05, is_gripper=True),
        ],
        segments=args.segments,
        dtype=dtype,
        device=device,
    )

    res, wall = timed(device, solver.run, q_start, q_end)
    print(f"status: {res.status.name}  ({wall:.1f}s inc. compile)")
    W = res.trajectory.size // (2 * n)
    q = res.trajectory[: W * n].reshape(W, n)
    reached = robot.point_fk(torch.as_tensor(q[W - 3], **kw)).cpu().numpy()
    print(f"horizon: {W} waypoints; gripper FK at the endpoint "
          f"(waypoint W-3): {reached.round(3)}")
    err = float(np.linalg.norm(reached - goal_xyz))
    print(f"goal error: {err:.2e} m")
    return 0 if res.status.name == "kOptimal" and err < 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
