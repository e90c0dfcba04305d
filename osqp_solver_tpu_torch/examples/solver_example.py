"""End-to-end UR5e demo, the port's counterpart of
``examples/solver_example.py`` (the reference's ``solver-example.cpp``).

Plans a base sweep ``{0,0,0,0,0,0} → {π,0,0,0,0,0}`` with the workspace floor
``y ≥ -0.4`` on the gripper ball, writes the joint trajectory and its
FK-mapped XYZ path to ``output_trajectory_ctrl.data`` /
``output_trajectory_xyz.data`` in the current directory (the reference's
formats, ``solver-example.cpp:73-81``) and prints the start/mid/end FK
summary (``:83-95``).

Runs on the CUDA device unless ``--cpu`` is given.  Dtype: float32 on the
card, whose kernels take float32 only (``--f64`` there raises their
``TypeError``); float64 on the CPU, the JAX script's default (``--f32`` for
float32).

Usage:  python -m osqp_solver_tpu_torch.examples.solver_example
        [--waypoints 802] [--segments 10] [--cpu] [--mode padded|exact]
        [--obstacles] [--f32 | --f64]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import constraints as C
from ..gomp.geometry import HorizontalLine
from ..gomp.planner import GOMPSolver
from ..models import ur5e
from ..utils.trajectory_io import write_trajectory_files
from ._common import device_and_dtype, timed


def build_solver(waypoints=802, time_step=0.1, segments=10, obstacles=False,
                 dtype=torch.float32, device="cuda"):
    """The reference example's planner: two collision balls
    (``solver-example.cpp:37-41``), its joint and workspace limits
    (``:44-47``) and, with ``obstacles``, its commented-out lines
    (``:48-51``)."""
    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    lines = [
        HorizontalLine.create([0, 1], [0, 0, 0.6], True),
        HorizontalLine.create([0, 1], [0.3, 0, 0.5], False),
    ] if obstacles else []
    return GOMPSolver(
        max_waypoints=waypoints,
        time_step=time_step,
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),  # :44
        vel_con=C.in_range(6, -np.pi, np.pi),  # :45
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),  # :46
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),  # :47
        obstacles=lines,
        balls=balls,
        gripper_ik=ur5e.inverse_kinematics_position,
        segments=segments,
        dtype=dtype,
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--waypoints", type=int, default=802)  # :13
    ap.add_argument("--time-step", type=float, default=0.1)  # :12
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--obstacles", action="store_true",
                    help="enable the reference's (commented-out) line "
                         "obstacles (solver-example.cpp:48-51)")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 on the CPU too")
    ap.add_argument("--f64", action="store_true",
                    help="ask for float64 on the card (the kernels refuse)")
    ap.add_argument("--mode", choices=("padded", "exact"), default="padded",
                    help="padded: one W_max-shaped session layout for the "
                         "whole time-scaling loop; exact: one session per "
                         "horizon length (reference-shaped)")
    args = ap.parse_args(argv)
    device, dtype = device_and_dtype(args.cpu, args.f32, args.f64)

    solver = build_solver(args.waypoints, args.time_step, args.segments,
                          args.obstacles, dtype, device)
    start = np.zeros(6)
    end = np.array([np.pi, 0, 0, 0, 0, 0.0])  # :70

    run = solver.run_padded if args.mode == "padded" else solver.run
    res, wall = timed(device, run, start, end)

    traj = res.trajectory
    W = traj.size // 12
    q = traj[: W * 6].reshape(W, 6)

    def fk(qi):
        qt = torch.as_tensor(np.asarray(qi), dtype=dtype, device=device)
        return ur5e.forward_kinematics(qt).cpu().numpy()

    points = fk(q)
    write_trajectory_files(
        q, points, "output_trajectory_ctrl.data", "output_trajectory_xyz.data"
    )

    start_gt = fk(start)
    print(f"status: {res.status.name}  waypoints: {W}  wall: {wall:.2f}s")
    print("per-segment stats:", res.stats)
    print("\nSummary:")
    print(f"Ground-truth start {start_gt} -> optimized start {points[0]}")
    print(f"Middle position after optimization: {points[min(10, W - 1)]}")
    print(f"Ground-truth end {fk(end)} -> optimized end {points[W - 1]}")
    return 0 if res.status.name.startswith("kOptimal") else 1


if __name__ == "__main__":
    sys.exit(main())
