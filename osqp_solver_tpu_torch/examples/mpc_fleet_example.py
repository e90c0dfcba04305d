"""Fleet MPC, the port's counterpart of ``examples/mpc_fleet_example.py``:
many receding-horizon controllers stepped together on one device.

B independent UR5e controllers, each owning one GOMP trajectory QP (the
reference's problem class, ``solver-example.cpp:37-51``; the honest batch
of ``gomp/honest_batch.py``), re-solved warm-started every control tick on a
cached KKT factorization: OSQP's ``Solve()``-in-a-loop session contract
batched over the fleet (:mod:`osqp_solver_tpu_torch.ops.session_lane`).

Runs on the CUDA device unless ``--cpu`` is given; float32 everywhere, as
the JAX script.

Usage:  python -m osqp_solver_tpu_torch.examples.mpc_fleet_example
        [--batch 8] [--ticks 10] [--waypoints 24] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..gomp.honest_batch import build_honest_batch
from ..ops import admm
from ..ops.session_lane import mpc_scan_lane, setup_lane, solve_lane
from ._common import device_and_dtype, timed


def goal_deltas(ticks: int, n: int, dtype, device):
    """Every controller's goal drift per tick: ``(T, N, 1)``."""
    t = torch.arange(ticks, dtype=dtype, device=device)[:, None, None]
    j = torch.arange(n, dtype=dtype, device=device)[None, :, None]
    return 2e-4 * torch.sin(t * 0.3 + j)


def shift_goal(base, d):
    """Move the last waypoint's position rows by ``d``."""
    pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
    pos_l[-1] += d
    pos_u[-1] += d
    return base.replace(pos_l=pos_l, pos_u=pos_u)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--waypoints", type=int, default=24)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device, _ = device_and_dtype(args.cpu)
    dtype = torch.float32
    B, T, W, N = args.batch, args.ticks, args.waypoints, 6
    settings = dataclasses.replace(
        admm.Settings(), rho=0.05, check_termination=2,
        adaptive_rho_interval=50,
    )

    print(f"building a fleet of {B} UR5e controllers (W={W})...")
    lane = build_honest_batch(B, W, N, dtype, device)

    # Setup = OSQP Init for the whole fleet: Ruiz once, factor once.
    sess = setup_lane(lane, settings, device=device)
    sess, res0 = solve_lane(sess, settings)
    st0, it0 = res0.status.cpu().numpy(), res0.iterations.cpu().numpy()
    print(
        f"tick 0 (cold): {int(np.sum(st0 == 0))}/{B} "
        f"optimal, median {int(np.median(it0))} iters"
    )

    # Per tick: every controller's goal equality drifts; the fleet re-solves
    # warm-started, zero refactorizations (classification-stable updates).
    deltas = goal_deltas(T, N, dtype, device)
    (sess, (status, iters)), dt = timed(device, mpc_scan_lane, sess, deltas,
                                        shift_goal, settings)
    st, it = status.cpu().numpy(), iters.cpu().numpy()
    print(
        f"{T} ticks x {B} controllers: {int(np.sum(st == 0))}/{B * T} optimal,"
        f" warm re-solves median {int(np.median(it))} iters,"
        f" {dt / T * 1e3:.1f} ms/tick (incl. compile on first call)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
