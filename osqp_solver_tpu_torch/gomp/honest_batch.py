"""Assembly of the benchmark problem classes, batch-trailing.

Counterparts of ``bench.py::build_honest_batch`` and
``bench.py::build_box_batch`` of the JAX package's repository: the "honest"
class is the full-GOMP QP of a 6-DOF UR5e trajectory (two robot balls —
wrist r=0.15 non-gripper, tool r=0.05 gripper — one ``HorizontalLine``
obstacle, the workspace floor y ≥ −0.4); the box class carries joint boxes
only.  Start and end configurations follow the same formulas per problem
index ``i``; the whole batch is assembled at once, directly in the lane
layout, on ``device``.
"""
from __future__ import annotations

import math

import torch

from ..models import ur5e
from ..ops.admm import resolve_device
from .geometry import HorizontalLine
from .trajectory import calc_warm_start_batched
from .trajectory_qp import (
    empty_trajectory_qp,
    linearize_workspace,
    with_gomp_boxes,
)
from .trajectory_qp_lane import LaneTrajectoryQP, from_trailing


def _index_grids(batch, N, dtype, device):
    j = torch.arange(N, dtype=dtype, device=device)[:, None]  # (N, 1)
    i = torch.arange(batch, dtype=dtype, device=device)[None, :]  # (1, B)
    return j, i


def build_honest_batch(batch: int, W: int = 100, N: int = 6,
                       dtype=torch.float32, device=None) -> LaneTrajectoryQP:
    """``batch`` honest-class QPs as one waypoint-layout
    :class:`LaneTrajectoryQP` (``N`` must be 6: the robot is the UR5e)."""
    dev = resolve_device(device)
    if N != ur5e.NUM_JOINTS:
        raise ValueError(f"the honest class is a UR5e problem (N=6), got N={N}")
    kw = dict(dtype=dtype, device=dev)
    DT, INF = 0.1, 1e30
    balls = (
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    )
    obstacles = [
        HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15), dtype=dtype,
                              device=dev)
    ]
    con3d = (torch.tensor([-INF, -0.4, -INF], **kw),
             torch.tensor([INF, INF, INF], **kw))
    pos = (torch.full((N,), -2 * math.pi, **kw),
           torch.full((N,), 2 * math.pi, **kw))
    vel = (torch.full((N,), -math.pi * DT, **kw),
           torch.full((N,), math.pi * DT, **kw))
    acc = (torch.full((N,), -800 * math.pi / 180 * DT**2, **kw),
           torch.full((N,), 800 * math.pi / 180 * DT**2, **kw))
    base = empty_trajectory_qp(
        W, N, gripper_flags=(False, True), n_obstacles=1,
        batch_shape=(batch,), **kw,
    )
    j, i = _index_grids(batch, N, dtype, dev)
    start = 0.02 * torch.sin(j + i)  # (N, B)
    end = torch.tensor([math.pi, 0, 0, 0, 0, 0], **kw)[:, None] + (
        0.02 * torch.cos(j * 1.3 + i)
    )
    qp = with_gomp_boxes(base, start, end, pos, vel, acc)
    warm = calc_warm_start_batched(start, end, W)
    qp = linearize_workspace(qp, balls, obstacles, con3d, warm)
    # Contiguous per-waypoint rows: what the kernels stream.
    return from_trailing(qp, row_layout="waypoint")


def build_box_batch(batch: int, W: int = 100, N: int = 6,
                    dtype=torch.float32, device=None) -> LaneTrajectoryQP:
    """``batch`` box-only QPs (no balls, no obstacles) as one waypoint-layout
    :class:`LaneTrajectoryQP`."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    base = empty_trajectory_qp(
        W, N, gripper_flags=(), n_obstacles=0, batch_shape=(batch,), **kw
    )
    pos = (torch.full((N,), -10.0, **kw), torch.full((N,), 10.0, **kw))
    vel = (torch.full((N,), -1.0, **kw), torch.full((N,), 1.0, **kw))
    acc = (torch.full((N,), -2.0, **kw), torch.full((N,), 2.0, **kw))
    j, i = _index_grids(batch, N, dtype, dev)
    start = 0.02 * torch.sin(j + i)
    end = 1.0 + 0.02 * torch.cos(j * 1.3 + i)
    return from_trailing(
        with_gomp_boxes(base, start, end, pos, vel, acc),
        row_layout="waypoint",
    )
