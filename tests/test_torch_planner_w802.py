"""PyTorch port vs JAX package: the flagship search's query whose SCP rounds
float32 moves, held in float64 on the CPU.

``chip_smoke.py planner_w802`` runs the full search of
``benchmarks/planner_batch.py --full --waypoints 802 --segments 10 --ct 3
--rho 0.02 --scaling 3`` on 512 UR5e queries in float32 on the card and
holds its first 8 queries to the JAX package's float32 CPU run
(``tools/jax_reference_counts.py planner_w802``).  Query 1 takes 10 SCP
rounds (309 ADMM iterations) on the card and 11 (318) in the JAX f32 run:
whether a round's plan passes the exact-FK check follows float32 rounding
(``ROADMAP.md`` C4).  Here both packages run that query in float64 on the
same inputs, and the port gives the JAX package's status, horizon, SCP
rounds and ADMM iterations."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp.planner import GOMPSolver as JSolver
from osqp_solver_tpu.models import ur5e as jur5e
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu_torch import GOMPSolver, constraints
from osqp_solver_tpu_torch.models import ur5e
from osqp_solver_tpu_torch.ops.admm import Settings

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)
N, W_MAX, QUERY = 6, 802, 1
# planner_batch.py --ct 3 --rho 0.02 --scaling 3; the rest stock.
OVERRIDES = dict(rho=0.02, check_termination=3, scaling=3)
INF = 1e30
SPEC = dict(max_waypoints=W_MAX, time_step=0.1, segments=10)


def _queries(B=512):
    """``benchmarks/planner_batch.py``'s queries (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    starts = 0.02 * rng.standard_normal((B, N))
    end0 = np.zeros(N)
    end0[0] = math.pi
    return starts, end0[None] + 0.02 * rng.standard_normal((B, N))


def _counts(st, hz, rounds, iters):
    return dict(status=int(np.asarray(st)[0]), horizon=int(np.asarray(hz)[0]),
                scp_rounds=int(np.asarray(rounds)[0]),
                admm_iters=int(np.asarray(iters)[0]))


def test_flagship_query_flipped_in_f32_agrees_in_f64():
    """Query 1 of the W_max=802 search through ``run_batch_padded`` of both
    packages in float64 on the CPU: equal status, winning horizon, SCP
    rounds and ADMM iterations."""
    starts, ends = _queries()
    start, end = starts[[QUERY]], ends[[QUERY]]
    jsolver = JSolver(
        **SPEC, settings=dataclasses.replace(jadmm.Settings(), **OVERRIDES),
        pos_con=JC.in_range(N, -2 * np.pi, 2 * np.pi),
        vel_con=JC.in_range(N, -np.pi, np.pi),
        acc_con=JC.in_range(N, -np.pi * 800 / 180, np.pi * 800 / 180),
        con_3d=JC.in_range(3, [-JC.INF, -0.4, -JC.INF], None),
        obstacles=[],
        balls=[jur5e.make_ball("back6", 0.15),
               jur5e.make_ball("tool", 0.05, is_gripper=True)],
        dtype=jax.numpy.float64)
    st, _, hz, rounds, iters = jsolver.run_batch_padded(start, end)
    want = _counts(st, hz, rounds, iters)
    tsolver = GOMPSolver(
        **SPEC, settings=dataclasses.replace(Settings(), **OVERRIDES),
        pos_con=constraints.in_range(N, -2 * math.pi, 2 * math.pi),
        vel_con=constraints.in_range(N, -math.pi, math.pi),
        acc_con=constraints.in_range(N, -800 * math.pi / 180,
                                     800 * math.pi / 180),
        con_3d=constraints.Constraint(lower=np.array([-INF, -0.4, -INF]),
                                      upper=np.full(3, INF)),
        obstacles=[], balls=[ur5e.make_ball("back6", 0.15),
                             ur5e.make_ball("tool", 0.05, is_gripper=True)],
        dtype=torch.float64, device="cpu")
    st, _, hz, rounds, iters = tsolver.run_batch_padded(start, end)
    assert _counts(st, hz, rounds, iters) == want
    # The float64 figures tools/jax_reference_counts.py planner_w802_f64
    # printed, which PERF.md records.
    assert want == dict(status=0, horizon=320, scp_rounds=10, admm_iters=309)
