"""PyTorch port vs JAX package: the planner on generic DH arms.

The iiwa14 (N=7) and the SCARA (N=4, a prismatic Z stroke) through
``run_batch_lane`` and ``run`` at W <= 12, B <= 4, as
``tests/test_dh_robot.py`` drives them (``run`` from W=10 in two segments,
for the JAX package's compile time): equal statuses, horizons, SCP rounds
and ADMM iteration counts, trajectories within 1e-8.  f64, CPU.  The arms'
kinematics and IK are ``test_torch_dh_robot.py``'s."""
import jax
import numpy as np
import pytest
import torch

from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp.planner import GOMPSolver as JSolver
from osqp_solver_tpu_torch import GOMPSolver, convert

from test_torch_dh_robot import _close, _pair
from test_torch_helpers import to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


# The planners of tests/test_dh_robot.py: one gripper ball at the tool,
# wide joint boxes; the SCARA with its stroke q3 in [0, 0.2] m.
def _planner_spec(name, n, waypoints, segments=None):
    lo, hi = np.full(n, -3.2), np.full(n, 3.2)
    if name == "SCARA":
        lo[2], hi[2] = 0.0, 0.2
    spec = dict(max_waypoints=waypoints, time_step=0.1, pos_con=(lo, hi),
                vel_con=(np.full(n, -8.0), np.full(n, 8.0)),
                acc_con=(np.full(n, -20.0), np.full(n, 20.0)),
                con_3d=(np.full(3, -2.0), np.full(3, 2.0)))
    if segments is not None:
        spec["segments"] = segments
    return spec


def _both_planners(name, waypoints=12, segments=None):
    j, t = _pair(name)
    n = j.n_joints
    spec = _planner_spec(name, n, waypoints, segments)
    jsolver = JSolver(
        max_waypoints=waypoints, time_step=0.1,
        pos_con=JC.Constraint(*spec["pos_con"]),
        vel_con=JC.Constraint(*spec["vel_con"]),
        acc_con=JC.Constraint(*spec["acc_con"]),
        con_3d=JC.Constraint(*spec["con_3d"]), obstacles=[],
        balls=[j.make_ball(radius=0.05, is_gripper=True)],
        **({"segments": segments} if segments else {}))
    tsolver = GOMPSolver(
        balls=[t.make_ball(radius=0.05, is_gripper=True)],
        **convert.gomp_solver_kwargs_from_numpy(spec, device="cpu"))
    return n, jsolver, tsolver


def _queries(name, n, B):
    starts = np.zeros((B, n))
    ends = np.tile(np.linspace(0.2, 0.5, B)[:, None], (1, n))
    if name == "SCARA":
        starts[:, 2] = 0.02
        ends[:, 2] = np.linspace(0.05, 0.15, B)
    return starts, ends


@pytest.mark.parametrize("name", ("IIWA14", "SCARA"))
def test_run_batch_lane_matches_reference(name):
    """``run_batch_lane`` (the fused lane driver) at W=10 on four queries:
    statuses and SCP rounds equal, trajectories within 1e-8, the goal
    reached at waypoint W-3."""
    n, jsolver, tsolver = _both_planners(name)
    starts, ends = _queries(name, n, 4)
    st_r, tr_r, it_r = jsolver.run_batch_lane(starts, ends, waypoints=10)
    st, tr, it = tsolver.run_batch_lane(starts, ends, waypoints=10)
    np.testing.assert_array_equal(to_np(st), np.asarray(st_r))
    np.testing.assert_array_equal(to_np(it), np.asarray(it_r))
    _close(tr, tr_r, rtol=0.0, atol=1e-8)
    assert (to_np(st) == 0).all()
    q_end = to_np(tr)[:, : 10 * n].reshape(4, 10, n)[:, 10 - 3]
    np.testing.assert_allclose(q_end, ends, atol=1e-2)


@pytest.mark.parametrize("name", ("IIWA14", "SCARA"))
def test_run_matches_reference(name):
    """``run`` (SCP and horizon shrinking on the session path) from one
    start to one goal: the status, every segment's statistics (horizon,
    status, SCP rounds, ADMM iterations) equal, the trajectory within
    1e-8."""
    n, jsolver, tsolver = _both_planners(name, waypoints=10, segments=2)
    starts, ends = _queries(name, n, 1)
    ref = jsolver.run(starts[0], ends[0])
    got = tsolver.run(starts[0], ends[0])
    assert int(got.status) == int(ref.status) == 0
    assert [tuple(s) for s in got.stats] == [tuple(s) for s in ref.stats]
    _close(got.trajectory, np.asarray(ref.trajectory), rtol=0.0, atol=1e-8)
