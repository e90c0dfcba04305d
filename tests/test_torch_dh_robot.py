"""PyTorch port vs JAX package: generic DH arms (``models/dh_robot.py``).

Every preset (UR5e, UR10e, iiwa14, SCARA) goes through both packages from
the JAX package's table (``convert.dh_robot_from``): FK, frames, the
Jacobians (``jacfwd`` of the matrix path and the SoA geometric one),
``fk_pose_jacobian`` with the prismatic columns, DLS position and pose IK
from the same starts, ``ik_checked``; the SCP linearization's
per-configuration branch (a ball with ``fk``/``jacobian`` only) against its
batched branch and the JAX package's; and the planner for the iiwa14 (N=7)
and the SCARA (N=4, a prismatic Z stroke) through ``run_batch_lane`` and
``run`` at W <= 12, B <= 4, as ``tests/test_dh_robot.py`` drives them
(``run`` from W=10 in two segments, for the JAX package's compile time).
f64, CPU, at 1e-12 for kinematics; planners: equal statuses, horizons, SCP
rounds and ADMM iteration counts, trajectories within 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp import trajectory_qp as jtqp
from osqp_solver_tpu.gomp.planner import GOMPSolver as JSolver
from osqp_solver_tpu.models import dh_robot as jdh
from osqp_solver_tpu_torch import GOMPSolver, convert
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttqp
from osqp_solver_tpu_torch.models import dh_robot as tdh
from osqp_solver_tpu_torch.models.robot import RobotBall
from osqp_solver_tpu_torch.utils.types import NoInverseKinematicSolution

from test_torch_helpers import to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)
PRESETS = ("UR5E", "UR10E", "IIWA14", "SCARA")
TOL = dict(rtol=0.0, atol=1e-12)


def _pair(name):
    j = getattr(jdh, name)
    return j, convert.dh_robot_from(j)


def _configs(n, shape, seed=0):
    return np.random.default_rng(seed).uniform(-2.5, 2.5, shape + (n,))


def _close(got, ref, **tol):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("name", PRESETS)
def test_converted_table_equals_the_port_preset(name):
    """``convert.dh_robot_from`` of the JAX preset is the port's preset."""
    j, t = _pair(name)
    assert t == getattr(tdh, name)
    assert (t.n_joints, t.joint_types, t.name) == (
        j.n_joints, tuple(j.joint_types), j.name)


@pytest.mark.parametrize("name", PRESETS)
def test_kinematics_match_reference(name):
    """The matrix path (frames, point and pose FK of every frame), the
    Jacobian callable, and the SoA walk (``fk_jacobian_points``,
    ``fk_pose_jacobian``, batched and with the joint axis inside) against
    the JAX package's."""
    j, t = _pair(name)
    n = j.n_joints
    qs = _configs(n, (3, 2), seed=n)
    q1 = qs[0, 0]
    _close(t.frames(torch.from_numpy(q1)), j.frames(jnp.asarray(q1)))
    for link in (None, n - 1, 2):
        _close(t.point_fk(torch.from_numpy(q1), link),
               j.point_fk(jnp.asarray(q1), link))
        for got, ref in zip(t.pose_fk(torch.from_numpy(q1), link),
                            j.pose_fk(jnp.asarray(q1), link)):
            _close(got, ref)
        _close(t.jacobian(link)(torch.from_numpy(q1)),
               j.jacobian(link)(jnp.asarray(q1)))
        ref = j.fk_pose_jacobian(jnp.asarray(qs), link)
        got = t.fk_pose_jacobian(torch.from_numpy(qs), link)
        for g, r in zip(got, ref):
            _close(g, r)
        # The joint axis inside: (3, N, 2) with axis=1 gives (3, 3, 2) and
        # (3, 3, N, 2).
        pts, jac = t.fk_jacobian_points(
            torch.from_numpy(qs).permute(0, 2, 1), link, axis=1)
        _close(pts.permute(0, 2, 1), ref[0])
        _close(jac.permute(0, 3, 1, 2), ref[2])


def test_scara_prismatic_columns():
    """The SCARA's Z stroke: its Jacobian column is the joint axis (down),
    with no angular part, and +q3 plunges the tool."""
    _, t = _pair("SCARA")
    q = torch.tensor([0.3, -0.4, 0.05, 0.7], dtype=torch.float64)
    p, R, Jp, Jw = t.fk_pose_jacobian(q)
    _close(Jp[:, 2], [0.0, 0.0, -1.0])
    _close(Jw[:, 2], [0.0, 0.0, 0.0])
    _close(p[2], 0.2 - 0.05)
    _close(t.point_fk(torch.zeros(4, dtype=torch.float64)), [0.6, 0.0, 0.2])


@pytest.mark.parametrize("name", ("IIWA14", "SCARA", "UR10E"))
def test_position_and_pose_ik_match_reference(name):
    """DLS position IK on a batch of three targets and pose IK on one, from
    the same starts, give the JAX package's ``q`` (vmapped there) and its
    convergence flags."""
    j, t = _pair(name)
    n = j.n_joints
    rng = np.random.default_rng(n)
    q_true = rng.uniform(-0.8, 0.8, (3, n))
    if name == "SCARA":
        q_true[:, 2] = rng.uniform(0.02, 0.18, 3)
    q0 = q_true + 0.15
    p = np.asarray(j.fk_jacobian_points(jnp.asarray(q_true))[0])
    jq, jok = jax.vmap(lambda pp, qq: j.position_ik(pp, q0=qq))(
        jnp.asarray(p), jnp.asarray(q0))
    tq, tok = t.position_ik(torch.from_numpy(p), q0=torch.from_numpy(q0))
    _close(tq, jq, rtol=0.0, atol=1e-12)
    np.testing.assert_array_equal(to_np(tok), np.asarray(jok))
    assert bool(tok.all())
    R = np.asarray(j.pose_fk(jnp.asarray(q_true[0]))[1])
    jq, jok = j.pose_ik(jnp.asarray(p[0]), jnp.asarray(R),
                        q0=jnp.asarray(q0[0]))
    tq, tok = t.pose_ik(torch.from_numpy(p[0]), torch.from_numpy(R),
                        q0=torch.from_numpy(q0[0]))
    _close(tq, jq, rtol=0.0, atol=1e-12)
    assert bool(tok) == bool(jok)


def test_ik_checked_raises_out_of_reach():
    """``ik_checked`` returns the solution of a reachable target and raises
    the port's ``NoInverseKinematicSolution`` for one out of reach, with
    and without an orientation."""
    _, t = _pair("UR10E")
    q_true = torch.tensor([0.3, -0.6, 0.9, -0.4, 0.5, 0.2],
                          dtype=torch.float64)
    p, R = t.pose_fk(q_true)
    q = tdh.ik_checked(t, p, rot=R, q0=q_true + 0.1)
    _close(t.point_fk(q), p, rtol=0.0, atol=1e-6)
    far = torch.tensor([9.0, 0.0, 0.0], dtype=torch.float64)
    with pytest.raises(NoInverseKinematicSolution):
        tdh.ik_checked(t, far, q0=q_true)
    with pytest.raises(NoInverseKinematicSolution):
        tdh.ik_checked(t, far, rot=R, q0=q_true)


def test_linearize_workspace_per_configuration_branch():
    """A ball with ``fk``/``jacobian`` only (evaluated per waypoint and
    problem) linearizes as the SoA batched ball does and as the JAX
    package's ``linearize_workspace`` does, problem by problem."""
    j, t = _pair("IIWA14")
    n, W, B = 7, 5, 3
    traj = np.random.default_rng(1).uniform(-1.0, 1.0, (2 * W * n, B))
    con = JC.in_range(3, -0.6, 0.6)
    tball = t.make_ball(link=6, radius=0.05, is_gripper=True)
    per_cfg = RobotBall(radius=0.05, is_gripper=True, fk=tball.fk,
                        jacobian=tball.jacobian)
    tqp = ttqp.empty_trajectory_qp(W, n, [True], 0, batch_shape=(B,),
                                   dtype=torch.float64)
    got = ttqp.linearize_workspace(tqp, [per_cfg], [], (con.lower, con.upper),
                                   torch.from_numpy(traj))
    soa = ttqp.linearize_workspace(tqp, [tball], [], (con.lower, con.upper),
                                   torch.from_numpy(traj))
    jball = j.make_ball(link=6, radius=0.05, is_gripper=True)
    jball = type(jball)(fk=jball.fk, jacobian=jball.jacobian, radius=0.05,
                        is_gripper=True)
    jqp = jtqp.empty_trajectory_qp(W, n, [True], 0)
    for name in ("ws_jac", "ws_l", "ws_u"):
        _close(getattr(got, name), to_np(getattr(soa, name)))
    for b in range(B):
        ref = jtqp.linearize_workspace(jqp, [jball], [],
                                       (con.lower, con.upper),
                                       jnp.asarray(traj[:, b]))
        for name in ("ws_jac", "ws_l", "ws_u"):
            _close(getattr(got, name)[..., b], getattr(ref, name))


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
