"""PyTorch port vs JAX package: generic DH arms (``models/dh_robot.py``).

Every preset (UR5e, UR10e, iiwa14, SCARA) goes through both packages from
the JAX package's table (``convert.dh_robot_from``): FK, frames, the
Jacobians (``jacfwd`` of the matrix path and the SoA geometric one),
``fk_pose_jacobian`` with the prismatic columns, DLS position and pose IK
from the same starts, ``ik_checked``; the SCP linearization's
per-configuration branch (a ball with ``fk``/``jacobian`` only) against its
batched branch and the JAX package's.  f64, CPU, at 1e-12.  The planner on
these arms is ``test_torch_dh_planner.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp import trajectory_qp as jtqp
from osqp_solver_tpu.models import dh_robot as jdh
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttqp
from osqp_solver_tpu_torch.models import dh_robot as tdh
from osqp_solver_tpu_torch.models.robot import RobotBall
from osqp_solver_tpu_torch.utils.types import NoInverseKinematicSolution

from test_torch_helpers import jit_vmap, to_np

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
    p = np.asarray(jax.jit(lambda q: j.fk_jacobian_points(q)[0])(
        jnp.asarray(q_true)))
    jq, jok = jit_vmap(lambda pp, qq: j.position_ik(pp, q0=qq))(
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
    for name in ("ws_jac", "ws_l", "ws_u"):
        _close(getattr(got, name), to_np(getattr(soa, name)))
    # The JAX package's, problem by problem, one compiled program.
    reference = jax.jit(lambda x: jtqp.linearize_workspace(
        jtqp.empty_trajectory_qp(W, n, [True], 0), [jball], [],
        (con.lower, con.upper), x))
    for b in range(B):
        ref = reference(jnp.asarray(traj[:, b]))
        for name in ("ws_jac", "ws_l", "ws_u"):
            _close(getattr(got, name)[..., b], getattr(ref, name))
