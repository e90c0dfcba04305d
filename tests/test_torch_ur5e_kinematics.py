"""PyTorch port vs JAX package: the UR5e 4×4 FK and closed-form IK
(``models/ur5e.py``), the trajectory helpers (``gomp/trajectory.py``) and
the ``.data`` writer (``utils/trajectory_io.py``).  Inputs are seeded numpy
configurations; f64, CPU.  FK and the helpers agree at 1e-12; the IK's
eight branches at 1e-10 (chains of inverse transforms and arc functions),
with the same validity and NaN pattern."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory as jtraj
from osqp_solver_tpu.models import ur5e as jur5e
from osqp_solver_tpu.utils import trajectory_io as jio
from osqp_solver_tpu.utils import types as jtypes
from osqp_solver_tpu_torch.gomp import trajectory as ttraj
from osqp_solver_tpu_torch.models import ur5e as tur5e
from osqp_solver_tpu_torch.utils import trajectory_io as tio
from osqp_solver_tpu_torch.utils import types as ttypes

from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port
FK_TOL = dict(rtol=0.0, atol=1e-12)


def configs(n=16, seed=0):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (n, 6))


@pytest.mark.parametrize("name", [
    "frames", "tool_pose", "forward_kinematics", "forward_kinematics_6_back",
    "forward_kinematics_elbow_joint",
])
def test_fk_family_matches_reference(name):
    q = configs()
    ref = jax.vmap(getattr(jur5e, name))(jnp.asarray(q))
    got = getattr(tur5e, name)(torch.from_numpy(q))
    assert tuple(got.shape) == tuple(ref.shape)
    assert_close(got, ref, **FK_TOL)
    # Any leading batch shape: (2, 8, ...) gives the same values.
    got2 = getattr(tur5e, name)(torch.from_numpy(q.reshape(2, 8, 6)))
    assert_close(got2.reshape(got.shape), got, rtol=0.0, atol=0.0)


def test_dh_and_link_transform_match_reference():
    th = configs(5)[:, 0]
    for i in range(6):
        ref = jax.vmap(lambda t: jur5e.link_transform(i, t))(jnp.asarray(th))
        assert_close(tur5e.link_transform(i, torch.from_numpy(th)), ref,
                     **FK_TOL)
    ref = jur5e._dh(jnp.asarray(0.3), 0.1, -0.2, 0.7)
    assert_close(tur5e._dh(torch.tensor(0.3, dtype=torch.float64), 0.1, -0.2,
                           0.7), ref, **FK_TOL)


def test_soa_fk_agrees_with_the_matrix_chain():
    q = torch.from_numpy(configs())
    for frame, fk in (("tool", tur5e.forward_kinematics),
                      ("back6", tur5e.forward_kinematics_6_back),
                      ("elbow", tur5e.forward_kinematics_elbow_joint)):
        assert_close(tur5e.fk_jacobian_points(q, frame)[0], fk(q), **FK_TOL)


def _poses():
    """Tool poses of seeded configurations, plus one out of reach."""
    T = jax.vmap(jur5e.tool_pose)(jnp.asarray(configs(12, seed=1)))
    far = np.eye(4)
    far[:3, 3] = [2.0, 0.0, 0.3]
    return np.concatenate([np.asarray(T), far[None]])


def test_inverse_kinematics_branches_match_reference():
    T = _poses()
    jsol, jvalid = jax.jit(jax.vmap(jur5e.inverse_kinematics))(jnp.asarray(T))
    sol, valid = tur5e.inverse_kinematics(torch.from_numpy(T))
    assert tuple(sol.shape) == (len(T), 8, 6)
    np.testing.assert_array_equal(to_np(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(to_np(torch.isnan(sol)),
                                  np.isnan(np.asarray(jsol)))
    assert_close(torch.nan_to_num(sol), np.nan_to_num(np.asarray(jsol)),
                 rtol=0.0, atol=1e-10)
    assert not bool(valid[-1].any())  # the far pose has no branch
    # Every valid branch reaches its pose.
    ok = valid[:-1]
    back = tur5e.tool_pose(sol[:-1])
    err = (back - torch.from_numpy(T[:-1])[:, None]).abs().amax(dim=(-1, -2))
    assert float(err[ok].max()) < 1e-9


def test_inverse_kinematics_position_checked_and_wrap():
    rng = np.random.default_rng(2)
    p = np.stack([np.array([0.4, -0.2, 0.3]) + 0.05 * rng.standard_normal(3)
                  for _ in range(6)] + [np.array([3.0, 0.0, 0.0])])
    q_ref = 0.3 * rng.standard_normal(6)
    for ref_arg in (None, q_ref):
        jq, jv = jax.jit(jax.vmap(lambda x: jur5e.inverse_kinematics_position(
            x, None if ref_arg is None else jnp.asarray(ref_arg))))(
                jnp.asarray(p))
        q, v = tur5e.inverse_kinematics_position(
            torch.from_numpy(p),
            None if ref_arg is None else torch.from_numpy(ref_arg))
        np.testing.assert_array_equal(to_np(v), np.asarray(jv))
        assert_close(q, jq, rtol=0.0, atol=1e-10)
    assert bool(v[:-1].all()) and not bool(v[-1])
    q0 = tur5e.inverse_kinematics_checked(torch.from_numpy(p[0]))
    assert_close(q0, jur5e.inverse_kinematics_checked(jnp.asarray(p[0])),
                 rtol=0.0, atol=1e-10)
    with pytest.raises(ttypes.NoInverseKinematicSolution) as err:
        tur5e.inverse_kinematics_checked(torch.from_numpy(p[-1]))
    assert err.value.point == (3.0, 0.0, 0.0)
    ang = np.linspace(-10.0, 10.0, 41)
    assert_close(tur5e.wrap_to_pi(torch.from_numpy(ang)),
                 jur5e.wrap_to_pi(jnp.asarray(ang)), **FK_TOL)


def test_types_mirror_reference():
    assert [int(a) for a in ttypes.XYZ_AXES] == [int(a) for a in jtypes.XYZ_AXES]
    assert ttypes.CENTIMETER == jtypes.CENTIMETER
    assert ttypes.ERROR == jtypes.ERROR
    assert str(ttypes.NoInverseKinematicSolution((1, 2, 3))) == str(
        jtypes.NoInverseKinematicSolution((1, 2, 3)))


@pytest.mark.parametrize("W,N,offset,diag", [(4, 3, 0, 1), (5, 2, 10, 2)])
def test_tri_diagonal_and_smoothness_match_reference(W, N, offset, diag):
    n = 2 * W * N
    np.testing.assert_array_equal(
        ttraj.tri_diagonal_matrix(2.0, -1.0, n, offset, diag),
        jtraj.tri_diagonal_matrix(2.0, -1.0, n, offset, diag))
    np.testing.assert_array_equal(ttraj.smoothness_objective(W, N),
                                  jtraj.smoothness_objective(W, N))


def test_warm_start_and_xyz_map_match_reference():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-1, 1, 6), rng.uniform(-1, 1, 6)
    got = ttraj.calc_warm_start_batched(torch.from_numpy(a),
                                        torch.from_numpy(b), 7)
    assert_close(got, jtraj.calc_warm_start_jnp(jnp.asarray(a),
                                                jnp.asarray(b), 7), **FK_TOL)
    traj = rng.uniform(-np.pi, np.pi, (3, 2 * 5 * 6))
    ref = jtraj.map_joint_trajectory_to_xyz(
        jnp.asarray(traj), jur5e.forward_kinematics, 6)
    got = ttraj.map_joint_trajectory_to_xyz(
        torch.from_numpy(traj), tur5e.forward_kinematics, 6)
    assert tuple(got.shape) == (3, 5, 3)
    assert_close(got, ref, **FK_TOL)


def test_data_writer_is_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    q = rng.uniform(-np.pi, np.pi, (9, 6)) * np.logspace(-7, 3, 9)[:, None]
    q[0, 0], q[1, 1] = 0.0, -0.0
    pts = rng.standard_normal((9, 3)) * 1e-5
    jio.write_trajectory_files(q, pts, tmp_path / "jc", tmp_path / "jx")
    tio.write_trajectory_files(q, pts, tmp_path / "tc", tmp_path / "tx")
    for kind in "cx":
        assert (tmp_path / f"t{kind}").read_bytes() == (
            tmp_path / f"j{kind}").read_bytes()
    assert tio.ctrl_lines(q) == jio.ctrl_lines(q)
    assert tio.xyz_lines(pts) == jio.xyz_lines(pts)
