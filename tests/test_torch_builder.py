"""The port's ``ConstraintBuilder``, ``TrajectoryLayout`` and the rest of
queue A3 against the JAX package, on the CPU in f64.

The builder scenarios mirror ``tests/test_builder.py`` (the reference's
``tests/test.cpp``) case for case: the same tiny problems go through both
builders, and the port's ``(l, A, u)`` must equal JAX's within 1e-12.  The
reference's stateful powers-of-two FK records its call order; the port
evaluates every waypoint at once, so its mirror hands the same values to the
builder through ``fk_jac_batched``, waypoint by waypoint in that order.
Beyond them: the UR5e balls of the reference example, ``HorizontalLine``
collisions beside dummy rows, and a ``SphereObstacle``.  Then the structured
container's exports (``layout``, ``row_map``, ``to_csr``), the tridiagonal
helpers, the lane container's Ruiz norms, the UR5e Jacobians, and the
builder's QP solved by both packages.  The scenarios and the layouts run in
``test_torch_builder_scenarios.py``, with this file's set-up."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu import ConstraintBuilder as JBuilder
from osqp_solver_tpu import RobotBall as JBall
from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp import geometry as jgeo
from osqp_solver_tpu.gomp import trajectory_qp as jtq
from osqp_solver_tpu.gomp.trajectory import smoothness_objective as jsmooth
from osqp_solver_tpu.models import ur5e as jur5e
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import tridiag as jtri
from osqp_solver_tpu.ops.qp import DenseQP as JDenseQP
from osqp_solver_tpu_torch import ConstraintBuilder as TBuilder
from osqp_solver_tpu_torch import RobotBall as TBall
from osqp_solver_tpu_torch import constraints as TC
from osqp_solver_tpu_torch.gomp import geometry as tgeo
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttq
from osqp_solver_tpu_torch.gomp.trajectory import smoothness_objective
from osqp_solver_tpu_torch.models import ur5e as tur5e
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import tridiag as ttri
from osqp_solver_tpu_torch.ops.qp import dense_qp
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import both, jit_vmap, to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

TOL = 1e-12
CON3 = ([11, 22, 33], [44, 55, 66])
CONST_JAC = np.arange(9, dtype=float).reshape(3, 3)  # test.cpp:258-269
POW2_JAC = np.array([[0, 1, 2], [4, 8, 16], [32, 64, 128]], dtype=float)


def _balls(fk_np, jac_np=CONST_JAC, radius=0.0, is_gripper=True,
           fk_t=None):
    """One fake-kinematics ball in each package: ``fk_np``/``jac_np`` for
    JAX (numpy, called per waypoint), their torch mirror for the port."""
    jb = JBall(fk=fk_np, jacobian=lambda q: jac_np, radius=radius,
               is_gripper=is_gripper)
    jt = torch.from_numpy(jac_np)
    tb = TBall(radius=radius, is_gripper=is_gripper,
               fk=fk_t or (lambda q: q), jacobian=lambda q: jt)
    return [jb], [tb]


def _pow2_balls():
    """The stateful FK of test.cpp:250-303: call c returns
    ``2^(3c), 2^(3c+1), 2^(3c+2)``.  The port's ball gives waypoint t the
    values of call t at once."""
    counter = {"n": 0}

    def pow2_fk(q):
        c = counter["n"]
        counter["n"] += 3
        return np.array([2.0 ** c, 2.0 ** (c + 1), 2.0 ** (c + 2)])

    def batched(q, axis=-1):
        Wq = q.shape[0]
        pts = 2.0 ** torch.arange(3 * Wq, dtype=q.dtype).reshape(Wq, 3)
        return pts, torch.from_numpy(CONST_JAC).expand(Wq, 3, 3)

    jb = JBall(fk=pow2_fk, jacobian=lambda q: CONST_JAC, radius=0.0,
               is_gripper=True)
    return [jb], [TBall(radius=0.0, is_gripper=True, fk_jac_batched=batched)]


def scenario(name):
    """``(jax_builder, port_builder)`` of one scenario of
    ``tests/test_builder.py`` (or of the extra cases below it)."""
    d, w = 2, 3
    boxes = {"joint_position": [("positions", [1, 2], [3, 4])],
             "velocity": [("velocities", [1, 2], [3, 4])],
             "acceleration": [("accelerations", [1, 2], [3, 4])],
             "all_constraint_kinds": [
                 ("positions", [1, 2], [3, 4]),
                 ("velocities", [5, 6], [7, 8]),
                 ("accelerations", [9, 10], [11, 12])]}
    if name == "linking_velocity_to_position":
        return JBuilder(w, d), TBuilder(w, d)
    if name in boxes:
        jb, tb = JBuilder(w, d), TBuilder(w, d)
        last = {"positions": w - 1, "velocities": w - 2,
                "accelerations": w - 3}
        for kind, lo, up in boxes[name]:
            getattr(jb, kind)(0, last[kind], JC.in_range(d, lo, up))
            getattr(tb, kind)(0, last[kind], TC.in_range(d, lo, up))
        return jb, tb
    d, w = 3, 2
    con = (JC.in_range(3, *CON3), TC.in_range(3, *CON3))
    traj = np.ones(w * d * 2)
    if name == "position3d_stateful_fk":
        jballs, tballs = _pow2_balls()
    elif name == "position3d_identity_fk":
        jballs, tballs = _balls(lambda q: np.asarray(q, dtype=float))
    elif name in ("position3d_jac_pow2", "ignore_velocity_trajectory"):
        jballs, tballs = _balls(lambda q: np.asarray(q, dtype=float),
                                POW2_JAC)
        traj = np.full(w * d * 2, 2.0)
        if name == "ignore_velocity_trajectory":
            traj = np.concatenate([np.full(w * d, 2.0),
                                   np.full(w * d, 1024.0)])
    elif name == "radius_tightens_bounds":
        jballs, tballs = _balls(lambda q: np.zeros(3), radius=0.25,
                                fk_t=lambda q: torch.zeros(3, dtype=q.dtype))
        traj = np.zeros(w * d * 2)
        con = (JC.in_range(3, [0] * 3, [10] * 3),
               TC.in_range(3, [0] * 3, [10] * 3))
    elif name == "obstacle_rows_collision_and_dummy":
        w = 4
        jballs, tballs = _balls(lambda q: np.asarray(q, dtype=float),
                                POW2_JAC, radius=0.1, is_gripper=False)
        traj_q = np.array([[0, 5, 0], [0, 0.05, 0], [0, 5, 0], [0, 5, 0]],
                          dtype=float)
        traj = np.concatenate([traj_q.reshape(-1), np.zeros(w * d)])
        jb = JBuilder(w, d, balls=jballs, obstacles=[
            jgeo.HorizontalLine.create([1, 0], [0, 0, 0.5], False)])
        tb = TBuilder(w, d, balls=tballs, obstacles=[
            tgeo.HorizontalLine.create([1, 0], [0, 0, 0.5], False)])
        jb.with_obstacles(JC.any_constraint(3), traj)
        tb.with_obstacles(TC.any_constraint(3), traj)
        return jb, tb
    else:
        raise KeyError(name)
    jb = JBuilder(w, d, balls=jballs).with_obstacles(con[0], traj)
    tb = TBuilder(w, d, balls=tballs).with_obstacles(con[1], traj)
    return jb, tb


def assert_lau(jb, tb, tol=TOL):
    for a, b in zip(jb.build(), tb.build()):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


# --- the reference example's problem, both packages --------------------------

WE, NE = 6, 6
START = np.zeros(NE)
END = np.array([np.pi, 0, 0, 0, 0, 0.0])
CON3D = ([-1e30, -0.4, -1e30], [1e30, 1e30, 1e30])


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    return jax.jit(fn)


def example_kit(pkg, obstacles):
    """The UR5e, its two balls and ``solver_example.py``'s boxes in one
    package (``"jax"`` or ``"torch"``); ``obstacles``: ``none``, ``lines``
    (the example's ``--obstacles``) or ``sphere`` (a line and a sphere)."""
    C, geo, ur = ((JC, jgeo, jur5e) if pkg == "jax"
                  else (TC, tgeo, tur5e))
    balls = [ur.make_ball("back6", 0.15),
             ur.make_ball("tool", 0.05, is_gripper=True)]
    if pkg == "jax":  # the JAX builder calls them once a waypoint: compiled
        balls = [dataclasses.replace(b, fk=_jitted(b.fk),
                                     jacobian=_jitted(b.jacobian))
                 for b in balls]
    obs = {"none": [],
           "lines": [geo.HorizontalLine.create([0, 1], [0, 0, 0.6], True),
                     geo.HorizontalLine.create([0, 1], [0.3, 0, 0.5], False)],
           "sphere": [geo.HorizontalLine.create([0, 1], [0.3, 0, 0.5], False),
                      geo.SphereObstacle.create([0.0, -0.28, -0.55], 0.2,
                                                margin=0.15)]}[obstacles]
    cons = (C.in_range(NE, -2 * np.pi, 2 * np.pi),
            C.in_range(NE, -np.pi * 0.1, np.pi * 0.1),
            C.in_range(NE, -np.pi * 8 / 1800, np.pi * 8 / 1800))
    return C, balls, obs, cons


def warm_trajectory(seed=0, end=END):
    rng = np.random.default_rng(seed)
    q = np.linspace(START, end, WE) + 0.05 * rng.standard_normal((WE, NE))
    return np.concatenate([q.reshape(-1), np.zeros(WE * NE)])


def example_builder(pkg, obstacles, traj, end=END):
    C, balls, obs, (pos, vel, acc) = example_kit(pkg, obstacles)
    B = (JBuilder if pkg == "jax" else TBuilder)(WE, NE, balls=balls,
                                                 obstacles=obs)
    return (B.position(0, C.equal(START))
            .positions(1, WE - 2, pos)
            .position(WE - 3, C.equal(end))
            .velocities(0, WE - 4, vel)
            .velocity(WE - 3, C.eq_zero(NE))
            .accelerations(0, WE - 4, acc)
            .acceleration(WE - 3, C.eq_zero(NE))
            .with_obstacles(C.Constraint(np.array(CON3D[0]),
                                         np.array(CON3D[1])), traj))


def example_container(pkg, obstacles, traj):
    C, balls, obs, (pos, vel, acc) = example_kit(pkg, obstacles)
    flags = [b.is_gripper for b in balls]
    if pkg == "jax":
        qp = jtq.empty_trajectory_qp(WE, NE, flags, len(obs))
        qp = jtq.with_gomp_boxes(qp, START, END, pos, vel, acc)
        return jtq.linearize_workspace(qp, balls, obs, CON3D, traj)
    qp = ttq.empty_trajectory_qp(WE, NE, flags, len(obs), torch.float64,
                                 "cpu")
    qp = ttq.with_gomp_boxes(qp, START, END, pos, vel, acc)
    return ttq.linearize_workspace(qp, balls, obs, CON3D,
                                   torch.from_numpy(traj))


@pytest.mark.parametrize("obstacles", ["none", "lines", "sphere"])
def test_example_builder_matches_reference(obstacles):
    """The reference example's QP (UR5e balls, the workspace floor) with no
    obstacle, the example's two lines (collision rows beside dummy rows)
    and a line with a sphere: ``(l, A, u)`` equal JAX's."""
    traj = warm_trajectory()
    jb = example_builder("jax", obstacles, traj)
    tb = example_builder("torch", obstacles, traj)
    assert_lau(jb, tb)
    l, A, u = tb.build()
    lay = tb.layout
    if obstacles == "lines":  # both live rows and dummy rows were written
        rows = [lay.workspace_row(b, t, k) for b in range(2)
                for t in range(WE) for k in range(lay.rows_per_waypoint(b))
                if k >= lay.rows_per_waypoint(b) - 2]
        live = [(l[r] > -TC.INF_THRESHOLD) | (u[r] < TC.INF_THRESHOLD)
                for r in rows]
        assert any(live) and not all(live)


@pytest.mark.parametrize("obstacles", ["none", "lines", "sphere"])
def test_container_exports_match_reference(obstacles):
    """``TrajectoryQP.layout``, ``row_map`` and ``to_csr`` equal JAX's
    (indices exactly, data within 1e-12), and the port's builder equals the
    port's ``to_dense`` through ``row_map`` (as ``test_trajectory_qp.py``
    holds it for JAX), its other rows inert."""
    traj = warm_trajectory(1)
    jq = example_container("jax", obstacles, traj)
    tq = example_container("torch", obstacles, traj)
    assert dataclasses.asdict(tq.layout()) == dataclasses.asdict(jq.layout())
    np.testing.assert_array_equal(tq.row_map(), jq.row_map())
    jc, tc = jq.to_csr(), tq.to_csr()
    for k in (0, 2):  # P and A: indptr, indices exactly; data
        np.testing.assert_array_equal(tc[k][0], jc[k][0])
        np.testing.assert_array_equal(tc[k][1], jc[k][1])
        np.testing.assert_allclose(tc[k][2], jc[k][2], rtol=TOL, atol=TOL)
    for k in (1, 3, 4):
        np.testing.assert_allclose(tc[k], jc[k], rtol=TOL, atol=TOL)
    assert tc[5] == jc[5]
    np.testing.assert_array_equal(tc[6], np.asarray(jc[6]))

    l_ref, A_ref, u_ref = example_builder("torch", obstacles, traj).build()
    rmap = tq.row_map()
    _, _, A_s, l_s, u_s = (to_np(a) for a in tq.to_dense())
    np.testing.assert_allclose(l_s, l_ref[rmap], rtol=TOL)
    np.testing.assert_allclose(u_s, u_ref[rmap], rtol=TOL)
    np.testing.assert_allclose(A_s, A_ref[rmap], atol=TOL)
    mask = np.ones(len(l_ref), bool)
    mask[rmap] = False
    assert np.all(A_ref[mask] == 0)
    assert np.all(l_ref[mask] <= -TC.INF_THRESHOLD)
    assert np.all(u_ref[mask] >= TC.INF_THRESHOLD)


# --- the rest of A3 -------------------------------------------------------

def test_tridiag_helpers_match_reference():
    """``block_tridiag_matvec`` and ``block_tridiag_to_dense`` on random
    blocks, one problem and a trailing batch of three."""
    rng = np.random.default_rng(3)
    Wt, n, Bt = 5, 4, 3
    diag = rng.normal(size=(Bt, Wt, n, n))
    lower = rng.normal(size=(Bt, Wt - 1, n, n))
    x = rng.normal(size=(Bt, Wt, n))
    for b in range(Bt):
        np.testing.assert_allclose(
            to_np(ttri.block_tridiag_matvec(*map(torch.from_numpy, (
                diag[b], lower[b], x[b])))),
            np.asarray(jtri.block_tridiag_matvec(diag[b], lower[b], x[b])),
            rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            to_np(ttri.block_tridiag_to_dense(torch.from_numpy(diag[b]),
                                              torch.from_numpy(lower[b]))),
            np.asarray(jtri.block_tridiag_to_dense(diag[b], lower[b])),
            rtol=0, atol=0)
    trail = lambda a: torch.from_numpy(np.moveaxis(a, 0, -1))  # noqa: E731
    y = ttri.block_tridiag_matvec(trail(diag), trail(lower), trail(x))
    ref = jit_vmap(jtri.block_tridiag_matvec)(diag, lower, x)
    np.testing.assert_allclose(to_np(y), np.moveaxis(np.asarray(ref), 0, -1),
                               rtol=TOL, atol=TOL)
    M = ttri.block_tridiag_to_dense(trail(diag), trail(lower))
    refM = jit_vmap(jtri.block_tridiag_to_dense)(diag, lower)
    np.testing.assert_array_equal(to_np(M), np.moveaxis(np.asarray(refM), 0,
                                                        -1))


@pytest.mark.parametrize("layout", ["type", "waypoint"])
def test_lane_ruiz_norms_match_reference(layout):
    """``LaneTrajectoryQP.A_col_absmax``, ``A_row_absmax`` and
    ``P_col_absmax`` (both row layouts) equal JAX's, and the generic Ruiz
    (``ops/ruiz.py``, batch-trailing) now takes a lane batch: its scalings
    equal those of JAX's lane Ruiz off the TPU (``admm_lane.
    ruiz_equilibrate_lane``, which computes the same norms from the base
    coefficients)."""
    from osqp_solver_tpu.ops import admm_lane as jlane_drv
    from osqp_solver_tpu_torch.ops import ruiz as truiz

    jqp, tqp = both(5)
    if layout == "waypoint":
        jqp = dataclasses.replace(jqp, row_layout="waypoint")
        tqp = tqp.replace(row_layout="waypoint")
    for name in ("A_col_absmax", "A_row_absmax", "P_col_absmax"):
        np.testing.assert_allclose(to_np(getattr(tqp, name)()),
                                   np.asarray(getattr(jqp, name)()),
                                   rtol=TOL, atol=TOL)
    tsc, ts = truiz.ruiz_equilibrate(tqp, 3)
    jsc, js = jax.jit(lambda q: jlane_drv.ruiz_equilibrate_lane(q, 3))(jqp)
    np.testing.assert_allclose(to_np(ts.D), np.asarray(js.D), rtol=1e-10)
    np.testing.assert_allclose(to_np(ts.E), np.asarray(js.E), rtol=1e-10)
    np.testing.assert_allclose(to_np(ts.c), np.asarray(js.c), rtol=1e-10)


def test_ur5e_jacobians_match_reference():
    """``joint_jacobian``, ``joint_jacobian_6_back`` and
    ``jacobian_elbow_joint`` equal JAX's ``jax.jacfwd`` of the FK, one
    configuration at a time, and take a batch."""
    rng = np.random.default_rng(11)
    qs = rng.uniform(-np.pi, np.pi, size=(6, 6))
    for name in ("joint_jacobian", "joint_jacobian_6_back",
                 "jacobian_elbow_joint"):
        tj = getattr(tur5e, name)(torch.from_numpy(qs))
        assert tj.shape == (6, 3, 6)
        ref = _jitted(getattr(jur5e, name))
        for i, q in enumerate(qs):
            np.testing.assert_allclose(to_np(tj[i]),
                                       np.asarray(ref(jnp.asarray(q))),
                                       rtol=TOL, atol=TOL)


def test_builder_qp_solve_matches_reference():
    """The builder's QP (the example's problem with its two lines, P from
    ``smoothness_objective``) solved by the port's ``ops/admm.solve`` and
    by JAX's: the same status and iteration count, ``x`` within 1e-8."""
    end = np.array([0.05, 0, 0, 0, 0, 0.0])  # reachable in three steps
    traj = warm_trajectory(2, end)
    jl, jA, ju = example_builder("jax", "lines", traj, end).build()
    tl, tA, tu = example_builder("torch", "lines", traj, end).build()
    P = jsmooth(WE, NE)
    np.testing.assert_array_equal(to_np(smoothness_objective(WE, NE)),
                                  np.asarray(P))
    q = np.zeros(P.shape[0])
    settings = dict(max_iter=400)
    js = dataclasses.replace(jadmm.Settings(), **settings)
    jres = jax.jit(lambda qp: jadmm.solve(qp, js))(JDenseQP(
        *(jnp.asarray(a) for a in (P, q, jA, jl, ju))))
    tres = tadmm.solve(dense_qp(torch.from_numpy(np.asarray(P)),
                                torch.from_numpy(q), torch.from_numpy(tA),
                                torch.from_numpy(tl), torch.from_numpy(tu)),
                       dataclasses.replace(tadmm.Settings(), **settings),
                       device="cpu")
    assert int(tres.status) == int(jres.status)
    assert int(tres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(to_np(tres.x), np.asarray(jres.x), atol=1e-8)
    assert int(jres.status) == int(ExitCode.kOptimal)
