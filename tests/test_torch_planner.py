"""PyTorch port vs JAX package: the batched GOMP planner.

``GOMPSolver.run_batch_padded`` (full time-scaling search) and
``run_batch_lane`` (fixed horizon) of both packages on the same queries, with
an identity-kinematics ball (N = 3) and line, sphere and capsule obstacles,
shared and per query.  Both planners are built from one set of arrays
(``convert.gomp_solver_kwargs_from_numpy``).  f64, CPU: statuses, winning
horizons, SCP rounds and ADMM iteration counts must be EQUAL; trajectories
agree within 1e-6 (the two lane solvers agree to ~1e-7 per solve, and the
differences pass through a handful of SCP re-linearizations)."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu import RobotBall as JBall
from osqp_solver_tpu import constraints as JC
from osqp_solver_tpu.gomp import geometry as jgeo
from osqp_solver_tpu.gomp.planner import GOMPSolver as JSolver
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu_torch import GOMPSolver, RobotBall, convert
from osqp_solver_tpu_torch.gomp import planner as tplanner
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np

pytestmark = pytest.mark.torch_port
N = 3
TRAJ_TOL = dict(rtol=0.0, atol=1e-6)


def _identity_fk_jac(q, axis=-1):
    """Torch identity kinematics: the ball sits at the joint vector."""
    axis = axis % q.dim()
    shape = [1] * (q.dim() + 1)
    shape[axis] = shape[axis + 1] = 3
    jac = torch.eye(3, dtype=q.dtype, device=q.device).reshape(shape).expand(
        q.shape[:axis] + (3, 3) + q.shape[axis + 1:])
    return q, jac


def _both_solvers(obstacles=(), waypoints=12, **kw):
    """The two packages' planners from ONE set of arrays; ``obstacles`` are
    the JAX package's."""
    spec = dict(
        max_waypoints=waypoints, time_step=0.1,
        pos_con=(np.full(N, -10.0), np.full(N, 10.0)),
        vel_con=(np.full(N, -20.0), np.full(N, 20.0)),
        acc_con=(np.full(N, -40.0), np.full(N, 40.0)),
        con_3d=(np.full(3, -10.0), np.full(3, 10.0)),
        obstacles=[convert.obstacle_to_numpy(o) for o in obstacles], **kw,
    )
    jball = JBall(fk=lambda s: s, jacobian=lambda s: jnp.eye(3, dtype=s.dtype),
                  radius=0.05, is_gripper=True)
    jsolver = JSolver(
        max_waypoints=waypoints, time_step=0.1,
        pos_con=JC.Constraint(*spec["pos_con"]),
        vel_con=JC.Constraint(*spec["vel_con"]),
        acc_con=JC.Constraint(*spec["acc_con"]),
        con_3d=JC.Constraint(*spec["con_3d"]),
        obstacles=list(obstacles), balls=[jball],
        **{k: v for k, v in kw.items() if k != "settings"},
        **({"settings": jadmm.Settings(**kw["settings"])}
           if "settings" in kw else {}),
    )
    tball = RobotBall(radius=0.05, is_gripper=True,
                      fk_jac_batched=_identity_fk_jac)
    tsolver = GOMPSolver(
        balls=[tball], **convert.gomp_solver_kwargs_from_numpy(
            spec, device="cpu"))
    return jsolver, tsolver


def _stacked(obstacles):
    """Per-query stacks in both conventions (JAX leading, port trailing)."""
    js = jgeo.stack_obstacles(obstacles)
    kind, arrays = convert.obstacle_to_numpy(js)
    return js, convert.obstacle_from_numpy(kind, arrays, per_query=True)


def _assert_padded_equal(got, ref, traj=True):
    for g, r, name in zip(got, ref, ("status", "traj", "horizon", "scp_rounds",
                                     "admm_iters")):
        if name == "traj":
            if traj:
                np.testing.assert_allclose(to_np(g), np.asarray(r), **TRAJ_TOL)
        else:
            np.testing.assert_array_equal(to_np(g), np.asarray(r), err_msg=name)


LINE = jgeo.HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
SPHERE = jgeo.SphereObstacle.create([0.5, 0.25, -0.125], radius=0.15)
CAPSULE = jgeo.CapsuleObstacle.create(
    [0.25, -1.0, 0.2], [0.25, 1.0, 0.2], radius=0.2, margin=0.2)


@pytest.fixture(scope="module")
def line_solvers():
    return _both_solvers([LINE], waypoints=12, segments=3)


def _line_queries(B=4):
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.02 * np.arange(B)[
        :, None]
    return starts, ends


def test_run_batch_padded_line_matches_reference(line_solvers):
    jsolver, tsolver = line_solvers
    starts, ends = _line_queries()
    ref = jsolver.run_batch_padded(starts, ends)
    syncs, solver_syncs = tplanner.PLANNER_SYNCS, tdrv.HOST_SYNCS
    got = tsolver.run_batch_padded(starts, ends)
    _assert_padded_equal(got, ref)
    assert (to_np(got[0]) == int(ExitCode.kOptimal)).all()
    assert got[1].shape == (4, 2 * 12 * N)
    # One host read per SCP round: no more than the slowest query's rounds
    # per segment summed, no fewer than one per segment that ran.
    rounds = tplanner.PLANNER_SYNCS - syncs
    assert 3 <= rounds <= int(to_np(got[3]).max()) * 3
    assert tdrv.HOST_SYNCS > solver_syncs


def test_run_batch_padded_warm_duals(line_solvers):
    jsolver, tsolver = line_solvers
    starts, ends = _line_queries()
    cold = tsolver.run_batch_padded(starts, ends)
    ref = jsolver.run_batch_padded(starts, ends, warm_duals=True)
    got = tsolver.run_batch_padded(starts, ends, warm_duals=True)
    _assert_padded_equal(got, ref)
    np.testing.assert_array_equal(to_np(got[0]), to_np(cold[0]))
    np.testing.assert_array_equal(to_np(got[2]), to_np(cold[2]))


def test_run_batch_padded_unfused_termination_equal(line_solvers):
    """``term_fused="off"`` (delta-writing chunk + residual pass) decides
    from the same quantities: every count equal, query for query."""
    _, tsolver = line_solvers
    starts, ends = _line_queries()
    fused = tsolver.run_batch_padded(starts, ends)
    tsolver.settings = dataclasses.replace(tsolver.settings, term_fused="off")
    try:
        unfused = tsolver.run_batch_padded(starts, ends)
    finally:
        tsolver.settings = dataclasses.replace(tsolver.settings,
                                               term_fused="auto")
    _assert_padded_equal(unfused, [to_np(a) for a in fused])


def test_run_batch_lane_line_matches_reference(line_solvers):
    jsolver, tsolver = line_solvers
    starts, ends = _line_queries()
    st_r, tr_r, it_r = jsolver.run_batch_lane(starts, ends, waypoints=12)
    st, tr, it = tsolver.run_batch_lane(starts, ends, waypoints=12)
    np.testing.assert_array_equal(to_np(st), np.asarray(st_r))
    np.testing.assert_array_equal(to_np(it), np.asarray(it_r))
    np.testing.assert_allclose(to_np(tr), np.asarray(tr_r), **TRAJ_TOL)
    # max_scp cuts the loop: nobody has passed after one round here.
    st1, _, it1 = tsolver.run_batch_lane(starts, ends, waypoints=12, max_scp=1)
    st1_r, _, it1_r = jsolver.run_batch_lane(starts, ends, waypoints=12,
                                             max_scp=1)
    np.testing.assert_array_equal(to_np(st1), np.asarray(st1_r))
    np.testing.assert_array_equal(to_np(it1), np.asarray(it1_r))


def test_run_batch_padded_masked_survival():
    """A query whose short horizons are infeasible keeps its longest
    feasible horizon while the other descends, in the SAME batch."""
    jsolver, tsolver = _both_solvers(waypoints=12, segments=3)
    starts = np.zeros((2, N))
    ends = np.stack([np.full(N, 0.8), np.full(N, 9.5)])
    ref = jsolver.run_batch_padded(starts, ends)
    got = tsolver.run_batch_padded(starts, ends)
    _assert_padded_equal(got, ref)
    h, s = to_np(got[2]), to_np(got[0])
    assert h[0] != h[1] or s[0] != s[1]


def test_run_batch_padded_per_query_spheres():
    """Same (start, end) for every query, a DIFFERENT sphere per query on
    the straight-line path."""
    B = 4
    start, end = np.zeros(N), np.array([1.0, 0.5, -0.25])
    starts, ends = np.tile(start, (B, 1)), np.tile(end, (B, 1))
    centers = [start + t * (end - start) for t in (0.3, 0.45, 0.6, 0.75)]
    spheres = [jgeo.SphereObstacle.create(c, radius=0.12) for c in centers]
    jsolver, tsolver = _both_solvers([SPHERE], waypoints=14, segments=2)
    jstack, tstack = _stacked(spheres)
    ref = jsolver.run_batch_padded(starts, ends, obstacles=[jstack])
    got = tsolver.run_batch_padded(starts, ends, obstacles=[tstack])
    _assert_padded_equal(got, ref)
    assert (to_np(got[0]) == int(ExitCode.kOptimal)).all()
    for b in range(B):  # every plan clears its OWN keep-out
        w = int(to_np(got[2])[b])
        q = to_np(got[1])[b][: 14 * N].reshape(14, N)[:w]
        assert np.linalg.norm(q - centers[b], axis=-1).min() >= 0.12 + 0.05 - 2e-3
    # Shared obstacle == the same obstacle stacked B times.
    _, trep = _stacked([SPHERE] * B)
    shared = tsolver.run_batch_padded(starts, ends)
    rep = tsolver.run_batch_padded(starts, ends, obstacles=[trep])
    _assert_padded_equal(rep, [to_np(a) for a in shared])


def test_run_batch_lane_capsule_shared_and_per_query():
    jsolver, tsolver = _both_solvers([CAPSULE], waypoints=10)
    B = 3
    rng = np.random.default_rng(3)
    starts = np.tile([-0.5, 0.0, 0.2], (B, 1)) + 0.05 * rng.standard_normal((B, N))
    ends = np.tile([1.0, 0.0, 0.2], (B, 1)) + 0.05 * rng.standard_normal((B, N))
    st_r, tr_r, it_r = jsolver.run_batch_lane(starts, ends, waypoints=10)
    st, tr, it = tsolver.run_batch_lane(starts, ends, waypoints=10)
    np.testing.assert_array_equal(to_np(st), np.asarray(st_r))
    np.testing.assert_array_equal(to_np(it), np.asarray(it_r))
    np.testing.assert_allclose(to_np(tr), np.asarray(tr_r), **TRAJ_TOL)
    assert (to_np(st) == int(ExitCode.kOptimal)).any()
    _, tstack = _stacked([CAPSULE] * B)
    st1, tr1, it1 = tsolver.run_batch_lane(starts, ends, waypoints=10,
                                           obstacles=[tstack])
    np.testing.assert_array_equal(to_np(st1), to_np(st))
    np.testing.assert_array_equal(to_np(it1), to_np(it))
    np.testing.assert_allclose(to_np(tr1), to_np(tr), rtol=0, atol=1e-12)


def test_obstacles_arg_and_query_validation(line_solvers):
    _, tsolver = line_solvers
    starts, ends = _line_queries()
    _, tline = _stacked([LINE] * 4)
    _, tline5 = _stacked([LINE] * 5)
    with pytest.raises(ValueError, match="obstacle count"):
        tsolver.run_batch_lane(starts, ends, waypoints=12, obstacles=[])
    with pytest.raises(ValueError, match="trailing batch"):
        tsolver.run_batch_lane(starts, ends, waypoints=12,
                               obstacles=[tsolver.obstacles[0]])
    with pytest.raises(ValueError, match="trailing batch"):
        tsolver.run_batch_padded(starts, ends, obstacles=[tline5])
    with pytest.raises(ValueError, match="starts/ends"):
        tsolver.run_batch_padded(starts[:, :2], ends[:, :2])
    # a well-formed per-query stack of the constructor's own line is accepted
    st, _, _ = tsolver.run_batch_lane(starts, ends, waypoints=12,
                                      obstacles=[tline], max_scp=1)
    assert st.shape == (4,)


def test_planner_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    spec = dict(max_waypoints=8, time_step=0.1,
                pos_con=(np.full(N, -1.0), np.full(N, 1.0)),
                vel_con=(np.full(N, -1.0), np.full(N, 1.0)),
                acc_con=(np.full(N, -1.0), np.full(N, 1.0)),
                con_3d=(np.full(3, -1.0), np.full(3, 1.0)))
    kwargs = convert.gomp_solver_kwargs_from_numpy(spec, device="cpu")
    kwargs.pop("device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GOMPSolver(balls=[], **kwargs)


def _planner_spec():
    return dict(max_waypoints=8, time_step=0.1,
                pos_con=(np.full(N, -1.0), np.full(N, 1.0)),
                vel_con=(np.full(N, -1.0), np.full(N, 1.0)),
                acc_con=(np.full(N, -1.0), np.full(N, 1.0)),
                con_3d=(np.full(3, -1.0), np.full(3, 1.0)))


def test_planner_kwargs_from_numpy_default_to_cuda():
    """Without ``device=`` the converter's kwargs build a CUDA planner (the
    entry points' rule), or raise where there is no CUDA device."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.gomp_solver_kwargs_from_numpy(_planner_spec())
        return
    kwargs = convert.gomp_solver_kwargs_from_numpy(_planner_spec())
    assert kwargs["device"].type == "cuda"
    assert GOMPSolver(balls=[], **kwargs).device.type == "cuda"


def test_planner_kwargs_from_numpy_on_the_cpu_when_asked():
    kwargs = convert.gomp_solver_kwargs_from_numpy(_planner_spec(),
                                                   device="cpu")
    assert kwargs["device"].type == "cpu"
    assert GOMPSolver(balls=[], **kwargs).device.type == "cpu"


def test_auto_refine_policy_matches_reference_and_is_refused():
    from osqp_solver_tpu_torch.ops import admm as tadmm

    for W, jdt, tdt in ((100, jnp.float32, torch.float32),
                        (1024, jnp.float32, torch.float32),
                        (1025, jnp.float32, torch.float32),
                        (2000, jnp.float64, torch.float64)):
        assert tadmm.refine_steps_for_horizon(W, tdt) == (
            jadmm.refine_steps_for_horizon(W, jdt))
    s = tadmm.Settings()
    assert tadmm.with_auto_refine(s, 1024, torch.float32) is s
    bumped = tadmm.with_auto_refine(s, 1025, torch.float32)
    assert bumped.kkt_refine == 1
    keep = dataclasses.replace(s, kkt_refine=3)
    assert tadmm.with_auto_refine(keep, 1025, torch.float32) is keep
    # Bumped, not silently dropped: the lane driver takes it, on its
    # unfused path (tests/test_torch_lane_settings.py plans at W=1025).
    tadmm.check_supported(bumped)
    qp = types.SimpleNamespace(row_layout="waypoint")
    assert tdrv._use_fused(qp, s) and not tdrv._use_fused(qp, bumped)
