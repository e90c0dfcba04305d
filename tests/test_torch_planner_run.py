"""PyTorch port vs JAX package: the single-query and session-batched
planners of ``GOMPSolver`` — ``run``, ``run_padded``, ``run_horizon``,
``run_horizon_padded`` and ``run_batch`` (``gomp/planner.py``), which solve
on the session layer (``ops/session.py``) over a ``TrajectoryQP``.

Both packages' planners come from one set of arrays (identity-kinematics
ball, N = 3), as in ``tests/test_torch_planner.py``.  f64, CPU: statuses,
winning horizons, SCP rounds and ADMM iteration counts (every
``SegmentStats`` field) must be EQUAL; trajectories agree within 1e-6.  The
JAX solvers live in module fixtures, so that each compiles its programs
once."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.gomp import geometry as jgeo
from osqp_solver_tpu_torch.gomp import planner as tplanner
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import session as tsession
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np
from test_torch_planner import (
    LINE, N, TRAJ_TOL, _both_solvers, _line_queries, _stacked,
)

pytestmark = pytest.mark.torch_port
START = np.array([0.0, 1.0, 0.2])
END = np.array([0.5, -1.0, 0.2])


def _spy(solver, name, log):
    """Record the horizon and warm start of every call of ``solver.name``
    and what it returns."""
    orig = getattr(solver, name)

    def spy(s, e, w, warm):
        out = orig(s, e, w, warm)
        log.append((w, to_np(warm).copy(), to_np(out[1]).copy()))
        return out

    setattr(solver, name, spy)


def _run_both(pair, method, horizon_name):
    """``method`` of both planners on (START, END), with the warm starts
    each fixed-horizon call received; the port's host reads counted."""
    jsolver, tsolver = pair
    jlog, tlog = [], []
    _spy(jsolver, horizon_name, jlog)
    _spy(tsolver, horizon_name, tlog)
    try:
        ref = getattr(jsolver, method)(START, END)
        syncs = tplanner.PLANNER_SYNCS
        got = getattr(tsolver, method)(START, END)
        syncs = tplanner.PLANNER_SYNCS - syncs
    finally:
        del jsolver.__dict__[horizon_name], tsolver.__dict__[horizon_name]
    return ref, got, jlog, tlog, syncs


def _assert_plan_equal(got, ref):
    assert got.status == ref.status
    assert [tuple(s) for s in got.stats] == [tuple(s) for s in ref.stats]
    assert got.trajectory.shape == np.asarray(ref.trajectory).shape
    np.testing.assert_allclose(got.trajectory, np.asarray(ref.trajectory),
                               **TRAJ_TOL)


@pytest.fixture(scope="module")
def line_pair():
    return _both_solvers([LINE], waypoints=12, segments=3)


@pytest.fixture(scope="module")
def line_run(line_pair):
    return _run_both(line_pair, "run", "run_horizon")


@pytest.fixture(scope="module")
def line_run_padded(line_pair):
    return _run_both(line_pair, "run_padded", "run_horizon_padded")


@pytest.mark.parametrize("which", ["run", "run_padded"])
def test_line_search_matches_reference(which, line_run, line_run_padded):
    ref, got, _, _, _ = line_run if which == "run" else line_run_padded
    _assert_plan_equal(got, ref)
    assert got.status == ExitCode.kOptimal
    assert [s.waypoints for s in got.stats] == [12, 8, 4]


@pytest.mark.parametrize("which", ["run", "run_padded"])
def test_warm_slicing_quirk_matches_reference(which, line_run,
                                              line_run_padded):
    """The warm starts each segment receives equal the reference's; after
    a kOptimal segment the next warm start is the first two w·N windows of
    its (compact) solution: the second holds leftover POSITIONS."""
    _, got, jlog, tlog, _ = line_run if which == "run" else line_run_padded
    assert [w for w, _, _ in tlog] == [w for w, _, _ in jlog] == [12, 8, 4]
    for (_, tw, _), (_, jw, _) in zip(tlog, jlog):
        np.testing.assert_allclose(tw, jw, **TRAJ_TOL)
    if which == "run":
        first = tlog[0][2]  # the W=12 solution (kOptimal)
        assert got.stats[0].status == int(ExitCode.kOptimal)
        np.testing.assert_array_equal(tlog[1][1], first[: 2 * 8 * N])


def test_planner_syncs_one_per_scp_round(line_run, line_run_padded):
    for _, got, _, _, syncs in (line_run, line_run_padded):
        assert syncs == sum(s.scp_iterations for s in got.stats)


def test_free_run_padded_matches_reference():
    pair = _both_solvers([], waypoints=10, segments=2)
    ref, got, _, _, _ = _run_both(pair, "run_padded", "run_horizon_padded")
    _assert_plan_equal(got, ref)
    assert got.status == ExitCode.kOptimal


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_run_horizon_with_a_callers_warm_start(padded, line_pair,
                                               line_run, line_run_padded):
    """A fixed-horizon call from a warm start the caller made (a perturbed
    straight line), at a horizon the search ran (its programs compiled)."""
    jsolver, tsolver = line_pair
    rng = np.random.default_rng(5)
    W = 8
    Wc = jsolver.max_waypoints if padded else W
    warm = np.zeros(2 * Wc * N)
    frac = np.linspace(0.0, 1.0, W)[:, None]
    warm[: W * N] = (START + frac * (END - START)).reshape(-1) + (
        0.01 * rng.standard_normal(W * N))
    name = "run_horizon_padded" if padded else "run_horizon"
    jcode, jx, jstats = getattr(jsolver, name)(START, END, W, warm)
    tcode, tx, tstats = getattr(tsolver, name)(START, END, W, warm)
    assert tcode == jcode
    assert tuple(tstats) == tuple(jstats)
    np.testing.assert_allclose(to_np(tx), np.asarray(jx), **TRAJ_TOL)


def test_default_settings_refactor_is_mirrored(monkeypatch):
    """``run_horizon``'s step refactors with the DEFAULT ``Settings()``, the
    padded step with the planner's — as the reference does; at
    ``sigma=1e-4`` the two differ, and the counts still equal the
    reference's."""
    settings = dict(sigma=1e-4)
    jsolver, tsolver = _both_solvers([LINE], waypoints=8, segments=1,
                                     settings=settings)
    seen = []
    orig = tsession.update

    def spy(sess, new_qp, refactor=True, settings=tadmm.Settings()):
        seen.append(settings.sigma)
        return orig(sess, new_qp, refactor, settings)

    warm = np.zeros(2 * 8 * N)
    warm[: 8 * N] = (START + np.linspace(0, 1, 8)[:, None] * (END - START)
                     ).reshape(-1)
    ref = jsolver.run_horizon(START, END, 8, warm)
    monkeypatch.setattr(tsession, "update", spy)
    got = tsolver.run_horizon(START, END, 8, warm)
    assert got[0] == ref[0] and tuple(got[2]) == tuple(ref[2])
    np.testing.assert_allclose(to_np(got[1]), np.asarray(ref[1]), **TRAJ_TOL)
    assert seen and set(seen) == {1e-6}
    seen.clear()
    tsolver.run_horizon_padded(START, END, 8, warm)
    assert seen and set(seen) == {1e-4}


@pytest.fixture(scope="module")
def batch_queries():
    B = 6
    starts, ends = _line_queries(B)
    return starts, ends + 0.01 * np.arange(B)[:, None]


def _assert_batch_equal(got, ref):
    st, tr, it = (to_np(a) for a in got)
    np.testing.assert_array_equal(st, np.asarray(ref[0]))
    np.testing.assert_array_equal(it, np.asarray(ref[2]))
    np.testing.assert_allclose(tr, np.asarray(ref[1]), **TRAJ_TOL)


def test_run_batch_shared_line_matches_reference(line_pair, batch_queries):
    jsolver, tsolver = line_pair
    starts, ends = batch_queries
    ref = jsolver.run_batch(starts, ends, waypoints=8)
    got = tsolver.run_batch(starts, ends, waypoints=8)
    _assert_batch_equal(got, ref)
    assert (to_np(got[0]) == int(ExitCode.kOptimal)).all()
    assert got[1].shape == (6, 2 * 8 * N)
    # Each query on its own: the batch's frozen carries change nothing.
    for b in (0, 5):
        one = tsolver.run_batch(starts[b:b + 1], ends[b:b + 1], waypoints=8)
        np.testing.assert_array_equal(to_np(one[2]), to_np(got[2])[b:b + 1])
        np.testing.assert_allclose(to_np(one[1]), to_np(got[1])[b:b + 1],
                                   rtol=0, atol=1e-9)


def test_run_batch_per_query_spheres_matches_reference(line_pair,
                                                       batch_queries):
    jsolver, tsolver = line_pair
    starts, ends = batch_queries
    # Spheres that grow from query to query across the straight line: the
    # last queries find no plan in their first round and stop there.
    mids = 0.5 * (starts + ends) + np.array([0.0, 0.0, 0.05])
    spheres = [jgeo.SphereObstacle.create(c, radius=0.15 + 0.02 * i)
               for i, c in enumerate(mids)]
    jstack, tstack = _stacked(spheres)
    ref = jsolver.run_batch(starts, ends, waypoints=8, obstacles=[jstack])
    got = tsolver.run_batch(starts, ends, waypoints=8, obstacles=[tstack])
    _assert_batch_equal(got, ref)
    st = to_np(got[0])
    assert (st == int(ExitCode.kOptimal)).any()
    assert (st == int(ExitCode.kUnknown)).any()
