"""PyTorch port vs JAX package: the planner's ``run_padded`` from a cold
start, ``run_horizon``'s default-``Settings()`` refactor (mirrored), and
the session-batched ``run_batch`` with a shared line and with per-query
spheres.  The planners and the line problem are
``test_torch_planner_run.py``'s; f64, CPU: statuses, SCP rounds and ADMM
iteration counts equal, trajectories within 1e-6."""
import numpy as np
import pytest

from osqp_solver_tpu.gomp import geometry as jgeo
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import session as tsession
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np
from test_torch_planner import (
    LINE, N, TRAJ_TOL, _both_solvers, _line_queries, _stacked,
)
from test_torch_planner_run import (  # noqa: F401  (line_pair: a fixture)
    END, START, _assert_plan_equal, _run_both, line_pair,
)

pytestmark = pytest.mark.torch_port


def test_free_run_padded_matches_reference():
    pair = _both_solvers([], waypoints=10, segments=2)
    ref, got, _, _, _ = _run_both(pair, "run_padded", "run_horizon_padded")
    _assert_plan_equal(got, ref)
    assert got.status == ExitCode.kOptimal


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
