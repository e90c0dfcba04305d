"""PyTorch port vs JAX package: the batched GOMP planner on fleets with
obstacles of their own — masked per-query survival in ``run_batch_padded``,
a sphere per query, and a capsule shared and per query through
``run_batch_lane``.  The planners, obstacles and helpers are
``test_torch_planner.py``'s; f64, CPU: statuses, winning horizons, SCP
rounds and ADMM iteration counts equal, trajectories within 1e-6."""
import numpy as np
import pytest

from osqp_solver_tpu.gomp import geometry as jgeo
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np
from test_torch_planner import (
    CAPSULE, N, SPHERE, TRAJ_TOL, _assert_padded_equal, _both_solvers,
    _stacked,
)

pytestmark = pytest.mark.torch_port


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
