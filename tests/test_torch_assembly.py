"""PyTorch port vs JAX package: problem assembly — UR5e SoA kinematics, the
horizontal-line obstacle, the trajectory-QP constructors and the two
benchmark batch constructors, field by field (f64, CPU, 1e-10)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import geometry as jgeom
from osqp_solver_tpu.gomp import trajectory as jtraj
from osqp_solver_tpu.gomp import trajectory_qp as jtqp
from osqp_solver_tpu.models import ur5e as jur5e
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp import geometry as tgeom
from osqp_solver_tpu_torch.gomp import honest_batch as thonest
from osqp_solver_tpu_torch.gomp import trajectory as ttraj
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttqp
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import _ARRAY_FIELDS
from osqp_solver_tpu_torch.models import ur5e as tur5e

from test_torch_helpers import assert_close

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
TOL = dict(rtol=1e-10, atol=1e-10)
W, N = 12, 6


@pytest.mark.parametrize("frame", ["tool", "back6", "elbow"])
def test_fk_jacobian_points(frame):
    q = np.random.default_rng(0).uniform(-3, 3, (5, 4, 6))
    jp, jj = jur5e.fk_jacobian_points(jnp.asarray(q), frame)
    tp, tj = tur5e.fk_jacobian_points(torch.from_numpy(q), frame)
    assert_close(tp, jp, **TOL)
    assert_close(tj, jj, **TOL)
    # Joint axis in the middle: the batch-trailing form the assembly uses.
    tp2, tj2 = tur5e.fk_jacobian_points(
        torch.from_numpy(q).movedim(-1, 1).contiguous(), frame, axis=1)
    assert_close(tp2.movedim(1, -1), jp, **TOL)
    assert_close(tj2.movedim(1, -1).movedim(1, -1), jj, **TOL)


def test_make_ball_and_warm_start():
    ball = tur5e.make_ball("tool", 0.05, is_gripper=True)
    assert ball.is_gripper and ball.radius == 0.05
    q = torch.zeros(2, 6, dtype=torch.float64)
    assert_close(ball.fk_jac_batched(q)[0],
                 jur5e.fk_jacobian_points(jnp.zeros((2, 6)), "tool")[0], **TOL)
    a, b = np.linspace(0, 1, 6), np.linspace(2, 3, 6)
    assert_close(ttraj.calc_warm_start(a, b, W), jtraj.calc_warm_start(a, b, W))
    assert_close(ttraj.linspace_configs(a, b, 5), jtraj.linspace_configs(a, b, 5))
    ab = np.stack([a, a + 1], axis=-1), np.stack([b, b - 1], axis=-1)
    got = ttraj.calc_warm_start_batched(*(torch.from_numpy(v) for v in ab), W)
    for i in range(2):
        assert_close(got[:, i], jtraj.calc_warm_start_jnp(
            jnp.asarray(ab[0][:, i]), jnp.asarray(ab[1][:, i]), W), **TOL)


@pytest.mark.parametrize("below", [False, True])
def test_horizontal_line(below):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.6, 0.6, (W, 3))
    jac = rng.normal(size=(W, 3, N))
    jq = rng.normal(size=(W, 3))
    jl = jgeom.HorizontalLine.create((0.3, 1.0), (0.1, 0.0, 0.15), below)
    tl = tgeom.HorizontalLine.create((0.3, 1.0), (0.1, 0.0, 0.15), below)
    tp = torch.from_numpy(pts)
    for name in ("distance_vec", "distance_vec_xy", "distance_xy",
                 "closest_point"):
        assert_close(getattr(tl, name)(tp), getattr(jl, name)(jnp.asarray(pts)),
                     **TOL)
    for r in (0.05, 0.3):
        assert_close(tl.has_collision(tp, r), jl.has_collision(jnp.asarray(pts), r))
        assert_close(tl.is_above(tp, r), jl.is_above(jnp.asarray(pts), r))
        assert_close(tl.violates(tp, r), jl.violates(jnp.asarray(pts), r))
        got = tgeom.call_linearize_rows(
            tl, tp, torch.from_numpy(jac), torch.from_numpy(jq), r,
            movable=torch.ones(W, dtype=torch.bool))
        ref = jgeom.call_linearize_rows(
            jl, jnp.asarray(pts), jnp.asarray(jac), jnp.asarray(jq), r)
        for a, b in zip(got, ref):
            assert_close(a, b, **TOL)
    assert bool(tl.bypass_from_below) == below
    # Some waypoint is flagged and some is not, so both row kinds are hit.
    flags = np.asarray(jl.has_collision(jnp.asarray(pts), 0.3))
    assert flags.any() and not flags.all()


@jax.jit
def _jax_problem(i, dtype=jnp.float64):
    """The JAX package's boxed and linearized problems of shift ``i``, one
    compiled program for every ``i`` instead of ~80 eager ops a call."""
    balls = (jur5e.make_ball("back6", 0.15),
             jur5e.make_ball("tool", 0.05, is_gripper=True))
    obstacles = [jgeom.HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15))]
    con3d = (jnp.asarray([-1e30, -0.4, -1e30]), jnp.asarray([1e30, 0.9, 1e30]))
    start = 0.3 * jnp.sin(jnp.arange(N, dtype=dtype) + i)
    end = jnp.asarray([2.5, 0, 0.4, 0, 0, 0], dtype) + 0.1 * i
    base = jtqp.empty_trajectory_qp(W, N, (False, True), 1, dtype)
    qp = jtqp.with_gomp_boxes(
        base, start, end, (jnp.full(N, -6.0), jnp.full(N, 6.0)),
        (jnp.full(N, -0.3), jnp.full(N, 1e30)),
        (jnp.full(N, -1e30), jnp.full(N, 0.1)))
    warm = jtraj.calc_warm_start_jnp(start, end, W)
    return qp, jtqp.linearize_workspace(qp, balls, obstacles, con3d, warm), (
        start, end, warm)


@pytest.mark.parametrize("batched", [False, True])
def test_constructors_match_reference(batched):
    idx = [0.0, 1.0, 2.0] if batched else [1.0]
    refs = [_jax_problem(i) for i in idx]
    bs = (len(idx),) if batched else ()

    def stack(k):  # per-problem (N,) / (2WN,) inputs, batch trailing
        vals = [np.asarray(r[2][k]) for r in refs]
        return torch.tensor(np.stack(vals, -1) if batched else vals[0])

    f64 = dict(dtype=torch.float64)
    base = ttqp.empty_trajectory_qp(W, N, (False, True), 1, batch_shape=bs)
    boxed = ttqp.with_gomp_boxes(
        base, stack(0), stack(1),
        (torch.full((N,), -6.0, **f64), torch.full((N,), 6.0, **f64)),
        (torch.full((N,), -0.3, **f64), torch.full((N,), 1e30, **f64)),
        (torch.full((N,), -1e30, **f64), torch.full((N,), 0.1, **f64)))
    balls = (tur5e.make_ball("back6", 0.15),
             tur5e.make_ball("tool", 0.05, is_gripper=True))
    obstacles = [tgeom.HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15))]
    con3d = (torch.tensor([-1e30, -0.4, -1e30], **f64),
             torch.tensor([1e30, 0.9, 1e30], **f64))
    full = ttqp.linearize_workspace(boxed, balls, obstacles, con3d, stack(2))
    assert full.p_structure == "vel_diag" and full.batch_shape == bs
    for stage, (got, which) in enumerate(((boxed, 0), (full, 1))):
        for k in _ARRAY_FIELDS:
            want = [np.asarray(getattr(r[which], k)) for r in refs]
            want = np.stack(want, -1) if batched else want[0]
            assert_close(getattr(got, k), want, **TOL)


@pytest.mark.parametrize("build", ["build_honest_batch", "build_box_batch"])
def test_benchmark_batches_match_reference(build):
    ref = jax.jit(lambda: getattr(bench, build)(8, W, N, jnp.float64))()
    got = getattr(thonest, build)(8, W, N, torch.float64, "cpu")
    s_ref, a_ref = convert.lane_qp_to_numpy(ref)
    s_got, a_got = convert.lane_qp_to_numpy(got)
    assert s_got == s_ref
    for k in _ARRAY_FIELDS:
        assert_close(a_got[k], a_ref[k], **TOL)
    assert got.row_layout == "waypoint" and got.batch == 8


def test_batch_assembly_needs_an_explicit_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError):
        thonest.build_honest_batch(2, W, N, torch.float64)
    with pytest.raises(ValueError):
        thonest.build_honest_batch(2, W, 3, torch.float64, "cpu")
