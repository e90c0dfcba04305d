"""PyTorch port vs JAX package: sphere and capsule keep-outs, per-query
obstacle stacks, and the horizon-masked assembly (``with_horizon_mask``,
``with_gomp_boxes_masked``, ``pinned_movable_mask``,
``linearize_workspace(w_active=...)``, ``calc_warm_start_masked``).  Same
numpy inputs through both packages; f64, CPU, 1e-12 (the formulas are the
same, only reduction order inside norms and dot products differs)."""
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
from osqp_solver_tpu_torch.gomp import trajectory as ttraj
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttqp
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import _ARRAY_FIELDS
from osqp_solver_tpu_torch.models import ur5e as tur5e

from test_torch_helpers import assert_close, jit_vmap, to_np

pytestmark = pytest.mark.torch_port
TOL = dict(rtol=1e-12, atol=1e-12)
W, N, B = 9, 4, 3
R_BALL = 0.05


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _port(obstacle, per_query=False):
    return convert.obstacle_from_numpy(
        *convert.obstacle_to_numpy(obstacle), per_query=per_query)


def _trajectory(seed, hop=False):
    """(W, 3) points wandering through the obstacles' neighbourhood; with
    ``hop`` two consecutive waypoints straddle the origin so that a segment
    tunnels through an obstacle there."""
    rng = np.random.default_rng(seed)
    pts = np.linspace([-0.6, -0.1, 0.05], [0.6, 0.2, -0.05], W)
    pts += 0.08 * rng.standard_normal((W, 3))
    if hop:
        pts[3] = [-0.22, 0.01, 0.0]
        pts[4] = [0.24, -0.01, 0.02]
    return pts


OBSTACLES = {
    "sphere": jgeom.SphereObstacle.create([0.0, 0.02, 0.0], radius=0.15,
                                          margin=0.2),
    "capsule": jgeom.CapsuleObstacle.create([0.0, -0.5, 0.0], [0.05, 0.5, 0.0],
                                            radius=0.12, margin=0.15),
}


def _protocol(obs, pts, jac, jq, movable, lib):
    """Every geometric output of one obstacle on one trajectory."""
    rel, d, t = obs.segment_closest(pts)
    out = {"segment_rel": rel, "segment_dist": d, "segment_t": t,
           "violates": obs.violates(pts, R_BALL)}
    for tag, mv in (("", None), ("_movable", movable)):
        rows = lib.call_linearize_rows(obs, pts, jac, jq, R_BALL, movable=mv)
        out.update({f"row{tag}": rows[0], f"low{tag}": rows[1],
                    f"upp{tag}": rows[2]})
    return out


@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("kind", ["sphere", "capsule"])
def test_keepout_shared_matches_reference(kind, hop):
    rng = np.random.default_rng(5)
    pts = _trajectory(1, hop)
    jac, jq = rng.normal(size=(W, 3, N)), rng.normal(size=(W, 3))
    movable = np.ones(W, bool)
    movable[[0, 4]] = False
    jobs, tobs = OBSTACLES[kind], _port(OBSTACLES[kind])
    ref = jax.jit(lambda *a: _protocol(jobs, *a, jgeom))(
        jnp.asarray(pts), jnp.asarray(jac), jnp.asarray(jq),
        jnp.asarray(movable))
    got = _protocol(tobs, _t(pts), _t(jac), _t(jq), torch.from_numpy(movable),
                    tgeom)
    for name in ref:
        assert_close(got[name], ref[name], **TOL)
    assert_close(tobs.distance(_t(pts)), jobs.distance(jnp.asarray(pts)), **TOL)
    if hop:  # the tunnel is seen, and cut by a relative (segment) row
        v = to_np(got["violates"])
        assert v[3] and v[4]
        assert not np.allclose(to_np(got["low"]), to_np(got["low_movable"]))
    live = to_np(got["low"]) > -1e29
    assert live.any() and not live.all()  # live and dummy rows both present


@pytest.mark.parametrize("kind", ["sphere", "capsule", "line"])
def test_per_query_stack_matches_reference_vmap(kind):
    """B obstacles, B trajectories: the JAX package vmaps over a LEADING
    axis, the port broadcasts a TRAILING one."""
    rng = np.random.default_rng(6)
    if kind == "sphere":
        each = [jgeom.SphereObstacle.create(
            0.05 * rng.standard_normal(3), radius=0.1 + 0.03 * b, margin=0.2)
            for b in range(B)]
    elif kind == "capsule":
        each = [jgeom.CapsuleObstacle.create(
            [0.0, -0.5, 0.0] + 0.05 * rng.standard_normal(3),
            [0.0, 0.5, 0.0] + 0.05 * rng.standard_normal(3), radius=0.1)
            for _ in range(B)]
    else:
        each = [jgeom.HorizontalLine.create(
            (0.2 * b, 1.0), (0.05 * b, 0.0, 0.02 * b), bool(b % 2))
            for b in range(B)]
    jstack = jgeom.stack_obstacles(each)
    tstack = _port(jstack, per_query=True)
    same = tgeom.stack_obstacles([_port(o) for o in each])
    for name, leaf in tgeom.obstacle_leaves(tstack).items():
        assert_close(getattr(same, name), leaf)
        assert leaf.shape[-1] == B
    pts = np.stack([_trajectory(10 + b, hop=b == 1) for b in range(B)])
    jac, jq = rng.normal(size=(B, W, 3, N)), rng.normal(size=(B, W, 3))
    movable = np.ones(W, bool)
    movable[[0, W - 3]] = False
    ref_v = jit_vmap(lambda o, p: o.violates(p, R_BALL))(jstack,
                                                         jnp.asarray(pts))
    ref_rows = jit_vmap(
        lambda o, p, j, q: jgeom.call_linearize_rows(
            o, p, j, q, R_BALL, movable=jnp.asarray(movable))
    )(jstack, jnp.asarray(pts), jnp.asarray(jac), jnp.asarray(jq))
    tp = _t(pts).movedim(0, -1)
    got_v = tstack.violates(tp, R_BALL)
    got_rows = tgeom.call_linearize_rows(
        tstack, tp, _t(jac).movedim(0, -1), _t(jq).movedim(0, -1), R_BALL,
        movable=torch.from_numpy(movable))
    assert_close(got_v.movedim(-1, 0), ref_v)
    for g, r in zip(got_rows, ref_rows):
        assert_close(g.movedim(-1, 0), r, **TOL)


def test_capsule_reference_cases():
    """The closed-form cases of the JAX package's capsule tests, as data."""
    cap = tgeom.CapsuleObstacle.create([0, 0, 0], [1, 0, 0], radius=0.2)
    assert_close(cap.distance(_t([0.5, 0.3, 0.0])), 0.3, atol=1e-12)
    assert_close(cap.distance(_t([1.4, 0.3, 0.0])), np.hypot(0.4, 0.3),
                 atol=1e-12)
    assert_close(cap.axis_closest(_t([-2.0, 1.0, 0.0])), [0, 0, 0], atol=1e-12)
    rel, d, t = cap.segment_closest(_t([[0.5, -1.0, 0.4], [0.5, 1.0, 0.4]]))
    assert_close(d[0], 0.4, atol=1e-9)
    assert_close(t[0], 0.5, atol=1e-9)
    assert_close(rel[0], [0, 0, 0.4], atol=1e-9)
    _, d, _ = cap.segment_closest(_t([[2.0, -1.0, 0.0], [2.0, 1.0, 0.0]]))
    assert_close(d[0], 1.0, atol=1e-9)  # corner region: to (1, 0, 0)
    _, d, _ = cap.segment_closest(_t([[0.2, 0.0, 0.5], [0.8, 0.0, 0.5]]))
    assert_close(d[0], 0.5, atol=1e-9)  # parallel segments
    cap = tgeom.CapsuleObstacle.create([0, -1, 0], [0, 1, 0], radius=0.2)
    assert bool(cap.violates(_t([[0.2, 0.0, 0.0]]), R_BALL)[0])
    assert not bool(cap.violates(_t([[0.5, 0.0, 0.0]]), R_BALL)[0])
    assert cap.violates(_t([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]]), R_BALL).all()
    assert not cap.violates(
        _t([[-0.5, 0.0, 0.5], [0.5, 0.0, 0.5]]), R_BALL).any()


def test_stacking_errors_and_line_table():
    s = tgeom.SphereObstacle.create([0, 0, 0], 0.1)
    line = tgeom.HorizontalLine.create([0, 1], [0.5, 0.0, 0.4], False)
    with pytest.raises(TypeError, match="one type"):
        tgeom.stack_obstacles([s, line])
    with pytest.raises(ValueError, match="per-query"):
        tgeom.stack_obstacles([s, s]).distance(torch.zeros(5, 3, 7))
    with pytest.raises(TypeError):
        convert.obstacle_from_numpy("Cube", {})
    jl = [jgeom.HorizontalLine.create([0, 1], [0.5, 0.0, 0.4], False),
          jgeom.HorizontalLine.create([1, 1], [0.1, 0.2, 0.3], True)]
    ref = jgeom.stack_lines(jl)
    got = tgeom.stack_lines([_port(l) for l in jl])
    for name in ("direction", "point", "bypass_below"):
        assert_close(getattr(got, name), getattr(ref, name), **TOL)
    assert tgeom.stack_lines([]).direction.shape == (0, 3)
    moved = s.to(dtype=torch.float32)
    assert moved.center.dtype == torch.float32 and moved.radius.dtype == torch.float32


# ------------------------------------------------------- masked assembly


def _masked_reference(i, wa, obstacles, dtype=jnp.float64):
    WM, NJ = 10, 6
    balls = (jur5e.make_ball("back6", 0.15),
             jur5e.make_ball("tool", 0.05, is_gripper=True))
    con3d = (jnp.asarray([-1e30, -0.4, -1e30]), jnp.asarray([1e30, 0.9, 1e30]))
    start = 0.3 * jnp.sin(jnp.arange(NJ, dtype=dtype) + i)
    end = jnp.asarray([2.5, 0, 0.4, 0, 0, 0], dtype) + 0.1 * i
    warm = jtraj.calc_warm_start_masked(start, end, WM, wa)
    qp = jtqp.empty_trajectory_qp(WM, NJ, (False, True), len(obstacles), dtype)
    qp = jtqp.with_horizon_mask(qp, wa)
    qp = jtqp.with_gomp_boxes_masked(
        qp, start, end, (jnp.full(NJ, -6.0), jnp.full(NJ, 6.0)),
        (jnp.full(NJ, -0.3), jnp.full(NJ, 1e30)),
        (jnp.full(NJ, -1e30), jnp.full(NJ, 0.1)), wa)
    qp = jtqp.linearize_workspace(
        qp, balls, obstacles, con3d, warm, w_active=wa,
        movable=jtqp.pinned_movable_mask(WM, wa))
    return qp, (start, end, warm)


@pytest.mark.parametrize("wa", [10, 6])
def test_masked_constructors_match_reference(wa):
    WM, NJ = 10, 6
    jobs = [jgeom.HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15)),
            jgeom.SphereObstacle.create([0.3, 0.1, 0.4], radius=0.2, margin=0.3)]
    idx = [0.0, 1.0, 2.0]
    # One compiled program for the three references, not their eager ops.
    reference = jax.jit(lambda i: _masked_reference(i, wa, jobs))
    refs = [reference(i) for i in idx]

    def stack(k):
        return torch.tensor(np.stack([np.asarray(r[1][k]) for r in refs], -1))

    f64 = dict(dtype=torch.float64)
    warm = ttraj.calc_warm_start_masked(stack(0), stack(1), WM, wa)
    assert_close(warm, stack(2), **TOL)
    assert_close(ttqp.pinned_movable_mask(WM, wa),
                 jtqp.pinned_movable_mask(WM, wa))
    assert_close(ttqp.pinned_movable_mask(WM), jtqp.pinned_movable_mask(WM))
    qp = ttqp.empty_trajectory_qp(WM, NJ, (False, True), 2, batch_shape=(3,))
    qp = ttqp.with_horizon_mask(qp, wa)
    qp = ttqp.with_gomp_boxes_masked(
        qp, stack(0), stack(1),
        (torch.full((NJ,), -6.0, **f64), torch.full((NJ,), 6.0, **f64)),
        (torch.full((NJ,), -0.3, **f64), torch.full((NJ,), 1e30, **f64)),
        (torch.full((NJ,), -1e30, **f64), torch.full((NJ,), 0.1, **f64)), wa)
    balls = (tur5e.make_ball("back6", 0.15),
             tur5e.make_ball("tool", 0.05, is_gripper=True))
    con3d = (torch.tensor([-1e30, -0.4, -1e30], **f64),
             torch.tensor([1e30, 0.9, 1e30], **f64))
    qp = ttqp.linearize_workspace(
        qp, balls, [_port(o) for o in jobs], con3d, warm, w_active=wa,
        movable=ttqp.pinned_movable_mask(WM, wa))
    for k in _ARRAY_FIELDS:
        want = np.stack([np.asarray(getattr(r[0], k)) for r in refs], -1)
        assert_close(getattr(qp, k), want, **TOL)
    if wa < WM:  # padding waypoints are inert
        assert (to_np(qp.ws_jac)[:, wa:] == 0).all()
        assert (to_np(qp.P_diag)[wa:] == 0).all()
