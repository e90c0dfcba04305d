"""PyTorch port vs JAX package: solver sessions on the generic path
(``ops/session.py``: ``setup``, ``solve``, ``update``, ``update_bounds``
guarded and unguarded, ``mpc_scan``) on BASELINE config 4's dense QP and on
a W=10 trajectory QP.  f64, CPU: statuses and ADMM iteration counts EQUAL
to the JAX package's ``ops/session.py``, solutions within 1e-8."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import qp as jqp
from osqp_solver_tpu.ops import session as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import session as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_admm import both_trajectory, settings_pair, trajectory_batch
from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def config4():
    """BASELINE config 4's QP: n=8 identity, box [-1, 1], q = 0."""
    n = 8
    return (np.eye(n), np.zeros(n), np.eye(n), -np.ones(n), np.ones(n))


def both_config4():
    arrays = config4()
    return (jqp.dense_qp(*arrays),
            convert.dense_qp_from_numpy(*arrays, device="cpu"))


def shift_box(base, s):
    return base.replace(l=-1.0 + s, u=1.0 + s)


@functools.lru_cache(maxsize=None)
def jax_calls(js):
    """The JAX package's ``setup`` and ``solve`` under ``jax.jit`` for the
    settings ``js``: one program each, not op by op."""
    return (jax.jit(lambda q: jsess.setup(q, js)),
            jax.jit(lambda se: jsess.solve(se, js)))


def assert_same(jres, tres, tol=1e-8):
    np.testing.assert_array_equal(to_np(tres.status), np.asarray(jres.status))
    np.testing.assert_array_equal(to_np(tres.iterations),
                                  np.asarray(jres.iterations))
    for k in ("x", "y"):
        assert_close(getattr(tres, k), getattr(jres, k), rtol=tol, atol=tol)


def test_setup_solve_update_match_jax():
    """Cold solve, a warm re-solve, then new values (q and A changed, the
    factor recomputed) and another re-solve: each result equal."""
    jq, tq = both_config4()
    js, ts = settings_pair()
    jsetup, jsolve = jax_calls(js)
    jse = jsetup(jq)
    tse = tsess.setup(tq, ts, device="cpu")
    for _ in range(2):
        jse, jres = jsolve(jse)
        tse, tres = tsess.solve(tse, ts)
        assert_same(jres, tres)
    rng = np.random.default_rng(0)
    q = rng.normal(size=8)
    A = np.eye(8) + 0.1 * rng.normal(size=(8, 8))
    jse = jax.jit(lambda se, q: jsess.update(se, q, settings=js))(
        jse, jq.replace(q=jnp.asarray(q), A=jnp.asarray(A)))
    tse = tsess.update(tse, tq.replace(q=torch.from_numpy(q),
                                       A=torch.from_numpy(A)), settings=ts)
    jse, jres = jsolve(jse)
    tse, tres = tsess.solve(tse, ts)
    assert_same(jres, tres)
    assert int(tres.status) == ExitCode.kOptimal
    assert_close(tse.rho_bar, jse.rho_bar, rtol=1e-12)


@pytest.mark.parametrize("guard", [False, True])
def test_update_bounds_matches_jax(guard):
    """A classification-stable shift, then a shift that turns row 0 into an
    equality: the guarded update refactors exactly on the flip, after one
    device read each; unguarded, the cached factor is kept (and both
    packages re-solve alike either way)."""
    jq, tq = both_config4()
    js, ts = settings_pair()
    jsetup, jsolve = jax_calls(js)
    jse, tse = jsetup(jq), tsess.setup(tq, ts, device="cpu")
    jse, _ = jsolve(jse)
    tse, _ = tsess.solve(tse, ts)
    l1, u1 = -0.9 * np.ones(8), 1.1 * np.ones(8)
    l2, u2 = l1.copy(), u1.copy()
    l2[0] = u2[0] = 0.25
    for l, u, flips in ((l1, u1, False), (l2, u2, True)):
        s0 = tadmm.HOST_SYNCS
        before = tse.factor
        jse = jsess.update_bounds(jse, guard, js, l=jnp.asarray(l),
                                  u=jnp.asarray(u))
        tse = tsess.update_bounds(tse, guard, ts, l=l, u=u)
        assert tadmm.HOST_SYNCS - s0 == int(guard)
        assert (tse.factor is before) == (not (guard and flips))
        jse, jres = jsolve(jse)
        tse, tres = tsess.solve(tse, ts)
        assert_same(jres, tres)


def test_mpc_scan_matches_jax():
    """Config 4's sweep (40 of its bound shifts): per-step statuses,
    iteration counts and solutions equal; the scan reads the device only
    in its solves (one read per chunk)."""
    jq, tq = both_config4()
    js, ts = settings_pair()
    shifts = np.linspace(0.0, 0.3, 40)[:, None] * np.ones(8)
    jse = jax_calls(js)[0](jq)
    _, (jx, jst, jit) = jsess.mpc_scan(jse, jnp.asarray(shifts), shift_box, js)
    tse = tsess.setup(tq, ts, device="cpu")
    s0 = tadmm.HOST_SYNCS
    end, (tx, tst, tit) = tsess.mpc_scan(tse, torch.from_numpy(shifts),
                                         shift_box, ts)
    np.testing.assert_array_equal(to_np(tst), np.asarray(jst))
    np.testing.assert_array_equal(to_np(tit), np.asarray(jit))
    assert_close(tx, jx, rtol=1e-8, atol=1e-8)
    assert tadmm.HOST_SYNCS - s0 == int(tit.sum()) // ts.check_termination
    assert end.factor is tse.factor  # the cached factor served every step
    assert tuple(tx.shape) == (40, 8)


def test_trajectory_session_matches_jax():
    """A W=10 trajectory QP session: the goal equality (waypoint W-3) moves
    each step, warm-started re-solves on the cached factor."""
    static, arrays = trajectory_batch(B=1, seed=4)
    jq, tq = both_trajectory(static, {k: v[0] for k, v in arrays.items()})
    js, ts = settings_pair(check_termination=5)
    goal = static["waypoints"] - 3
    deltas = 1e-3 * np.sin(np.arange(8))[:, None] * np.ones(6)

    def jshift(base, d):
        return base.replace(pos_l=base.pos_l.at[goal].add(d),
                            pos_u=base.pos_u.at[goal].add(d))

    def tshift(base, d):
        pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
        pos_l[goal] += d
        pos_u[goal] += d
        return base.replace(pos_l=pos_l, pos_u=pos_u)

    _, (jx, jst, jit) = jax.jit(lambda q, d: jsess.mpc_scan(
        jsess.setup(q, js), d, jshift, js))(jq, jnp.asarray(deltas))
    _, (tx, tst, tit) = tsess.mpc_scan(tsess.setup(tq, ts, device="cpu"),
                                       torch.from_numpy(deltas), tshift, ts)
    np.testing.assert_array_equal(to_np(tst), np.asarray(jst))
    np.testing.assert_array_equal(to_np(tit), np.asarray(jit))
    assert (to_np(tst) == ExitCode.kOptimal).all()
    assert_close(tx, jx, rtol=1e-8, atol=1e-8)


def test_batched_session_and_warm_setup():
    """A batch of two sessions stepped together, set up warm from a
    solution: the result is batch-leading, and the warm start converges at
    the first check."""
    arrays = tuple(np.stack([a, a]) for a in config4())
    tq = convert.dense_qp_from_numpy(*arrays, device="cpu")
    _, ts = settings_pair()
    cold = tadmm.solve_batched(tq, ts, device="cpu")
    sess = tsess.setup(tq, ts, warm_x=cold.x, warm_y=cold.y, device="cpu")
    assert sess.batched and tuple(sess.warm_x.shape) == (8, 2)
    _, res = tsess.solve(sess, ts)
    assert tuple(res.x.shape) == (2, 8)
    assert (res.iterations == ts.check_termination).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsess.setup(tq, ts)
    with pytest.raises(NotImplementedError):
        tsess.setup(tq, dataclasses.replace(ts, anderson=1), device="cpu")
