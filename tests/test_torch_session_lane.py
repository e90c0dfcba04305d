"""PyTorch port vs JAX package: batched lane sessions (``ops/session_lane.py``).

The JAX package runs its sessions on the unfused path
(``Settings(fused_chunk="off")``); the port runs each of its forms on the CPU
— the packed chunk in the ``hrec`` and ``gain`` factor forms, the unfused
path (``fused_chunk="off"``), and the ``"type"`` row layout — and must give
equal statuses and ADMM iteration counts, solutions within 1e-7.  f64,
honest class, W=20, B=8.  The JAX runs (all in the waypoint layout: the
row order changes no count) are cached per module: each is made once and
compared with every form.  The device rule and the path choice are
``test_torch_session_lane_api.py``'s."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops import session_lane as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.trajectory_qp import TrajectoryQP
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import (
    _ARRAY_FIELDS,
    LaneFactor,
)
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import assert_close, to_np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
B, W, N, T = 8, 20, 6, 3
# The fleet benchmark's settings (benchmarks/mpc_fleet.py).
FLEET = dict(rho=0.05, check_termination=5, adaptive_rho_interval=51)
S_JAX = dataclasses.replace(jadmm.Settings(), fused_chunk="off", **FLEET)
FORMS = {
    "hrec": dict(factor_form="hrec"),
    "gain": dict(factor_form="gain"),
    "unfused": dict(fused_chunk="off"),
    "type": {},  # the "type" row layout reaches the unfused path by itself
}
# Goal shifts per tick (classification-stable: equalities stay equalities),
# applied to the goal equality, which ``with_gomp_boxes`` puts at waypoint
# W-3 (the last two waypoints' position rows are loose).
GOAL = -3
DELTAS = 5e-3 * np.sin(0.3 * np.arange(T)[:, None, None]
                       + np.arange(N)[None, :, None])
_CACHE = {}


def _settings(form):
    return dataclasses.replace(tadmm.Settings(), **FLEET, **FORMS[form])


def _layout(form):
    return "type" if form == "type" else "waypoint"


def _problems(layout):
    """The honest batch in both frameworks, in one row layout."""
    if "qp" not in _CACHE:
        jqp = jax.jit(lambda: bench.build_honest_batch(B, W, N,
                                                       jnp.float64))()
        _CACHE["qp"] = (jqp, convert.lane_qp_from_numpy(
            *convert.lane_qp_to_numpy(jqp)))
    jqp, tqp = _CACHE["qp"]
    return jqp.replace(row_layout=layout), tqp.replace(row_layout=layout)


def _jax(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _jax_solved():
    """A JAX session set up and solved once, and that solve's result."""
    jqp, _ = _problems("waypoint")
    return _jax("solved", lambda: jax.jit(lambda q: jsess.solve_lane(
        jsess.setup_lane(q, S_JAX), S_JAX))(jqp))


def _shift_jax(base, d):
    d = jnp.asarray(d)
    return base.replace(pos_l=base.pos_l.at[GOAL].add(d),
                        pos_u=base.pos_u.at[GOAL].add(d))


def _shift(base, d):
    d = torch.as_tensor(d, dtype=base.dtype)
    pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
    pos_l[GOAL] += d
    pos_u[GOAL] += d
    return base.replace(pos_l=pos_l, pos_u=pos_u)


def _same_counts(got, ref):
    np.testing.assert_array_equal(to_np(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(to_np(got.iterations),
                                  np.asarray(ref.iterations))
    assert_close(got.x, ref.x, rtol=1e-7, atol=1e-7)


def _batch_leading(tqp):
    """The same problems as a batch-leading ``TrajectoryQP`` (what the JAX
    package's vmapped assembly returns), for ``setup_lane``'s ``to_lane``."""
    return TrajectoryQP(
        waypoints=tqp.waypoints, n_dim=tqp.n_dim,
        gripper_flags=tqp.gripper_flags, n_obstacles=tqp.n_obstacles,
        p_structure=tqp.p_structure,
        **{k: getattr(tqp, k).movedim(-1, 0).contiguous()
           for k in _ARRAY_FIELDS})


def _setup(form):
    _, tqp = _problems(_layout(form))
    qps = _batch_leading(tqp) if form == "type" else tqp
    return tsess.setup_lane(qps, _settings(form), device="cpu")


@pytest.mark.parametrize("form", list(FORMS))
def test_setup_solve_matches_reference(form):
    """One session solve equals the JAX session's and the port's own
    batched solve; the session caches the factor in its path's form."""
    layout = _layout(form)
    _, tqp = _problems(layout)
    ref = _jax_solved()[1]
    s = _settings(form)
    sess = _setup(form)
    assert sess.scaled.row_layout == layout
    if form in ("hrec", "gain"):
        cholp, gainp = sess.factor
        assert (gainp is None) == (form == "hrec")
        assert sess.cache is not None
    else:
        assert isinstance(sess.factor, LaneFactor) and sess.cache is None
    sess, res = tsess.solve_lane(sess, s)
    _same_counts(res, ref)
    assert (to_np(res.status) == ExitCode.kOptimal).all()
    direct = tdrv.solve_batched_lane(tqp, s, device="cpu")
    np.testing.assert_array_equal(to_np(res.iterations),
                                  to_np(direct.iterations))
    assert_close(res.x, direct.x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("form", list(FORMS))
def test_mpc_scan_matches_manual_loop_and_reference(form):
    """``mpc_scan_lane`` over T ticks: (T, B) statuses and iterations equal
    to the JAX scan and to a manual update/solve loop; the scan adds no
    device read beyond its solves' one per chunk, and warm ticks need no
    more iterations than the cold one (but more than one chunk: the goal
    really moves)."""
    jqp, _ = _problems("waypoint")

    def ref_fn():
        out = jax.jit(lambda q: jsess.mpc_scan_lane(
            jsess.setup_lane(q, S_JAX), jnp.asarray(DELTAS), _shift_jax,
            S_JAX, emit="full")[1])(jqp)
        return tuple(np.asarray(a) for a in out)

    st_j, it_j, x_j = _jax("scan", ref_fn)
    s = _settings(form)
    sess0 = _setup(form)
    syncs = tdrv.HOST_SYNCS
    _, (st, it, x) = tsess.mpc_scan_lane(sess0, torch.from_numpy(DELTAS),
                                         _shift, s, emit="full")
    chunks = sum(-(-int(m) // s.check_termination) for m in it.max(dim=1)[0])
    assert tdrv.HOST_SYNCS - syncs == chunks
    assert tuple(st.shape) == tuple(it.shape) == (T, B)
    assert tuple(x.shape) == (T, B, 2 * W * N)
    np.testing.assert_array_equal(to_np(st), st_j)
    np.testing.assert_array_equal(to_np(it), it_j)
    assert_close(x, x_j, rtol=1e-7, atol=1e-7)
    assert (to_np(st) == ExitCode.kOptimal).all()
    assert (it[1:] <= it[0]).all() and (it[1:] > s.check_termination).all()

    sess = sess0
    for t in range(T):
        shifted = _shift(sess.base, DELTAS[t])
        sess = tsess.update_bounds_lane(sess, pos_l=shifted.pos_l,
                                        pos_u=shifted.pos_u)
        sess, r = tsess.solve_lane(sess, s)
        np.testing.assert_array_equal(to_np(r.status), to_np(st[t]))
        np.testing.assert_array_equal(to_np(r.iterations), to_np(it[t]))
    with pytest.raises(ValueError):
        tsess.mpc_scan_lane(sess0, torch.from_numpy(DELTAS), _shift, s,
                            emit="x")


@pytest.mark.parametrize("form", ["hrec", "gain", "unfused"])
def test_guard_refactors_exactly_when_a_row_flips(form):
    """A guarded classification-stable shift keeps the factor (the same
    object); a guarded update that turns problem 0's goal equality into a
    box refactors the whole batch, as the JAX guard does; each guarded
    update reads the device once; unguarded updates never refactor."""
    flip = 50.0

    def ref_fn():
        def flipped(se):  # the guarded update and its solve, one program
            pos_u = se.base.pos_u.at[GOAL, :, 0].add(flip)
            se = jsess.update_bounds_lane(se, guard_reclassification=True,
                                          settings=S_JAX, pos_u=pos_u)
            return jsess.solve_lane(se, S_JAX)[1]
        return jax.jit(flipped)(_jax_solved()[0])

    ref = _jax("guard", ref_fn)
    s = _settings(form)
    sess, _ = tsess.solve_lane(_setup(form), s)

    syncs = tdrv.HOST_SYNCS
    stable = tsess.update_bounds_lane(
        sess, guard_reclassification=True, settings=s,
        pos_l=sess.base.pos_l + 1e-4, pos_u=sess.base.pos_u + 1e-4)
    assert stable.factor is sess.factor
    assert tdrv.HOST_SYNCS - syncs == 1

    pos_u = sess.base.pos_u.clone()
    pos_u[GOAL, :, 0] += flip
    unguarded = tsess.update_bounds_lane(sess, pos_u=pos_u)
    assert unguarded.factor is sess.factor
    assert tdrv.HOST_SYNCS - syncs == 1
    guarded = tsess.update_bounds_lane(sess, guard_reclassification=True,
                                       settings=s, pos_u=pos_u)
    assert guarded.factor is not sess.factor
    assert tdrv.HOST_SYNCS - syncs == 2
    _, res = tsess.solve_lane(guarded, s)
    _same_counts(res, ref)
    assert (to_np(res.status) == ExitCode.kOptimal).all()


@pytest.mark.parametrize("kind", ["blocks", "packed_hrec", "packed_gain"])
def test_jax_session_continued_by_port(kind):
    """A session the JAX package set up and advanced one tick, handed over
    as numpy arrays (``lane_session_to_numpy`` / ``lane_session_from_numpy``),
    continues in the port with the JAX package's counts.  The packed kinds
    carry the JAX factor packed as the fused path consumes it, and the JAX
    package's kernel packs as the cache."""
    def ref_fn():
        def shifted(se):  # the update and its solve, one program
            b = _shift_jax(se.base, DELTAS[1])
            se = jsess.update_bounds_lane(se, pos_l=b.pos_l, pos_u=b.pos_u)
            return jsess.solve_lane(se, S_JAX)[1]
        js = _jax_solved()[0]
        return js, convert.lane_session_to_numpy(js), jax.jit(shifted)(js)

    js, data, ref = _jax("carry", ref_fn)
    assert data["factor"][0] == "blocks" and data["cache"] is None
    form = {"blocks": "unfused", "packed_hrec": "hrec",
            "packed_gain": "gain"}[kind]
    if kind != "blocks":
        (cholp, gainp), cache = _jax("packs", lambda: jax.jit(
            lambda se: (jfused.pack_factor(se.scaled, se.factor),
                        jdrv.build_const_packs(se.scaled, se.scaling)))(js))
        data = dict(data, factor=(
            "packed", np.asarray(cholp),
            None if form == "hrec" else np.asarray(gainp)),
            cache={k: np.asarray(v) for k, v in cache.items()})
    sess = convert.lane_session_from_numpy(data, device="cpu")
    assert_close(sess.rho_bar, js.rho_bar)
    assert_close(sess.warm_x, js.warm_x)
    s = _settings(form)
    shifted = _shift(sess.base, DELTAS[1])
    sess = tsess.update_bounds_lane(sess, pos_l=shifted.pos_l,
                                    pos_u=shifted.pos_u)
    _, res = tsess.solve_lane(sess, s)
    _same_counts(res, ref)
    back = convert.lane_session_to_numpy(sess)
    assert back["factor"][0] == ("blocks" if kind == "blocks" else "packed")
    with pytest.raises(ValueError):
        convert.lane_session_from_numpy(dict(data, factor=("dense", 0, 0)),
                                        device="cpu")
