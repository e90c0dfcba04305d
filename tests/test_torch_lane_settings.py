"""PyTorch port vs JAX package: the lane driver's ``kkt_refine``, ``polish``
and ``anderson`` settings.

The port runs on the CPU (the kernels' plain versions) and is held to the
JAX package's ``solve_batched_lane`` on its plain path
(``Settings(fused_chunk="off")``) on the same numpy problems: equal
statuses and ADMM iteration counts, solutions within 1e-7.  f64, W ≤ 12,
B ≤ 8: the waypoint-layout batch of ``tests/test_admm_fused.py`` (W=8, N=3,
two balls; its first 8 problems), with and without the block-P objective
of ``tests/test_torch_blockp.py``, and the box class of ``bench.py`` (W=12,
N=6).  ``kkt_refine > 0`` takes the unfused path in both packages; polish
and Anderson run on every path.  The four mechanism tests of
``_anderson_step`` are the JAX package's own (``tests/test_admm_lane.py``),
run through both packages on the same inputs.  Last, the batched planner
plans a float32 horizon above 1024 waypoints (one refinement step per KKT
solve) as the JAX package does."""
import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory_qp_lane as jlane
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops import session_lane as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import LaneTrajectoryQP
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.admm import ADMMState
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_admm_fused import build_wp_batch
from test_torch_blockp import with_block_p
from test_torch_helpers import assert_close, to_np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
B = 8
# The chunk cadence of the reference's own Anderson tests
# (tests/test_admm_lane.py), and their ρ-adaptation case.
AA = dict(check_termination=3, anderson=4)
AA_RHO = dict(AA, adaptive_rho_interval=6, rho=10.0)
_REFS = {}


@functools.lru_cache(maxsize=None)
def _problems(kind):
    """``(jax batch, port batch)`` of one kind, the same numbers in both."""
    if kind == "box":
        jqp = bench.build_box_batch(B, 12, 6, jnp.float64)
    else:
        static, arrays = convert.lane_qp_to_numpy(build_wp_batch(honest=True))
        arrays = {k: v[..., :B] for k, v in arrays.items()}
        jqp = jlane.LaneTrajectoryQP(
            **static, **{k: jnp.asarray(v) for k, v in arrays.items()})
        if kind == "block":
            jqp, _ = with_block_p(jqp)
    return jqp, convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp))


def _reference(kind, overrides):
    key = (kind, tuple(sorted(overrides.items())))
    if key not in _REFS:
        js = dataclasses.replace(jadmm.Settings(), fused_chunk="off",
                                 **overrides)
        _REFS[key] = jdrv.solve_batched_lane(_problems(kind)[0], js)
    return _REFS[key]


def _same(got, ref, tol=1e-7):
    np.testing.assert_array_equal(to_np(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(to_np(got.iterations),
                                  np.asarray(ref.iterations))
    for name in ("x", "y", "z"):
        assert_close(getattr(got, name), getattr(ref, name), rtol=tol,
                     atol=tol)
    for name in ("prim_res", "dual_res"):
        assert_close(getattr(got, name), getattr(ref, name), rtol=1e-8,
                     atol=1e-8)


def _compare(kind, overrides, port_overrides=None):
    """The port's solve (its settings: ``overrides`` and
    ``port_overrides``) against the JAX package's, and the host reads it
    made (one per chunk)."""
    ref = _reference(kind, overrides)
    ts = dataclasses.replace(tadmm.Settings(),
                             **{**overrides, **(port_overrides or {})})
    syncs = tdrv.HOST_SYNCS
    got = tdrv.solve_batched_lane(_problems(kind)[1], ts, device="cpu")
    _same(got, ref)
    ct = ts.check_termination
    chunks = -(-(int(to_np(got.iterations).max()) - ts.termination_warmup)
               // ct)
    assert tdrv.HOST_SYNCS - syncs == chunks
    return got


class _Calls:
    """Counts calls of a method of the port's lane container."""

    def __init__(self, monkeypatch, name):
        self.n = 0
        fn = getattr(LaneTrajectoryQP, name)

        def counted(qp, *a, **kw):
            self.n += 1
            return fn(qp, *a, **kw)
        monkeypatch.setattr(LaneTrajectoryQP, name, counted)


@pytest.mark.parametrize("kind", ["balls", "box"])
@pytest.mark.parametrize("refine", [1, 2])
def test_kkt_refine_matches_reference(kind, refine, monkeypatch):
    """``kkt_refine=k``: the unfused path (whatever ``fused_chunk`` says),
    each KKT solve followed by ``k`` refinement solves."""
    solves = _Calls(monkeypatch, "kkt_solve")
    got = _compare(kind, dict(kkt_refine=refine))
    assert (to_np(got.status) == ExitCode.kOptimal).all()
    assert solves.n == (1 + refine) * int(to_np(got.iterations).max())


@pytest.mark.parametrize("kind,form", [
    ("balls", {}), ("balls", dict(fused_chunk="off")),
    ("box", {}), ("box", dict(fused_chunk="off")),
    ("block", {}), ("block", dict(fused_chunk="off")),
])
def test_polish_matches_reference(kind, form, monkeypatch):
    """``polish=True`` after the loop, fused and unfused, vel-diag and block
    P: one more factor and ``1 + polish_refine_iter`` solves, counted apart
    from the ρ refactors; the polished iterate is taken where it is better."""
    overrides = dict(polish=True, check_termination=5)
    factors = _Calls(monkeypatch, "kkt_factor")
    solves = _Calls(monkeypatch, "kkt_solve")
    before = tdrv.POLISH_FACTORS
    got = _compare(kind, overrides, form)
    assert tdrv.POLISH_FACTORS - before == 1
    plain = tdrv.solve_batched_lane(
        _problems(kind)[1],
        dataclasses.replace(tadmm.Settings(), check_termination=5, **form),
        device="cpu")
    np.testing.assert_array_equal(to_np(got.status), to_np(plain.status))
    if form or kind == "block":
        return  # the unfused and block-P paths factor and solve anyway
    assert factors.n == 1
    assert solves.n == 1 + tadmm.Settings().polish_refine_iter
    # Polish moved the optimal problems' solutions, by a little.
    moved = np.abs(to_np(got.x) - to_np(plain.x)).max()
    assert 0 < moved < 1e-2


@pytest.mark.parametrize("overrides,form", [
    (AA, {}),
    (AA, dict(term_fused="off")),
    (AA, dict(fused_chunk="off")),
    (AA_RHO, {}),
    (AA_RHO, dict(fused_chunk="off")),
], ids=["fused", "term_off", "unfused", "rho_fused", "rho_unfused"])
def test_anderson_matches_reference(overrides, form):
    """``anderson=4`` between chunks: fused (the chunk's termination fused
    and not) and unfused, and with ρ adaptation firing, which resets the
    adapted problems' history."""
    before = tdrv.RHO_REFACTORS
    got = _compare("balls", overrides, form)
    assert (to_np(got.status) == ExitCode.kOptimal).all()
    assert (tdrv.RHO_REFACTORS > before) == ("rho" in overrides)


@pytest.mark.parametrize("overrides", [
    dict(kkt_refine=1), dict(polish=True), AA,
], ids=["kkt_refine", "polish", "anderson"])
def test_lane_session_takes_the_setting(overrides):
    """``setup_lane`` → ``solve_lane`` twice (the goal moved between) with
    each setting, as the JAX package's sessions; polish's factor is counted
    apart, and no ρ refactor or Ruiz runs per tick."""
    jqp, tqp = _problems("box")
    js = dataclasses.replace(jadmm.Settings(), fused_chunk="off", **overrides)
    ts = dataclasses.replace(tadmm.Settings(), **overrides)
    d = 1e-3 * np.arange(6, dtype=float)[:, None]

    jsn = jsess.setup_lane(jqp, js)
    jsn, jr0 = jsess.solve_lane(jsn, js)
    jsn = jsess.update_bounds_lane(
        jsn, pos_l=jsn.base.pos_l.at[-3].add(d),
        pos_u=jsn.base.pos_u.at[-3].add(d))
    _, jr1 = jsess.solve_lane(jsn, js)

    pol, ref = tdrv.POLISH_FACTORS, tdrv.RHO_REFACTORS
    sess = tsess.setup_lane(tqp, ts, device="cpu")
    sess, r0 = tsess.solve_lane(sess, ts)
    pos_l, pos_u = sess.base.pos_l.clone(), sess.base.pos_u.clone()
    pos_l[-3] += torch.from_numpy(d)
    pos_u[-3] += torch.from_numpy(d)
    sess = tsess.update_bounds_lane(sess, pos_l=pos_l, pos_u=pos_u)
    _, r1 = tsess.solve_lane(sess, ts)
    _same(r0, jr0)
    _same(r1, jr1)
    assert (to_np(r1.status) == ExitCode.kOptimal).all()
    assert tdrv.POLISH_FACTORS - pol == (2 if ts.polish else 0)
    assert tdrv.RHO_REFACTORS == ref


# ---------------------------------------------------------------------------
# _anderson_step's mechanism: the JAX package's fixture and cases, the
# same inputs through both packages.
# ---------------------------------------------------------------------------


def _aa_case(case):
    """``(JAX out, port out, JAX in)`` of one step of the reference's
    mechanism tests, on their fixture (``tests/test_admm_lane.py``)."""
    from test_admm_lane import _aa_fixture, _prime_history

    scaled, st, settings, v_out = _aa_fixture()
    st = _prime_history(st, v_out)
    reset = jnp.zeros_like(st.done)
    if case == "rho_reset":
        reset = jnp.ones_like(st.done)
    elif case == "safeguard":
        st = st.replace(aa_vin=st.aa_vin - 10.0)
    else:
        st = st.replace(aa_vin=st.aa_vin - 0.01)
        if case == "done":
            st = st.replace(done=jnp.zeros_like(st.done).at[1].set(True))
    out = jdrv._anderson_step(scaled, st, settings, use_fused=False,
                              reset_mask=reset)

    t = lambda a: torch.from_numpy(np.array(a))
    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(scaled))
    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(
        ADMMState) if f.name != "factor"}
    tst = ADMMState(factor=None, **{
        k: None if v is None else t(v) for k, v in fields.items()})
    ts = dataclasses.replace(tadmm.Settings(), anderson=settings.anderson)
    got = tdrv._anderson_step(tscaled, tst, ts, False, t(reset))
    return out, got, st, tscaled


def _same_step(got, out):
    for name in ("x", "z", "y", "aa_g", "aa_f", "aa_vin", "aa_fnorm"):
        assert_close(getattr(got, name), getattr(out, name), rtol=1e-10,
                     atol=1e-12)
    np.testing.assert_array_equal(to_np(got.aa_n), np.asarray(out.aa_n))


@pytest.mark.parametrize("case", ["rho_reset", "safeguard"])
def test_anderson_reset_mechanism(case):
    """A reset (ρ adapted, or the residual grew past the safeguard): every
    slot refilled with the current pair, the counter back to 1, the plain
    iterate kept exactly."""
    out, got, st, _ = _aa_case(case)
    _same_step(got, out)
    np.testing.assert_array_equal(to_np(got.aa_n), 1)
    v_out = torch.cat([got.x, got.z + got.y / got.rho_vec])
    for s in range(got.aa_g.shape[0]):
        assert_close(got.aa_g[s], v_out, atol=1e-12)
    assert_close(got.x, np.asarray(st.x), atol=1e-12)
    assert_close(got.y, np.asarray(st.y), atol=1e-12)


def test_anderson_accept_extrapolates_consistently():
    """The accept path: the iterate moves, the counter grows, and z, y are
    recovered consistently from w."""
    out, got, st, scaled = _aa_case("accept")
    _same_step(got, out)
    np.testing.assert_array_equal(to_np(got.aa_n), 3)
    assert float((got.x - torch.from_numpy(np.array(st.x))).abs().max()) > 1e-9
    w = got.z + got.y / got.rho_vec
    assert_close(got.z, torch.minimum(torch.maximum(w, scaled.l), scaled.u),
                 atol=1e-12)
    assert_close(got.y, got.rho_vec * (w - got.z), atol=1e-12)


def test_anderson_done_problems_frozen():
    """A done problem keeps its iterate, counter and safeguard norm; the
    live ones move."""
    out, got, st, _ = _aa_case("done")
    _same_step(got, out)
    x0 = torch.from_numpy(np.array(st.x))
    assert_close(got.x[:, 1], x0[:, 1], atol=1e-15)
    assert int(got.aa_n[1]) == int(st.aa_n[1])
    assert float(got.aa_fnorm[1]) == float(st.aa_fnorm[1])
    assert float((got.x[:, 0] - x0[:, 0]).abs().max()) > 1e-9


# ---------------------------------------------------------------------------
# The batched planner above 1024 waypoints in float32.
# ---------------------------------------------------------------------------


def test_run_batch_lane_plans_a_float32_horizon_above_1024(monkeypatch):
    """``run_batch_lane`` at W=1025 in float32 (identity kinematics, N=3,
    two queries): the bumped ``kkt_refine=1`` sends every lane solve to the
    unfused path, two KKT solves per iteration; statuses and SCP rounds
    equal the JAX package's, trajectories within float32 rounding."""
    from osqp_solver_tpu import RobotBall as JBall
    from osqp_solver_tpu import constraints as JC
    from osqp_solver_tpu.gomp.planner import GOMPSolver as JSolver
    from osqp_solver_tpu_torch import GOMPSolver, RobotBall

    from test_torch_planner import _identity_fk_jac, _line_queries

    N, Wl = 3, 1025
    spec = dict(
        max_waypoints=Wl, time_step=0.1,
        pos_con=(np.full(N, -10.0), np.full(N, 10.0)),
        vel_con=(np.full(N, -20.0), np.full(N, 20.0)),
        acc_con=(np.full(N, -40.0), np.full(N, 40.0)),
        con_3d=(np.full(3, -10.0), np.full(3, 10.0)), obstacles=[])
    f32 = lambda pair: JC.Constraint(*(jnp.asarray(a, jnp.float32)
                                       for a in pair))
    jsolver = JSolver(
        max_waypoints=Wl, time_step=0.1, pos_con=f32(spec["pos_con"]),
        vel_con=f32(spec["vel_con"]), acc_con=f32(spec["acc_con"]),
        con_3d=f32(spec["con_3d"]), obstacles=[], dtype=jnp.float32,
        balls=[JBall(fk=lambda s: s, jacobian=lambda s: jnp.eye(
            3, dtype=s.dtype), radius=0.05, is_gripper=True)])
    tsolver = GOMPSolver(
        balls=[RobotBall(radius=0.05, is_gripper=True,
                         fk_jac_batched=_identity_fk_jac)],
        **convert.gomp_solver_kwargs_from_numpy(spec, device="cpu",
                                                dtype=torch.float32))
    assert tadmm.with_auto_refine(tsolver.settings, Wl,
                                  torch.float32).kkt_refine == 1
    fused = []
    use_fused = tdrv._use_fused
    monkeypatch.setattr(tdrv, "_use_fused",
                        lambda *a: fused.append(use_fused(*a)) or fused[-1])
    starts, ends = _line_queries(B=2)
    st_r, tr_r, it_r = jsolver.run_batch_lane(
        starts.astype(np.float32), ends.astype(np.float32), waypoints=Wl)
    st, tr, it = tsolver.run_batch_lane(starts, ends, waypoints=Wl)
    np.testing.assert_array_equal(to_np(st), np.asarray(st_r))
    np.testing.assert_array_equal(to_np(it), np.asarray(it_r))
    assert (to_np(st) == 0).all()
    np.testing.assert_allclose(to_np(tr), np.asarray(tr_r), rtol=0,
                               atol=1e-4)
    assert fused and not any(fused)
