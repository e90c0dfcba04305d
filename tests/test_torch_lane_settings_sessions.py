"""PyTorch port vs JAX package: the lane driver's ``kkt_refine``, ``polish``
and ``anderson`` settings in the lane sessions, and the batched planner at
a float32 horizon above 1024 waypoints (one refinement step per KKT
solve).  f64 unless stated; the problems and helpers are
``test_torch_lane_settings.py``'s, the Anderson step's mechanism tests
``test_torch_anderson_mechanism.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import session_lane as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np
from test_torch_lane_settings import AA, _problems, _same

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


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

    def jax_ticks(q):  # compiled once: the eager loop is slow on the CPU
        jsn = jsess.setup_lane(q, js)
        jsn, jr0 = jsess.solve_lane(jsn, js)
        jsn = jsess.update_bounds_lane(
            jsn, pos_l=jsn.base.pos_l.at[-3].add(d),
            pos_u=jsn.base.pos_u.at[-3].add(d))
        return jr0, jsess.solve_lane(jsn, js)[1]

    jr0, jr1 = jax.jit(jax_ticks)(jqp)

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
