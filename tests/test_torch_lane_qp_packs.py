"""PyTorch port vs JAX package: the lane kernels' packs (coefficients,
bounds, state, factor, P, the residual kernel's) and their unpacking, the
termination quantities assembled from the accumulators, and the
converters' round trips.  f64, CPU.  Split from ``test_torch_lane_qp.py``
(the lane container), whose set-up it imports."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import kkt_factor_pallas as jfactor
from osqp_solver_tpu.ops import residuals_pallas as jresid
from osqp_solver_tpu.ops.ruiz import Scaling as JScaling
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import B, assert_close, both
from test_torch_lane_qp import TOL, _vecs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0),
                                         ((True, True), 2)])
def test_coef_and_lu_packs(flags, n_obs):
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    assert_close(tfused.build_coef_pack(tqp), jfused.build_coef_pack(jqp))
    assert_close(tfused.build_lu_pack(tqp), jfused.build_lu_pack(jqp))


def test_state_pack_round_trip():
    jqp, tqp = both()
    x, y = _vecs(jqp)
    z = np.random.default_rng(4).normal(size=y.shape)
    jp = jfused.pack_state(jqp, *(jnp.asarray(a) for a in (x, z, y)))
    tp = tfused.pack_state(tqp, *(torch.from_numpy(a) for a in (x, z, y)))
    assert_close(tp, jp)
    for a, b in zip(tfused.unpack_state(tqp, tp), (x, z, y)):
        assert_close(a, b)


def test_pack_factor_and_unpack_chol():
    jqp, tqp = both()
    rho = np.random.default_rng(3).uniform(0.05, 5.0, (jqp.m, B))
    jf = jqp.kkt_factor(jnp.asarray(rho), 1e-6)
    tf = tqp.kkt_factor(torch.from_numpy(rho), 1e-6)
    jc, jg = jfused.pack_factor(jqp, jf)
    tc, tg = tfused.pack_factor(tqp, tf)
    assert_close(tc, jc, rtol=1e-10, atol=1e-12)
    assert_close(tg, jg, rtol=1e-10, atol=1e-12)
    assert_close(tfused.unpack_chol(tqp, tc), tf.chol)


def test_p_vel_packs():
    jqp, tqp = both()
    for a, b in zip(tfactor.build_p_vel_packs(tqp),
                    jfactor.build_p_vel_packs(jqp)):
        assert_close(a, b)


def _scalings(jqp):
    rng = np.random.default_rng(5)
    D = rng.uniform(0.5, 2.0, (jqp.n, B))
    E = rng.uniform(0.5, 2.0, (jqp.m, B))
    c = rng.uniform(0.5, 2.0, (B,))
    js = JScaling(*(jnp.asarray(a) for a in (D, E, c, 1 / D, 1 / E, 1 / c)))
    return js, convert.scaling_from_numpy(D, E, c)


def test_residual_packs():
    jqp, tqp = both()
    js, ts = _scalings(jqp)
    for a, b in zip(tresid.build_residual_packs(tqp, ts),
                    jresid.build_residual_packs(jqp, js)):
        assert_close(a, b, **TOL)


def test_residual_packs_block_p():
    jqp, tqp = both()
    jqp, tqp = jqp.replace(p_structure="block"), tqp.replace(p_structure="block")
    js, ts = _scalings(jqp)
    for a, b in zip(tresid.build_residual_packs(tqp, ts),
                    jresid.build_residual_packs(jqp, js)):
        assert_close(a, b, **TOL)


def test_assemble_term_quantities():
    acc = np.random.default_rng(6).normal(size=(24, B))
    cinv = np.random.default_rng(7).uniform(0.5, 2.0, (B,))
    nq = np.random.default_rng(8).uniform(0.5, 2.0, (B,))
    jt = jresid.assemble_term_quantities(*(jnp.asarray(a) for a in (acc, cinv, nq)))
    tt = tresid.assemble_term_quantities(*(torch.from_numpy(a) for a in (acc, cinv, nq)))
    for name in jt._fields:
        assert_close(getattr(tt, name), getattr(jt, name), **TOL)


def test_convert_round_trip_and_settings():
    import dataclasses

    from osqp_solver_tpu.ops import admm as jadmm
    from osqp_solver_tpu_torch.ops import admm as tadmm

    jqp, tqp = both()
    static, arrays = convert.lane_qp_to_numpy(jqp)
    again = convert.lane_qp_from_numpy(static, arrays)
    for k, v in convert.lane_qp_to_numpy(tqp)[1].items():
        assert_close(getattr(again, k), v)
    js = dataclasses.replace(jadmm.Settings(), rho=0.04, check_termination=2)
    ts = convert.settings_from_dict(dataclasses.asdict(js))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(tadmm.Settings()) == dataclasses.asdict(jadmm.Settings())
    with pytest.raises(KeyError):
        convert.settings_from_dict({"no_such_field": 1})
    with pytest.raises(KeyError):
        convert.lane_qp_from_numpy(static, {})
    assert_close(
        tadmm._rho_vec(torch.full((B,), 0.1, dtype=torch.float64), tqp.l, tqp.u),
        jadmm._rho_vec(jnp.full((B,), 0.1), jqp.l, jqp.u),
    )
