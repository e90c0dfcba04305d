"""PyTorch port vs JAX package: the lane container's operators and every
host-side pack, on the same numpy inputs (f64, CPU, 1e-12)."""
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

from test_torch_helpers import B, N, assert_close, both

pytestmark = pytest.mark.torch_port
TOL = dict(rtol=1e-12, atol=1e-12)
LAYOUTS = ["waypoint", "type"]


def _vecs(jqp, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(jqp.n, B)), rng.normal(size=(jqp.m, B))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_structure_and_bounds(layout):
    jqp, tqp = both(row_layout=layout)
    assert (tqp.n, tqp.m, tqp.batch) == (jqp.n, jqp.m, jqp.batch)
    assert tqp.rows_per_waypoint == jqp.rows_per_waypoint
    assert tqp.rows_per_waypoint_padded == jqp.rows_per_waypoint_padded
    assert_close(tqp.l, jqp.l)
    assert_close(tqp.u, jqp.u)
    assert_close(tqp.q, jqp.q)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_matvecs(layout):
    jqp, tqp = both(row_layout=layout)
    x, y = _vecs(jqp)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert_close(tqp.A_matvec(tx), jqp.A_matvec(jnp.asarray(x)), **TOL)
    assert_close(tqp.AT_matvec(ty), jqp.AT_matvec(jnp.asarray(y)), **TOL)
    assert_close(tqp.P_matvec(tx), jqp.P_matvec(jnp.asarray(x)), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_concat_round_trip(layout):
    jqp, tqp = both(row_layout=layout)
    _, y = _vecs(jqp)
    parts_t = tqp._split_rows(torch.from_numpy(y))
    parts_j = jqp._split_rows(jnp.asarray(y))
    for a, b in zip(parts_t, parts_j):
        assert_close(a, b)
    assert_close(tqp._concat_rows(*parts_t, pad_value=7.0),
                 jqp._concat_rows(*parts_j, pad_value=7.0))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_scale_data(layout):
    jqp, tqp = both(row_layout=layout)
    rng = np.random.default_rng(2)
    D = rng.uniform(0.5, 2.0, (jqp.n, B))
    E = rng.uniform(0.5, 2.0, (jqp.m, B))
    c = rng.uniform(0.5, 2.0, (B,))
    js = jqp.scale_data(jnp.asarray(D), jnp.asarray(E), jnp.asarray(c))
    ts = tqp.scale_data(*(torch.from_numpy(a) for a in (D, E, c)))
    _, arrays = convert.lane_qp_to_numpy(ts)
    for k, v in arrays.items():
        assert_close(v, getattr(js, k), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kkt_blocks(layout):
    jqp, tqp = both(row_layout=layout)
    rho = np.random.default_rng(3).uniform(0.05, 5.0, (jqp.m, B))
    jd, jl = jqp.kkt_blocks(jnp.asarray(rho), 1e-6)
    td, tl = tqp.kkt_blocks(torch.from_numpy(rho), 1e-6)
    assert_close(td, jd, **TOL)
    assert_close(tl, jl, **TOL)


def test_kkt_factor_and_solve():
    jqp, tqp = both()
    rho = np.random.default_rng(3).uniform(0.05, 5.0, (jqp.m, B))
    x, _ = _vecs(jqp)
    jf = jqp.kkt_factor(jnp.asarray(rho), 1e-6)
    tf = tqp.kkt_factor(torch.from_numpy(rho), 1e-6)
    assert_close(tf.chol, jf.chol, rtol=1e-10, atol=1e-12)
    assert_close(tf.gain, jf.gain, rtol=1e-10, atol=1e-12)
    assert_close(tqp.kkt_solve(tf, torch.from_numpy(x)),
                 jqp.kkt_solve(jf, jnp.asarray(x)), rtol=1e-9, atol=1e-12)


def test_layouts_and_tri_maps():
    jqp, tqp = both()
    assert tfused._row_layout(tqp) == jfused._row_layout(jqp)
    assert tfused._coef_layout(tqp) == jfused._coef_layout(jqp)
    assert tfused._tri_maps(2 * N) == jfused._tri_maps(2 * N)
    assert tfused.state_rows(tqp) == jfused.state_rows(jqp)
    assert tfused.dxdy_rows(tqp) == jfused.dxdy_rows(jqp)
    assert (tresid._ACC, tresid._NACC) == (jresid._ACC, jresid._NACC)
    # The kernels' flattened view of the dense rows: row 4N+k ↔ coef 7N+kN.
    _, ball_rows = jfused._row_layout(jqp)
    _, ball_coefs, _, _ = jfused._coef_layout(jqp)
    for (ws_r, obs_r), (ws_c, obs_c) in zip(ball_rows, ball_coefs):
        for r, c in ((ws_r, ws_c), (obs_r, obs_c)):
            if r is not None:
                assert c == 7 * N + (r - 4 * N) * N
    assert tfused.n_dense_rows(tqp) == 5


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
