"""PyTorch port vs JAX package: the lane container's structure, bounds,
operators, scaling and KKT blocks, on the same numpy inputs (f64, CPU,
1e-12); its host-side packs are ``test_torch_lane_qp_packs.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import residuals_pallas as jresid
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
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
