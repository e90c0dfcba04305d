"""PyTorch port vs JAX package: the block-P kernel forms.

A waypoint-layout batch whose objective has generic dense 2N x 2N blocks
(``p_structure="block"``): the GOMP smoothness term plus
``chip_smoke.block_p_terms``, which fills every entry of each ``P_diag``
block and the upper triangle of each ``P_lower`` block (a vel-diag P would
hide a wrong index).  The plain versions of the Ruiz kernel, the residual
kernel and the gain chunk against the JAX package's Pallas kernels in
interpret mode (B=128, the kernels' lane tile; W=8, N=3; f64), the port's
``pack_factor`` against the reference's, and the ``BLOCK_P`` builds of
``csrc/ruiz.cu`` and ``csrc/residuals.cu`` compiled with g++ in host
emulation (double) against the plain versions at 1e-9."""
import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops import residuals_pallas as jresid
from osqp_solver_tpu.ops.ruiz_pallas import ruiz_equilibrate_lane_kernel
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import LaneFactor
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_admm_fused import B, N, W, build_wp_batch
from test_torch_helpers import (
    RUIZ_CASES, RUIZ_PARAMS, assert_close, emulated_ruiz, host_lib,
    random_lane_problem, t_, to_np, torch_lane,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the block-P objective of the chip phases)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# Strong enough that every block entry matters, weak enough that the batch
# still solves (1024-problem chip phases use chip_smoke's own weights).
BLOCK = dict(seed=7, m_scale=0.5, w=0.5, q_scale=1.0)


def with_block_p(jqp, **kw):
    """A JAX lane batch with the block-P objective added, and the port's
    copy of it."""
    args = dict(BLOCK, **kw)
    dPd, dPl = chip_smoke.block_p_terms(
        jqp.waypoints, jqp.n_dim, jqp.batch, args["seed"], args["m_scale"],
        args["w"], args["q_scale"])
    jqp = jqp.replace(P_diag=jqp.P_diag + dPd, P_lower=jqp.P_lower + dPl,
                      p_structure="block")
    return jqp, convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp))


@functools.lru_cache(maxsize=None)
def _batch():
    return with_block_p(build_wp_batch(honest=True))


@functools.lru_cache(maxsize=None)
def _scaled():
    """The batch scaled by the JAX package (jnp Ruiz), a cold state, its
    factor, and the same in the port."""
    jqp, _ = _batch()
    settings = dataclasses.replace(jadmm.Settings(), check_termination=3,
                                   factor_form="gain")
    scaled, scaling = jdrv._ruiz_equilibrate_lane_jnp(jqp, 3)
    st = jdrv.init_state_lane(scaled, settings)
    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(scaled))
    ts = convert.scaling_from_numpy(
        *(to_np(a) for a in (scaling.D, scaling.E, scaling.c)))
    tsettings = convert.settings_from_dict(dataclasses.asdict(settings))
    return settings, scaled, scaling, st, tsettings, tscaled, ts


def test_block_p_ruiz_plain_matches_interpreted_kernel():
    jqp, tqp = _batch()
    js, jsc = ruiz_equilibrate_lane_kernel(jqp, 2, interpret=True)
    ts, tsc = truiz.ruiz_equilibrate_lane_kernel(tqp, 2)  # CPU: plain
    for name in ("D", "E", "c"):
        assert_close(getattr(tsc, name), getattr(jsc, name), rtol=1e-12)
    assert_close(ts.P_diag, js.P_diag, rtol=1e-12, atol=1e-14)
    assert_close(ts.P_lower, js.P_lower, rtol=1e-12, atol=1e-14)
    assert truiz.ruiz_equilibrate_lane_kernel.launches_block == 0


def test_block_p_pack_factor_matches_reference():
    """Entry for entry: the reference's packing of one full-block factor,
    and the whole route (each package's block-tridiagonal factor, then
    ``pack_factor``) within 1e-12."""
    settings, scaled, _, st, tsettings, tscaled, _ = _scaled()
    jf = scaled.kkt_factor(st.rho_vec, settings.sigma)
    jc, jg = jfused.pack_factor(scaled, jf)
    tc, tg = tfused.pack_factor(tscaled, LaneFactor(chol=t_(jf.chol),
                                                    gain=t_(jf.gain)))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(tg), np.asarray(jg))
    tc2, tg2 = tdrv._packed_factor(tscaled, t_(st.rho_vec), tsettings)
    assert_close(tc2, jc, rtol=1e-12, atol=1e-12)
    assert_close(tg2, jg, rtol=1e-12, atol=1e-12)
    # The coupling blocks are upper-triangular, so the gain is too: packing
    # it drops nothing.
    full = tfused.unpack_gain(tscaled, tg)
    assert_close(full, jf.gain, rtol=1e-12, atol=1e-12)


def test_block_p_gain_chunk_plain_matches_interpreted_kernel():
    """The JAX chunk kernel in its gain form (the form block P takes) and
    the port's plain chunk from the same state and the same packed factor:
    state and deltas within 1e-9 (two routes through 3 iterations); a
    frozen problem emits exact zeros."""
    settings, scaled, _, st, tsettings, tscaled, _ = _scaled()
    done = jnp.zeros((B,), bool).at[9].set(True)
    pf = jfused.pack_factor(scaled, scaled.kkt_factor(st.rho_vec,
                                                      settings.sigma))
    x2, z2, y2, dx2, dy2 = jfused.fused_admm_chunk(
        scaled, None, st.x, st.z, st.y, st.rho_vec, done, settings,
        packed_factor=pf, interpret=True)
    out, dxdy = tfused.fused_admm_chunk(
        tscaled, t_(st.rho_vec), t_(done), tsettings,
        coef=tfused.build_coef_pack(tscaled),
        lu=tfused.build_lu_pack(tscaled),
        packed_factor=(t_(pf[0]), t_(pf[1])),
        state_pack=tfused.pack_state(tscaled, t_(st.x), t_(st.z), t_(st.y)),
        emit_dxdy=True)
    assert_close(out, jfused.pack_state(scaled, x2, z2, y2), rtol=1e-9,
                 atol=1e-9)
    assert_close(dxdy, jfused.pack_dxdy(scaled, dx2, dy2), rtol=1e-9,
                 atol=1e-9)
    assert (to_np(dxdy)[..., 9] == 0.0).all()
    assert tfused.fused_admm_chunk.launches_block == 0


def test_block_p_residual_plain_matches_interpreted_kernel():
    """Every ``TermQuantities`` field of the port's plain pass against the
    JAX residual kernel (block branch) on the same packed state and
    deltas."""
    settings, scaled, scaling, st, _, tscaled, ts = _scaled()
    rng = np.random.default_rng(12)
    x = st.x + rng.normal(size=st.x.shape)
    z = st.z + rng.normal(size=st.z.shape)
    y = st.y + 0.1 * rng.normal(size=st.y.shape)
    dx, dy = rng.normal(size=st.x.shape), rng.normal(size=st.y.shape)
    sp = jfused.pack_state(scaled, jnp.asarray(x), jnp.asarray(z),
                           jnp.asarray(y))
    dp = jfused.pack_dxdy(scaled, jnp.asarray(dx), jnp.asarray(dy))
    ref = jresid.termination_quantities_kernel(
        scaled, sp, dp, jfused.build_coef_pack(scaled),
        jresid.build_residual_packs(scaled, scaling) + (scaling.cinv,),
        interpret=True)
    got = tresid.termination_quantities_kernel(
        tscaled, t_(sp), t_(dp), tfused.build_coef_pack(tscaled),
        tresid.build_residual_packs(tscaled, ts) + (ts.cinv,))
    for name in ref._fields:
        if name == "blew_up":
            np.testing.assert_array_equal(to_np(got.blew_up),
                                          np.asarray(ref.blew_up))
        else:
            assert_close(getattr(got, name), getattr(ref, name), rtol=1e-12,
                         atol=1e-12)
    assert tresid.termination_quantities_kernel.launches_block == 0


# ------------------------------------------- CUDA sources in host emulation


def _random_block_case(seed, flags=(False, True), n_obs=1, W=8, B=8):
    """A random lane batch with a symmetric random ``P_diag`` and an
    upper-triangular random ``P_lower`` on top of its vel-diag P."""
    static, arrays = random_lane_problem(seed, W=W, B=B, flags=flags,
                                         n_obs=n_obs)
    rng = np.random.default_rng(seed + 50)
    B2, b = 2 * static["n_dim"], arrays["q_vec"].shape[-1]
    M = rng.normal(size=(W, B2, B2, b))
    arrays["P_diag"] = arrays["P_diag"] + M + M.transpose(0, 2, 1, 3)
    arrays["P_lower"] = arrays["P_lower"] + rng.normal(
        size=(W - 1, B2, B2, b)) * np.triu(np.ones((B2, B2)))[None, :, :, None]
    static["p_structure"] = "block"
    return torch_lane(static, arrays)


@pytest.mark.parametrize("iters,flags,n_obs,case", RUIZ_PARAMS)
def test_emulated_block_ruiz_kernel_matches_plain(iters, flags, n_obs, case,
                                                  tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    kw = {k: v for k, v in RUIZ_CASES.get(case, {}).items()
          if k in ("W", "B")}
    tqp = _random_block_case(iters, flags, n_obs, **kw)
    D, E, c = truiz._ruiz_scalings_plain(tqp, iters)
    assert truiz._ruiz_kernel_packs(tqp)[1].shape == tqp.P_diag.shape
    Dk, Ek, ck = emulated_ruiz(tqp, iters, case)
    assert_close(Dk, D, rtol=1e-9)
    assert_close(Ek, E, rtol=1e-9)
    assert_close(ck, c, rtol=1e-9)


# The emulated block residual kernel's cases: B = 8 (two blocks of 4
# problems) at two horizons, a batch that is not a multiple of the problems
# per block, and a single problem.
BLOCK_RESIDUAL_PARAMS = [
    pytest.param(W, flags, n_obs, 8, id=f"{fid}-{W}")
    for flags, n_obs, fid in [((False, True), 1, "flags0-1"),
                              ((), 0, "flags1-0")]
    for W in (4, 9)
] + [pytest.param(5, (False, True), 1, 13, id="odd_batch"),
     pytest.param(4, (False, True), 1, 1, id="B1")]


@pytest.mark.parametrize("W,flags,n_obs,batch", BLOCK_RESIDUAL_PARAMS)
def test_emulated_block_residual_kernel_matches_plain(W, flags, n_obs, batch,
                                                      tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tqp = _random_block_case(W, flags, n_obs, W=W, B=batch)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, 3)
    packs = tdrv.build_const_packs(tscaled, ts)
    rng = np.random.default_rng(W + 7)
    b = tqp.batch
    sp = tfused.pack_state(tscaled, *(t_(rng.normal(size=(k, b)))
                                      for k in (tqp.n, tqp.m, tqp.m)))
    dp = tfused.pack_dxdy(tscaled, t_(rng.normal(size=(tqp.n, b))),
                          t_(rng.normal(size=(tqp.m, b))))
    rowc = torch.cat([packs["EEinv"], tfused.build_lu_pack(tscaled)], dim=1)
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc,
                                                  packs["varc"])
    acc = torch.full((24, b), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(
        host_lib("residuals", tscaled), packs["coef"], packs["Pdp"],
        packs["Plf"], sp, dp, rowc, packs["varc"], acc)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)
    assert (to_np(acc)[18:] == 0.0).all()
