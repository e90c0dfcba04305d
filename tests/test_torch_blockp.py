"""PyTorch port vs JAX package: the block-P kernel forms.

A waypoint-layout batch whose objective has generic dense 2N x 2N blocks
(``p_structure="block"``): the GOMP smoothness term plus
``chip_smoke.block_p_terms``, which fills every entry of each ``P_diag``
block and the upper triangle of each ``P_lower`` block (a vel-diag P would
hide a wrong index).  This file builds the batch (``with_block_p``) and
holds the ``BLOCK_P`` builds of ``csrc/ruiz.cu`` and ``csrc/residuals.cu``,
compiled with g++ in host emulation (double), to the plain versions at
1e-9; ``test_torch_blockp_interpret.py`` holds the plain versions to the
JAX package's Pallas kernels in interpret mode (B=128, W=8, N=3; f64)."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_admm_fused import B, W
from test_torch_helpers import (
    RUIZ_CASES, RUIZ_PARAMS, assert_close, emulated_ruiz, host_lib,
    random_lane_problem, t_, to_np, torch_lane, wp_batch,
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
    return with_block_p(wp_batch(honest=True))


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
