"""The KKT factor and the residual kernel above 16 joints, in host
emulation (g++, double), against their plain versions: the wide forms at
N = 17, 24 and 64, their windows and rings on chip or in the device-memory
workspace (``budget=1`` forces it), and the residual kernel's wide block-P
build.  The shared set-up is ``test_torch_lane_wide.py``'s."""
import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import assert_close, host_lib
from test_torch_lane_sizes import _chunk_case
from test_torch_lane_wide import (  # noqa: F401  (_build_dir: autouse)
    B, PLACES, W, WIDE, _block_problem, _build_dir, _group, _problem,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("N", WIDE)
@pytest.mark.parametrize("form", ["hrec-chip", "gain-chip", "gain-dev"])
def test_emulated_wide_factor_kernel(N, form):
    """The KKT factor's wide form, its window in shared memory or in the
    workspace, against its plain version."""
    emit_gain = form.startswith("gain")
    budget = PLACES[form.split("-")[1]]
    tqp = _problem(N, seed=N)
    rho = torch.from_numpy(
        np.random.default_rng(N).uniform(0.05, 5.0, (tqp.m, B)))
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    lib = host_lib("kkt_factor", tqp)
    p = tfactor.plan(lib, W, B, budget)
    assert (p["G"], p["Q"]) == (_group(2 * N), 1)
    assert (p["workspace_bytes"] > 0) == (budget == 1)
    Pd, Pl = tfactor.build_p_vel_packs(tqp)
    nan = torch.full(plain[0].shape, float("nan"), dtype=torch.float64)
    cholp = nan.clone()
    gainp = nan.clone() if emit_gain else None
    tfactor._launch_factor(
        lib, tfused.build_coef_pack(tqp), rho.reshape(W, -1, B).contiguous(),
        Pd, Pl, cholp, 1e-6, gainp, budget=budget)
    assert_close(cholp, plain[0], rtol=1e-9, atol=1e-12)
    if emit_gain:
        assert_close(gainp, plain[1], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("N", WIDE)
@pytest.mark.parametrize("place", list(PLACES))
def test_emulated_wide_residual_kernel(N, place):
    """The residual kernel's wide form, its ring on chip or in the
    workspace, on the state and deltas of three plain iterations."""
    budget = PLACES[place]
    tscaled, scaling, ts, rho_vec, done, _, args = _chunk_case(N, False)
    sp, dp = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, emit_dxdy=True, **args)
    rowc, varc, Pdp, Plf, _ = tresid.build_residual_packs(tscaled, scaling)
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc, varc)
    lib = host_lib("residuals", tscaled)
    p = tresid.plan(lib, B, budget)
    assert (p["G"], p["Q"], p["tile_stride"]) == (_group(2 * N), 1, 1)
    assert (p["workspace_bytes"] > 0) == (budget == 1)
    acc = torch.full((24, B), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(lib, args["coef"], Pdp, Plf, sp, dp, rowc, varc,
                             acc, budget=budget)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)


def test_emulated_wide_block_residual_kernel():
    """The residual kernel's wide block-P build (N=17) on a random state and
    deltas, against its plain version."""
    tqp = _block_problem(17, 5)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, 3)
    packs = tdrv.build_const_packs(tscaled, ts)
    rng = np.random.default_rng(17)
    sp = tfused.pack_state(tscaled, *(torch.from_numpy(rng.normal(size=(k, B)))
                                      for k in (tqp.n, tqp.m, tqp.m)))
    dp = tfused.pack_dxdy(tscaled, torch.from_numpy(rng.normal(size=(tqp.n, B))),
                          torch.from_numpy(rng.normal(size=(tqp.m, B))))
    rowc = torch.cat([packs["EEinv"], tfused.build_lu_pack(tscaled)], dim=1)
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc,
                                                  packs["varc"])
    acc = torch.full((24, B), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(host_lib("residuals", tscaled), packs["coef"],
                             packs["Pdp"], packs["Plf"], sp, dp, rowc,
                             packs["varc"], acc)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)
