"""The lane kernels above 6 joints, in host emulation.

``csrc/kkt_factor.cu`` at N = 10 (its Schur-entry tables a byte a field,
slot rows past 127), 12 and 16 (16-bit fields, the rows of a step split
among the group's lanes, the waypoints assembled in their slots), and
``csrc/admm_chunk.cu`` (the solves by columns across the group above
N = 10) and ``csrc/residuals.cu`` at N = 12 and 16, each compiled with g++
(double) and held to its plain version on a random lane batch (W=4, B=2,
two balls and an obstacle row).  The block-tridiagonal kernels' cases at
B2 = 24 and 32 are in ``tests/test_torch_tridiag.py``.  Emulation runs a
block's threads at barriers and cannot see a race: ``chip_smoke.py``'s
``lane_sizes`` phase is the check on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import (
    assert_close, host_lib, random_lane_problem, torch_lane,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
W, B = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _build_dir(tmp_path_factory):
    """One build of each library for the whole module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path_factory.mktemp("build")))
    yield
    mp.undo()


def _problem(N, seed=0):
    return torch_lane(*random_lane_problem(seed, W=W, N=N, B=B))


@pytest.mark.parametrize("N", [10, 12, 16])
@pytest.mark.parametrize("emit_gain", [False, True], ids=["hrec", "gain"])
def test_emulated_factor_kernel_at_more_joints(N, emit_gain):
    """The factor with a shared-memory budget that splits the horizon into
    windows, against its plain version."""
    tqp = _problem(N, seed=N)
    rho = torch.from_numpy(
        np.random.default_rng(N).uniform(0.05, 5.0, (tqp.m, B)))
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    lib = host_lib("kkt_factor", tqp)
    budget = int(0.7 * tfactor.plan(lib, W, B)["shared_bytes"])
    assert tfactor.plan(lib, W, B, budget)["windows"] > 1
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


def _chunk_case(N, gain):
    """A scaled batch, a warm state, problem 1 frozen, and the chunk's
    arguments in the hrec or the gain form."""
    tqp = _problem(N, seed=N + 1)
    ts = dataclasses.replace(tadmm.Settings(), check_termination=3)
    tscaled, scaling = tdrv.ruiz_equilibrate_lane(tqp, 5)
    rng = np.random.default_rng(N + 100)
    st = tdrv.init_state_lane(
        tscaled, ts, torch.from_numpy(rng.normal(size=(tqp.n, B))),
        torch.from_numpy(0.1 * rng.normal(size=(tqp.m, B))), scaling)
    done = torch.tensor([False, True])
    packs = tdrv.build_const_packs(tscaled, scaling)
    args = dict(
        coef=packs["coef"], lu=tfused.build_lu_pack(tscaled),
        packed_factor=tfactor.factor_packed_lane(
            tscaled, st.rho_vec, ts.sigma, coef=packs["coef"],
            emit_gain=gain),
        state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y),
    )
    return tscaled, scaling, ts, st.rho_vec, done, packs, args


@pytest.mark.parametrize("N", [12, 16])
@pytest.mark.parametrize("form", ["hrec-term", "gain-dxdy"])
def test_emulated_chunk_kernel_at_more_joints(N, form):
    """Three iterations of the chunk (the hrec form with its termination
    accumulators: both solves of a pass; the gain form writing its deltas:
    one solve a pass) against the plain version; the frozen problem keeps
    its state."""
    gain = form.startswith("gain")
    tscaled, _, ts, rho_vec, done, packs, args = _chunk_case(N, gain)
    term = None if gain else (packs["EEinv"], packs["varc"], packs["Pdp"],
                              packs["Plf"])
    plain_state, plain_out = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, term_packs=term, emit_dxdy=gain, **args)
    f64 = dict(dtype=torch.float64)
    state = args["state_pack"].clone()
    acc = None if gain else torch.full((24, B), float("nan"), **f64)
    dxdy = (torch.full_like(plain_out, float("nan")) if gain else None)
    ee, varc, Pdp, Plf = term if term else (
        None, None, None, tfactor.build_p_vel_packs(tscaled)[1])
    cholp, gainp = args["packed_factor"]
    tfused._launch_chunk(
        host_lib("admm_chunk", tscaled), cholp, args["coef"],
        tscaled._interleave(tscaled.q_vec).contiguous(), args["lu"],
        rho_vec.reshape(W, -1, B).contiguous(), Plf, ee, varc, Pdp,
        done.to(torch.float64), state,
        torch.empty((W, 2 * N, B), **f64), acc, ts.check_termination,
        ts.sigma, ts.alpha, dxdy=dxdy, gainp=gainp)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    assert_close(acc if acc is not None else dxdy, plain_out, rtol=1e-8,
                 atol=1e-9)


@pytest.mark.parametrize("N", [12, 16])
def test_emulated_residual_kernel_at_more_joints(N):
    """The streaming residual kernel on the state and deltas of three
    plain iterations, against its plain version."""
    tscaled, scaling, ts, rho_vec, done, _, args = _chunk_case(N, False)
    sp, dp = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, emit_dxdy=True, **args)
    rowc, varc, Pdp, Plf, _ = tresid.build_residual_packs(tscaled, scaling)
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc, varc)
    acc = torch.full((24, B), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(host_lib("residuals", tscaled), args["coef"],
                             Pdp, Plf, sp, dp, rowc, varc, acc)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)
