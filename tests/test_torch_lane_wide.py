"""The lane kernels above 16 joints, in host emulation, and the lane driver
there against the JAX package.

Above 2N = 32 every lane kernel takes its wide form: a group of several
warps (64 threads at N = 17-32, 128 at N = 33-64) a problem, one problem
a block, the shuffles replaced by broadcasts through shared memory, and,
where a ring or a window does not fit on chip, a device-memory workspace
(``budget=1`` forces it here).  Each source is compiled with g++ (double)
at N = 17, 24 and 64 and held to its plain version on a random lane batch
(W=4, B=2, two balls and an obstacle row), as
``tests/test_torch_lane_sizes.py`` does below 17; the tridiagonal pair at
B2 = 34, 48 and 128 (whose ring, in double, does not fit the emulated
store: the workspace without a forced budget).  Emulation runs a block's
threads at barriers and cannot see a race: ``chip_smoke.py``'s ``lane_wide``
phase is the check on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jlane
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import (
    assert_close, host_lib, host_lib_signature, jax_lane,
    random_lane_problem, torch_lane,
)
from test_torch_lane_sizes import _chunk_case
from test_torch_tridiag import spd_batch, t_

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)
W, B = 4, 2
WIDE = [17, 24, 64]
# "dev": a one-byte shared-memory budget, which puts the ring or the window
# in the device-memory workspace.
PLACES = {"chip": 0, "dev": 1}
# Block sizes whose rings go to the workspace unforced in double (the
# three-stage ring of 128-wide blocks is above the emulated 512 KB).
UNFORCED_DEV = {128}


def _group(B2):
    """The wide form's group: the power of two at or above ``B2``."""
    return 1 << (B2 - 1).bit_length()


@pytest.fixture(scope="module", autouse=True)
def _build_dir(tmp_path_factory):
    """One build of each library for the whole module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path_factory.mktemp("build")))
    yield
    mp.undo()


def _problem(N, seed=0):
    return torch_lane(*random_lane_problem(seed, W=W, N=N, B=B))


def _block_problem(N, seed):
    """``_problem`` with a symmetric random ``P_diag`` and an upper-
    triangular random ``P_lower`` on top of its vel-diag P (block P)."""
    tqp = _problem(N, seed=seed)
    rng = np.random.default_rng(N)
    B2 = 2 * N
    M = torch.from_numpy(rng.normal(size=(W, B2, B2, B)))
    U = torch.from_numpy(rng.normal(size=(W - 1, B2, B2, B))
                         * np.triu(np.ones((B2, B2)))[None, :, :, None])
    return tqp.replace(P_diag=tqp.P_diag + M + M.transpose(1, 2),
                       P_lower=tqp.P_lower + U, p_structure="block")


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
@pytest.mark.parametrize("form", ["hrec-term-chip", "gain-dxdy-chip",
                                  "hrec-term-dev"])
def test_emulated_wide_chunk_kernel(N, form):
    """Three iterations of the chunk's wide form (the hrec form with its
    termination accumulators, the gain form writing its deltas), its ring
    on chip or in the workspace, against the plain version; the frozen
    problem keeps its state."""
    gain = form.startswith("gain")
    budget = PLACES[form.rsplit("-", 1)[1]]
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
    lib = host_lib("admm_chunk", tscaled)
    assert (lib.admm_chunk_workspace_bytes(B, 1, 0, budget) > 0) == (
        budget == 1)
    tfused._launch_chunk(
        lib, cholp, args["coef"],
        tscaled._interleave(tscaled.q_vec).contiguous(), args["lu"],
        rho_vec.reshape(W, -1, B).contiguous(), Plf, ee, varc, Pdp,
        done.to(torch.float64), state,
        torch.empty((W, 2 * N, B), **f64), acc, ts.check_termination,
        ts.sigma, ts.alpha, dxdy=dxdy, gainp=gainp, budget=budget)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    assert_close(acc if acc is not None else dxdy, plain_out, rtol=1e-8,
                 atol=1e-9)


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


@pytest.mark.parametrize("N,block", [(17, False), (24, False), (64, False),
                                     (17, True)],
                         ids=["17", "24", "64", "17-block"])
def test_emulated_wide_ruiz_kernel(N, block):
    """The Ruiz kernel's rolled wide form, vel-diag and block P, against
    its plain version."""
    tqp = _block_problem(N, N + 3) if block else _problem(N, seed=N + 3)
    D, E, c = truiz._ruiz_scalings_plain(tqp, 3)
    lib = host_lib("ruiz", tqp)
    packs = truiz._ruiz_kernel_packs(tqp)
    for t in packs[4:]:
        t.fill_(float("nan"))
    truiz._launch_ruiz(lib, *packs, 3)
    Dk, Ek, ck = truiz._unpack_scalings(tqp, *packs[4:])
    for got, ref in ((Dk, D), (Ek, E), (ck, c)):
        assert_close(got, ref, rtol=1e-9)


@pytest.mark.parametrize("B2", [34, 48, 128])
@pytest.mark.parametrize("place", list(PLACES))
def test_emulated_wide_tridiag_kernels(B2, place):
    """The block-tridiagonal factor and solve in their wide forms, their
    rings on chip or in the workspace (W=3, B=2; at B2=128 in the
    workspace either way), against the plain versions."""
    budget = PLACES[place]
    diag, lower, rhs = (t_(a) for a in spd_batch(3, B2, B, seed=B2))
    lib = host_lib_signature("tridiag", {"B2": B2})
    fp, sp = ttri.factor_plan(lib, B, budget), ttri.plan(lib, 3, B, budget)
    assert (fp["G"], fp["Q"], sp["G"], sp["Q"]) == (_group(B2), 1,
                                                    _group(B2), 1)
    assert (fp["workspace_bytes"] > 0) == (sp["workspace_bytes"] > 0) == (
        budget == 1 or B2 in UNFORCED_DEV)
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain, budget=budget)
    x = torch.full_like(rhs, float("nan"))
    ttri._launch(lib, "solve", chol, gain, rhs, x, budget=budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)


def test_lane_driver_at_20_joints_matches_jax():
    """``solve_batched_lane`` at N=20 (W=4, B=2, f64, the plain versions on
    the CPU) against the JAX package: the same statuses and iteration
    counts, and the same solutions."""
    static, arrays = random_lane_problem(20, W=W, N=20, B=B)
    settings = dataclasses.replace(jadmm.Settings(), check_termination=5,
                                   max_iter=400)
    jres = jlane.solve_batched_lane(jax_lane(static, arrays), settings)
    tres = tdrv.solve_batched_lane(
        torch_lane(static, arrays),
        convert.settings_from_dict(dataclasses.asdict(settings)),
        device="cpu")
    assert np.array_equal(np.asarray(jres.status), tres.status.numpy())
    assert np.array_equal(np.asarray(jres.iterations),
                          tres.iterations.numpy())
    assert_close(tres.x, jnp.asarray(jres.x), rtol=1e-7, atol=1e-9)
