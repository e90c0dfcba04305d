"""The lane kernels with several columns a thread, in host emulation.

Above 2N = 512 a problem's group stays at 512 threads (with its producers,
a block's 1,024) and each thread owns the columns lane, lane + 512, ... of
the problem (``group_size`` / ``group_cols`` of
``csrc/lane_platform.cuh``).  The card runs that at N = 300
(``chip_smoke.py lane_wide``).  Here each source is compiled with g++
(double) with the group capped at 32 threads (``-DLANE_GROUP_MAX=32``,
which only these tests pass), so that at N = 40 every thread owns three
columns (the last of them for 16 of the 32 threads), and held to its plain
version on a random lane batch (W=4, B=2, two balls and an obstacle row):
the KKT factor in both forms, the chunk in both factor forms with its
termination accumulators and writing its deltas, the residual kernel
vel-diag and block P; each with its window or ring on chip and in the
device-memory workspace (``budget=1``).  The tridiagonal pair and the
lane driver above 256 joints are ``test_torch_lane_cols_tridiag.py``'s."""
import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch import _build
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import assert_close, host_lib_signature
from test_torch_lane_sizes import _chunk_case
from test_torch_lane_wide import (  # noqa: F401  (_build_dir: autouse)
    B, PLACES, W, _block_problem, _build_dir, _problem,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
N = 40
CAP = {"LANE_GROUP_MAX": 32}


def _sig(name, qp):
    """A build's signature for ``qp``'s layout (and P form), group capped."""
    if "BLOCK_P" in _build.KERNELS[name]:
        return dict(tfused.p_signature(qp), **CAP)
    return dict(tfused.layout_signature(qp), **CAP)


def _lib(name, qp):
    return host_lib_signature(name, _sig(name, qp))


@pytest.fixture(scope="module", autouse=True)
def _built(_build_dir):  # noqa: F811
    """The capped builds at N=40, their compilers started together."""
    qp, bqp = _problem(N), _block_problem(N, 1)
    handles = [_build.start_build(name, _sig(name, q), True) for name, q in (
        ("kkt_factor", qp), ("admm_chunk", qp), ("residuals", qp),
        ("residuals", bqp))]
    for h in handles:
        _build.finish_build(h)


@pytest.mark.parametrize("form", ["hrec-chip", "gain-dev"])
def test_cols_factor_kernel(form):
    """The KKT factor, each thread owning three rows of a step, against its
    plain version."""
    emit_gain = form.startswith("gain")
    budget = PLACES[form.split("-")[1]]
    tqp = _problem(N, seed=N)
    rho = torch.from_numpy(
        np.random.default_rng(N).uniform(0.05, 5.0, (tqp.m, B)))
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    lib = _lib("kkt_factor", tqp)
    p = tfactor.plan(lib, W, B, budget)
    assert (p["G"], p["threads_per_block"]) == (32, 32)
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


@pytest.mark.parametrize("form", ["hrec-term-chip", "hrec-dxdy-dev",
                                  "gain-term-chip", "gain-dxdy-dev"])
def test_cols_chunk_kernel(form):
    """Three iterations of the chunk, each thread owning three columns of
    the column solves and of every per-variable step: each factor form
    (hrec, gain) with its termination accumulators and writing its deltas,
    against the plain version; the frozen problem keeps its state."""
    factor, mode, place = form.split("-")
    gain, emit_dxdy = factor == "gain", mode == "dxdy"
    budget = PLACES[place]
    tscaled, _, ts, rho_vec, done, packs, args = _chunk_case(N, gain)
    term = None if emit_dxdy else (packs["EEinv"], packs["varc"],
                                   packs["Pdp"], packs["Plf"])
    plain_state, plain_out = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, term_packs=term, emit_dxdy=emit_dxdy,
        **args)
    f64 = dict(dtype=torch.float64)
    state = args["state_pack"].clone()
    acc = None if emit_dxdy else torch.full((24, B), float("nan"), **f64)
    dxdy = torch.full_like(plain_out, float("nan")) if emit_dxdy else None
    ee, varc, Pdp, Plf = term if term else (
        None, None, None, tfactor.build_p_vel_packs(tscaled)[1])
    cholp, gainp = args["packed_factor"]
    assert (gainp is not None) == gain
    lib = _lib("admm_chunk", tscaled)
    assert tfused._chunk_group(lib) == 32
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


def _block_case():
    """A block-P batch scaled by the Ruiz kernel's plain version, a random
    state and deltas, and its residual packs."""
    tqp = _block_problem(N, 1)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, 3)
    packs = tdrv.build_const_packs(tscaled, ts)
    rng = np.random.default_rng(N)
    rnd = lambda k: torch.from_numpy(rng.normal(size=(k, B)))  # noqa: E731
    sp = tfused.pack_state(tscaled, rnd(tqp.n), rnd(tqp.m), rnd(tqp.m))
    dp = tfused.pack_dxdy(tscaled, rnd(tqp.n), rnd(tqp.m))
    rowc = torch.cat([packs["EEinv"], tfused.build_lu_pack(tscaled)], dim=1)
    return (tscaled, packs["coef"], packs["Pdp"], packs["Plf"], sp, dp, rowc,
            packs["varc"])


@pytest.mark.parametrize("form", ["vel-chip", "vel-dev", "block-chip"])
def test_cols_residual_kernel(form):
    """The residual kernel, each thread owning three variables, vel-diag
    (on the state and deltas of three plain iterations) and block P (on a
    random state and deltas), against its plain version."""
    budget = PLACES[form.split("-")[1]]
    if form.startswith("block"):
        tscaled, coef, Pdp, Plf, sp, dp, rowc, varc = _block_case()
    else:
        tscaled, scaling, ts, rho_vec, done, _, args = _chunk_case(N, False)
        sp, dp = tfused.fused_admm_chunk_plain(
            tscaled, rho_vec, done, ts, emit_dxdy=True, **args)
        rowc, varc, Pdp, Plf, _ = tresid.build_residual_packs(tscaled,
                                                              scaling)
        coef = args["coef"]
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc, varc)
    lib = _lib("residuals", tscaled)
    p = tresid.plan(lib, B, budget)
    assert (p["G"], p["threads_per_block"]) == (32, 64)
    assert (p["workspace_bytes"] > 0) == (budget == 1)
    acc = torch.full((24, B), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(lib, coef, Pdp, Plf, sp, dp, rowc, varc, acc,
                             budget=budget)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)
