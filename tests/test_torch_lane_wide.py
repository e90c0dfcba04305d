"""The lane kernels above 16 joints, in host emulation, and the lane driver
there against the JAX package.  This file holds the shared set-up and the
chunk kernel; ``test_torch_lane_wide_factor.py`` the KKT factor and the
residual kernel, ``test_torch_lane_wide_tridiag.py`` Ruiz, the
tridiagonal pair and the lane driver at 20 joints.

Above 2N = 32 every lane kernel takes its wide form: a group of several
warps (64 threads at N = 17-32, 128 at N = 33-64) a problem, one problem
a block, the shuffles replaced by broadcasts through shared memory, and,
where a ring or a window does not fit on chip, a device-memory workspace
(``budget=1`` forces it here).  Each source is compiled with g++ (double)
at N = 17, 24 and 64 (the chunk's ungained forms at 33: the same group of
128 threads as 64) and held to its plain version on a random lane batch
(W=4, B=2, two balls and an obstacle row), as
``tests/test_torch_lane_sizes.py`` does below 17; the tridiagonal pair at
B2 = 34, 48 and 128 (whose ring, in double, does not fit the emulated
store: the workspace without a forced budget).  Emulation runs a block's
threads at barriers and cannot see a race: ``chip_smoke.py``'s ``lane_wide``
phase is the check on the card."""
import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor

from test_torch_helpers import (
    assert_close, host_lib, random_lane_problem, torch_lane,
)
from test_torch_lane_sizes import _chunk_case

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
W, B = 4, 2
WIDE = [17, 24, 64]
# "dev": a one-byte shared-memory budget, which puts the ring or the window
# in the device-memory workspace.
PLACES = {"chip": 0, "dev": 1}
# Block sizes whose rings go to the workspace unforced in double (the
# solve's three-stage ring of 128-wide blocks, and the factor's working
# matrix beside the copied D_t and L_t, are above the emulated 512 KB).
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


# N=33 takes the same group of 128 threads as N=64 at half the columns;
# the gain chunk, whose ring the card's plans put in the workspace unforced
# at N=64, keeps that size.
CHUNK_CASES = [(n, f) for f in ("hrec-term-chip", "gain-dxdy-chip",
                                "hrec-term-dev") for n in (17, 24)] + [
    (33, "hrec-term-chip"), (64, "gain-dxdy-chip"), (33, "hrec-term-dev")]


@pytest.mark.parametrize("N,form", CHUNK_CASES,
                         ids=[f"{f}-{n}" for n, f in CHUNK_CASES])
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
