"""PyTorch port vs JAX package: the unfused-termination path.

The streaming residual kernel's plain version against the fused
accumulators, the wrappers' argument checks, and the two CUDA sources'
arithmetic in host emulation (g++, double) against the plain versions at
1e-9 for W = 4, 5 and 12 with frozen problems.  The plain versions against
the JAX package's Pallas kernels in interpret mode are
``test_torch_residuals_interpret.py``'s.  f64, CPU."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import B, assert_close, both, host_lib, t_, to_np

pytestmark = pytest.mark.torch_port


def _port_packs(tscaled, ts):
    return tresid.build_residual_packs(tscaled, ts) + (ts.cinv,)


# ------------------------------------------------------------ the wrappers


@functools.lru_cache(maxsize=None)
def _port_case(seed=0, W=8, flags=(False, True), n_obs=1, B=B):
    """A random problem scaled by the port, a non-trivial state and a done
    mask that freezes problems 1 and 6 (those of them in the batch) — the
    port alone (the comparisons below are between the port's kernels and
    its plain versions)."""
    _, tqp = both(seed, flags=flags, n_obs=n_obs, W=W, B=B)
    tsettings = dataclasses.replace(tadmm.Settings(), check_termination=3)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, 5)
    rng = np.random.default_rng(seed + 100)
    st = tdrv.init_state_lane(
        tscaled, tsettings, t_(rng.normal(size=(tqp.n, B))),
        t_(0.1 * rng.normal(size=(tqp.m, B))), ts)
    done = torch.zeros(B, dtype=torch.bool)
    done[[k for k in (1, 6) if k < B]] = True
    packs = tdrv.build_const_packs(tscaled, ts)
    args = dict(
        coef=packs["coef"], lu=tfused.build_lu_pack(tscaled),
        packed_factor=tfactor.factor_packed_lane(
            tscaled, st.rho_vec, tsettings.sigma, coef=packs["coef"]),
        state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y),
    )
    return tscaled, ts, tsettings, st.rho_vec, done, packs, args


def _residual_case(W=8, flags=(False, True), n_obs=1, seed=0, B=B):
    """Packs after 3 plain iterations that end with the delta form."""
    tscaled, ts, tsettings, rho_vec, done, packs, args = _port_case(
        seed, W, flags, n_obs, B)
    sp, dp = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, emit_dxdy=True, **args)
    return tscaled, ts, sp, dp, args["coef"], _port_packs(tscaled, ts)


def test_residual_plain_matches_fused_accumulators():
    """The separate pass on (state, dxdy) gives what the chunk's fused
    accumulators give for the same iteration."""
    tscaled, ts, tsettings, rho_vec, done, packs, args = _port_case()
    _, acc = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, term_packs=(
            packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"]), **args)
    sp, dp = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, emit_dxdy=True, **args)
    fused = tresid.assemble_term_quantities(acc, ts.cinv, packs["norm_Dq"])
    sep = tresid.termination_quantities_plain(
        tscaled, sp, dp, args["coef"], _port_packs(tscaled, ts))
    for name in fused._fields:
        assert_close(getattr(sep, name), getattr(fused, name),
                     rtol=1e-13, atol=1e-13)


def test_residual_nan_in_state_is_carried():
    tscaled, ts, sp, dp, coef, packs = _residual_case()
    sp = sp.clone()
    sp[2, 1, 3] = float("nan")
    got = tresid.termination_quantities_kernel(tscaled, sp, dp, coef, packs)
    assert to_np(got.blew_up).tolist() == [b == 3 for b in range(B)]


def test_residual_and_dxdy_wrappers_refuse_bad_arguments():
    tscaled, ts, sp, dp, coef, packs = _residual_case()
    call = tresid.termination_quantities_kernel
    with pytest.raises(ValueError):
        call(tscaled, sp, dp[:, :-1].contiguous(), coef, packs)
    with pytest.raises(TypeError):
        call(tscaled, sp, dp.float(), coef, packs)
    with pytest.raises(ValueError):
        call(tscaled.replace(row_layout="type"), sp, dp, coef, packs)
    with pytest.raises(ValueError):
        call(tscaled, sp, dp, coef, (packs[0][:, :-1].contiguous(),) + packs[1:])
    tscaled, ts, tsettings, rho_vec, done, packs, args = _port_case()
    with pytest.raises(ValueError):  # accumulators and deltas together
        tfused.fused_admm_chunk(
            tscaled, rho_vec, done, tsettings, emit_dxdy=True, term_packs=(
                packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"]),
            **args)


# ------------------------------------------- CUDA sources in host emulation


# The emulated residual kernel's cases: the base batch (B = 8, two blocks of
# 4 problems) at three horizons, a batch that is not a multiple of the
# problems per block (the last block masked) and a single problem.
RESIDUAL_PARAMS = [
    pytest.param(W, flags, n_obs, B, id=f"{fid}-{W}")
    for flags, n_obs, fid in [((False, True), 1, "flags0-1"),
                              ((), 0, "flags1-0")]
    for W in (4, 5, 12)
] + [pytest.param(5, (False, True), 1, 13, id="odd_batch"),
     pytest.param(4, (False, True), 1, 1, id="B1")]


@pytest.mark.parametrize("W,flags,n_obs,batch", RESIDUAL_PARAMS)
def test_emulated_residual_kernel_matches_plain(W, flags, n_obs, batch,
                                                tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tscaled, ts, sp, dp, coef, packs = _residual_case(W, flags, n_obs, seed=W,
                                                      B=batch)
    rowc, varc, Pdp, Plf = packs[:4]
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc, varc)
    acc = torch.full((24, batch), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(
        host_lib("residuals", tscaled), coef, Pdp, Plf, sp, dp, rowc, varc, acc)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)
    assert (to_np(acc)[18:] == 0.0).all()


@pytest.mark.parametrize("W", [4, 5, 12])
@pytest.mark.parametrize("n_iter", [1, 3])
def test_emulated_chunk_dxdy_form_matches_plain(W, n_iter, tmp_path,
                                                monkeypatch):
    """``n_iter=1``: the deltas are against the INPUT state."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tscaled, ts, tsettings, rho_vec, done, packs, args = _port_case(W, W)
    plain_state, plain_dxdy = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, emit_dxdy=True, n_iter=n_iter,
        **args)
    state = args["state_pack"].clone()
    dxdy = torch.full_like(plain_dxdy, float("nan"))
    tfused._launch_chunk(
        host_lib("admm_chunk", tscaled), args["packed_factor"][0],
        args["coef"], tscaled._interleave(tscaled.q_vec).contiguous(),
        args["lu"], rho_vec.reshape(W, -1, B).contiguous(),
        tfactor.build_p_vel_packs(tscaled)[1], None, None, None,
        done.to(torch.float64), state,
        torch.empty((W, 2 * tscaled.n_dim, B), dtype=torch.float64), None,
        n_iter, tsettings.sigma, tsettings.alpha, dxdy=dxdy)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(dxdy, plain_dxdy, rtol=1e-9, atol=1e-9)
    assert (to_np(dxdy)[..., [1, 6]] == 0.0).all()  # frozen: exact zeros
