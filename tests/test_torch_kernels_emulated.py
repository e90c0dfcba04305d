"""The three lane kernels' CUDA sources (KKT factor, Ruiz, fused ADMM
chunk) and the residual kernel's, compiled with g++ in host emulation
(double) and held to their plain versions: odd batches, frozen problems,
windows and placements a small shared-memory budget forces, and the chunk's
termination accumulators against the delta form + residual kernel.  The
plain versions against the JAX package are ``test_torch_kernels_plain.py``'s.
f64, CPU."""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import (
    ODD_BATCH, RUIZ_CASES, RUIZ_PARAMS, assert_close, both,
    chunk_case as _chunk_case, emulated_ruiz, host_lib as _host_lib,
    random_lane_problem, t_ as _t, to_np, torch_lane,
)
from test_torch_kernels_plain import _gain_args

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the block-P objective of the chip phases)

pytestmark = pytest.mark.torch_port


# ------------------------------------------- CUDA sources in host emulation


# Cases of the emulated factor kernel beyond the base batch (W=8, B=8: one
# block of 8 problems): a batch that is not a multiple of the problems per
# block (the last block masked), W=2, and W=11 with a shared-memory budget
# (bytes of the double-precision emulation) that splits the horizon into
# several windows, the last one shorter.
FACTOR_CASES = {"odd_batch": dict(B=ODD_BATCH), "w2": dict(W=2),
                "windows": dict(W=11, B=ODD_BATCH, budget=20000)}
FACTOR_PARAMS = [
    pytest.param(f, n, "base", id=fid)
    for f, n, fid in [((False, True), 1, "flags0-1"), ((), 0, "flags1-0")]
] + [pytest.param((False, True), 1, c, id=c) for c in FACTOR_CASES]


def _emulated_factor(case, flags, n_obs, seed, emit_gain):
    """The factor kernel in host emulation on one case of FACTOR_CASES (or
    the base batch) against the plain version: ``(kernel, plain)`` pairs
    of the packed chol (and gain)."""
    kw = dict(FACTOR_CASES.get(case, {}))
    budget = kw.pop("budget", 0)
    _, tqp = both(flags=flags, n_obs=n_obs, **kw)
    W, Bb = tqp.waypoints, tqp.batch
    rho = _t(np.random.default_rng(seed).uniform(0.05, 5.0, (tqp.m, Bb)))
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    Pd, Pl = tfactor.build_p_vel_packs(tqp)
    cholp = torch.full_like(plain[0], float("nan"))
    gainp = torch.full_like(plain[0], float("nan")) if emit_gain else None
    lib = _host_lib("kkt_factor", tqp)
    if case == "windows":
        p = tfactor.plan(lib, W, Bb, budget)
        assert p["windows"] > 1 and W % p["window"] != 0
    tfactor._launch_factor(
        lib, tfused.build_coef_pack(tqp),
        rho.reshape(W, -1, Bb).contiguous(), Pd, Pl, cholp, 1e-6, gainp,
        budget=budget)
    return [(cholp, plain[0])] + ([(gainp, plain[1])] if emit_gain else [])


@pytest.mark.parametrize("flags,n_obs,case", FACTOR_PARAMS)
def test_emulated_factor_kernel_matches_plain(flags, n_obs, case, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    for got, ref in _emulated_factor(case, flags, n_obs, 3, False):
        assert_close(got, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("iters,flags,n_obs,case", RUIZ_PARAMS)
def test_emulated_ruiz_kernel_matches_plain(iters, flags, n_obs, case,
                                            tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    kw = {k: v for k, v in RUIZ_CASES.get(case, {}).items()
          if k in ("W", "B")}
    _, tqp = both(flags=flags, n_obs=n_obs, **kw)
    D, E, c = truiz._ruiz_scalings_plain(tqp, iters)
    Dk, Ek, ck = emulated_ruiz(tqp, iters, case)
    assert_close(Dk, D, rtol=1e-12)
    assert_close(Ek, E, rtol=1e-12)
    assert_close(ck, c, rtol=1e-12)


# Cases of the emulated chunk kernel beyond the base batch of B problems
# (one block of Q = 8): a batch that is not a multiple of Q (the last block
# masked), and a done mask that freezes all problems but two.
CHUNK_FLAGS = [((False, True), 1, "flags0-1"), ((), 0, "flags1-0")]


def _emulated_case(case, flags=(False, True), n_obs=1):
    """The chunk case of ``case`` ("base", "odd_batch", "frozen"): the
    arguments of :func:`test_torch_helpers.chunk_case`, with the batch or
    the done mask changed."""
    if case == "odd_batch":
        return _chunk_case(flags=flags, n_obs=n_obs, B=ODD_BATCH)[1]
    c = _chunk_case(flags=flags, n_obs=n_obs)[1]
    if case == "frozen":
        done = torch.ones_like(c[4])
        done[[0, 5]] = False
        c = c[:4] + (done,) + c[5:]
    return c


def _emulated_chunk(tscaled, rho_vec, done, tsettings, args, mode,
                    n_iter=None):
    """One launch of ``csrc/admm_chunk.cu`` in host emulation (double) on a
    copy of the state: ``(state, acc | dxdy | None)``; ``mode`` "term",
    "plain" or "dxdy", the form from ``args["packed_factor"]``."""
    W, Bb = tscaled.waypoints, tscaled.batch
    f64 = dict(dtype=torch.float64)
    state = args["state_pack"].clone()
    ee, varc, Pdp, Plf = args["term_packs"] if mode == "term" else (
        None, None, None, tfactor.build_p_vel_packs(tscaled)[1])
    acc = torch.full((24, Bb), float("nan"), **f64) if mode == "term" else None
    dxdy = (torch.full((W, tfused.dxdy_rows(tscaled)[1], Bb), float("nan"),
                       **f64) if mode == "dxdy" else None)
    cholp, gainp = args["packed_factor"]
    tfused._launch_chunk(
        _host_lib("admm_chunk", tscaled), cholp, args["coef"],
        tscaled._interleave(tscaled.q_vec).contiguous(), args["lu"],
        rho_vec.reshape(W, -1, Bb).contiguous(), Plf, ee, varc, Pdp,
        done.to(torch.float64), state,
        torch.empty((W, 2 * tscaled.n_dim, Bb), **f64), acc,
        tsettings.check_termination if n_iter is None else n_iter,
        tsettings.sigma, tsettings.alpha, dxdy=dxdy, gainp=gainp)
    return state, acc if mode == "term" else dxdy


@pytest.mark.parametrize("flags,n_obs,emit_term,case", [
    pytest.param(f, n, e, "base", id=f"{fid}-{e}")
    for f, n, fid in CHUNK_FLAGS for e in (True, False)
] + [
    pytest.param((False, True), 1, e, c, id=f"{c}-{e}")
    for c in ("odd_batch", "frozen") for e in (True, False)
])
def test_emulated_chunk_kernel_matches_plain(flags, n_obs, emit_term, case,
                                             tmp_path, monkeypatch):
    """The hrec form of ``csrc/admm_chunk.cu`` (a group of threads per
    problem, Q problems per block) against the plain version; frozen
    problems keep their state bit for bit."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tscaled, ts, tsettings, rho_vec, done, packs, args = _emulated_case(
        case, flags, n_obs)
    if not emit_term:
        args = dict(args, term_packs=None)
    plain_state, plain_acc = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, **args)
    state, acc = _emulated_chunk(tscaled, rho_vec, done, tsettings, args,
                                 "term" if emit_term else "plain")
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    if emit_term:
        assert_close(acc, plain_acc, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("flags,n_obs,case", FACTOR_PARAMS)
def test_emulated_factor_kernel_gain_write_matches_plain(flags, n_obs, case,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    for got, ref in _emulated_factor(case, flags, n_obs, 5, True):
        assert_close(got, ref, rtol=1e-9, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _block_p_chunk_case():
    """A block-P batch (``chip_smoke.block_p_terms`` added to its P),
    scaled and factored by the port (``pack_factor`` of the block-
    tridiagonal factor: the gain form), a warm state and problems 1 and 6
    frozen: the arguments of the emulated gain ``dxdy`` chunk, as the
    block-P path runs it."""
    static, arrays = random_lane_problem(seed=4)
    W_, N_, B_ = static["waypoints"], static["n_dim"], arrays["q_vec"].shape[1]
    dPd, dPl = chip_smoke.block_p_terms(W_, N_, B_, seed=7, m_scale=0.5,
                                        w=0.5, q_scale=1.0)
    arrays = dict(arrays, P_diag=arrays["P_diag"] + dPd,
                  P_lower=arrays["P_lower"] + dPl)
    tqp = torch_lane(dict(static, p_structure="block"), arrays)
    tsettings = dataclasses.replace(tadmm.Settings(), check_termination=3,
                                    factor_form="gain")
    tscaled, ts = tlane_drv.ruiz_equilibrate_lane(tqp, 3)
    rng = np.random.default_rng(104)
    st = tlane_drv.init_state_lane(
        tscaled, tsettings, _t(rng.normal(size=(tqp.n, B_))),
        _t(0.1 * rng.normal(size=(tqp.m, B_))), ts)
    done = torch.zeros(B_, dtype=torch.bool)
    done[[1, 6]] = True
    args = dict(
        coef=tfused.build_coef_pack(tscaled), lu=tfused.build_lu_pack(tscaled),
        packed_factor=tlane_drv._packed_factor(tscaled, st.rho_vec, tsettings),
        state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y),
        term_packs=None,
    )
    return tscaled, ts, tsettings, st.rho_vec, done, None, args


@pytest.mark.parametrize("flags,n_obs,mode,case", [
    pytest.param(f, n, m, "base", id=f"{fid}-{m}")
    for f, n, fid in CHUNK_FLAGS for m in ("term", "plain", "dxdy")
] + [
    pytest.param((False, True), 1, m, c, id=f"{c}-{m}")
    for c in ("odd_batch", "frozen") for m in ("term", "dxdy")
] + [pytest.param((False, True), 1, "dxdy", "block_p", id="block_p-dxdy")])
def test_emulated_chunk_kernel_gain_form_matches_plain(flags, n_obs, mode,
                                                       case, tmp_path,
                                                       monkeypatch):
    """The gain form of each of the three modes of ``csrc/admm_chunk.cu``
    (G_{t-1} streamed forward, G_t backward) against the plain version;
    ``block_p``: a block-P batch through ``pack_factor``, the build the
    block-P path reaches."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    if case == "block_p":
        tscaled, ts, tsettings, rho_vec, done, packs, args = (
            _block_p_chunk_case())
    else:
        tscaled, ts, tsettings, rho_vec, done, packs, args = _emulated_case(
            case, flags, n_obs)
        args = _gain_args(tscaled, tsettings, rho_vec, args)
    if mode != "term":
        args["term_packs"] = None
    plain_state, plain_extra = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, emit_dxdy=mode == "dxdy", **args)
    state, extra = _emulated_chunk(tscaled, rho_vec, done, tsettings, args,
                                   mode)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    if mode == "term":
        assert_close(extra, plain_extra, rtol=1e-8, atol=1e-9)
    elif mode == "dxdy":
        assert_close(extra, plain_extra, rtol=1e-9, atol=1e-9)
        assert (to_np(extra)[..., to_np(done)] == 0.0).all()


@pytest.mark.parametrize("form,case", [
    pytest.param("hrec", "base", id="hrec"),
    pytest.param("gain", "base", id="gain"),
    pytest.param("hrec", "odd_batch", id="hrec-odd_batch"),
    pytest.param("gain", "odd_batch", id="gain-odd_batch"),
])
def test_emulated_term_accumulators_equal_dxdy_then_residuals(
        form, case, tmp_path, monkeypatch):
    """Fused and unfused termination decide from the same numbers: the
    accumulators of the emulated ``MODE_TERM`` chunk equal, bit for bit,
    those of the emulated ``MODE_DXDY`` chunk followed by the emulated
    ``csrc/residuals.cu`` on its state and deltas (both kernels add the
    sums in the same order; the maxima are exact in any order)."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tscaled, ts, tsettings, rho_vec, done, packs, args = _emulated_case(case)
    if form == "gain":
        args = _gain_args(tscaled, tsettings, rho_vec, args)
    state_t, acc_t = _emulated_chunk(tscaled, rho_vec, done, tsettings, args,
                                     "term")
    state_d, dxdy = _emulated_chunk(tscaled, rho_vec, done, tsettings,
                                    dict(args, term_packs=None), "dxdy")
    np.testing.assert_array_equal(to_np(state_t), to_np(state_d))
    ee, varc, Pdp, Plf = args["term_packs"]
    acc_r = torch.full_like(acc_t, float("nan"))
    tresid._launch_residuals(
        _host_lib("residuals", tscaled), args["coef"], Pdp, Plf, state_d,
        dxdy, torch.cat([ee, args["lu"]], dim=1), varc, acc_r)
    np.testing.assert_array_equal(to_np(acc_t), to_np(acc_r))
