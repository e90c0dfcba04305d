"""The lane kernels' CUDA sources compiled with g++ in host emulation
(double) and held to their plain versions: here the KKT factor (both forms:
odd batches, windows a small shared-memory budget forces) and the chunk's
termination accumulators against the delta form + residual kernel, with
the chunk cases' set-up; Ruiz, the chunk's hrec form and its gain form are
in ``test_torch_kernels_emulated_ruiz.py``, ``_chunk.py`` and ``_gain.py``.
The plain versions against the JAX package are
``test_torch_kernels_plain*.py``'s.  f64, CPU."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import (
    B, ODD_BATCH, assert_close, both, host_lib as _host_lib,
    random_lane_problem, t_ as _t, to_np, torch_lane,
)
from test_torch_kernels_plain import _gain_args

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


# Cases of the emulated chunk kernel beyond the base batch of B problems
# (one block of Q = 8): a batch that is not a multiple of Q (the last block
# masked), and a done mask that freezes all problems but two.
CHUNK_FLAGS = [((False, True), 1, "flags0-1"), ((), 0, "flags1-0")]


@functools.lru_cache(maxsize=None)
def _port_chunk_case(flags, n_obs, B):
    """The port's half of :func:`test_torch_helpers.chunk_case` (seed 0,
    three iterations), made by the port alone: the same numpy batch, warm
    state and done mask, scaled (five Ruiz passes) and initialised by the
    port's own functions.  The emulated kernels are held to the port's
    plain versions, which ``chunk_case`` holds to the JAX package, so these
    need no JAX reference (one compiled program each, ~15 s on the CPU).
    Cached: callers clone what they write to."""
    static, arrays = random_lane_problem(0, flags=flags, n_obs=n_obs, B=B)
    tqp = torch_lane(static, arrays)
    tsettings = dataclasses.replace(tadmm.Settings(), check_termination=3)
    tscaled, ts = tlane_drv.ruiz_equilibrate_lane(tqp, 5)
    rng = np.random.default_rng(100)
    wx = rng.normal(size=(tqp.n, B))
    wy = 0.1 * rng.normal(size=(tqp.m, B))
    done = np.zeros(B, bool)
    done[[1, 6]] = True
    st = tlane_drv.init_state_lane(tscaled, tsettings, _t(wx), _t(wy), ts)
    packs = tlane_drv.build_const_packs(tscaled, ts)
    args = dict(
        coef=packs["coef"], lu=tfused.build_lu_pack(tscaled),
        packed_factor=tfactor.factor_packed_lane(
            tscaled, st.rho_vec, tsettings.sigma, coef=packs["coef"]),
        state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y),
        term_packs=(packs["EEinv"], packs["varc"], packs["Pdp"],
                    packs["Plf"]),
    )
    return tscaled, ts, tsettings, st.rho_vec, _t(done), packs, args


def _emulated_case(case, flags=(False, True), n_obs=1):
    """The chunk case of ``case`` ("base", "odd_batch", "frozen"):
    :func:`_port_chunk_case`, with the batch or the done mask changed."""
    if case == "odd_batch":
        return _port_chunk_case(tuple(flags), n_obs, ODD_BATCH)
    c = _port_chunk_case(tuple(flags), n_obs, B)
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


@pytest.mark.parametrize("flags,n_obs,case", FACTOR_PARAMS)
def test_emulated_factor_kernel_gain_write_matches_plain(flags, n_obs, case,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    for got, ref in _emulated_factor(case, flags, n_obs, 5, True):
        assert_close(got, ref, rtol=1e-9, atol=1e-12)


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
