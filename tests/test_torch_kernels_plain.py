"""PyTorch port vs JAX package: the plain versions of the three kernels
(KKT factor, Ruiz, fused ADMM chunk) against the reference's plain paths,
the wrappers' argument checks, and the CUDA sources' arithmetic in host
emulation (g++, double) against the plain versions.  f64, CPU."""
import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jlane_drv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import (
    B, ODD_BATCH, RUIZ_CASES, RUIZ_PARAMS, assert_close, both,
    chunk_case as _chunk_case, emulated_ruiz, host_lib as _host_lib,
    random_lane_problem, t_ as _t, to_np, torch_lane,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the block-P objective of the chip phases)

pytestmark = pytest.mark.torch_port


# ------------------------------------------------------------------ factor


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_factor_plain_matches_reference(flags, n_obs):
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    rho = np.random.default_rng(3).uniform(0.05, 5.0, (jqp.m, B))
    ref = jfused.pack_factor(jqp, jqp.kkt_factor(jnp.asarray(rho), 1e-6))[0]
    cholp, gainp = tfactor.factor_packed_lane(tqp, _t(rho), 1e-6)
    assert gainp is None
    assert_close(cholp, ref, rtol=1e-10, atol=1e-13)
    assert tfactor.factor_packed_lane.launches == 0


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_factor_plain_gain_matches_reference(flags, n_obs):
    """``emit_gain=True``: the packed upper-triangular G_t beside cholp, the
    last waypoint's row zero (the reference's ``pack_factor``)."""
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    rho = np.random.default_rng(4).uniform(0.05, 5.0, (jqp.m, B))
    ref_c, ref_g = jfused.pack_factor(
        jqp, jqp.kkt_factor(jnp.asarray(rho), 1e-6))
    cholp, gainp = tfactor.factor_packed_lane(tqp, _t(rho), 1e-6,
                                              emit_gain=True)
    assert_close(cholp, ref_c, rtol=1e-10, atol=1e-13)
    assert_close(gainp, ref_g, rtol=1e-10, atol=1e-13)
    assert (to_np(gainp)[-1] == 0.0).all()
    assert tfactor.factor_packed_lane.launches_gain == 0


def _gain_args(tscaled, tsettings, rho_vec, args):
    """The chunk case's arguments with the gain-form packed factor."""
    gf = tfactor.factor_packed_lane(tscaled, rho_vec, tsettings.sigma,
                                    coef=args["coef"], emit_gain=True)
    return dict(args, packed_factor=gf)


def test_factor_wrapper_refuses_bad_arguments():
    _, tqp = both()
    rho = torch.full((tqp.m, B), 0.1, dtype=torch.float64)
    with pytest.raises(ValueError):
        tfactor.factor_packed_lane(tqp, rho[:-1], 1e-6)
    with pytest.raises(TypeError):
        tfactor.factor_packed_lane(tqp, rho.float(), 1e-6)
    with pytest.raises(ValueError):
        tfactor.factor_packed_lane(tqp.replace(row_layout="type"), rho, 1e-6)


# -------------------------------------------------------------------- Ruiz


@pytest.mark.parametrize("iters", [3, 10])
@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_ruiz_plain_matches_reference(iters, flags, n_obs):
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    jscaled, js = jlane_drv._ruiz_equilibrate_lane_jnp(jqp, iters)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, iters)
    for name in ("D", "E", "c", "Dinv", "Einv", "cinv"):
        assert_close(getattr(ts, name), getattr(js, name), rtol=1e-12)
    for k, v in convert.lane_qp_to_numpy(tscaled)[1].items():
        assert_close(v, getattr(jscaled, k), rtol=1e-12, atol=1e-14)
    assert truiz.ruiz_equilibrate_lane_kernel.launches == 0


def test_ruiz_type_layout_and_bad_arguments():
    jqp, tqp = both(row_layout="type")
    _, js = jlane_drv._ruiz_equilibrate_lane_jnp(jqp, 3)
    _, ts = tlane_drv.ruiz_equilibrate_lane(tqp, 3)
    assert_close(ts.E, js.E, rtol=1e-12)
    with pytest.raises(ValueError):
        truiz.ruiz_equilibrate_lane_kernel(tqp, 3)  # needs waypoint layout
    with pytest.raises(ValueError):
        truiz.ruiz_equilibrate_lane_kernel(both()[1], 0)


# ------------------------------------------------------------------- chunk


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_chunk_plain_matches_reference(flags, n_obs):
    (jscaled, ref, tq), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case(flags=flags, n_obs=n_obs))
    before = args["state_pack"].clone()
    out, acc = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings, **args)
    assert_close(args["state_pack"], before)  # CPU: input left untouched
    x, z, y = tfused.unpack_state(tscaled, out)
    tol = dict(rtol=1e-10, atol=1e-10)
    assert_close(x, ref.x, **tol)
    assert_close(z, ref.z, **tol)
    assert_close(y, ref.y, **tol)
    # Frozen problems kept their state bit for bit.
    assert_close(out[..., [1, 6]], before[..., [1, 6]])
    got = tresid.assemble_term_quantities(acc, ts.cinv, packs["norm_Dq"])
    for name in tq._fields:
        assert_close(getattr(got, name), getattr(tq, name),
                     rtol=1e-9, atol=1e-9)
    assert tfused.fused_admm_chunk.launches == 0


def test_chunk_without_term_packs_advances_state_only():
    _, (tscaled, ts, tsettings, rho_vec, done, packs, args) = _chunk_case()
    with_acc, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                          **args)
    args = dict(args, term_packs=None)
    out, acc = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                       n_iter=3, **args)
    assert acc is None
    assert_close(out, with_acc)


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_chunk_emit_dxdy_matches_reference_deltas(flags, n_obs):
    """The delta-writing form: same state, and the packed deltas are the
    reference's ``dx``/``dy`` of the last iteration (zero where frozen)."""
    (jscaled, ref, _), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case(flags=flags, n_obs=n_obs))
    args = dict(args, term_packs=None)
    out, dxdy = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                        emit_dxdy=True, **args)
    plain_out, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                           **args)
    assert_close(out, plain_out)
    dx, dy = tfused.unpack_dxdy(tscaled, dxdy)
    assert_close(dx, ref.dx, rtol=1e-10, atol=1e-10)
    assert_close(dy, ref.dy, rtol=1e-10, atol=1e-10)
    assert dxdy.shape == (tscaled.waypoints, tfused.dxdy_rows(tscaled)[1], B)
    assert (to_np(dxdy)[..., [1, 6]] == 0.0).all()
    assert tfused.fused_admm_chunk.launches_dxdy == 0


@pytest.mark.parametrize("mode", ["term", "plain", "dxdy"])
def test_chunk_plain_gain_form_matches_reference(mode):
    """The gain form of each mode: the streamed G_t gives the reference's
    iterations (its unfused solve is the gain algebra), accumulators and
    deltas; the state equals the hrec form's."""
    (jscaled, ref, tq), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case())
    gargs = _gain_args(tscaled, tsettings, rho_vec, args)
    if mode != "term":
        gargs["term_packs"] = args["term_packs"] = None
    kw = dict(emit_dxdy=True) if mode == "dxdy" else {}
    out, extra = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                         **gargs, **kw)
    hrec_out, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                          **args, **kw)
    x, z, y = tfused.unpack_state(tscaled, out)
    tol = dict(rtol=1e-10, atol=1e-10)
    assert_close(x, ref.x, **tol)
    assert_close(z, ref.z, **tol)
    assert_close(y, ref.y, **tol)
    assert_close(out, hrec_out, rtol=1e-10, atol=1e-10)
    if mode == "term":
        got = tresid.assemble_term_quantities(extra, ts.cinv, packs["norm_Dq"])
        for name in tq._fields:
            assert_close(getattr(got, name), getattr(tq, name),
                         rtol=1e-9, atol=1e-9)
    elif mode == "dxdy":
        dx, dy = tfused.unpack_dxdy(tscaled, extra)
        assert_close(dx, ref.dx, **tol)
        assert_close(dy, ref.dy, **tol)
    else:
        assert extra is None
    assert tfused.fused_admm_chunk.launches_gain == 0


def test_chunk_wrapper_refuses_bad_arguments():
    _, (tscaled, ts, tsettings, rho_vec, done, packs, args) = _chunk_case()
    call = lambda **kw: tfused.fused_admm_chunk(  # noqa: E731
        tscaled, rho_vec, done, tsettings, **dict(args, **kw))
    with pytest.raises(ValueError):
        call(state_pack=args["state_pack"][:, :-1].contiguous())
    with pytest.raises(TypeError):
        call(coef=args["coef"].float())
    with pytest.raises(ValueError):
        call(lu=args["lu"].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        call(n_iter=0)
    with pytest.raises(ValueError):
        tfused.fused_admm_chunk(tscaled, rho_vec, done[:-1], tsettings, **args)
    # A block-P chunk runs only in the gain form and without term_packs (the
    # reference asserts both): with no gain pack, or with the packs of the
    # fused accumulators, it raises.
    cholp = args["packed_factor"][0]
    block = tscaled.replace(p_structure="block")
    with pytest.raises(ValueError, match="gain form"):
        tfused.fused_admm_chunk(block, rho_vec, done, tsettings, **args)
    with pytest.raises(ValueError, match="gain form"):
        tfused.fused_admm_chunk(
            block, rho_vec, done, tsettings,
            **dict(args, packed_factor=(cholp, cholp), term_packs=(
                packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])))
    with pytest.raises(ValueError):
        call(packed_factor=(cholp, cholp[:-1].contiguous()))


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
