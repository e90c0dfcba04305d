"""The lane kernels' wide groups above 64 joints, in host emulation.

Above N = 32 the KKT factor's assembly of a waypoint's packed triangle and
its stores are rolled, and above N = 64 the other loops whose trip counts
grow as N (a row's dense products, the per-waypoint sums, the gain chunk's
products with G), so that the builds at N = 40, 100 and 256 compile in
minutes; up to N = 32 every loop is unrolled.  At N = 65 (a partial group
of 256 threads, 130 of them owning a row) the KKT factor in both forms,
the residual kernel and the chunk, each compiled with g++ (double) in its
rolled form, are held to their plain versions on a random lane batch (W=4,
B=2, two balls and an obstacle row), as ``tests/test_torch_lane_wide*.py``
hold the forms at N = 17-64.  Above N = 128 the chunk also carries its
long sums (the column solves, the products with G, a dense row's
products) in double: built in float (``_build.float_library``), the chunk
at N = 129 (a partial group of 512 threads) runs that mixed arithmetic
within the card's tolerance of float64.
The card runs the groups of 128, 256 and 512 threads at N = 40, 100 and
256 (``chip_smoke.py lane_wide``)."""
import dataclasses

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch import _build
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import _ARRAY_FIELDS
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import assert_close, host_lib
from test_torch_lane_sizes import _chunk_case
from test_torch_lane_wide import (  # noqa: F401  (_build_dir: autouse)
    B, W, _build_dir, _group, _problem,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
N = 65
# The float build's size, and the card it plans for (an H100's shared
# memory a block may use, and its SMs).
NF, H100 = 129, (232448, 132)


@pytest.fixture(scope="module", autouse=True)
def _built(_build_dir):  # noqa: F811
    """The three builds at N=65 and the float chunk at N=129, their
    compilers started together."""
    sig = {"NDIM": N, "NX": 5}
    handles = [_build.start_build(name, s, True) for name, s in (
        ("kkt_factor", sig), ("admm_chunk", sig),
        ("residuals", dict(sig, BLOCK_P=0)))]
    handles.append(_build.start_float_build(
        "admm_chunk", {"NDIM": NF, "NX": 5}, *H100))
    for h in handles:
        _build.finish_build(h)


@pytest.mark.parametrize("emit_gain", [False, True], ids=["hrec", "gain"])
def test_emulated_256_thread_factor(emit_gain):
    """The KKT factor with a group of 256 threads against its plain
    version."""
    tqp = _problem(N, seed=N)
    rho = torch.from_numpy(
        np.random.default_rng(N).uniform(0.05, 5.0, (tqp.m, B)))
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    lib = host_lib("kkt_factor", tqp)
    assert tfactor.plan(lib, W, B)["G"] == _group(2 * N) == 256
    Pd, Pl = tfactor.build_p_vel_packs(tqp)
    nan = torch.full(plain[0].shape, float("nan"), dtype=torch.float64)
    cholp = nan.clone()
    gainp = nan.clone() if emit_gain else None
    tfactor._launch_factor(
        lib, tfused.build_coef_pack(tqp), rho.reshape(W, -1, B).contiguous(),
        Pd, Pl, cholp, 1e-6, gainp)
    assert_close(cholp, plain[0], rtol=1e-9, atol=1e-12)
    if emit_gain:
        assert_close(gainp, plain[1], rtol=1e-9, atol=1e-12)


def test_emulated_256_thread_residual_kernel():
    """The residual kernel with a group of 256 threads on the state and
    deltas of three plain iterations."""
    tscaled, scaling, ts, rho_vec, done, _, args = _chunk_case(N, False)
    sp, dp = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, emit_dxdy=True, **args)
    rowc, varc, Pdp, Plf, _ = tresid.build_residual_packs(tscaled, scaling)
    plain = tresid.termination_accumulators_plain(tscaled, sp, dp, rowc, varc)
    lib = host_lib("residuals", tscaled)
    assert tresid.plan(lib, B)["G"] == 256
    acc = torch.full((24, B), float("nan"), dtype=torch.float64)
    tresid._launch_residuals(lib, args["coef"], Pdp, Plf, sp, dp, rowc, varc,
                             acc)
    assert_close(acc, plain, rtol=1e-9, atol=1e-9)


def test_emulated_256_thread_gain_chunk():
    """Three iterations of the gain chunk writing its deltas (the rolled
    products with G in both passes) with a group of 256 threads against
    the plain version; the frozen problem keeps its state."""
    tscaled, _, ts, rho_vec, done, packs, args = _chunk_case(N, True)
    plain_state, plain_dxdy = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, ts, emit_dxdy=True, **args)
    f64 = dict(dtype=torch.float64)
    state = args["state_pack"].clone()
    dxdy = torch.full_like(plain_dxdy, float("nan"))
    cholp, gainp = args["packed_factor"]
    lib = host_lib("admm_chunk", tscaled)
    tfused._launch_chunk(
        lib, cholp, args["coef"],
        tscaled._interleave(tscaled.q_vec).contiguous(), args["lu"],
        rho_vec.reshape(W, -1, B).contiguous(),
        tfactor.build_p_vel_packs(tscaled)[1], None, None, None,
        done.to(torch.float64), state, torch.empty((W, 2 * N, B), **f64),
        None, ts.check_termination, ts.sigma, ts.alpha, dxdy=dxdy,
        gainp=gainp)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    assert_close(dxdy, plain_dxdy, rtol=1e-8, atol=1e-9)


def test_float_512_thread_chunk_within_card_tolerance():
    """One iteration of the hrec chunk at N=129 (a partial group of 512
    threads, its sums in double) built in float, against the plain version
    in float64 on the same float32 inputs: the state within the
    ``kernels`` phase's tolerance of float64 (1e-3 of its largest
    entry)."""
    tqp = _problem(NF, seed=NF)
    tqp = tqp.replace(**{k: getattr(tqp, k).float() for k in _ARRAY_FIELDS})
    ts = dataclasses.replace(tadmm.Settings(), check_termination=1)
    tscaled, scaling = tdrv.ruiz_equilibrate_lane(tqp, 5)
    rng = np.random.default_rng(NF)
    st = tdrv.init_state_lane(
        tscaled, ts, torch.from_numpy(rng.normal(size=(tqp.n, B))).float(),
        torch.from_numpy(0.1 * rng.normal(size=(tqp.m, B))).float(), scaling)
    packs = tdrv.build_const_packs(tscaled, scaling)
    args = dict(coef=packs["coef"], lu=tfused.build_lu_pack(tscaled),
                packed_factor=tfactor.factor_packed_lane(
                    tscaled, st.rho_vec, ts.sigma, coef=packs["coef"]),
                state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y))
    done = torch.zeros(B, dtype=torch.bool)
    plain32, _ = tfused.fused_admm_chunk_plain(tscaled, st.rho_vec, done, ts,
                                               **args)
    d64 = {k: v.double() for k, v in args.items() if k != "packed_factor"}
    plain64, _ = tfused.fused_admm_chunk_plain(
        tscaled.replace(**{k: getattr(tscaled, k).double()
                           for k in _ARRAY_FIELDS}),
        st.rho_vec.double(), done, ts, **d64,
        packed_factor=(args["packed_factor"][0].double(), None))
    lib = _build.float_library("admm_chunk", {"NDIM": NF, "NX": 5},
                               *H100)
    state = args["state_pack"].clone()
    tfused._launch_chunk(
        lib, args["packed_factor"][0], args["coef"],
        tscaled._interleave(tscaled.q_vec).contiguous(), args["lu"],
        st.rho_vec.reshape(W, -1, B).contiguous(),
        tfactor.build_p_vel_packs(tscaled)[1], None, None, None,
        done.float(), state, torch.empty((W, 2 * NF, B)), None,
        ts.check_termination, ts.sigma, ts.alpha)

    def far(s):
        return ((s.double() - plain64).abs().max()
                / plain64.abs().max()).item()
    assert far(plain32) <= 1e-3 and far(state) <= 1e-3
