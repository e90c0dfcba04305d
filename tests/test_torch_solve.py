"""PyTorch port vs JAX package: the whole lane solve on the honest class.

The port runs on the CPU (``device="cpu"``: the solve loop with the kernels'
plain versions) and is held to the JAX package's plain path
(``Settings(fused_chunk="off")``): equal statuses, equal ADMM iteration
counts, solutions within 1e-7, residuals within 1e-8.  f64, B=8.  The
default form at W=16, 20 and 24, and on the same JAX solves the
termination forms (``term_fused="off"`` against the fused accumulators)
and the gain factor form; the W=12 cases (the lane settings, the
refusals) are ``test_torch_solve_forms.py``'s."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import assert_close, to_np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
B, N = 8, 6
BENCH = dict(rho=0.04, check_termination=2, adaptive_rho_interval=45,
             scaling=3, alpha=1.6, factor_form="hrec", termination_warmup=21)
_CACHE = {}
_REFS = {}  # JAX solves, by problem and settings: several port forms share one


def _problems(W):
    """The same honest batch in both frameworks (the JAX one handed over
    as arrays, so both solvers see identical data)."""
    if W not in _CACHE:
        # Built under jax.jit: one compiled program, not its eager ops.
        jqp = jax.jit(lambda: bench.build_honest_batch(B, W, N,
                                                       jnp.float64))()
        tqp = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp))
        _CACHE[W] = (jqp, tqp)
    return _CACHE[W]


def _compare(W, overrides, warm=False, rho0=None, port_overrides=None):
    jqp, tqp = _problems(W)
    js = dataclasses.replace(jadmm.Settings(), fused_chunk="off", **overrides)
    ts = dataclasses.replace(tadmm.Settings(),
                             **{**overrides, **(port_overrides or {})})
    kw_j, kw_t = {}, {}
    if warm:
        rng = np.random.default_rng(W)
        wx = 0.05 * rng.normal(size=(B, jqp.n))
        wy = 0.01 * rng.normal(size=(B, jqp.m))
        kw_j = dict(warm_x=jnp.asarray(wx), warm_y=jnp.asarray(wy))
        kw_t = dict(warm_x=wx, warm_y=wy)
    if rho0 is not None:
        kw_j["rho0"] = jnp.asarray(rho0)
        kw_t["rho0"] = rho0
    # Keyed by the settings themselves: overrides that spell out a default
    # share one JAX solve.
    key = (W, js, warm, None if rho0 is None else tuple(np.ravel(rho0)))
    if key not in _REFS:
        # Under jax.jit: one compiled program, far quicker than the
        # eager loop on the CPU.
        _REFS[key] = jax.jit(
            lambda q: jdrv.solve_batched_lane(q, js, **kw_j))(jqp)
    ref = _REFS[key]
    syncs = tdrv.HOST_SYNCS
    got = tdrv.solve_batched_lane(tqp, ts, device="cpu", **kw_t)
    np.testing.assert_array_equal(to_np(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(to_np(got.iterations),
                                  np.asarray(ref.iterations))
    for name in ("x", "y", "z"):
        assert_close(getattr(got, name), getattr(ref, name),
                     rtol=1e-7, atol=1e-7)
    for name in ("prim_res", "dual_res"):
        assert_close(getattr(got, name), getattr(ref, name),
                     rtol=1e-8, atol=1e-8)
    assert_close(got.rho, ref.rho, rtol=1e-6)  # ratio of small residuals
    assert_close(got.obj_val, ref.obj_val, rtol=1e-7, atol=1e-7)
    # One host read per chunk, no more.
    ct = ts.check_termination
    chunks = -(-(int(to_np(got.iterations).max()) - ts.termination_warmup) // ct)
    assert tdrv.HOST_SYNCS - syncs == chunks
    return got


def test_honest_bench_settings_cold():
    got = _compare(20, BENCH)
    assert (to_np(got.status) == ExitCode.kOptimal).all()


def test_honest_stock_settings_cold():
    got = _compare(20, {})
    assert (to_np(got.status) == ExitCode.kOptimal).all()


def test_honest_rho_adaptation_refactors():
    got = _compare(24, dict(rho=0.005))
    assert (to_np(got.status) == ExitCode.kOptimal).all()
    assert len(np.unique(to_np(got.rho))) > 1  # some ρ adapted, some not


@pytest.mark.parametrize("stall_checks", [12, 0])
def test_honest_stall_exit(stall_checks):
    got = _compare(16, dict(BENCH, stall_checks=stall_checks, max_iter=120))
    want = 87 if stall_checks else 120
    assert int(to_np(got.iterations).max()) <= want + 1  # warm-up 21 + 2k
    assert (to_np(got.status) != ExitCode.kOptimal).all()


def test_honest_warm_started():
    _compare(20, dict(BENCH, termination_warmup=0), warm=True)


def test_honest_rho0_per_problem():
    _compare(20, BENCH, rho0=np.linspace(0.02, 0.3, B))


def test_port_unfused_cpu_path_agrees():
    _compare(20, BENCH, port_overrides=dict(fused_chunk="off"))


def test_no_scaling():
    _compare(20, dict(BENCH, scaling=0, max_iter=60))


@pytest.mark.parametrize("stall_checks", [12, 0])
@pytest.mark.parametrize("W,extra,optimal", [
    (20, {}, True),  # converges
    (16, dict(max_iter=120), False),  # gives up: stall window or max_iter
])
def test_unfused_termination_matches_fused_and_reference(W, extra, optimal,
                                                         stall_checks):
    """``term_fused="off"`` (the chunk's delta-writing form + the separate
    residual pass) decides from the same quantities as the fused
    accumulators: statuses and iteration counts equal to ``"auto"`` and to
    the JAX package, solutions within 1e-9 of the fused run."""
    overrides = dict(BENCH, stall_checks=stall_checks, **extra)
    fused = _compare(W, overrides)
    unfused = _compare(W, overrides, port_overrides=dict(term_fused="off"))
    np.testing.assert_array_equal(to_np(unfused.status), to_np(fused.status))
    np.testing.assert_array_equal(to_np(unfused.iterations),
                                  to_np(fused.iterations))
    assert_close(unfused.x, fused.x, rtol=1e-9, atol=1e-9)
    assert (to_np(unfused.status) == ExitCode.kOptimal).all() == optimal


@pytest.mark.parametrize("W,overrides,port_overrides", [
    (20, BENCH, {}),  # warm-up chunk, fused termination
    (24, dict(rho=0.005), {}),  # ρ adaptation refactors in the gain form
    (20, BENCH, dict(term_fused="off")),  # delta-writing chunk + residuals
])
def test_gain_factor_form_matches_reference(W, overrides, port_overrides):
    """``factor_form="gain"``: the factor writes the packed gain and the
    chunk streams it; statuses and iteration counts equal to the JAX
    package, solutions within 1e-7."""
    got = _compare(W, overrides,
                   port_overrides=dict(port_overrides, factor_form="gain"))
    assert (to_np(got.status) == ExitCode.kOptimal).all()
