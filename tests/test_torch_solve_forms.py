"""PyTorch port vs JAX package: the lane solve's forms on the honest class
(``term_fused="off"`` against the fused accumulators, ``factor_form=
"gain"``, and the settings the lane driver once refused), held to the JAX
package's plain path as ``test_torch_solve.py`` holds the default form:
equal statuses and ADMM iteration counts, solutions within 1e-7.  f64,
B=8."""
import numpy as np
import pytest

from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import assert_close, to_np
from test_torch_solve import BENCH, _compare

pytestmark = pytest.mark.torch_port


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


@pytest.mark.parametrize("override", [
    dict(anderson=3), dict(polish=True), dict(kkt_refine=1),
], ids=["anderson", "polish", "kkt_refine"])
def test_lane_settings_match_reference(override):
    """The settings the lane driver once refused, on the honest class at
    W=12 (primal infeasible at stock settings): statuses and iteration
    counts equal to the JAX package's, solutions within 1e-7."""
    _compare(12, dict(override, check_termination=3))
