"""PyTorch port vs JAX package: the lane solve on the honest class at W=12
(primal infeasible at stock settings): the settings the lane driver once
refused, held to the JAX package's plain path as ``test_torch_solve.py``
holds the other forms (equal statuses and ADMM iteration counts, solutions
within 1e-7), and the settings and arguments it refuses.  f64, B=8."""
import dataclasses

import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_helpers import to_np
from test_torch_solve import _compare, _problems

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("override", [
    dict(anderson=3), dict(polish=True), dict(kkt_refine=1),
], ids=["anderson", "polish", "kkt_refine"])
def test_lane_settings_match_reference(override):
    """The settings the lane driver once refused, on the honest class at
    W=12 (primal infeasible at stock settings): statuses and iteration
    counts equal to the JAX package's, solutions within 1e-7."""
    _compare(12, dict(override, check_termination=3))


def test_honest_primal_infeasible():
    got = _compare(12, {})
    assert (to_np(got.status) == ExitCode.kPrimalInfeasible).all()


@pytest.mark.parametrize("override", [
    dict(kkt_method="cg"),
    dict(factor_round="f16"), dict(factor_warmup_stream="bf16"),
])
def test_unported_settings_raise(override):
    _, tqp = _problems(12)
    s = dataclasses.replace(tadmm.Settings(), **override)
    with pytest.raises(NotImplementedError):
        tdrv.solve_batched_lane(tqp, s, device="cpu")


def test_bad_settings_and_arguments_raise():
    _, tqp = _problems(12)
    with pytest.raises(ValueError):
        tdrv.solve_batched_lane(
            tqp, dataclasses.replace(tadmm.Settings(), factor_round="f8"),
            device="cpu")
    with pytest.raises(ValueError):
        tdrv.solve_batched_lane(
            tqp, dataclasses.replace(tadmm.Settings(), fused_chunk="maybe"),
            device="cpu")
    with pytest.raises(ValueError):
        tdrv.solve_batched_lane(
            tqp, dataclasses.replace(tadmm.Settings(), term_fused="maybe"),
            device="cpu")
    with pytest.raises(ValueError):
        tdrv.solve_batched_lane(
            tqp, dataclasses.replace(tadmm.Settings(), factor_form="ldl"),
            device="cpu")
    with pytest.raises(TypeError):
        tdrv.solve_batched_lane({"not": "a lane qp"}, device="cpu")


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tqp = _problems(12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdrv.solve_batched_lane(tqp)
