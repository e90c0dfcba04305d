"""PyTorch port vs JAX package: which lane batches reach the Ruiz kernel.

The reference admits its Pallas Ruiz only for waypoint-layout batches of at
least 4 waypoints (``ruiz_pallas.ruiz_kernel_supported``) and runs the jnp
version below that on every backend.  The port's dispatch
(``admm_lane.ruiz_equilibrate_lane``) mirrors it: a W=3 batch never enters
the kernel wrapper, a W=4 batch does.  W=3 is the shortest horizon GOMP's
builders make (``with_gomp_boxes`` indexes waypoint ``W - 3``).  The W=3
solves are held to JAX's ``solve_batched_lane`` in f64: equal statuses and
iteration counts, solutions within 1e-9.  CPU, B=8.  At W=3 the honest
class (0 to pi in three steps under its velocity limits) is primal
infeasible in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp.trajectory_qp_lane import LaneTrajectoryQP
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.honest_batch import (
    build_box_batch,
    build_honest_batch,
)
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

B = 8
BUILDERS = {"box": build_box_batch, "honest": build_honest_batch}


def _batch(kind, W):
    return BUILDERS[kind](B, W, 6, torch.float64, "cpu")


@pytest.fixture
def kernel_refuses(monkeypatch):
    """The Ruiz kernel wrapper, made to raise if anything calls it."""
    def refuse(*a, **kw):
        raise AssertionError("the Ruiz kernel wrapper was called")
    monkeypatch.setattr(truiz, "ruiz_equilibrate_lane_kernel", refuse)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_three_waypoints_skip_the_kernel(kind, kernel_refuses):
    qp = _batch(kind, 3)
    assert not truiz.ruiz_kernel_supported(qp)
    scaled, scaling = tdrv.ruiz_equilibrate_lane(qp, 4)
    ref, ref_scaling = truiz.ruiz_equilibrate_lane_plain(qp, 4)
    for k in ("D", "E", "c"):
        assert torch.equal(getattr(scaling, k), getattr(ref_scaling, k))


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_four_waypoints_reach_the_kernel(kind, kernel_refuses):
    qp = _batch(kind, 4)
    assert truiz.ruiz_kernel_supported(qp)
    with pytest.raises(AssertionError, match="wrapper was called"):
        tdrv.ruiz_equilibrate_lane(qp, 4)
    # the "type" layout never does, as before
    assert not truiz.ruiz_kernel_supported(qp.replace(row_layout="type"))


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_three_waypoint_solve_matches_jax(kind, kernel_refuses):
    """The whole lane solve at W=3 (the port's default fused chunk, plain
    versions on the CPU) against JAX's in f64."""
    tqp = _batch(kind, 3)
    static, arrays = convert.lane_qp_to_numpy(tqp)
    jqp = LaneTrajectoryQP(**static, **{k: jnp.asarray(v)
                                        for k, v in arrays.items()})
    ref = jax.jit(lambda q: jdrv.solve_batched_lane(q, jadmm.Settings()))(
        jqp)
    got = tdrv.solve_batched_lane(tqp, tadmm.Settings(), device="cpu")
    np.testing.assert_array_equal(to_np(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(to_np(got.iterations),
                                  np.asarray(ref.iterations))
    # box: all optimal; honest (0 to pi in three steps): all primal
    # infeasible, the certificate path
    assert (to_np(got.status) == (0 if kind == "box" else 1)).all()
    for name in ("x", "y", "z"):
        assert_close(getattr(got, name), getattr(ref, name), rtol=1e-9,
                     atol=1e-9)
