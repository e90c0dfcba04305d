"""The block-tridiagonal pair with several rows a thread, in host emulation,
and the lane driver above 256 joints against the JAX package.

Above B2 = 512 a problem's group stays at 512 threads and each owns the
rows lane, lane + 512, ... of a step in both kernels (``csrc/tridiag.cu``).
Here the factor and the solve are compiled with g++ (double) with the group
capped at 32 threads (``-DLANE_GROUP_MAX=32``, which only these tests
pass), at B2 = 80 (three rows a thread, the last for 16 of the 32) on chip
and B2 = 100 (four, the last for 4) in the device-memory workspace, and
held to their plain versions.  Then ``solve_batched_lane`` at N = 257 (a
size the card refused before it took several columns a thread; W=4, B=2,
f64, the plain versions on the CPU) against the JAX package's, both on the
path JAX takes on the CPU (``fused_chunk="off"``)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jlane
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import assert_close, host_lib_signature
from test_torch_lane_wide import B, PLACES, W
from test_torch_tridiag import spd_batch, t_

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("B2,place", [(80, "chip"), (100, "dev")])
def test_cols_tridiag_kernels(B2, place, tmp_path, monkeypatch):
    """The factor and the solve, each thread owning three or four rows of
    a step (W=3, B=2), against the plain versions."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    budget = PLACES[place]
    diag, lower, rhs = (t_(a) for a in spd_batch(3, B2, B, seed=B2))
    lib = host_lib_signature("tridiag", {"B2": B2, "LANE_GROUP_MAX": 32})
    fp, sp = ttri.factor_plan(lib, B, budget), ttri.plan(lib, 3, B, budget)
    assert (fp["G"], fp["threads_per_block"]) == (32, 32)
    assert (sp["G"], sp["threads_per_block"]) == (32, 64)
    assert (fp["workspace_bytes"] > 0) == (sp["workspace_bytes"] > 0) == (
        budget == 1)
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain, budget=budget)
    x = torch.full_like(rhs, float("nan"))
    ttri._launch(lib, "solve", chol, gain, rhs, x, budget=budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)


def test_lane_driver_at_257_joints_matches_jax():
    """``solve_batched_lane`` at N=257 on the JAX package's box class
    (``bench.build_box_batch``, W=4, B=2) against the JAX package's: 25
    iterations, termination checked every 5 (the class takes ~250 to
    converge at this size, over a minute of CPU here), the same statuses
    and iteration counts, the iterates within 1e-8."""
    jqp = jax.jit(lambda: bench.build_box_batch(B, W, 257, jnp.float64))()
    settings = dataclasses.replace(jadmm.Settings(), check_termination=5,
                                   max_iter=25, fused_chunk="off")
    jres = jax.jit(lambda q: jlane.solve_batched_lane(q, settings))(jqp)
    tres = tdrv.solve_batched_lane(
        convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp)),
        convert.settings_from_dict(dataclasses.asdict(settings)),
        device="cpu")
    assert np.array_equal(np.asarray(jres.status), tres.status.numpy())
    assert np.array_equal(np.asarray(jres.iterations),
                          tres.iterations.numpy())
    for name in ("x", "y", "z"):
        assert_close(getattr(tres, name), getattr(jres, name), rtol=1e-8,
                     atol=1e-8)
