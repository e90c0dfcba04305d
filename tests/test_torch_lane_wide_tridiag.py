"""Ruiz and the block-tridiagonal pair above 16 joints, in host emulation
(g++, double), against their plain versions (Ruiz at N = 17, 24 and 64 and
its block-P build at 17; the tridiagonal pair at B2 = 34, 48 and 128, on
chip and in the workspace), and ``solve_batched_lane`` at N=20 against the
JAX package.  The shared set-up is ``test_torch_lane_wide.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jlane
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import (
    assert_close, host_lib, host_lib_signature, jax_lane,
    random_lane_problem, torch_lane,
)
from test_torch_lane_wide import (  # noqa: F401  (_build_dir: autouse)
    B, PLACES, UNFORCED_DEV, W, _block_problem, _build_dir, _group,
    _problem,
)
from test_torch_tridiag import spd_batch, t_

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("N,block", [(17, False), (24, False), (64, False),
                                     (17, True)],
                         ids=["17", "24", "64", "17-block"])
def test_emulated_wide_ruiz_kernel(N, block):
    """The Ruiz kernel's rolled wide form, vel-diag and block P, against
    its plain version."""
    tqp = _block_problem(N, N + 3) if block else _problem(N, seed=N + 3)
    D, E, c = truiz._ruiz_scalings_plain(tqp, 3)
    lib = host_lib("ruiz", tqp)
    packs = truiz._ruiz_kernel_packs(tqp)
    for t in packs[4:]:
        t.fill_(float("nan"))
    truiz._launch_ruiz(lib, *packs, 3)
    Dk, Ek, ck = truiz._unpack_scalings(tqp, *packs[4:])
    for got, ref in ((Dk, D), (Ek, E), (ck, c)):
        assert_close(got, ref, rtol=1e-9)


@pytest.mark.parametrize("B2", [34, 48, 128])
@pytest.mark.parametrize("place", list(PLACES))
def test_emulated_wide_tridiag_kernels(B2, place):
    """The block-tridiagonal factor and solve in their wide forms, their
    rings on chip or in the workspace (W=3, B=2; at B2=128 in the
    workspace either way), against the plain versions."""
    budget = PLACES[place]
    diag, lower, rhs = (t_(a) for a in spd_batch(3, B2, B, seed=B2))
    lib = host_lib_signature("tridiag", {"B2": B2})
    fp, sp = ttri.factor_plan(lib, B, budget), ttri.plan(lib, 3, B, budget)
    assert (fp["G"], fp["Q"], sp["G"], sp["Q"]) == (_group(B2), 1,
                                                    _group(B2), 1)
    assert (fp["workspace_bytes"] > 0) == (sp["workspace_bytes"] > 0) == (
        budget == 1 or B2 in UNFORCED_DEV)
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


def test_lane_driver_at_20_joints_matches_jax():
    """``solve_batched_lane`` at N=20 (W=4, B=2, f64, the plain versions on
    the CPU) against the JAX package: the same statuses and iteration
    counts, and the same solutions."""
    static, arrays = random_lane_problem(20, W=W, N=20, B=B)
    settings = dataclasses.replace(jadmm.Settings(), check_termination=5,
                                   max_iter=400)
    jres = jax.jit(lambda q: jlane.solve_batched_lane(q, settings))(
        jax_lane(static, arrays))
    tres = tdrv.solve_batched_lane(
        torch_lane(static, arrays),
        convert.settings_from_dict(dataclasses.asdict(settings)),
        device="cpu")
    assert np.array_equal(np.asarray(jres.status), tres.status.numpy())
    assert np.array_equal(np.asarray(jres.iterations),
                          tres.iterations.numpy())
    assert_close(tres.x, jnp.asarray(jres.x), rtol=1e-7, atol=1e-9)
