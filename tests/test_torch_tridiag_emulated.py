"""The block-tridiagonal factor and solve (``csrc/tridiag.cu``) compiled with
g++ in host emulation (double) against their plain versions at B2 <= 32:
the solve's cases of ``SOLVE_PARAMS`` (``w_t`` on chip and in ``x``) and
the factor's.  Split from ``test_torch_tridiag.py``, whose set-up it
imports."""
import pytest
import torch

from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import assert_close, host_lib_signature
from test_torch_tridiag import _emulated, spd_batch, t_

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


SOLVE_PARAMS = [
    pytest.param(W, B2, 37, 0, id=f"{W}-{B2}")
    for B2 in (12, 14) for W in (1, 2, 5)
] + [
    pytest.param(5, 12, 1, 0, id="B1"),
    pytest.param(2, 12, 1, 0, id="B1-W2"),
    pytest.param(1, 12, 37, 1, id="w_in_x-1"),
    pytest.param(2, 14, 37, 1, id="w_in_x-2"),
    pytest.param(5, 12, 37, 1, id="w_in_x-5"),
]


@pytest.mark.parametrize("W,B2,B,budget", SOLVE_PARAMS)
def test_emulated_kernels_match_plain(W, B2, B, budget, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, rhs = (t_(a) for a in spd_batch(W, B2, B, seed=W + B2))
    p = ttri.plan(host_lib_signature("tridiag", {"B2": B2}), W, B, budget)
    assert (p["G"], p["w_on_chip"]) == (16, int(budget == 0))
    assert p["blocks"] == -(-B // p["Q"])
    chol, gain, x = _emulated(diag, lower, rhs, budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()  # upper triangle written zero
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)


FACTOR_PARAMS = [
    pytest.param(5, 12, 37, id="B37"),
    pytest.param(5, 12, 1, id="B1"),
    pytest.param(1, 12, 37, id="W1"),
    pytest.param(2, 12, 37, id="W2"),
    pytest.param(5, 14, 37, id="B2_14"),
    pytest.param(2, 14, 1, id="B2_14-W2-B1"),
]


@pytest.mark.parametrize("W,B2,B", FACTOR_PARAMS)
def test_emulated_factor_matches_plain(W, B2, B, tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, _ = (t_(a) for a in spd_batch(W, B2, B, seed=10 * W + B2))
    lib = host_lib_signature("tridiag", {"B2": B2})
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()  # upper triangle written zero
