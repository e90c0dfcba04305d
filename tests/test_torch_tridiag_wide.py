"""The block-tridiagonal factor and solve above 8 joints (B2 = 18-32: the
16-bit Schur tables, a lane a row) compiled with g++ in host emulation
(double) against their plain versions.  Split from
``test_torch_tridiag.py``, whose set-up it imports."""
import pytest
import torch

from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import assert_close, host_lib_signature
from test_torch_tridiag import _emulated, spd_batch, t_

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


WIDE_PARAMS = [
    pytest.param(5, 18, 13, 0, id="B2_18"),
    pytest.param(3, 18, 1, 1, id="B2_18-B1-w_in_x"),
    pytest.param(4, 20, 13, 1, id="B2_20-w_in_x"),
    pytest.param(2, 20, 1, 0, id="B2_20-W2-B1"),
    # Above B2 = 20 (N = 12 and 16) a step's rows are split among the
    # group's lanes in both kernels.
    pytest.param(4, 24, 2, 0, id="B2_24"),
    pytest.param(4, 32, 2, 1, id="B2_32-w_in_x"),
]


@pytest.mark.parametrize("W,B2,B,budget", WIDE_PARAMS)
def test_emulated_kernels_above_8_joints_match_plain(W, B2, B, budget,
                                                     tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, rhs = (t_(a) for a in spd_batch(W, B2, B, seed=W + B2 + B))
    lib = host_lib_signature("tridiag", {"B2": B2})
    p = ttri.plan(lib, W, B, budget)
    assert (p["G"], p["w_on_chip"]) == (32, int(budget == 0))
    fp = ttri.factor_plan(lib, B)
    assert (fp["G"], fp["Q"]) == (32, 8)
    assert fp["blocks"] == -(-B // fp["Q"])
    chol, gain, x = _emulated(diag, lower, rhs, budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)
