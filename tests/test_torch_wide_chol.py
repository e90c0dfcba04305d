"""The blocked wide forms of the two factors (``csrc/wide_chol.cuh``: the
tridiagonal factor of ``csrc/tridiag.cu`` and ``csrc/kkt_factor.cu``
above B2 = 32) in host emulation (g++, double) with the panel lowered to
8 columns (``-DWC_NB=8``, which only these tests pass), so that a few
tens of rows take several panels: B2 = 34 (five panels, the last with 2
real rows of 8), 40 (five whole ones) and 80 with the group capped at 32
threads (ten panels, each product of several passes of rows); the
matrix on chip and in the device-memory workspace; the split form, where
a batch leaves SMs idle (built to plan for 64 SMs, ``-DLANE_EMU_SMS=64``:
a block a panel of rows, one launch a phase); and one problem whose block is
not positive definite among good ones, which gets NaN in its outputs from
that block on while the others stay their plain versions'.
"""
import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import assert_close, host_lib_signature
from test_torch_lane_wide import (  # noqa: F401  (_build_dir: autouse)
    PLACES, _build_dir, _problem,
)
from test_torch_tridiag import spd_batch, t_

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
NB8 = {"WC_NB": 8}
SPLIT = {"LANE_EMU_SMS": 64}  # plans for 64 SMs: the factors split
W, B = 4, 3
BAD_T, BAD_B = 2, 1  # the block that is not positive definite


def _tri_lib(B2, cap=False, split=False):
    return host_lib_signature("tridiag", dict(
        {"B2": B2}, **NB8, **({"LANE_GROUP_MAX": 32} if cap else {}),
        **(SPLIT if split else {})))


def _tri_factor(lib, diag, lower, budget=0):
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain, budget=budget)
    return chol, gain


@pytest.mark.parametrize("B2,place,cap,split", [
    (34, "chip", False, 1), (34, "dev", False, 1), (80, "chip", True, 1),
    (80, "chip", False, 10)],
    ids=["34-chip", "34-dev", "80-cap32", "80-split"])
def test_emulated_tridiag_factor_panels(B2, place, cap, split):
    """The tridiagonal factor over several panels of 8 columns (a ragged
    last one at B2=34), one block a problem or split (a block a panel of
    rows at B2=80: ten), against the plain version; the upper triangle of
    every block zero."""
    budget = PLACES[place]
    diag, lower, _ = (t_(a) for a in spd_batch(W, B2, B, seed=B2))
    lib = _tri_lib(B2, cap, split > 1)
    p = ttri.factor_plan(lib, B, budget)
    assert (p["Q"], p["blocks"], p["blocks_per_problem"]) == (
        1, B * split, split)
    assert (p["workspace_bytes"] > 0) == (budget == 1 or split > 1)
    # split: a launch to start, then a step's product and diagonal-block
    # phases for each of its ten panels and its G_t phase
    assert ttri.factor_device_launches(p, W) == (
        1 + W * (2 * 10 + 1) if split > 1 else 1)
    chol, gain = _tri_factor(lib, diag, lower, budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()


@pytest.mark.parametrize("split", [False, True], ids=["block", "split"])
def test_emulated_tridiag_factor_bad_block(split):
    """Problem 1's block at step 2 is negative definite: its chol from step
    2 on is NaN (lower triangles whole, as the plain version's), its gain
    at step 2 NaN, and everything else is the plain version's; one block a
    problem or split."""
    B2 = 34
    diag, lower, _ = (t_(a) for a in spd_batch(W, B2, B, seed=7))
    diag[BAD_T, :, :, BAD_B] = -torch.eye(B2, dtype=diag.dtype)
    lib = _tri_lib(B2, split=split)
    assert ttri.factor_plan(lib, B)["blocks_per_problem"] == (5 if split
                                                               else 1)
    chol, gain = _tri_factor(lib, diag, lower)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    il = torch.tril_indices(B2, B2)
    low, plow = chol[:, il[0], il[1]], pchol[:, il[0], il[1]]
    assert torch.isnan(low[BAD_T:, :, BAD_B]).all()
    assert torch.equal(torch.isnan(low), torch.isnan(plow))
    assert torch.isnan(gain[BAD_T:, ..., BAD_B]).all()
    good = [b for b in range(B) if b != BAD_B]
    assert_close(chol[..., good], pchol[..., good], rtol=1e-9, atol=1e-12)
    assert_close(gain[..., good], pgain[..., good], rtol=1e-9, atol=1e-12)
    assert_close(low[:BAD_T, :, BAD_B], plow[:BAD_T, :, BAD_B], rtol=1e-9,
                 atol=1e-12)
    assert_close(gain[:BAD_T, ..., BAD_B], pgain[:BAD_T, ..., BAD_B],
                 rtol=1e-9, atol=1e-12)


def _kkt_case(N, seed, bad=False):
    tqp = _problem(N, seed=seed)
    rho = np.random.default_rng(seed).uniform(0.05, 5.0, (tqp.m, tqp.batch))
    if bad:  # waypoint BAD_T of problem BAD_B: rho of its rows far negative
        Rp = tqp.rows_per_waypoint_padded
        rho[BAD_T * Rp:(BAD_T + 1) * Rp, BAD_B] = -1e3
    return tqp, torch.from_numpy(rho)


def _kkt_factor(tqp, rho, budget=0, emit_gain=True, split=False):
    lib = host_lib_signature("kkt_factor", dict(
        tfused.layout_signature(tqp), **NB8, **(SPLIT if split else {})))
    Pd, Pl = tfactor.build_p_vel_packs(tqp)
    Wq, Bq = tqp.waypoints, tqp.batch
    Tp = tfused._tri_maps(2 * tqp.n_dim)[2]
    cholp = torch.full((Wq, Tp, Bq), float("nan"), dtype=torch.float64)
    gainp = torch.full_like(cholp, float("nan")) if emit_gain else None
    tfactor._launch_factor(
        lib, tfused.build_coef_pack(tqp), rho.reshape(Wq, -1, Bq).contiguous(),
        Pd, Pl, cholp, 1e-6, gainp, budget=budget)
    return lib, cholp, gainp


@pytest.mark.parametrize("N,form", [(17, "hrec-chip"), (20, "gain-dev"),
                                    (40, "gain-split"), (17, "hrec-split")])
def test_emulated_kkt_factor_panels(N, form):
    """The KKT factor over five or ten panels of 8 columns (B2 = 34: the
    last with 2 real rows; 40, 80: whole), in either form, one block a
    problem on chip or in the workspace, or split (a block a panel of
    rows: five or ten), against its plain version."""
    emit_gain = form.startswith("gain")
    place = form.split("-")[1]
    split = place == "split"
    budget = PLACES.get(place, 0)
    tqp, rho = _kkt_case(N, N)
    lib, cholp, gainp = _kkt_factor(tqp, rho, budget, emit_gain, split)
    p = tfactor.plan(lib, tqp.waypoints, tqp.batch, budget)
    cl = (2 * N + 7) // 8 if split else 1  # a block a panel of rows
    assert (p["Q"], p["blocks"], p["blocks_per_problem"]) == (
        1, tqp.batch * cl, cl)
    # split: a launch to start, then a step's stage, assembly, the product
    # and diagonal-block phases of each panel and its G_t phase
    assert tfactor.device_launches(p, tqp.waypoints) == (
        1 + tqp.waypoints * (3 + 2 * cl) if split else 1)
    assert (p["workspace_bytes"] > 0) == (budget == 1 or split)
    plain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                             emit_gain=emit_gain)
    assert_close(cholp, plain[0], rtol=1e-9, atol=1e-12)
    if emit_gain:
        assert_close(gainp, plain[1], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("split", [False, True], ids=["block", "split"])
def test_emulated_kkt_factor_bad_block(split):
    """Problem 1's KKT block at waypoint 2 is not positive definite (its
    rows' rho far negative): its packed factor has NaN at waypoint 2 and
    is NaN whole after it, earlier waypoints and the other problems are
    the plain version's; one block a problem or split."""
    tqp, rho = _kkt_case(17, 3, bad=True)
    _, cholp, gainp = _kkt_factor(tqp, rho, split=split)
    plain, pgain = tfactor.factor_packed_lane_plain(tqp, rho, 1e-6,
                                                    emit_gain=True)
    T = 34 * 35 // 2
    assert torch.isnan(cholp[BAD_T, :T, BAD_B]).any()
    assert torch.isnan(cholp[BAD_T + 1:, :T, BAD_B]).all()
    assert torch.isnan(gainp[BAD_T, :T, BAD_B]).any()
    good = [b for b in range(tqp.batch) if b != BAD_B]
    assert_close(cholp[..., good], plain[..., good], rtol=1e-9, atol=1e-12)
    assert_close(gainp[..., good], pgain[..., good], rtol=1e-9, atol=1e-12)
    assert_close(cholp[:BAD_T, :, BAD_B], plain[:BAD_T, :, BAD_B],
                 rtol=1e-9, atol=1e-12)
