"""The fused ADMM chunk's CUDA source (``csrc/admm_chunk.cu``) in its gain
form (all three modes, and the block-P delta form), compiled with g++ in
host emulation (double), against its plain version.  Split from
``test_torch_kernels_emulated.py``, whose set-up it imports."""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv

from test_torch_helpers import (
    assert_close, random_lane_problem, t_ as _t, to_np, torch_lane,
)
from test_torch_kernels_emulated import (
    CHUNK_FLAGS, _emulated_case, _emulated_chunk,
)
from test_torch_kernels_plain import _gain_args

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the block-P objective of the chip phases)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _block_p_chunk_case():
    """A block-P batch (``chip_smoke.block_p_terms`` added to its P),
    scaled and factored by the port (``pack_factor`` of the block-
    tridiagonal factor: the gain form), a warm state and problems 1 and 6
    frozen: the arguments of the emulated gain ``dxdy`` chunk, as the
    block-P path runs it."""
    static, arrays = random_lane_problem(seed=4)
    W_, N_, B_ = static["waypoints"], static["n_dim"], arrays["q_vec"].shape[1]
    dPd, dPl = chip_smoke.block_p_terms(W_, N_, B_, seed=7, m_scale=0.5,
                                        w=0.5, q_scale=1.0)
    arrays = dict(arrays, P_diag=arrays["P_diag"] + dPd,
                  P_lower=arrays["P_lower"] + dPl)
    tqp = torch_lane(dict(static, p_structure="block"), arrays)
    tsettings = dataclasses.replace(tadmm.Settings(), check_termination=3,
                                    factor_form="gain")
    tscaled, ts = tlane_drv.ruiz_equilibrate_lane(tqp, 3)
    rng = np.random.default_rng(104)
    st = tlane_drv.init_state_lane(
        tscaled, tsettings, _t(rng.normal(size=(tqp.n, B_))),
        _t(0.1 * rng.normal(size=(tqp.m, B_))), ts)
    done = torch.zeros(B_, dtype=torch.bool)
    done[[1, 6]] = True
    args = dict(
        coef=tfused.build_coef_pack(tscaled), lu=tfused.build_lu_pack(tscaled),
        packed_factor=tlane_drv._packed_factor(tscaled, st.rho_vec, tsettings),
        state_pack=tfused.pack_state(tscaled, st.x, st.z, st.y),
        term_packs=None,
    )
    return tscaled, ts, tsettings, st.rho_vec, done, None, args


@pytest.mark.parametrize("flags,n_obs,mode,case", [
    pytest.param(f, n, m, "base", id=f"{fid}-{m}")
    for f, n, fid in CHUNK_FLAGS for m in ("term", "plain", "dxdy")
] + [
    pytest.param((False, True), 1, m, c, id=f"{c}-{m}")
    for c in ("odd_batch", "frozen") for m in ("term", "dxdy")
] + [pytest.param((False, True), 1, "dxdy", "block_p", id="block_p-dxdy")])
def test_emulated_chunk_kernel_gain_form_matches_plain(flags, n_obs, mode,
                                                       case, tmp_path,
                                                       monkeypatch):
    """The gain form of each of the three modes of ``csrc/admm_chunk.cu``
    (G_{t-1} streamed forward, G_t backward) against the plain version;
    ``block_p``: a block-P batch through ``pack_factor``, the build the
    block-P path reaches."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    if case == "block_p":
        tscaled, ts, tsettings, rho_vec, done, packs, args = (
            _block_p_chunk_case())
    else:
        tscaled, ts, tsettings, rho_vec, done, packs, args = _emulated_case(
            case, flags, n_obs)
        args = _gain_args(tscaled, tsettings, rho_vec, args)
    if mode != "term":
        args["term_packs"] = None
    plain_state, plain_extra = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, emit_dxdy=mode == "dxdy", **args)
    state, extra = _emulated_chunk(tscaled, rho_vec, done, tsettings, args,
                                   mode)
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    if mode == "term":
        assert_close(extra, plain_extra, rtol=1e-8, atol=1e-9)
    elif mode == "dxdy":
        assert_close(extra, plain_extra, rtol=1e-9, atol=1e-9)
        assert (to_np(extra)[..., to_np(done)] == 0.0).all()
