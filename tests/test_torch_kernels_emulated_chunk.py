"""The fused ADMM chunk's CUDA source (``csrc/admm_chunk.cu``) in its hrec
form, compiled with g++ in host emulation (double), against its plain
version (with and without the termination accumulators; an odd batch, all
but two problems frozen).  Split from ``test_torch_kernels_emulated.py``,
whose set-up it imports."""
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm_fused as tfused

from test_torch_helpers import assert_close
from test_torch_kernels_emulated import (
    CHUNK_FLAGS, _emulated_case, _emulated_chunk,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("flags,n_obs,emit_term,case", [
    pytest.param(f, n, e, "base", id=f"{fid}-{e}")
    for f, n, fid in CHUNK_FLAGS for e in (True, False)
] + [
    pytest.param((False, True), 1, e, c, id=f"{c}-{e}")
    for c in ("odd_batch", "frozen") for e in (True, False)
])
def test_emulated_chunk_kernel_matches_plain(flags, n_obs, emit_term, case,
                                             tmp_path, monkeypatch):
    """The hrec form of ``csrc/admm_chunk.cu`` (a group of threads per
    problem, Q problems per block) against the plain version; frozen
    problems keep their state bit for bit."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    tscaled, ts, tsettings, rho_vec, done, packs, args = _emulated_case(
        case, flags, n_obs)
    if not emit_term:
        args = dict(args, term_packs=None)
    plain_state, plain_acc = tfused.fused_admm_chunk_plain(
        tscaled, rho_vec, done, tsettings, **args)
    state, acc = _emulated_chunk(tscaled, rho_vec, done, tsettings, args,
                                 "term" if emit_term else "plain")
    assert_close(state, plain_state, rtol=1e-9, atol=1e-9)
    assert_close(state[..., done], args["state_pack"][..., done])
    if emit_term:
        assert_close(acc, plain_acc, rtol=1e-8, atol=1e-9)
