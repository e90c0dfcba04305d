"""PyTorch port vs JAX package: the block-P lane path end to end.

``solve_batched_lane`` and the lane sessions on a waypoint-layout batch with
generic dense 2N x 2N P blocks (the block-P objective of
``test_torch_blockp.py``; B=128, W=8, N=3, f64).  The port runs it through
its packed chunk in the gain form, fed ``pack_factor`` of the
block-tridiagonal factor, with the block-P Ruiz and the residual pass once
per chunk (their plain versions here); the JAX package runs its unfused
path (``fused_chunk="off"``), which gives the same counts on these
upper-triangular coupling blocks.  Statuses and ADMM iteration counts must
be equal.  The sessions and the packed gain's caveat are
``test_torch_blockp_sessions.py``'s."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_blockp import with_block_p
from test_torch_helpers import assert_close, to_np, wp_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CT = 5
S_JAX = dataclasses.replace(jadmm.Settings(), check_termination=CT,
                            fused_chunk="off")


def _settings(**kw):
    return dataclasses.replace(tadmm.Settings(), check_termination=CT, **kw)


@functools.lru_cache(maxsize=None)
def _batch():
    return with_block_p(wp_batch(honest=True))


@functools.lru_cache(maxsize=None)
def _jax_solve():
    jqp, _ = _batch()
    r = jax.jit(lambda q: jdrv.solve_batched_lane(q, S_JAX))(jqp)
    return tuple(np.asarray(a) for a in (r.status, r.iterations, r.x))


def _same(got_status, got_iters, got_x, ref, tol=1e-8):
    np.testing.assert_array_equal(to_np(got_status), ref[0])
    np.testing.assert_array_equal(to_np(got_iters), ref[1])
    assert_close(got_x, ref[2], rtol=tol, atol=tol)


@pytest.mark.parametrize("form", [
    dict(fused_chunk="on", factor_form="gain"),
    dict(fused_chunk="on", factor_form="hrec"),  # falls back to the gain form
    dict(fused_chunk="off"),
], ids=["gain", "hrec", "unfused"])
def test_block_p_solve_matches_reference(form):
    """The packed chunk (either factor form asked for: block P runs the
    gain form) and the unfused path give the JAX package's statuses and
    iteration counts, x within 1e-8."""
    _, tqp = _batch()
    ref = _jax_solve()
    assert (ref[0] == ExitCode.kOptimal).all()
    n0 = tfused.fused_admm_chunk.launches_block
    res = tdrv.solve_batched_lane(tqp, _settings(**form), device="cpu")
    _same(res.status, res.iterations, res.x, ref)
    assert tfused.fused_admm_chunk.launches_block == n0  # plain, on the CPU


def test_block_p_fused_factor_is_the_packed_gain_form():
    """The fused path's factor for block P is ``pack_factor`` of the
    block-tridiagonal factor with its gain pack, whatever ``factor_form``
    says; ``_use_fused`` admits the batch."""
    _, tqp = _batch()
    s = _settings(factor_form="hrec")
    sess = tsess.setup_lane(tqp, s, device="cpu")
    assert tdrv._use_fused(sess.scaled, s) and sess.cache is not None
    cholp, gainp = sess.factor
    ref = tfused.pack_factor(sess.scaled, sess.scaled.kkt_factor(
        tadmm._rho_vec(sess.rho_bar, sess.scaled.l, sess.scaled.u), s.sigma))
    assert gainp is not None
    assert torch.equal(cholp, ref[0]) and torch.equal(gainp, ref[1])
