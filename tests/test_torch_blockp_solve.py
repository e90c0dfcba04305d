"""PyTorch port vs JAX package: the block-P lane path end to end.

``solve_batched_lane`` and the lane sessions on a waypoint-layout batch with
generic dense 2N x 2N P blocks (the block-P objective of
``test_torch_blockp.py``; B=128, W=8, N=3, f64).  The port runs it through
its packed chunk in the gain form, fed ``pack_factor`` of the
block-tridiagonal factor, with the block-P Ruiz and the residual pass once
per chunk (their plain versions here); the JAX package runs its unfused
path (``fused_chunk="off"``), which gives the same counts on these
upper-triangular coupling blocks.  Statuses and ADMM iteration counts must
be equal.  The last case pins, in both packages, what the packed gain does
to a coupling block with entries below its diagonal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops import session_lane as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_admm_fused import N, build_wp_batch
from test_torch_blockp import with_block_p
from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CT = 5
S_JAX = dataclasses.replace(jadmm.Settings(), check_termination=CT,
                            fused_chunk="off")
# Goal shifts per tick at the goal equality (waypoint W-3).
GOAL, T = -3, 3
DELTAS = 5e-3 * np.sin(0.3 * np.arange(T)[:, None, None]
                       + np.arange(N)[None, :, None])


def _settings(**kw):
    return dataclasses.replace(tadmm.Settings(), check_termination=CT, **kw)


@functools.lru_cache(maxsize=None)
def _batch():
    return with_block_p(build_wp_batch(honest=True))


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


def _shift_jax(base, d):
    d = jnp.asarray(d)
    return base.replace(pos_l=base.pos_l.at[GOAL].add(d),
                        pos_u=base.pos_u.at[GOAL].add(d))


def _shift(base, d):
    d = torch.as_tensor(d, dtype=base.dtype)
    pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
    pos_l[GOAL] += d
    pos_u[GOAL] += d
    return base.replace(pos_l=pos_l, pos_u=pos_u)


@pytest.mark.parametrize("fused_chunk", ["auto", "off"])
def test_block_p_sessions_match_reference(fused_chunk):
    """``setup_lane`` → ``mpc_scan_lane`` over T ticks of a moving goal:
    (T, B) statuses and iterations equal to the JAX sessions', the last
    tick's x within 1e-7."""
    jqp, tqp = _batch()
    _, (st_j, it_j, x_j) = jsess.mpc_scan_lane(
        jsess.setup_lane(jqp, S_JAX), jnp.asarray(DELTAS), _shift_jax, S_JAX,
        emit="full")
    s = _settings(fused_chunk=fused_chunk)
    _, (st, it, x) = tsess.mpc_scan_lane(
        tsess.setup_lane(tqp, s, device="cpu"), torch.from_numpy(DELTAS),
        _shift, s, emit="full")
    np.testing.assert_array_equal(to_np(st), np.asarray(st_j))
    np.testing.assert_array_equal(to_np(it), np.asarray(it_j))
    assert_close(x[-1], np.asarray(x_j)[-1], rtol=1e-7, atol=1e-7)
    assert (to_np(st) == ExitCode.kOptimal).all()


def test_pack_factor_caveat_is_mirrored():
    """``pack_factor`` keeps only the upper triangle of each gain block
    (reference ``osqp_solver_tpu/ops/admm_fused.py:257-260``): exact while
    every coupling block of P is upper-triangular.  The penalty
    ``0.5 (v_{k+1}[j] - q_k[j])^2`` puts entries strictly below the
    diagonal of ``P_lower[k]``: the packed chunk (``"on"``) then iterates
    with a truncated gain and does not converge by ``max_iter``, while the
    unfused path (``"off"``) converges.  The port mirrors both packages'
    behaviour problem for problem, as ``ROADMAP.md`` queue C records."""
    jqp = build_wp_batch(honest=True)
    Pd, Pl = np.array(jqp.P_diag), np.array(jqp.P_lower)
    for j in range(N):
        Pd[1:, N + j, N + j] += 1.0
        Pd[:-1, j, j] += 1.0
        Pl[:, N + j, j] -= 1.0
    jqp = jqp.replace(P_diag=jnp.asarray(Pd), P_lower=jnp.asarray(Pl),
                      p_structure="block")
    tqp = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp))
    for fc, want, p50 in (("on", ExitCode.kMaxIterations, 40),
                          ("off", ExitCode.kOptimal, 25)):
        sj = dataclasses.replace(S_JAX, fused_chunk=fc, max_iter=40)
        r = jax.jit(lambda q: jdrv.solve_batched_lane(q, sj))(jqp)
        res = tdrv.solve_batched_lane(
            tqp, _settings(fused_chunk=fc, max_iter=40), device="cpu")
        np.testing.assert_array_equal(to_np(res.status), np.asarray(r.status))
        np.testing.assert_array_equal(to_np(res.iterations),
                                      np.asarray(r.iterations))
        assert (np.asarray(r.status) == want).all()
        assert int(np.median(np.asarray(r.iterations))) == p50
