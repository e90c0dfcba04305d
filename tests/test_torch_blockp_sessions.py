"""PyTorch port vs JAX package: the block-P lane sessions, and the packed
gain's caveat, in both packages.

``setup_lane`` → ``mpc_scan_lane`` on ``test_torch_blockp_solve.py``'s
block-P batch with a moving goal (fused and not), held to the JAX
package's sessions; and what ``pack_factor``'s upper gain triangle does to
a coupling block with entries below its diagonal, the same in both
packages (``ROADMAP.md`` queue C)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops import session_lane as jsess
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_admm_fused import N
from test_torch_blockp_solve import S_JAX, _batch, _settings
from test_torch_helpers import assert_close, to_np, wp_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
# Goal shifts per tick at the goal equality (waypoint W-3).
GOAL, T = -3, 3
DELTAS = 5e-3 * np.sin(0.3 * np.arange(T)[:, None, None]
                       + np.arange(N)[None, :, None])


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


@functools.lru_cache(maxsize=None)
def _jax_sessions():
    """The JAX sessions' ``(statuses, iterations, x)``: one program for
    both of the port's ``fused_chunk`` cases."""
    jqp, _ = _batch()
    return jax.jit(lambda q: jsess.mpc_scan_lane(
        jsess.setup_lane(q, S_JAX), jnp.asarray(DELTAS), _shift_jax, S_JAX,
        emit="full")[1])(jqp)


@pytest.mark.parametrize("fused_chunk", ["auto", "off"])
def test_block_p_sessions_match_reference(fused_chunk):
    """``setup_lane`` → ``mpc_scan_lane`` over T ticks of a moving goal:
    (T, B) statuses and iterations equal to the JAX sessions', the last
    tick's x within 1e-7."""
    _, tqp = _batch()
    st_j, it_j, x_j = _jax_sessions()
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
    behaviour problem for problem, as ``ROADMAP.md`` queue C records.
    The box batch (no ball or obstacle rows) shows it as the honest one
    does: the caveat is P's alone, and the JAX chunk kernel compiles in
    interpret mode a quarter faster without those rows."""
    jqp = wp_batch(honest=False)
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
