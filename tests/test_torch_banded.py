"""PyTorch port vs JAX package: the banded row-block container
(``parallel/banded.py``) and the generic solver's collective hooks.

The trajectory QP is the reference's ``tests/test_banded.py`` problem (a
gripper ball, W=25, N=3), built by the JAX package in f64 and carried to the
port as numpy arrays.  Tolerances: indices exact, data and operators at
1e-12, solves with equal status and iterations and ``x`` within 1e-8."""
import dataclasses
import datetime
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.parallel import banded as jbanded
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.parallel import _comm
from osqp_solver_tpu_torch.parallel import banded as tbanded

from test_banded import make_traj_qp
from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)
TOL = dict(rtol=0.0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def both(W=25, N=3):
    """The trajectory QP and its banded form in both packages (the JAX side
    under jax.jit: one program each, not op by op)."""
    jqp = jax.jit(lambda: make_traj_qp(W=W, N=N))()
    tqp = convert.trajectory_qp_from_numpy(
        *convert.trajectory_qp_to_numpy(jqp), device="cpu")
    jb, jmap = jax.jit(jbanded.banded_from_trajectory)(jqp)
    return (jqp, tqp, jb, np.asarray(jmap),
            *tbanded.banded_from_trajectory(tqp))


def test_banded_from_trajectory_and_operators_match_jax():
    _, _, jb, jmap, tb, tmap = both()
    np.testing.assert_array_equal(tmap, jmap)
    assert (tb.waypoints, tb.block, tb.rows_per_wp) == (
        jb.waypoints, jb.block, jb.rows_per_wp)
    for name in ("P_diag", "P_lower", "q_wb", "A0", "A1", "l_wr", "u_wr"):
        assert_close(getattr(tb, name), getattr(jb, name), **TOL)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(tb.n)
    y = rng.standard_normal(tb.m)
    rho = np.abs(rng.standard_normal(tb.m)) + 0.1
    D = np.exp(0.3 * rng.standard_normal(tb.n))
    E = np.exp(0.3 * rng.standard_normal(tb.m))

    @jax.jit
    def reference(jb, x, y, rho, D, E):
        """Every JAX operator below, one compiled program."""
        return (jb.A_matvec(x), jb.AT_matvec(y), jb.P_matvec(x),
                [getattr(jb, name)() for name in NORMS],
                jb.kkt_blocks(rho, 1e-6), jb.scale_data(D, E, 0.7))
    jax_out = reference(jb, *(jnp.asarray(a) for a in (x, y, rho, D, E)))
    tx, ty = torch.tensor(x), torch.tensor(y)
    for got, ref in zip((tb.A_matvec(tx), tb.AT_matvec(ty), tb.P_matvec(tx)),
                        jax_out[:3]):
        assert_close(got, ref, **TOL)
    for name, ref in zip(NORMS, jax_out[3]):
        assert_close(getattr(tb, name)(), ref, **TOL)
    d, lo = tb.kkt_blocks(torch.tensor(rho), 1e-6)
    jd, jl = jax_out[4]
    assert_close(d, jd, **TOL)
    assert_close(lo[:-1], jl, **TOL)
    ts = tb.scale_data(torch.tensor(D), torch.tensor(E),
                       torch.tensor(0.7, dtype=torch.float64))
    for name in ("P_diag", "P_lower", "q_wb", "A0", "A1", "l_wr", "u_wr"):
        assert_close(getattr(ts, name), getattr(jax_out[5], name), **TOL)


NORMS = ("A_col_absmax", "A_row_absmax", "P_col_absmax")


def test_interleave_round_trip_matches_jax():
    W, N = 7, 3
    x = np.random.default_rng(1).standard_normal((2 * W * N, 2))
    tx = torch.tensor(x)
    s = tbanded.interleave_state(tx, W, N)
    assert_close(s[:, 0], jbanded.interleave_state(jnp.asarray(x[:, 0]), W, N))
    assert torch.equal(tbanded.deinterleave_state(s, W, N), tx)


@pytest.mark.parametrize("K", [2, 3, 8])
def test_partition_banded_matches_jax(K):
    _, _, jb, _, tb, _ = both()
    jch, jWs = jbanded.partition_banded(jb, K)
    tch, tWs = tbanded.partition_banded(tb, K)
    assert tWs == jWs
    assert set(tch) == set(jch)
    for name in tch:
        np.testing.assert_array_equal(to_np(tch[name]), np.asarray(jch[name]))


def test_banded_solve_matches_jax():
    _, _, jb, _, tb, _ = both()
    jres = jax.jit(lambda q: jadmm.solve(q))(jb)
    tres = tadmm.solve(tb, device="cpu")
    assert int(tres.status) == int(jres.status) == 0
    assert int(tres.iterations) == int(jres.iterations)
    assert_close(tres.x, jres.x, atol=1e-8)
    assert_close(tres.obj_val, jres.obj_val, atol=1e-8)


def test_hooks_without_a_group_are_the_plain_reductions(monkeypatch):
    """A container that holds all its rows (``RowReductions``): the solve is
    bit for bit the one whose reductions are the plain per-problem
    expressions the hooks replaced."""
    tqp = both()[1]
    res = tadmm.solve(tqp, device="cpu")
    monkeypatch.setattr(tadmm, "_g_inf_norm", lambda qp, v: tadmm._norm0(v))
    monkeypatch.setattr(tadmm, "_g_max",
                        lambda qp, v, e: tadmm._max0(v, e))
    monkeypatch.setattr(tadmm, "_g_sum", lambda qp, v: v.sum(dim=0))
    plain = tadmm.solve(tqp, device="cpu")
    for f in dataclasses.fields(res):
        assert torch.equal(getattr(res, f.name), getattr(plain, f.name)), f


@dataclasses.dataclass(frozen=True)
class _GroupBanded(tbanded.BandedQP):
    """A one-process banded container that carries a group and reduces
    over it as the horizon-sharded container does."""

    process_group: object = None
    reduce = tbanded.ShardedBandedQP.reduce
    row_mean = tbanded.ShardedBandedQP.row_mean

    @property
    def n_valid_mask(self):
        return torch.ones(self.n, dtype=torch.bool)


def test_hooks_reduce_through_the_group():
    """A container with a one-rank gloo group: every scalar reduction of
    the solve (ADMM and Ruiz) goes through the collective helper, and the
    solve agrees with the group-less one."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        tb = both()[4]
        gb = _GroupBanded(process_group=dist.group.WORLD,
                          **{f.name: getattr(tb, f.name)
                             for f in dataclasses.fields(tb)})
        _comm.reset()
        res = tadmm.solve(gb, device="cpu")
        c = _comm.counts()
    finally:
        dist.destroy_process_group()
    ref = tadmm.solve(tb, device="cpu")
    assert set(c) == {"all_reduce"} and c["all_reduce"]["calls"] > 20
    assert c["all_reduce"]["sizes"] == [8]  # one (B,)=(1,) f64 scalar each
    assert int(res.status) == int(ref.status) == 0
    assert int(res.iterations) == int(ref.iterations)
    assert_close(res.x, ref.x, atol=1e-12)
