"""PyTorch port vs JAX package: the generic batched ADMM path on the
trajectory container (``gomp/trajectory_qp.py``'s operator protocol:
matvecs, norms, ``to_dense``, KKT blocks, scaling) and its solves, batched
and one problem.  f64, CPU: statuses and iteration counts equal, ``x``
within 1e-8, operators within 1e-12.  Split from ``test_torch_admm.py``,
whose set-up it imports."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_admm import (
    assert_same, both_trajectory, random_trajectory, settings_pair,
    trajectory_batch,
)
from test_torch_dense import lead
from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def test_solve_batched_trajectory_matches_jax():
    """W=10, N=6, B=4 on the trajectory container (its factor and solve:
    the block-tridiagonal kernels' plain versions here)."""
    jq, tq = both_trajectory(*trajectory_batch())
    js, ts = settings_pair()
    jres = jax.jit(lambda q: jadmm.solve_batched(q, js))(jq)
    tres = tadmm.solve_batched(tq, ts, device="cpu")
    assert_same(jres, tres)
    assert (to_np(tres.status) == ExitCode.kOptimal).all()


def test_solve_one_trajectory_matches_jax():
    static, arrays = trajectory_batch(B=1, seed=1)
    one = {k: v[0] for k, v in arrays.items()}
    jq, tq = both_trajectory(static, one)
    js, ts = settings_pair()
    jres = jax.jit(lambda q: jadmm.solve(q, js))(jq)
    tres = tadmm.solve(tq, ts, device="cpu")
    assert int(tres.status) == int(jres.status) == ExitCode.kOptimal
    assert int(tres.iterations) == int(jres.iterations)
    assert_close(tres.x, jres.x, rtol=1e-8, atol=1e-8)


def test_trajectory_operators_match_jax():
    jq, tq = random_trajectory()
    B = 3
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(B, jq.n)), rng.normal(size=(B, jq.m))
    tx, ty = torch.from_numpy(x.T.copy()), torch.from_numpy(y.T.copy())
    rho = rng.uniform(0.1, 2.0, (B, jq.m))

    @jax.jit
    def reference(jq, x, y, rho):
        """Every operator of the JAX container, one compiled program."""
        v = lambda f, *a: jax.vmap(f)(jq, *a)  # noqa: E731
        return ((v(lambda q, x: q.A_matvec(x), x),
                 v(lambda q, y: q.AT_matvec(y), y),
                 v(lambda q, x: q.P_matvec(x), x),
                 v(lambda q: q.A_col_absmax()), v(lambda q: q.A_row_absmax()),
                 v(lambda q: q.P_col_absmax()), v(lambda q: q.l),
                 v(lambda q: q.u)),
                v(lambda q: q.to_dense()),
                v(lambda q, r: q.kkt_blocks(r, 1e-6), rho))
    ops, dense, (jd, jl) = reference(jq, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(rho))
    assert (tq.n, tq.m) == (jq.n, jq.m)
    for got, ref in zip((tq.A_matvec(tx), tq.AT_matvec(ty), tq.P_matvec(tx),
                         tq.A_col_absmax(), tq.A_row_absmax(),
                         tq.P_col_absmax(), tq.l, tq.u), ops):
        assert_close(lead(got), ref, rtol=1e-12, atol=1e-12)
    for got, ref in zip(tq.to_dense(), dense):
        assert_close(lead(got), ref, rtol=1e-12, atol=1e-12)
    td, tl = tq.kkt_blocks(torch.from_numpy(rho.T.copy()), 1e-6)
    assert_close(lead(td), jd, rtol=1e-12, atol=1e-12)
    assert_close(lead(tl), jl, rtol=1e-12, atol=1e-12)


def test_trajectory_scale_data_matches_jax():
    jq, tq = random_trajectory(seed=2)
    B = 3
    rng = np.random.default_rng(3)
    D = rng.uniform(0.5, 2.0, (B, jq.n))
    E = rng.uniform(0.5, 2.0, (B, jq.m))
    c = rng.uniform(0.5, 2.0, B)
    js = jax.jit(jax.vmap(lambda q, D, E, c: q.scale_data(D, E, c)))(
        jq, jnp.asarray(D), jnp.asarray(E), jnp.asarray(c))
    ts = tq.scale_data(*(torch.from_numpy(np.ascontiguousarray(a.T))
                         for a in (D, E, c)))
    for k in convert._ARRAY_FIELDS:
        assert_close(lead(getattr(ts, k)), getattr(js, k), rtol=1e-12,
                     atol=1e-12)
