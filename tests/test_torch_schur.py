"""PyTorch port vs JAX package: the Schur horizon split (``parallel/schur.py``)
and the chunked trajectory container (``parallel/horizon.py``).

The same numpy inputs (made from a seed) go through both packages on the
CPU in f64.  The port puts the K chunks on the trailing batch axis; its
pieces are moved to the reference's leading chunk axis to compare.
Tolerance: 1e-10 on the split solves, the chunked ADMM solve's status and
iteration count equal and ``x`` within 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.parallel import horizon as jhorizon
from osqp_solver_tpu.parallel import multihost as jmultihost
from osqp_solver_tpu.parallel import schur as jschur
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import tridiag_kernel
from osqp_solver_tpu_torch.parallel import horizon as thorizon
from osqp_solver_tpu_torch.parallel import multihost as tmultihost
from osqp_solver_tpu_torch.parallel import schur as tschur

from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def spd_tridiag(W, B, seed):
    """Numpy ``(diag (W, B, B), lower (W-1, B, B), b (W, B))`` of a
    diagonally dominant symmetric block-tridiagonal system."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((W, B, B))
    diag = M @ M.transpose(0, 2, 1) + 4.0 * B * np.eye(B)
    lower = 0.5 * rng.standard_normal((W - 1, B, B))
    return diag, lower, rng.standard_normal((W, B))


def test_partition_round_trip_and_pieces_match_jax():
    W, B, K = 23, 4, 4
    diag, lower, b = spd_tridiag(W, B, 0)
    ch = tschur.partition_blocks(torch.tensor(diag), torch.tensor(lower), K)
    jch = jschur.partition_blocks(jnp.asarray(diag), jnp.asarray(lower), K)
    assert ch.n_blocks == jch.n_blocks == W
    assert_close(ch.Di.movedim(3, 0), jch.Di)
    assert_close(ch.Li.movedim(3, 0), jch.Li)
    for name in ("sepD", "Lleft", "Lright"):
        assert_close(getattr(ch, name).movedim(2, 0), getattr(jch, name))
    bi, bs = tschur.partition_rhs(torch.tensor(b), K)
    jbi, jbs = jschur.partition_rhs(jnp.asarray(b), K)
    assert_close(bi.movedim(2, 0), jbi)
    assert_close(bs.movedim(1, 0), jbs)
    merged = tschur.merge_solution(bi, bs[:, : K - 1], W)
    np.testing.assert_array_equal(to_np(merged), b)


def test_one_chunk_is_the_sequential_solve():
    """K=1 (a world of one rank): no separator, the split is the sequential
    tridiagonal solve bit for bit (the reference's form indexes an empty
    separator system there)."""
    diag, lower, b = (torch.tensor(a) for a in spd_tridiag(11, 4, 0))
    seq = tschur.tridiag_solve(tschur.tridiag_factor(diag, lower), b)
    assert torch.equal(tschur.schur_solve_reference(diag, lower, b, 1), seq)


@pytest.mark.parametrize("W,K", [(11, 2), (23, 4), (40, 8), (31, 3)])
def test_split_solves_match_jax(W, K):
    """``schur_solve_reference`` and ``schur_factor`` + ``schur_solve_cached``
    against the reference's, one problem and a batch of two (the port's
    trailing batch beside its chunk axis)."""
    B = 4
    diag, lower, b = spd_tridiag(W, B, W)
    jd, jl, jb = (jnp.asarray(a) for a in (diag, lower, b))
    ref = np.asarray(jax.jit(
        lambda d, l, r: jschur.schur_solve_reference(d, l, r, K))(jd, jl, jb))
    ref_c = np.asarray(jax.jit(lambda d, l, r: jschur.schur_solve_cached(
        jschur.schur_factor(d, l, K), r))(jd, jl, jb))
    td, tl, tb = (torch.tensor(a) for a in (diag, lower, b))
    assert_close(tschur.schur_solve_reference(td, tl, tb, K), ref, atol=1e-10)
    assert_close(tschur.schur_solve_cached(tschur.schur_factor(td, tl, K), tb),
                 ref_c, atol=1e-10)
    # a batch: the same problem and its negated right-hand side
    two = lambda a: torch.stack([a, a], dim=-1)  # noqa: E731
    x2 = tschur.schur_solve_cached(
        tschur.schur_factor(two(td), two(tl), K), torch.stack([tb, -tb], -1))
    assert_close(x2[..., 0], ref_c, atol=1e-10)
    assert_close(x2[..., 1], -ref_c, atol=1e-10)


def test_auto_chunks_matches_jax():
    for W in (1, 511, 512, 800, 10000, 30000):
        assert thorizon.auto_chunks(W) == jhorizon.auto_chunks(W), W


def test_as_chunked_solve_matches_jax():
    """The W=48 box QP through ``ops/admm.solve`` on ``as_chunked(qp, 4)``
    against the reference's ``ChunkedTrajectoryQP`` solve; the factor and
    solve reach the tridiagonal wrappers (their plain versions here)."""
    W, N, K = 48, 3, 4
    tqp = tmultihost.build_horizon_problem(W, N, torch.float64, "cpu")
    assert thorizon.as_chunked(tqp) is tqp  # auto_chunks(48) == 1
    jqp = jax.jit(jmultihost._build_horizon_problem,
                  static_argnums=(0, 1, 2))(W, N, jnp.float64)
    jres = jax.jit(lambda q: jadmm.solve(q))(jhorizon.as_chunked(jqp, K))
    chunked = thorizon.as_chunked(tqp, K)
    assert isinstance(chunked, thorizon.ChunkedTrajectoryQP)
    assert chunked.n_chunks == K
    tres = tadmm.solve(chunked, device="cpu")
    assert int(tres.status) == int(jres.status) == 0
    assert int(tres.iterations) == int(jres.iterations)
    assert_close(tres.x, jres.x, atol=1e-8)
    # the chunked and the sequential containers agree with each other too
    seq = tadmm.solve(tqp, device="cpu")
    assert int(seq.iterations) == int(tres.iterations)
    assert_close(seq.x, tres.x, atol=1e-8)


def test_interface_columns_one_solve_launch_per_factor(monkeypatch):
    """``schur_factor`` makes three kernel calls: the interiors' factor
    (the chunks as the batch), one solve of the interface columns (the
    factor laid out once per column: K·2·B2 problems) and the reduced
    factor; ``schur_solve_cached`` two solves."""
    W, B, K = 40, 4, 8
    diag, lower, b = (torch.tensor(a) for a in spd_tridiag(W, B, 5))
    calls = []
    real_f = tridiag_kernel.factor_lane_major
    real_s = tridiag_kernel.solve_lane_major

    def f(d, lo):
        calls.append(("factor", tuple(d.shape)))
        return real_f(d, lo)

    def s(c, g, r):
        calls.append(("solve", tuple(c.shape)))
        return real_s(c, g, r)

    monkeypatch.setattr(tridiag_kernel, "factor_lane_major", f)
    monkeypatch.setattr(tridiag_kernel, "solve_lane_major", s)
    sf = tschur.schur_factor(diag, lower, K)
    Wl = sf.chunks.Di.shape[0]
    assert calls == [("factor", (Wl, B, B, K)),
                     ("solve", (Wl, B, B, K * 2 * B)),
                     ("factor", (K - 1, B, B, 1))]
    calls.clear()
    tschur.schur_solve_cached(sf, b)
    assert calls == [("solve", (Wl, B, B, K)), ("solve", (K - 1, B, B, 1))]
