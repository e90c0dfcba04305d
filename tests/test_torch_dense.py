"""PyTorch port vs JAX package: the batched dense Cholesky factor and solve
(``ops/dense_kernel.py``) and the dense container (``ops/qp.py``).

The plain versions are held to ``pallas_dense.factor_lane_major`` /
``solve_lane_major`` in interpret mode (at n=8, and for the NaN semantics
of a failing column) or to the XLA path the JAX package's tests hold them
to, at the tolerances of ``tests/test_pallas_dense.py``, and
``csrc/dense.cu`` compiled in host emulation (g++, double) to the plain
versions at 1e-9.  The container's
operators, norms, scaling and Ruiz equilibration are held to the JAX
package's at 1e-12.  f64 unless stated, CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import pallas_dense as jpd
from osqp_solver_tpu.ops import qp as jqp
from osqp_solver_tpu.ops import ruiz as jruiz
from osqp_solver_tpu_torch import _build, convert
from osqp_solver_tpu_torch.ops import dense_kernel as tdk
from osqp_solver_tpu_torch.ops import qp as tqp
from osqp_solver_tpu_torch.ops import ruiz as truiz

from test_torch_helpers import (
    assert_close, host_lib_signature, jit_vmap, to_np,
)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def spd_batch(n, B, seed=0, dtype=np.float64):
    """Batch-trailing SPD matrices ``(n, n, B)`` (``M Mᵀ/n + 0.5 I``, as
    ``tests/test_pallas_dense.py``) and a right-hand side ``(n, B)``."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, n, n))
    M = a @ a.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    rhs = rng.normal(size=(n, B))
    return (np.ascontiguousarray(np.moveaxis(M, 0, -1)).astype(dtype),
            rhs.astype(dtype))


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,B", [(8, 3), (24, 5), (64, 2)])
def test_plain_matches_pallas_interpret(n, B):
    """The shapes and tolerances of ``tests/test_pallas_dense.py``, in
    float32 as there.  At n=8 the reference's Pallas factor and solve run
    in interpret mode (their one interpret-mode case here); at n=24 and 64
    the plain versions are held to the XLA path that
    ``tests/test_pallas_dense.py::test_factor_kernel_matches_xla`` and
    ``::test_solve_kernel_matches_xla`` hold the interpreted kernels to at
    these shapes (``jnp.linalg.cholesky`` and ``jnp.linalg.solve`` under
    ``vmap``)."""
    M, rhs = spd_batch(n, B, seed=n, dtype=np.float32)
    if n == 8:
        jLt = jpd.factor_lane_major(jnp.asarray(M), interpret=True)
        jx = jpd.solve_lane_major(jLt, jnp.asarray(rhs), interpret=True)
    else:
        Ms = jnp.moveaxis(jnp.asarray(M), -1, 0)
        jLt = jnp.moveaxis(jax.vmap(jnp.linalg.cholesky)(Ms).swapaxes(-1, -2),
                           0, -1)
        jx = jax.vmap(jnp.linalg.solve)(Ms, jnp.asarray(rhs.T)).T
    Lt = tdk.factor_lane_major(t_(M))
    assert_close(Lt, jLt, rtol=2e-4, atol=2e-4)
    x = tdk.solve_lane_major(Lt, t_(rhs))
    assert_close(x, jx, rtol=2e-3, atol=2e-3)
    assert tdk.factor_lane_major.launches == 0
    assert tdk.solve_lane_major.launches == 0


def test_plain_non_spd_problem_gives_nan():
    """A problem whose matrix is not positive definite: the reference's
    Pallas kernel gives NaN from the failing column on, the plain version
    (``jnp.linalg.cholesky`` semantics) the whole problem; both leave the
    other problems untouched and both solves give NaN there."""
    n, B, bad, col = 8, 3, 1, 5
    M, rhs = spd_batch(n, B, seed=1)
    M[col, col, bad] = -1.0
    jLt = np.asarray(jpd.factor_lane_major(jnp.asarray(M), interpret=True))
    Lt = to_np(tdk.factor_lane_major(t_(M)))
    low = np.triu(np.ones((n, n), bool))  # Lt[j, i] with i >= j
    assert np.isnan(jLt[col:][low[col:], bad]).all()
    assert np.isnan(Lt[..., bad][low]).all()
    others = [b for b in range(B) if b != bad]
    assert_close(Lt[..., others], jLt[..., others], rtol=1e-12, atol=1e-12)
    x = to_np(tdk.solve_lane_major(t_(Lt), t_(rhs)))
    assert np.isnan(x[:, bad]).all() and np.isfinite(x[:, others]).all()


# Host emulation of the launches: 16 threads per block (the emulated warp is
# 4 threads), planned for 2 SMs; CARD is an H100's shared memory per block.
CARD, THREADS, SMS = 232448, 16, 2


def _emulated(M, rhs, budget=CARD):
    """Factor and solve through ``csrc/dense.cu`` in host emulation, planned
    for ``budget`` bytes of shared memory per block; returns ``(Lt, x,
    factor plan, solve plan)``."""
    lib = tdk.configure(host_lib_signature("dense", {}))
    kw = dict(budget=budget, threads=THREADS, sms=SMS)
    Lt = torch.full_like(M, float("nan"))
    tdk._launch(lib, "factor", M, Lt, **kw)
    x = torch.full_like(rhs, float("nan"))
    tdk._launch(lib, "solve", Lt, rhs, x, **kw)
    n, B = rhs.shape
    return (Lt, x, tdk.plan(lib, "factor", n, B, **kw),
            tdk.plan(lib, "solve", n, B, **kw))


@pytest.mark.parametrize("n,B,budget,branches", [
    pytest.param(1, 1, CARD, (0, 0), id="1-1"),
    pytest.param(8, 37, CARD, (0, 0), id="8-37"),
    pytest.param(24, 3, CARD, (0, 0), id="24-3"),
    pytest.param(64, 33, CARD, (0, 0), id="64-33"),
    # Small budgets: the factor on its device-memory scratch; the solve
    # with L read from Lt and the vector in shared memory (2000 bytes), or
    # in x (100 bytes).
    pytest.param(24, 5, 2000, (1, 1), id="24-5-device"),
    pytest.param(40, 7, 100, (1, 2), id="40-7-device"),
])
def test_emulated_kernels_match_plain(n, B, budget, branches, tmp_path,
                                      monkeypatch):
    """B = 37, 33, 5, 7: not a multiple of the problems per block; n = 1
    and B = 1: the single-problem and 1x1 cases of the solver; the last two
    cases take the branches that an H100 runs for n > 336 (factor) and
    n > 58,112 (solve)."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    M, rhs = (t_(a) for a in spd_batch(n, B, seed=n + B))
    Lt, x, fplan, splan = _emulated(M, rhs, budget)
    assert (fplan["branch"], splan["branch"]) == branches
    assert_close(Lt, tdk.factor_lane_major_plain(M), rtol=1e-9, atol=1e-12)
    iu = torch.ones(n, n, dtype=torch.bool).tril(-1)  # Lt[j, i], i < j
    assert (Lt[iu] == 0).all()  # zeros above the diagonal of L written
    assert_close(x, tdk.solve_lane_major_plain(Lt, rhs), rtol=1e-9,
                 atol=1e-12)
    # and the solve really solves M x = rhs
    Mx = torch.einsum("ijb,jb->ib", M, x)
    assert_close(Mx, rhs, rtol=1e-9, atol=1e-9)


def _check_nan_from_column(budget, factor_branch):
    """The kernel turns the failing column and every later one of that
    problem into NaN (earlier columns keep their values, as the
    reference's Pallas kernel does), and touches no other problem."""
    n, B, bad, col = 12, 37, 7, 4
    M, rhs = spd_batch(n, B, seed=3)
    M[col, col, bad] = 0.0  # a zero pivot is not positive either
    Lt, x, fplan, _ = _emulated(t_(M), t_(rhs), budget)
    assert fplan["branch"] == factor_branch
    Lt, x = to_np(Lt), to_np(x)
    jLt = np.asarray(jpd.factor_lane_major(
        jnp.asarray(M[..., bad:bad + 1]), interpret=True))[..., 0]
    low = np.triu(np.ones((n, n), bool))
    rows = np.arange(n)[:, None] >= col
    assert np.isnan(Lt[..., bad][low & rows]).all()
    assert_close(Lt[:col, :, bad], jLt[:col], rtol=1e-12, atol=1e-12)
    assert np.isnan(x[:, bad]).all()
    others = np.arange(B) != bad
    assert np.isfinite(Lt[..., others]).all()
    assert np.isfinite(x[:, others]).all()
    assert_close(Lt[..., others], to_np(tdk.factor_lane_major_plain(
        t_(M[..., others]))), rtol=1e-9, atol=1e-12)


def test_emulated_non_spd_problem_gives_nan_from_its_column(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    _check_nan_from_column(CARD, 0)


def test_emulated_non_spd_problem_gives_nan_in_device_memory_branch(
        tmp_path, monkeypatch):
    """The same planted pivot with the triangles in the device-memory
    scratch buffer (a budget below one triangle)."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    _check_nan_from_column(200, 1)


def test_wrappers_refuse_bad_arguments():
    M, rhs = (t_(a) for a in spd_batch(4, 3))
    with pytest.raises(ValueError):
        tdk.factor_lane_major(M[:, :3])
    Lt = tdk.factor_lane_major(M)
    with pytest.raises(ValueError):
        tdk.solve_lane_major(Lt, rhs[:, :2])
    with pytest.raises(TypeError):
        tdk.solve_lane_major(Lt, rhs.float())
    assert _build.KERNELS["dense"] == ()


# --------------------------------------------------------------- container


def random_dense(B, n, m, seed=0):
    """Batch-leading numpy arrays of random feasible box QPs (the JAX
    package's vmapped layout)."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(B, n, n))
    P = Mx @ Mx.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    x0 = rng.normal(size=(B, n))
    margin = np.abs(rng.normal(size=(B, m))) + 0.1
    Ax0 = np.einsum("bmn,bn->bm", A, x0)
    return P, q, A, Ax0 - margin, Ax0 + margin


def both_dense(arrays):
    jq = jqp.DenseQP(*(jnp.asarray(a) for a in arrays))
    return jq, convert.dense_qp_from_numpy(*arrays, device="cpu")


def lead(t):
    return np.moveaxis(to_np(t), -1, 0)


@pytest.mark.parametrize("batch_major", [False, True])
def test_dense_operators_norms_and_scaling_match_jax(batch_major):
    B, n, m = 5, 7, 9
    jq, tq = both_dense(random_dense(B, n, m, seed=2))
    if batch_major:
        tq = tq.batch_major()
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(B, n)), rng.normal(size=(B, m))
    tx, ty = t_(x.T), t_(y.T)
    v = lambda f, *a: np.asarray(jit_vmap(f)(jq, *a))  # noqa: E731
    for got, ref in (
        (tq.P_matvec(tx), v(lambda q, x: q.P_matvec(x), jnp.asarray(x))),
        (tq.A_matvec(tx), v(lambda q, x: q.A_matvec(x), jnp.asarray(x))),
        (tq.AT_matvec(ty), v(lambda q, y: q.AT_matvec(y), jnp.asarray(y))),
        (tq.P_col_absmax(), v(lambda q: q.P_col_absmax())),
        (tq.A_col_absmax(), v(lambda q: q.A_col_absmax())),
        (tq.A_row_absmax(), v(lambda q: q.A_row_absmax())),
    ):
        assert_close(lead(got), ref, rtol=1e-12, atol=1e-12)
    D = rng.uniform(0.5, 2.0, (B, n))
    E = rng.uniform(0.5, 2.0, (B, m))
    c = rng.uniform(0.5, 2.0, B)
    js = jit_vmap(lambda q, D, E, c: q.scale_data(D, E, c))(
        jq, jnp.asarray(D), jnp.asarray(E), jnp.asarray(c))
    ts = tq.scale_data(t_(D.T), t_(E.T), t_(c))
    for k in ("P", "q", "A", "l", "u"):
        assert_close(lead(getattr(ts, k)), getattr(js, k), rtol=1e-12,
                     atol=1e-12)
    rho = rng.uniform(0.1, 3.0, (B, m))
    jM = jit_vmap(lambda q, r: q.P + 1e-6 * jnp.eye(n) + q.A.T @ (
        r[:, None] * q.A))(jq, jnp.asarray(rho))
    assert_close(lead(tq.kkt_matrix(t_(rho.T), 1e-6)), jM, rtol=1e-12,
                 atol=1e-12)


def test_ruiz_equilibrate_matches_jax():
    B, n, m = 4, 6, 8
    jq, tq = both_dense(random_dense(B, n, m, seed=5))
    js, jsc = jit_vmap(lambda q: jruiz.ruiz_equilibrate(q, 10))(jq)
    ts, tsc = truiz.ruiz_equilibrate(tq, 10)
    for k in ("D", "E", "c"):
        assert_close(lead(getattr(tsc, k)), getattr(jsc, k), rtol=1e-12,
                     atol=1e-14)
    for k in ("P", "A", "q", "l", "u"):
        assert_close(lead(getattr(ts, k)), getattr(js, k), rtol=1e-12,
                     atol=1e-14)
    ident = truiz.identity_scaling(n, m, torch.float64, (B,))
    assert ident.D.shape == (n, B) and ident.c.shape == (B,)
    assert bool((ident.E == 1).all())


def test_dense_qp_builder_and_converter():
    arrays = random_dense(3, 4, 5, seed=6)
    tq = convert.dense_qp_from_numpy(*arrays, device="cpu")
    assert tuple(tq.P.shape) == (4, 4, 3) and tq.batch_shape == (3,)
    one = convert.dense_qp_from_numpy(*(a[0] for a in arrays), device="cpu")
    assert one.batch_shape == () and tuple(one.A.shape) == (5, 4)
    built = tqp.dense_qp(np.eye(2, dtype=np.float32), [1.0, 2.0], np.eye(2),
                         [0.0, 0.0], [1.0, 1.0])
    assert built.q.dtype == torch.float64 and built.P.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.dense_qp_from_numpy(*arrays)
