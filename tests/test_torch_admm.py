"""PyTorch port vs JAX package: the generic batched ADMM path
(``ops/admm.py``: ``solve_batched``, ``solve``, polish, ``kkt_refine``, the
CG backend of ``ops/cg.py``) on the dense container; on the trajectory
container it is ``test_torch_admm_trajectory.py``'s, with the helpers
here.

Every problem is made with numpy from a seed and handed to both packages.
f64, CPU: statuses and ADMM iteration counts must be EQUAL, ``x``/``y``
agree within 1e-8 (relative to their size where it exceeds 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory_qp as jtq
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import cg as jcg
from osqp_solver_tpu.ops import qp as jqp
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp import trajectory_qp as ttq
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tlane
from osqp_solver_tpu_torch.ops import cg as tcg
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_dense import both_dense, lead, random_dense
from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

INF = 1e30


def settings_pair(**kw):
    s = dataclasses.replace(jadmm.Settings(), **kw)
    return s, convert.settings_from_dict(dataclasses.asdict(s))


def assert_same(jres, tres, tol=1e-8):
    """Equal statuses and iteration counts; x, y within ``tol``."""
    np.testing.assert_array_equal(to_np(tres.status), np.asarray(jres.status))
    np.testing.assert_array_equal(to_np(tres.iterations),
                                  np.asarray(jres.iterations))
    for k in ("x", "y"):
        assert_close(getattr(tres, k), getattr(jres, k), rtol=tol, atol=tol)
    assert_close(tres.rho, jres.rho, rtol=1e-10)


# ------------------------------------------------------------- dense, batch

MIXED = np.array([1.0, 1e3, 1.0, 1e-3, 1.0, 30.0, 1.0, 0.1,
                  1.0, 1.0, 3.0, 1.0, 1.0, 1e2, 1.0, 1.0])


@pytest.mark.parametrize("case", [
    "default", "no_adaptation", "mixed_scaling0", "kkt_refine", "polish",
    "cg",
])
def test_solve_batched_dense_matches_jax(case):
    """B=16 random box QPs (B=6 for CG: each CG solve runs its 100 steps).
    ``mixed_scaling0``: badly scaled problems with ``scaling=0``, so that ρ
    adapts for a subset of the batch (the reference's own test of
    ``solve_batched``)."""
    B = 6 if case == "cg" else 16
    P, q, A, l, u = random_dense(B, 12, 18, seed=11)
    kw = {"default": {}, "no_adaptation": dict(adaptive_rho=False),
          "mixed_scaling0": dict(scaling=0), "kkt_refine": dict(kkt_refine=1),
          "polish": dict(polish=True), "cg": dict(kkt_method="cg")}[case]
    if case == "mixed_scaling0":
        P, q = P * MIXED[:, None, None], q * MIXED[:, None]
    jq, tq = both_dense((P, q, A, l, u))
    js, ts = settings_pair(**kw)
    jres = jax.jit(lambda q: jadmm.solve_batched(q, js))(jq)
    tres = tadmm.solve_batched(tq, ts, device="cpu")
    assert_same(jres, tres)
    assert (to_np(tres.status) == ExitCode.kOptimal).all()
    assert_close(tres.obj_val, jres.obj_val, rtol=1e-8)
    if case == "mixed_scaling0":
        assert len(set(to_np(tres.rho).tolist())) > 1  # adapted per problem


def test_solve_batched_counts_reads_and_refactors():
    """One device read per chunk; a batch refactor only when some problem's
    ρ moved (the mixed batch adapts at least once)."""
    P, q, A, l, u = random_dense(16, 12, 18, seed=11)
    _, tq = both_dense((P * MIXED[:, None, None], q * MIXED[:, None], A, l,
                        u))
    _, ts = settings_pair(scaling=0)
    s0, r0 = tadmm.HOST_SYNCS, tadmm.RHO_REFACTORS
    res = tadmm.solve_batched(tq, ts, device="cpu")
    chunks = int(res.iterations.max()) // ts.check_termination
    assert tadmm.HOST_SYNCS - s0 == chunks
    assert 1 <= tadmm.RHO_REFACTORS - r0 < chunks


def test_warm_start_matches_jax():
    P, q, A, l, u = random_dense(8, 10, 14, seed=3)
    jq, tq = both_dense((P, q, A, l, u))
    js, ts = settings_pair()
    solve = jax.jit(lambda q, wx=None, wy=None: jadmm.solve_batched(
        q, js, wx, wy))
    cold = solve(jq)
    rng = np.random.default_rng(0)
    wx = np.asarray(cold.x) + 1e-3 * rng.normal(size=cold.x.shape)
    wy = np.array(cold.y)
    jres = solve(jq, jnp.asarray(wx), jnp.asarray(wy))
    tres = tadmm.solve_batched(tq, ts, wx, wy, device="cpu")
    assert_same(jres, tres)
    assert int(tres.iterations.max()) <= int(np.asarray(cold.iterations).max())


# ----------------------------------------------------- dense, one problem


def _box():
    n = 8
    return (np.eye(n), -np.ones(n), np.eye(n), -0.5 * np.ones(n),
            0.5 * np.ones(n))


def _equality():
    rng = np.random.default_rng(0)
    n, p = 12, 4
    M = rng.normal(size=(n, n))
    b = rng.normal(size=p)
    return (M @ M.T + 0.5 * np.eye(n), rng.normal(size=n),
            rng.normal(size=(p, n)), b, b)


def _infinite_rows():
    n = 6
    A = np.vstack([np.eye(n), np.random.default_rng(1).normal(size=(4, n))])
    return (np.eye(n), -np.arange(1.0, n + 1), A,
            np.concatenate([-np.ones(n), -INF * np.ones(4)]),
            np.concatenate([np.ones(n), INF * np.ones(4)]))


def _primal_infeasible():
    return (np.eye(1), np.zeros(1), np.array([[1.0], [1.0]]),
            np.array([1.0, -INF]), np.array([INF, -1.0]))


def _dual_infeasible():
    return (np.zeros((1, 1)), -np.ones(1), np.eye(1), np.zeros(1),
            INF * np.ones(1))


def _nonconvex():
    return (np.array([[-4.0]]), np.zeros(1), np.eye(1), -np.ones(1),
            np.ones(1))


@pytest.mark.parametrize("case,status", [
    (_box, ExitCode.kOptimal), (_equality, ExitCode.kOptimal),
    (_infinite_rows, ExitCode.kOptimal),
    (_primal_infeasible, ExitCode.kPrimalInfeasible),
    (_dual_infeasible, ExitCode.kDualInfeasible),
    (_nonconvex, ExitCode.kNonConvex),
])
def test_solve_one_problem_matches_jax(case, status):
    """The analytic and certificate cases of ``tests/test_admm.py`` through
    ``solve`` (a batch of one); the nonconvex 1x1 P gives a NaN factor and
    the blow-up test flags it."""
    arrays = case()
    jq = jqp.dense_qp(*arrays)
    tq = convert.dense_qp_from_numpy(*arrays, device="cpu")
    jres = jax.jit(jadmm.solve)(jq)
    tres = tadmm.solve(tq, tadmm.Settings(), device="cpu")
    assert int(tres.status) == status == int(jres.status)
    assert int(tres.iterations) == int(jres.iterations)
    assert tuple(tres.x.shape) == tuple(np.shape(jres.x))
    for k in ("x", "y"):
        assert_close(getattr(tres, k), getattr(jres, k), rtol=1e-8, atol=1e-8)


def test_solve_refuses_a_batch_and_lane_keeps_its_refusals():
    _, tq = both_dense(random_dense(2, 3, 4))
    with pytest.raises(ValueError):
        tadmm.solve(tq, device="cpu")
    # The lane driver refuses the CG backend, as the reference's does; it
    # takes polish and refinement (tests/test_torch_lane_settings.py).
    cg = tadmm.Settings(kkt_method="cg")
    tadmm.check_supported(cg, generic=True)
    with pytest.raises(NotImplementedError, match="lane driver"):
        tadmm.check_supported(cg)
    with pytest.raises(NotImplementedError):
        tlane.solve_batched_lane(None, cg, device="cpu")
    for kw in (dict(polish=True), dict(kkt_refine=1)):
        s = tadmm.Settings(**kw)
        tadmm.check_supported(s, generic=True)
        tadmm.check_supported(s)
    # Anderson acceleration is the lane driver's only, as in the reference.
    tadmm.check_supported(tadmm.Settings(anderson=2))
    with pytest.raises(NotImplementedError, match="lane driver only"):
        tadmm.solve_batched(tq, tadmm.Settings(anderson=2), device="cpu")
    with pytest.raises(ValueError):
        tadmm.check_supported(tadmm.Settings(kkt_method="qr"), generic=True)


def test_solve_batched_default_device_is_cuda():
    _, tq = both_dense(random_dense(2, 3, 4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tadmm.solve_batched(tq)


def test_cg_solve_matches_jax():
    P, q, A, l, u = random_dense(4, 9, 11, seed=8)
    jq, tq = both_dense((P, q, A, l, u))
    rng = np.random.default_rng(2)
    rho = rng.uniform(0.1, 2.0, (4, 11))
    b = rng.normal(size=(4, 9))
    # The JAX references under jax.jit: one program each, not op by op.
    jr = jax.jit(jax.vmap(lambda qp, r, b: jcg.cg_solve(
        qp, r, 1e-6, b, tol=1e-10, max_iter=40)))(
        jq, jnp.asarray(rho), jnp.asarray(b))
    tr = tcg.cg_solve(tq, torch.from_numpy(rho.T.copy()), 1e-6,
                      torch.from_numpy(b.T.copy()), tol=1e-10, max_iter=40)
    np.testing.assert_array_equal(to_np(tr.iterations),
                                  np.asarray(jr.iterations))
    assert_close(lead(tr.x), jr.x, rtol=1e-10, atol=1e-12)
    jd = jax.jit(jax.vmap(lambda qp, r: jcg.kkt_diagonal(qp, r, 1e-6)))(
        jq, jnp.asarray(rho))
    assert_close(lead(tcg.kkt_diagonal(tq, torch.from_numpy(rho.T.copy()),
                                       1e-6)), jd, rtol=1e-12)


# ------------------------------------------------------------ trajectory


def trajectory_batch(B=4, W=10, N=6, seed=0):
    """``(static, batch-leading arrays)`` of a GOMP box batch (config-1
    class) with a gripper ball whose workspace rows box a random
    linearization: built by the port in f64, handed to both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float64, device="cpu")
    qp = ttq.empty_trajectory_qp(W, N, (True,), 0, batch_shape=(B,), **kw)
    start = torch.from_numpy(0.02 * rng.normal(size=(N, B)))
    end = torch.from_numpy(1.0 + 0.02 * rng.normal(size=(N, B)))
    full = lambda v: torch.full((N,), v, **kw)  # noqa: E731
    qp = ttq.with_gomp_boxes(qp, start, end, (full(-10.0), full(10.0)),
                             (full(-1.0), full(1.0)), (full(-2.0), full(2.0)))
    jac = torch.from_numpy(0.3 * rng.normal(size=(1, W, 3, N, B)))
    q_ws = torch.linspace(0, 1, W, dtype=torch.float64)[:, None, None]
    centre = (jac * q_ws[None, :, None]).sum(dim=3)
    qp = qp.replace(ws_jac=jac, ws_l=centre - 2.0, ws_u=centre + 2.0)
    static, arrays = convert.trajectory_qp_to_numpy(qp)
    return static, {k: np.moveaxis(v, -1, 0) for k, v in arrays.items()}


def both_trajectory(static, arrays):
    jq = jtq.TrajectoryQP(**static, **{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    return jq, convert.trajectory_qp_from_numpy(static, arrays, device="cpu")


def random_trajectory(B=3, W=6, N=3, seed=0):
    """Every array field of a two-ball, one-obstacle container random (the
    operators do not care about feasibility)."""
    rng = np.random.default_rng(seed)
    j0 = jax.eval_shape(lambda: jtq.empty_trajectory_qp(
        W, N, (False, True), 1, dtype=jnp.float64))
    arrays = {k: rng.normal(size=(B,) + np.shape(getattr(j0, k)))
              for k in convert._ARRAY_FIELDS}
    arrays["P_diag"] = arrays["P_diag"] + np.swapaxes(arrays["P_diag"], -1, -2)
    static = dict(waypoints=W, n_dim=N, gripper_flags=(False, True),
                  n_obstacles=1, p_structure="block")
    return both_trajectory(static, arrays)
