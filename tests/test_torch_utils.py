"""PyTorch port: ``utils/observability.py``, ``utils/checkpoint.py`` and
``utils/oracle.py`` (the port's own ctypes bridge to
``native/osqp_oracle.cpp``), on the CPU in f64.

``solve_stats`` must give the JAX package's dict for the same solve (counts
exact, residuals and ρ within 1e-10 relative); a checkpointed session must
resume bit for bit; the oracle must agree with the port's ``ops/admm.solve``
status for status on the reference's oracle cases."""
import jax
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.utils import observability as jobs
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.honest_batch import build_box_batch
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import session as tsession
from osqp_solver_tpu_torch.ops import session_lane as tsess
from osqp_solver_tpu_torch.ops.status import ExitCode
from osqp_solver_tpu_torch.utils import checkpoint, oracle
from osqp_solver_tpu_torch.utils import observability as tobs

from test_admm import random_qp
from test_native_oracle import _small_trajectory_qp

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)
INF = 1e30


_random_qp = jax.jit(random_qp, static_argnums=(1, 2))


def both_dense(seed, n=8, m=12):
    jq = _random_qp(jax.random.PRNGKey(seed), n, m)
    arrays = [np.asarray(a) for a in (jq.P, jq.q, jq.A, jq.l, jq.u)]
    return jq, arrays, convert.dense_qp_from_numpy(*arrays, device="cpu")


def assert_same_stats(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert_same_stats(got[k], v)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-10, abs=1e-300), k
        elif isinstance(v, list):
            assert got[k] == pytest.approx(v, rel=1e-10), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("batched", [False, True])
def test_solve_stats_match_jax(batched):
    if batched:
        jqs, tqs = [], []
        for seed in range(4):
            jq, arrays, _ = both_dense(seed + 1)
            jqs.append(jq)
            tqs.append(arrays)
        jq = jax.tree_util.tree_map(lambda *a: jax.numpy.stack(a), *jqs)
        tq = convert.dense_qp_from_numpy(
            *(np.stack(a) for a in zip(*tqs)), device="cpu")
        jres = jax.jit(jadmm.solve_batched)(jq)
        tres = tadmm.solve_batched(tq, device="cpu")
    else:
        jq, _, tq = both_dense(0)
        jres = jax.jit(jadmm.solve)(jq)
        tres = tadmm.solve(tq, device="cpu")
    want = jobs.solve_stats(jres)
    assert_same_stats(tobs.solve_stats(tres), want)
    assert want["problems"] == (4 if batched else 1)


def test_trace_writes_a_trace_and_prints_its_span(tmp_path, capsys):
    _, _, tq = both_dense(0)
    with tobs.trace("tiny solve", trace_dir=str(tmp_path)):
        tadmm.solve(tq, device="cpu")
    files = list(tmp_path.glob("*.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "tiny solve" in files[0].read_text()
    assert "[trace] tiny solve: " in capsys.readouterr().err
    with tobs.trace("no dir"):
        pass
    assert "[trace] no dir: " in capsys.readouterr().err


def test_stage_timer_accumulates():
    t = tobs.StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    d = t.as_dict()
    assert set(d) == {"a", "b"} and d["a"] >= 0.0 and d["b"] >= 0.0


def _same_tree(a, b):
    la, _ = checkpoint._flatten(a)
    lb, _ = checkpoint._flatten(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)
    assert checkpoint._fingerprint(a) == checkpoint._fingerprint(b)


GOAL = -3


def _shift(base, d):
    pos_l, pos_u = base.pos_l.clone(), base.pos_u.clone()
    pos_l[GOAL] += d
    pos_u[GOAL] += d
    return base.replace(pos_l=pos_l, pos_u=pos_u)


def test_checkpoint_round_trips_and_resumes_bit_for_bit(tmp_path):
    """A ``Session``, a ``LaneSession`` and a ``SolveResult`` round-trip; a
    fleet MPC sweep resumed from a checkpoint after two ticks equals the
    uninterrupted four-tick sweep bit for bit."""
    _, _, tq = both_dense(0)
    sess = tsession.setup(tq, device="cpu")
    sess, res = tsession.solve(sess)
    for name, state in (("session", sess), ("result", res)):
        path = str(tmp_path / f"{name}.npz")
        checkpoint.save(path, state)
        _same_tree(checkpoint.load(path, state), state)

    s = tadmm.Settings(rho=0.05, check_termination=5)
    qps = build_box_batch(3, W=8, N=6, dtype=torch.float64, device="cpu")
    lane0 = tsess.setup_lane(qps, s, device="cpu")
    deltas = torch.tensor(5e-3 * np.sin(0.3 * np.arange(4)[:, None, None]
                                        + np.arange(6)[None, :, None]))
    _, full = tsess.mpc_scan_lane(lane0, deltas, _shift, s, emit="full")
    lane2, head = tsess.mpc_scan_lane(lane0, deltas[:2], _shift, s,
                                      emit="full")
    path = str(tmp_path / "lane.npz")
    checkpoint.save(path, lane2)
    back = checkpoint.load(path, lane2)
    _same_tree(back, lane2)
    _, tail = tsess.mpc_scan_lane(back, deltas[2:], _shift, s, emit="full")
    for whole, a, b in zip(full, head, tail):
        assert torch.equal(whole, torch.cat([a, b]))
    assert (full[0] == ExitCode.kOptimal).all()


def test_checkpoint_load_refuses_mismatches(tmp_path):
    P, q, A = np.eye(3), np.zeros(3), np.ones((2, 3))
    qp = convert.dense_qp_from_numpy(P, q, A, -np.ones(2), np.ones(2),
                                     device="cpu")
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, qp)
    _same_tree(checkpoint.load(path, qp), qp)
    # the wrong class
    res = tadmm.solve(qp, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load(path, res)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load(path, (torch.zeros(3), torch.zeros(3)))
    # the wrong leaf count (a file that lost a leaf)
    data = dict(np.load(path))
    del data[sorted(k for k in data if k.startswith("leaf_"))[-1]]
    short = str(tmp_path / "short.npz")
    np.savez(short, **data)
    with pytest.raises(ValueError, match="stored leaves"):
        checkpoint.load(short, qp)
    # the wrong shape under strict_shapes, accepted without
    other = convert.dense_qp_from_numpy(np.eye(4), np.zeros(4),
                                        np.ones((2, 4)), -np.ones(2),
                                        np.ones(2), device="cpu")
    with pytest.raises(ValueError, match="template expects"):
        checkpoint.load(path, other)
    loose = checkpoint.load(path, other, strict_shapes=False)
    assert torch.equal(loose.P, qp.P)


def test_oracle_agrees_with_the_port_status_for_status():
    """The reference's oracle cases: random feasible QPs (n=16, m=24 and
    n=12, m=20), a contradictory one, and the small trajectory QP through
    the sparse banded-KKT oracle."""
    if not oracle.available():
        pytest.skip("g++ unavailable to build the native oracle")
    for seed, n, m in ((0, 16, 24), (3, 16, 24), (8, 16, 24), (5, 12, 20)):
        _, arrays, tq = both_dense(seed, n, m)
        res_c = oracle.solve(*arrays)
        res_t = tadmm.solve(tq, device="cpu")
        assert res_c.status == int(res_t.status) == ExitCode.kOptimal
        assert res_c.prim_res < 1e-2 and res_c.dual_res < 1e-2
        np.testing.assert_allclose(res_c.x, res_t.x.numpy(), atol=5e-2)
    A = np.array([[1.0], [1.0]])
    l = np.array([1.0, -INF])
    u = np.array([INF, -1.0])
    res_c = oracle.solve(np.eye(1), np.zeros(1), A, l, u)
    res_t = tadmm.solve(convert.dense_qp_from_numpy(
        np.eye(1), np.zeros(1), A, l, u, device="cpu"), device="cpu")
    assert res_c.status == int(res_t.status) == ExitCode.kPrimalInfeasible
    # tensors are taken as they are
    assert oracle.solve(*(torch.tensor(a) for a in arrays)).status == 0
    tqp = convert.trajectory_qp_from_numpy(
        *convert.trajectory_qp_to_numpy(jax.jit(_small_trajectory_qp)()),
        device="cpu")
    P_csr, q_int, A_csr, lo, up, kb, perm = tqp.to_csr()
    res_c = oracle.solve_sparse(P_csr, q_int, A_csr, lo, up, kb)
    res_t = tadmm.solve(tqp, device="cpu")
    assert res_c.status == int(res_t.status) == ExitCode.kOptimal
    np.testing.assert_allclose(res_c.x[perm], res_t.x.numpy(), atol=5e-2)
    assert oracle._lib_path().exists()
    assert "native/build" not in str(oracle._lib_path())
