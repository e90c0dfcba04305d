"""PyTorch port vs JAX package across real process boundaries: one spawned
run of ``python -m osqp_solver_tpu_torch.parallel.multihost --device cpu``,
four gloo ranks, f64.

While the ranks run, the parent computes the JAX package's sharded figures
in-process (on the virtual CPU devices of ``conftest.py``) for the same
numpy-built problems; each rank writes its results to an ``.npz`` that the
parent holds against them.  Checked:

* ``solve_batch_sharded`` (16 random QPs, n=12, m=18) against the one-process
  ``solve_batch`` (1e-9, equal counts) and JAX's sharded result (1e-9,
  equal counts);
* ``schur_solve_sharded`` (W=63, B2=4) against the sequential solve and
  JAX's (1e-9);
* ``solve_horizon_sharded`` (W=48, N=3) on the 1x4 and the 2x2 mesh with
  ``local_chunks`` 1 and 2: JAX's status and iterations, ``x`` within 1e-8;
* the collective helper's payload sizes at W=48 and W=96: the same;
* ``solve_banded_sharded_2d`` on the 2x2 mesh against one-process solves;
* ``run_batch_lane_sharded`` / ``run_batch_padded_sharded`` (N=3, identity
  ball) against the one-process calls (equal counts, 1e-8).
"""
import json
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import qp as jqp
from osqp_solver_tpu.parallel import batch as jbatch
from osqp_solver_tpu.parallel import horizon as jhorizon
from osqp_solver_tpu.parallel import mesh as jmesh
from osqp_solver_tpu.parallel import multihost as jmultihost
from osqp_solver_tpu.parallel import schur as jschur
from osqp_solver_tpu_torch.parallel import multihost as tmultihost

pytestmark = [pytest.mark.torch_port, pytest.mark.multiprocess]

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_figures():
    """The JAX package's sharded results of the workers' problems; the six
    programs are compiled three at a time (XLA compiles outside the GIL)."""
    qp = jax.jit(jmultihost._build_horizon_problem,
                 static_argnums=(0, 1, 2))(48, 3, jnp.float64)

    def batch():
        qps = jqp.DenseQP(*(jnp.asarray(a)
                            for a in tmultihost.batch_problems()))
        r = jbatch.solve_batch_sharded(qps, jmesh.make_mesh(batch=RANKS,
                                                            horizon=1))
        return dict(batch_x=r.x, batch_status=r.status,
                    batch_iters=r.iterations)

    def schur():
        # Under jax.jit: one program instead of ~70 eager ones, the same
        # values bit for bit.
        d, lo, b = (jnp.asarray(a) for a in tmultihost.spd_tridiag(63, 4))
        mesh = jmesh.make_mesh(batch=1, horizon=RANKS)
        solve = jax.jit(
            lambda d, lo, b: jschur.schur_solve_sharded(d, lo, b, mesh))
        return dict(schur_x=solve(d, lo, b))

    def horizon(rows, lc):
        mesh = jmesh.make_mesh(batch=rows, horizon=RANKS // rows)
        r = jhorizon.solve_horizon_sharded(qp, mesh, local_chunks=lc)
        name = f"{rows}x{RANKS // rows}_lc{lc}"
        return {f"{name}_x": r.x, f"{name}_status": r.status,
                f"{name}_iters": r.iterations}

    jobs = [batch, schur] + [lambda v=v: horizon(*v)
                             for v in tmultihost.HORIZON_VARIANTS]
    out = {}
    with ThreadPoolExecutor(3) as pool:
        for part in pool.map(lambda job: job(), jobs):
            out.update(part)
    return {k: np.asarray(v) for k, v in out.items()}


def test_four_ranks_match_jax_and_one_process(tmp_path):
    assert jax.config.jax_enable_x64
    master = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "osqp_solver_tpu_torch.parallel.multihost",
             "--device", "cpu", "--master", master,
             "--world-size", str(RANKS), "--rank", str(r),
             "--out", str(tmp_path / f"rank{r}.json"),
             "--save", str(tmp_path / f"rank{r}.npz"), "--timeout", "240"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(RANKS)
    ]
    logs = []
    try:
        ref = _jax_figures()
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    reports, saved = [], []
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        reports.append(json.loads((tmp_path / f"rank{r}.json").read_text()))
        saved.append(dict(np.load(tmp_path / f"rank{r}.npz")))
    for r, (rep, got) in enumerate(zip(reports, saved)):
        assert rep["ok"], rep
        assert rep["process"] == r and rep["num_processes"] == RANKS
        assert set(got) == set(ref)
        for k in ref:
            if k.endswith("_x"):
                tol = 1e-9 if k in ("batch_x", "schur_x") else 1e-8
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert set(rep["horizon_variants"]) == {
            "1x4_lc1", "1x4_lc2", "2x2_lc1", "2x2_lc2"}
        assert rep["payload"]["same_at_2W"]
        sizes = rep["payload"]["per_W"]["48"]["sizes"]
        assert max(sizes["all_gather"]) <= RANKS * 6 * 6 * 8 * 4
        assert sizes["all_reduce"] == [8]
        assert rep["mesh2d"]["grid"] == [2, 2]
        assert rep["planner"]["scp_iters_match"]
        assert rep["planner"]["padded_counts_match"]
        assert rep["planner"]["padded_optimal"] >= 4
    # every rank returns the same gathered results
    for key in ("batch", "horizon", "horizon_variants", "mesh2d", "planner"):
        assert all(rep[key] == reports[0][key] for rep in reports), key
