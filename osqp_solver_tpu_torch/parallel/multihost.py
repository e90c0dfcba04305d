"""Multi-process execution path over ``torch.distributed``.

Counterpart of ``osqp_solver_tpu/parallel/multihost.py`` (``initialize``,
``run_worker``, ``main``).  One process per mesh slot: with one GPU per rank
the group is NCCL; on the CPU, and where several ranks share one GPU, it is
gloo (:mod:`._comm` then stages the CUDA payloads through the host).

Run one worker per rank, e.g. four on the CPU::

    python -m osqp_solver_tpu_torch.parallel.multihost --device cpu \\
        --master 127.0.0.1:29500 --world-size 4 --rank K --out verdict_K.json

Each worker builds the same deterministic problems, solves them on the
global mesh — batch-sharded ADMM, horizon-sharded banded ADMM (on a 1-D
horizon mesh and, with an even world, a 2-D ``(batch, horizon)`` mesh), the
sharded planner fleet — checks each against its own one-process solve, and
writes a JSON verdict with the reference's keys (plus the port's extra
checks).  ``--save FILE.npz`` also writes the rank's results (solutions,
statuses, iteration counts) for a caller to hold against another package.

The reference's ``replicate_to_global`` (lifting identical process-local
arrays to a global ``jax.Array``) has no torch counterpart beyond a
``torch.distributed.broadcast``: a process holds plain tensors, and every
rank here builds the same inputs, so nothing is replicated.
"""
from __future__ import annotations

import argparse
import datetime
import json
import pathlib

import numpy as np
import torch
import torch.distributed as dist


def initialize(master: str = "127.0.0.1:29500", world_size: int = 1,
               rank: int = 0, device: str = "cuda",
               timeout_s: float = 300.0) -> str:
    """Start this process's ``torch.distributed`` group; returns the
    backend: NCCL when every rank has a GPU of its own, gloo on the CPU and
    where ranks share a GPU.  ``timeout_s`` bounds every collective, so a
    rank that took another branch fails instead of hanging."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA device")
        n_gpu = torch.cuda.device_count()
        torch.cuda.set_device(rank % n_gpu)
        backend = "nccl" if n_gpu >= world_size else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{master}", world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return backend


# ---------------------------------------------------------------------------
# Worker: build → solve sharded → compare with the one-process solve
# ---------------------------------------------------------------------------


def batch_problems(batch: int = 16, n: int = 12, m: int = 18, seed: int = 0):
    """Batch-leading numpy arrays ``(P, q, A, l, u)`` of random feasible box
    QPs (the same for every rank and for the reference package)."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(batch, n, n))
    P = Mx @ Mx.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n))
    x0 = rng.normal(size=(batch, n))
    margin = np.abs(rng.normal(size=(batch, m))) + 0.1
    Ax0 = np.einsum("bmn,bn->bm", A, x0)
    return P, q, A, Ax0 - margin, Ax0 + margin


def spd_tridiag(W: int, B: int, seed: int = 3):
    """Numpy ``(diag (W, B, B), lower (W-1, B, B), b (W, B))`` of a
    diagonally dominant symmetric block-tridiagonal system."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((W, B, B))
    diag = M @ M.transpose(0, 2, 1) + 4.0 * B * np.eye(B)
    lower = 0.5 * rng.standard_normal((W - 1, B, B))
    return diag, lower, rng.standard_normal((W, B))


def build_horizon_problem(W: int, N: int, dtype, device, shift: float = 0.0):
    """The reference worker's box-only trajectory QP (start 0, end 1; the
    last position box moved by ``shift``)."""
    from ..gomp.trajectory_qp import empty_trajectory_qp, with_gomp_boxes

    kw = dict(dtype=dtype, device=device)
    base = empty_trajectory_qp(W, N, gripper_flags=(), n_obstacles=0, **kw)
    qp = with_gomp_boxes(
        base, torch.zeros(N, **kw), torch.ones(N, **kw),
        (torch.full((N,), -10.0, **kw), torch.full((N,), 10.0, **kw)),
        (torch.full((N,), -1.0, **kw), torch.full((N,), 1.0, **kw)),
        (torch.full((N,), -2.0, **kw), torch.full((N,), 2.0, **kw)),
    )
    if shift:
        qp = qp.replace(pos_l=qp.pos_l.clone(), pos_u=qp.pos_u.clone())
        qp.pos_l[-1] += shift
        qp.pos_u[-1] += shift
    return qp


def _identity_fk_jac(q, axis=-1):
    """Identity kinematics: the ball sits at the joint vector."""
    axis = axis % q.dim()
    shape = [1] * (q.dim() + 1)
    shape[axis] = shape[axis + 1] = 3
    jac = torch.eye(3, dtype=q.dtype, device=q.device).reshape(shape).expand(
        q.shape[:axis] + (3, 3) + q.shape[axis + 1:])
    return q, jac


def planner(waypoints: int, dtype, device, obstacles=(), **kw):
    """The reference sharding tests' planner: N=3, one identity ball."""
    from ..gomp import constraints as C
    from ..gomp.planner import GOMPSolver
    from ..models.robot import RobotBall

    ball = RobotBall(radius=0.05, is_gripper=True,
                     fk_jac_batched=_identity_fk_jac)
    return GOMPSolver(
        max_waypoints=waypoints, time_step=0.1,
        pos_con=C.in_range(3, -10, 10), vel_con=C.in_range(3, -20, 20),
        acc_con=C.in_range(3, -40, 40), con_3d=C.in_range(3, -10, 10),
        obstacles=list(obstacles), balls=[ball], dtype=dtype, device=device,
        **kw)


def planner_queries(B: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    starts = 0.1 * rng.standard_normal((B, 3))
    ends = np.array([1.0, 0.5, -0.25]) + 0.1 * rng.standard_normal((B, 3))
    return starts, ends


# (mesh rows, local chunks) of the horizon-sharded variants; rows 2 is the
# 2-D (batch, horizon) mesh.
HORIZON_VARIANTS = ((1, 1), (1, 2), (2, 1), (2, 2))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - np.asarray(b)))) if np.size(b) else 0.0


def run_worker(out_path: str, device: str = "cuda", save=None,
               batch: int = 16, W_hor: int = 48, N: int = 3) -> dict:
    """Body of one process (after :func:`initialize`): the sharded solves
    on the global mesh, checked against this process's own one-process
    solves; ``save``: an ``.npz`` path for the results."""
    from .. import convert
    from ..gomp.geometry import HorizontalLine
    from ..ops import admm
    from . import _comm
    from .banded import banded_from_trajectory, solve_banded_sharded_2d
    from .batch import solve_batch, solve_batch_sharded
    from .horizon import solve_horizon_sharded
    from .mesh import make_mesh, mesh_device
    from .schur import schur_solve_sharded, tridiag_factor, tridiag_solve

    world, rank = dist.get_world_size(), dist.get_rank()
    f64 = device == "cpu"
    dtype = torch.float64 if f64 else torch.float32
    tol_b, tol_h = (1e-9, 1e-6) if f64 else (2e-4, 2e-3)
    settings = admm.Settings()
    saved = {}
    report: dict = {
        "process": rank, "num_processes": world, "global_devices": world,
        "local_devices": 1, "backend": dist.get_backend(),
    }

    # ---- batch axis over every rank ---------------------------------------
    mesh_b = make_mesh(batch=world, horizon=1, device=device)
    dev = mesh_device(mesh_b)
    qps = convert.dense_qp_from_numpy(*batch_problems(batch), device=dev,
                                      dtype=dtype)
    res_b = solve_batch_sharded(qps, mesh_b, settings)
    ref_b = solve_batch(qps, settings, device=dev)
    err_b = _err(res_b.x, _np(ref_b.x))
    report["batch"] = {
        "max_abs_err_vs_local": err_b,
        "all_optimal": bool(np.all(_np(res_b.status) == 0)),
        "statuses_match": bool(np.array_equal(_np(res_b.status),
                                              _np(ref_b.status))),
        "iterations_match": bool(np.array_equal(_np(res_b.iterations),
                                                _np(ref_b.iterations))),
    }
    ok = (report["batch"]["all_optimal"] and report["batch"]["statuses_match"]
          and err_b <= tol_b)
    saved.update(batch_x=res_b.x, batch_status=res_b.status,
                 batch_iters=res_b.iterations)

    # ---- the Schur split of one block-tridiagonal system over every rank --
    mesh_h = make_mesh(batch=1, horizon=world, device=device)
    sys_t = [torch.tensor(a, dtype=dtype, device=dev)
             for a in spd_tridiag(63, 4)]
    x_s = schur_solve_sharded(*sys_t, mesh_h)
    x_seq = tridiag_solve(tridiag_factor(sys_t[0], sys_t[1]), sys_t[2])
    report["schur"] = {"max_abs_err_vs_sequential": _err(x_s, _np(x_seq))}
    ok = ok and report["schur"]["max_abs_err_vs_sequential"] <= tol_b
    saved["schur_x"] = x_s

    # ---- horizon axis over every rank (its collectives counted) -----------
    qp_h = build_horizon_problem(W_hor, N, dtype, dev)
    _comm.reset()
    res_h = solve_horizon_sharded(qp_h, mesh_h, settings)
    counts_h = _comm.counts()
    ref_h = admm.solve(qp_h, settings, device=dev)
    err_h = _err(res_h.x, _np(ref_h.x))
    report["horizon"] = {
        "max_abs_err_vs_local": err_h,
        "status": int(res_h.status), "ref_status": int(ref_h.status),
        "iterations": int(res_h.iterations),
        "ref_iterations": int(ref_h.iterations),
    }
    ok = ok and (report["horizon"]["status"] == report["horizon"]["ref_status"]
                 == 0 and err_h <= tol_h
                 and report["horizon"]["iterations"]
                 == report["horizon"]["ref_iterations"])

    # ---- horizon variants: local chunks, the 2-D mesh -----------------------
    variants = {}
    for rows, lc in HORIZON_VARIANTS:
        if world % rows or (rows > 1 and world // rows < 2):
            continue
        mesh = mesh_h if rows == 1 else make_mesh(
            batch=rows, horizon=world // rows, device=device)
        r = res_h if (rows, lc) == (1, 1) else solve_horizon_sharded(
            qp_h, mesh, settings, local_chunks=lc)
        name = f"{rows}x{world // rows}_lc{lc}"
        v = {"status": int(r.status), "iterations": int(r.iterations),
             "max_abs_err_vs_local": _err(r.x, _np(ref_h.x))}
        ok = ok and v["status"] == 0 and v["max_abs_err_vs_local"] <= tol_h
        saved.update({f"{name}_x": r.x, f"{name}_status": r.status,
                      f"{name}_iters": r.iterations})
        variants[name] = v
    report["horizon_variants"] = variants

    # ---- the per-call payloads do not grow with the horizon ----------------
    payload = {}
    for W in (W_hor, 2 * W_hor):
        if W == W_hor:
            r, c = res_h, counts_h
        else:
            _comm.reset()
            r = solve_horizon_sharded(build_horizon_problem(W, N, dtype, dev),
                                      mesh_h, settings)
            c = _comm.counts()
        payload[W] = {
            "sizes": {k: v["sizes"] for k, v in c.items()
                      if k != "gather_result"},
            "calls": {k: v["calls"] for k, v in c.items()},
            "iterations": int(r.iterations),
        }
    a, b = (payload[W]["sizes"] for W in (W_hor, 2 * W_hor))
    report["payload"] = {"per_W": payload, "same_at_2W": a == b}
    ok = ok and a == b and (world == 1 or bool(a))

    # ---- 2-D mesh: problems over the batch axis, horizons over the other ---
    if world % 2 == 0 and world >= 2:
        rows = 2 if world >= 4 else 1
        mesh2 = make_mesh(batch=rows, horizon=world // rows, device=device)
        bandeds = [banded_from_trajectory(build_horizon_problem(
            W_hor, N, dtype, dev, shift=0.03 * i))[0] for i in range(rows)]
        stacked = bandeds[0].replace(**{
            k: torch.stack([getattr(bq, k) for bq in bandeds], dim=-1)
            for k in ("P_diag", "P_lower", "q_wb", "A0", "A1", "l_wr",
                      "u_wr")})
        res2 = solve_banded_sharded_2d(stacked, mesh2, settings)
        refs2 = [admm.solve(bq, settings, device=dev) for bq in bandeds]
        err2 = max(_err(res2.x[i], _np(r.x)) for i, r in enumerate(refs2))
        report["mesh2d"] = {
            "grid": [rows, world // rows],
            "statuses": [int(s) for s in _np(res2.status)],
            "ref_statuses": [int(r.status) for r in refs2],
            "iterations": [int(s) for s in _np(res2.iterations)],
            "ref_iterations": [int(r.iterations) for r in refs2],
            "max_abs_err_vs_local": err2,
        }
        m2 = report["mesh2d"]
        ok = (ok and m2["statuses"] == m2["ref_statuses"]
              and m2["iterations"] == m2["ref_iterations"] and err2 <= tol_h)

    # ---- planner layer: fleets over the batch axis -------------------------
    line = HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
    lane = planner(10, dtype, dev)
    starts, ends = planner_queries(2 * world)
    st0, tr0, k0 = lane.run_batch_lane(starts, ends, 10)
    st1, tr1, k1 = lane.run_batch_lane_sharded(starts, ends, 10, mesh_b)
    padded = planner(12, dtype, dev, obstacles=[line], segments=3)
    starts16, ends16 = planner_queries(4 * world)
    p0 = padded.run_batch_padded(starts16, ends16)
    p1 = padded.run_batch_padded_sharded(starts16, ends16, mesh_b)
    err_p = _err(tr1, _np(tr0))
    err_pp = _err(p1[1], _np(p0[1]))
    report["planner"] = {
        "statuses": [int(s) for s in _np(st1)],
        "ref_statuses": [int(s) for s in _np(st0)],
        "scp_iters_match": bool(np.array_equal(_np(k1), _np(k0))),
        "max_abs_err_vs_local": err_p,
        "padded_counts_match": all(
            np.array_equal(_np(a), _np(b)) for a, b in
            ((p0[0], p1[0]), (p0[2], p1[2]), (p0[3], p1[3]), (p0[4], p1[4]))),
        "padded_max_abs_err_vs_local": err_pp,
        "padded_optimal": int(np.sum(_np(p0[0]) == 0)),
    }
    pl = report["planner"]
    tol_p = 1e-8 if f64 else 1e-5
    ok = (ok and pl["statuses"] == pl["ref_statuses"] and pl["scp_iters_match"]
          and err_p <= tol_p and pl["padded_counts_match"]
          and err_pp <= tol_p)

    report["ok"] = bool(ok)
    if save:
        np.savez(save, **{k: _np(v) for k, v in saved.items()})
    pathlib.Path(out_path).write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--master", default="127.0.0.1:29500",
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", required=True, help="this rank's JSON verdict")
    ap.add_argument("--save", default=None,
                    help=".npz for this rank's results")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds any collective may wait")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    initialize(args.master, args.world_size, args.rank, args.device,
               args.timeout)
    try:
        report = run_worker(args.out, args.device, args.save)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    if not report["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
