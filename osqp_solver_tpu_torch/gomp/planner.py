"""GOMP planner: SCP loop + time-scaling horizon shrinking.

Counterpart of ``osqp_solver_tpu/gomp/planner.py``.  Two families of entry
points:

* the single-query and session-batched planners on the generic path
  (:mod:`~osqp_solver_tpu_torch.ops.session` over a ``TrajectoryQP``, the
  reference's cached-factor setup/update/solve layer): ``run(start, end)``
  (the reference's flagship call, one horizon per segment),
  ``run_padded`` (every segment in one ``W_max``-shaped masked session),
  their fixed-horizon steps ``run_horizon`` / ``run_horizon_padded``, and
  ``run_batch`` (B queries at one horizon in one session with a trailing
  batch dim).  On the card their factor and solve are the
  block-tridiagonal kernels (:mod:`~osqp_solver_tpu_torch.ops.
  tridiag_kernel`);
* the lane-batched planners on the fused lane solve
  (:func:`~osqp_solver_tpu_torch.ops.admm_lane.solve_batched_lane`):
  ``run_batch_lane`` (fixed horizon) and ``run_batch_padded`` (the full
  time-scaling search over a batch of queries), with shared or per-query
  line / sphere / capsule obstacles.  A float32 horizon above 1024
  waypoints takes one iterative-refinement step per KKT solve (the
  reference's ``with_auto_refine`` policy), which sends the lane solve to
  its unfused path: the block-tridiagonal factor and solve kernels, the
  solve launched twice per ADMM iteration.

The reference's jitted programs are plain host functions and its
``lax.while_loop`` / ``fori_loop`` host loops.  The host reads the device
ONCE per SCP round (one small tensor: the round's status, iteration count
and exact-FK verdict for one query; "any query still iterating", "rounds
so far", "any query still descending" for a batch), counted in
:data:`PLANNER_SYNCS` — beside the solvers' own one read per chunk
(``ops.admm.HOST_SYNCS``, ``ops.admm_lane.HOST_SYNCS``).  A segment in which
no query runs does no solve, exactly as the reference's ``while_loop`` runs
no body.  The batched paths' horizon ``wa`` is one Python int for the whole
batch, and their containers stay ``W_max``-shaped and masked, so all
segments share one row layout and one build of the kernels.

Queries enter and results leave batch-LEADING (``starts (B, N)``,
trajectories ``(B, 2·W·N)``) as in the reference; inside, everything is
batch-trailing.

Not ported yet: the ``_sharded`` variants (they need ``parallel/``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.robot import RobotBall
from ..ops import admm as admm_mod
from ..ops import session as ops_session
from ..ops.admm import Settings, pin_matmul_precision, resolve_device
from ..ops.admm_lane import solve_batched_lane
from ..ops.status import ExitCode
from .constraints import Constraint, scaled
from .geometry import ERROR, obstacle_leaves
from .trajectory import calc_warm_start_batched, calc_warm_start_masked
from .trajectory_qp import (
    empty_trajectory_qp,
    linearize_workspace,
    pinned_movable_mask,
    with_gomp_boxes,
    with_gomp_boxes_masked,
    with_horizon_mask,
)
from .trajectory_qp_lane import from_trailing

MAX_ITERATIONS = 100  # SCP re-linearization cap
SEGMENTS = 10  # time-scaling steps

# Device→host reads made by the planner's SCP loops since import (one per
# SCP round; the solves inside add ``ops.admm.HOST_SYNCS`` or
# ``ops.admm_lane.HOST_SYNCS``).
PLANNER_SYNCS = 0

_OPTIMAL = int(ExitCode.kOptimal)
_INACCURATE = int(ExitCode.kOptimalInaccurate)
_UNKNOWN = int(ExitCode.kUnknown)


class SegmentStats(NamedTuple):
    waypoints: int
    scp_iterations: int
    admm_iterations: int
    status: int


class PlanResult(NamedTuple):
    status: ExitCode
    trajectory: np.ndarray  # (2*W*N,) positions then velocities (unscaled)
    stats: List[SegmentStats]


class GOMPSolver:
    """Batched GOMP planner.

    ``vel_con``/``acc_con`` are pre-scaled by ``dt`` and ``dt²`` at
    construction so dynamics rows stay unit-coefficient; the returned
    trajectories' velocity half is divided by ``dt``.  ``device``: where the
    planner runs — CUDA unless the caller passes ``"cpu"`` (raises when
    there is no CUDA device and the CPU was not asked for).  ``balls`` need
    ``fk_jac_batched`` (see :mod:`~osqp_solver_tpu_torch.models.ur5e`).
    """

    def __init__(
        self,
        max_waypoints: int,
        time_step: float,
        pos_con: Constraint,
        vel_con: Constraint,
        acc_con: Constraint,
        con_3d: Constraint,
        obstacles: Sequence,  # HorizontalLine | SphereObstacle | ... (duck-typed)
        balls: Sequence[RobotBall],
        gripper_ik=None,  # stored-but-unused, as in the reference
        settings: Settings = Settings(),
        max_scp_iterations: int = MAX_ITERATIONS,
        segments: int = SEGMENTS,
        dtype=torch.float64,
        device=None,
    ):
        assert max_waypoints >= 4
        self.device = resolve_device(device)
        self.max_waypoints = int(max_waypoints)
        self.time_step = float(time_step)
        self.n_dim = pos_con.n
        self.pos_con = pos_con
        self.vel_con = scaled(vel_con, self.time_step)
        self.acc_con = scaled(acc_con, self.time_step**2)
        self.con_3d = con_3d
        self.dtype = dtype
        self.obstacles = [self._placed(o) for o in obstacles]
        self.balls = tuple(balls)
        self.gripper_ik = gripper_ik
        self.settings = settings
        self.max_scp_iterations = int(max_scp_iterations)
        self.segments = int(segments)

    # ------------------------------------------------------------- helpers

    def _placed(self, obstacle):
        """The obstacle with its tensors on the planner's device and dtype
        (duck-typed obstacles without ``to`` are taken as they are)."""
        to = getattr(obstacle, "to", None)
        return to(device=self.device, dtype=self.dtype) if to else obstacle

    def _tensor(self, a):
        return torch.as_tensor(
            np.asarray(a) if not isinstance(a, torch.Tensor) else a,
            dtype=self.dtype, device=self.device,
        )

    def _boxes(self):
        return tuple(
            (self._tensor(c.lower), self._tensor(c.upper))
            for c in (self.pos_con, self.vel_con, self.acc_con)
        )

    def _con3d(self):
        return (self._tensor(self.con_3d.lower), self._tensor(self.con_3d.upper))

    def _queries(self, starts, ends):
        """Batch-leading ``(B, N)`` queries → batch-trailing ``(N, B)``."""
        s = self._tensor(starts).T.contiguous()
        e = self._tensor(ends).T.contiguous()
        if s.dim() != 2 or s.shape != e.shape or s.shape[0] != self.n_dim:
            raise ValueError(
                f"starts/ends must both be (B, {self.n_dim}); got "
                f"{tuple(s.T.shape)} and {tuple(e.T.shape)}"
            )
        return s, e

    def _obstacles_arg(self, obstacles, B: int):
        """Resolve the optional per-query ``obstacles`` argument of the
        batched planner paths: ``None`` → the constructor's obstacles
        (shared by every query); otherwise a sequence matching the
        constructor's obstacle count whose leaves carry a trailing ``(B,)``
        per-problem axis (build with
        :func:`~osqp_solver_tpu_torch.gomp.geometry.stack_obstacles`).
        Returns ``(obstacle_list, per_query: bool)``."""
        if obstacles is None:
            return list(self.obstacles), False
        obstacles = list(obstacles)
        if len(obstacles) != len(self.obstacles):
            raise ValueError(
                "per-query obstacles must match the constructor's obstacle "
                f"count ({len(self.obstacles)}; the obstacle-row layout is "
                f"static) — got {len(obstacles)}"
            )
        for o in obstacles:
            for leaf in obstacle_leaves(o).values():
                shape = tuple(getattr(leaf, "shape", ()))
                if len(shape) < 1 or shape[-1] != B:
                    raise ValueError(
                        "per-query obstacle leaves need a trailing batch "
                        f"axis of size {B} (geometry.stack_obstacles); got "
                        f"a leaf of shape {shape}"
                    )
        return [self._placed(o) for o in obstacles], True

    def _ball_points(self, x, W):
        """Exact-FK ball centres ``(W, 3, B)`` of every ball for the
        position half of ``x (2WN, B)``."""
        q = x[: W * self.n_dim].reshape(W, self.n_dim, -1)
        return [ball.fk_jac_batched(q, axis=1)[0] for ball in self.balls]

    def _is_solution_ok_fn(self, W, per_query_obs: bool = False):
        """Exact nonlinear-FK feasibility of a batch: gripper within the 3-D
        box ± radius ± ERROR; all balls clear of every obstacle.
        ``is_ok(x (2WN, B)) -> (B,) bool`` — or ``is_ok(x, obstacles)`` when
        ``per_query_obs``."""
        masked = self._is_solution_ok_masked_fn(W, per_query_obs=True)

        def is_ok_core(x, obstacles):
            return masked(x, W, obstacles)

        if per_query_obs:
            return is_ok_core
        return lambda x: is_ok_core(x, self.obstacles)

    def _is_solution_ok_masked_fn(self, W, per_query_obs: bool = False):
        """Masked-horizon exact-FK feasibility: ``is_ok(x, wa)`` — or
        ``is_ok(x, wa, obstacles)`` when ``per_query_obs`` — judges the
        first ``wa`` waypoints only.  (An obstacle's segment test at
        waypoint ``wa − 1`` reads the first padding waypoint, as in the
        reference.)"""
        c3l, c3u = (c.reshape(1, 3, 1) for c in self._con3d())

        def is_ok_core(x, wa, obstacles):
            act = (torch.arange(W, device=x.device) < int(wa))[:, None]  # (W, 1)
            ok = torch.ones(x.shape[-1], dtype=torch.bool, device=x.device)
            for ball, pts in zip(self.balls, self._ball_points(x, W)):
                r = ball.radius
                if ball.is_gripper:
                    inside = (c3l - ERROR <= pts - r) & (pts + r <= c3u + ERROR)
                    ok &= (inside | ~act[:, None]).all(dim=(0, 1))
                for line in obstacles:
                    ok &= (~line.violates(pts, r) | ~act).all(dim=0)
            return ok

        if per_query_obs:
            return is_ok_core
        return lambda x, wa: is_ok_core(x, wa, self.obstacles)

    # ------------------------------------------------------ session path

    def _build_session(self, start, end, warm, W, settings, obstacles=None):
        """Session of one query (``start (N,)``, ``warm (2WN,)``) or of a
        batch (``start (N, B)``, ``warm (2WN, B)``) at horizon ``W``.
        ``obstacles``: per-query obstacles (trailing ``(B,)`` leaves);
        ``None`` → the constructor's."""
        if obstacles is None:
            obstacles = self.obstacles
        qp = empty_trajectory_qp(
            W, self.n_dim, [b.is_gripper for b in self.balls],
            len(self.obstacles), self.dtype, self.device,
            batch_shape=tuple(start.shape[1:]),
        )
        qp = with_gomp_boxes(qp, start, end, *self._boxes())
        qp = linearize_workspace(
            qp, self.balls, obstacles, self._con3d(), warm,
            movable=pinned_movable_mask(W, device=self.device),
        )
        warm_x = warm.T if warm.dim() > 1 else warm
        return ops_session.setup(qp, settings, warm_x=warm_x,
                                 device=self.device)

    def _programs(self, waypoints: int):
        """``(setup_fn, step_fn)`` of one query at this horizon length.

        ``step_fn`` refactors through ``ops_session.update`` with the
        DEFAULT ``Settings()`` (the reference's ``run_horizon`` step does,
        unlike its padded and batched steps), mirrored."""
        W = waypoints
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        is_ok = self._is_solution_ok_fn(W)
        con3d = self._con3d()
        movable = pinned_movable_mask(W, device=self.device)

        def setup_fn(start, end, warm):
            return self._build_session(start, end, warm, W, settings)

        def step_fn(sess):
            sess, res = ops_session.solve(sess, settings)
            ok = is_ok(res.x[:, None])[0]
            new_qp = linearize_workspace(
                ops_session._user_view(sess, sess.base), self.balls,
                self.obstacles, con3d, res.x, movable=movable,
            )
            sess = ops_session.update(sess, new_qp)
            return sess, res.x, res.status, ok, res.iterations

        return setup_fn, step_fn

    def _padded_programs(self):
        """``(setup_fn, step_fn)`` at ``W_max`` with the active horizon
        ``wa`` an argument: every segment of :meth:`run_padded` shares one
        row layout (``trajectory_qp.with_horizon_mask``)."""
        W = self.max_waypoints
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        is_ok = self._is_solution_ok_masked_fn(W)
        con3d, boxes = self._con3d(), self._boxes()

        def linearize(qp, x, wa):
            return linearize_workspace(
                qp, self.balls, self.obstacles, con3d, x, w_active=wa,
                movable=pinned_movable_mask(W, wa, device=self.device),
            )

        def setup_fn(start, end, warm, wa):
            qp = empty_trajectory_qp(
                W, self.n_dim, [b.is_gripper for b in self.balls],
                len(self.obstacles), self.dtype, self.device,
            )
            qp = with_horizon_mask(qp, wa)
            qp = with_gomp_boxes_masked(qp, start, end, *boxes, wa)
            return ops_session.setup(linearize(qp, warm, wa), settings,
                                     warm_x=warm, device=self.device)

        def step_fn(sess, wa):
            sess, res = ops_session.solve(sess, settings)
            ok = is_ok(res.x[:, None], wa)[0]
            new_qp = linearize(ops_session._user_view(sess, sess.base),
                               res.x, wa)
            sess = ops_session.update(sess, new_qp, settings=settings)
            return sess, res.x, res.status, ok, res.iterations

        return setup_fn, step_fn

    def _scp_loop(self, sess, step, waypoints: int, warm):
        """The fixed-horizon SCP loop of one query: ``step(sess)`` until the
        solve fails, the exact-FK check passes, or ``max_scp_iterations``
        rounds; one device read a round.  Returns ``(ExitCode, solution,
        SegmentStats)`` with the reference's status ladder."""
        global PLANNER_SYNCS
        last_solution = warm
        total_admm = 0
        for i in range(self.max_scp_iterations):
            sess, x, status, ok, iters = step(sess)
            last_solution = x
            status, iters, ok = torch.stack(
                [status.to(torch.int32), iters.to(torch.int32),
                 ok.to(torch.int32)]).tolist()  # the round's one read
            PLANNER_SYNCS += 1
            total_admm += iters
            if status not in (_OPTIMAL, _INACCURATE):
                # No solution at this horizon.
                return (ExitCode.kUnknown, last_solution,
                        SegmentStats(waypoints, i + 1, total_admm, status))
            if ok:
                # A 10x-relaxed-tolerance solve stays distinguishable.
                code = (ExitCode.kOptimal if status == _OPTIMAL
                        else ExitCode.kOptimalInaccurate)
                return (code, last_solution,
                        SegmentStats(waypoints, i + 1, total_admm, status))
        return (ExitCode.kUnknown, last_solution,
                SegmentStats(waypoints, self.max_scp_iterations, total_admm,
                             -1))

    def _point(self, a):
        """One configuration or flat trajectory as a 1-D tensor."""
        return self._tensor(a).reshape(-1)

    def run_horizon(self, start, end, waypoints: int, warm_start):
        """One fixed-horizon SCP solve of one query: solve, check exact-FK
        feasibility, re-linearize + update, repeat ≤ ``max_scp_iterations``
        times.  ``warm_start (2·W·N,)``.  Returns ``(ExitCode, solution
        (2·W·N,) tensor, SegmentStats)``."""
        assert waypoints >= 4
        pin_matmul_precision()
        setup_fn, step_fn = self._programs(waypoints)
        warm = self._point(warm_start)
        sess = setup_fn(self._point(start), self._point(end), warm)
        return self._scp_loop(sess, step_fn, waypoints, warm)

    def run_horizon_padded(self, start, end, w_active: int, warm_start):
        """One SCP solve at horizon ``w_active`` inside the ``W_max``
        session; ``warm_start`` in padded layout ``(2·W_max·N,)``."""
        assert 4 <= w_active <= self.max_waypoints
        pin_matmul_precision()
        setup_fn, step_fn = self._padded_programs()
        wa = int(w_active)
        warm = self._point(warm_start)
        sess = setup_fn(self._point(start), self._point(end), warm, wa)
        return self._scp_loop(sess, lambda s: step_fn(s, wa), wa, warm)

    def _slice_warm_padded(self, sol_padded, w_prev: int, w_new: int):
        """The reference's warm-start slicing quirk in padded layout: the
        first two ``w_new·N`` windows of the previous COMPACT solution (when
        the previous horizon was longer the second window is leftover
        positions), re-padded.  On the solution's device."""
        W, N = self.max_waypoints, self.n_dim
        sol = self._point(sol_padded)
        compact = torch.cat([sol[: w_prev * N], sol[W * N: W * N + w_prev * N]])
        wn = w_new * N
        out = torch.zeros(2 * W * N, dtype=sol.dtype, device=sol.device)
        out[:wn] = compact[:wn]
        out[W * N: W * N + wn] = compact[wn: 2 * wn]
        return out

    def _segments(self):
        """The time-scaling search's horizons, longest first."""
        for i in range(self.segments, 0, -1):
            waypoints = self.max_waypoints * i // self.segments
            if waypoints < 4:
                break
            yield waypoints

    def run(self, start_pos, end_pos) -> PlanResult:
        """Time-scaling outer loop: shrink the horizon ``segments → 1``,
        warm-starting each segment from the previous solution; keep the
        shortest feasible trajectory.  Velocities unscaled by dt."""
        N = self.n_dim
        start, end = self._point(start_pos), self._point(end_pos)
        last_solution = calc_warm_start_batched(start, end, self.max_waypoints)
        last_code = ExitCode.kUnknown
        stats: List[SegmentStats] = []
        for waypoints in self._segments():
            # The first two wN-slices of the previous solution — when the
            # previous horizon was longer, the "velocity" half is leftover
            # positions (the reference's quirk, replicated).
            wn = waypoints * N
            warm = torch.cat([last_solution[:wn], last_solution[wn: 2 * wn]])
            code, solution, seg_stats = self.run_horizon(
                start, end, waypoints, warm)
            stats.append(seg_stats)
            if code not in (ExitCode.kOptimal, ExitCode.kUnknown):
                break
            if code == ExitCode.kOptimal:
                last_code = ExitCode.kOptimal
                last_solution = solution
        sol = last_solution.cpu().numpy().copy()
        half = sol.size // 2
        sol[half:] /= self.time_step
        return PlanResult(status=last_code, trajectory=sol, stats=stats)

    def run_padded(self, start_pos, end_pos) -> PlanResult:
        """:meth:`run`'s search (warm-start quirk included) with every
        segment in ONE ``W_max``-shaped masked session layout.  Returns the
        winning horizon's compact trajectory, velocities unscaled."""
        W, N = self.max_waypoints, self.n_dim
        start, end = self._point(start_pos), self._point(end_pos)
        last_code = ExitCode.kUnknown
        last_solution = calc_warm_start_masked(start, end, W, W)
        last_w = W
        stats: List[SegmentStats] = []
        for waypoints in self._segments():
            warm = self._slice_warm_padded(last_solution, last_w, waypoints)
            code, solution, seg_stats = self.run_horizon_padded(
                start, end, waypoints, warm)
            stats.append(seg_stats)
            if code not in (ExitCode.kOptimal, ExitCode.kUnknown):
                break
            if code == ExitCode.kOptimal:
                last_code = ExitCode.kOptimal
                last_solution = solution
                last_w = waypoints
        sol = last_solution.cpu().numpy()
        out = np.concatenate([sol[: last_w * N], sol[W * N: W * N + last_w * N]])
        out[last_w * N:] /= self.time_step
        return PlanResult(status=last_code, trajectory=out, stats=stats)

    def run_batch(self, starts, ends, waypoints: int,
                  max_scp: Optional[int] = None, obstacles=None):
        """Batched fixed-horizon planner on ONE session with a trailing
        batch dim: the SCP loop (solve → exact-FK check → re-linearize →
        update with ``settings``) for B queries with masked per-query
        convergence.  A query that has stopped keeps its solution, status
        and round count, as the reference's vmapped ``while_loop`` freezes
        its carry; its problem is not solved again.

        ``obstacles``: optional per-query obstacles, as in
        :meth:`run_batch_lane`.  Returns ``(statuses (B,), trajectories (B,
        2WN), scp_iters (B,))`` with velocities unscaled by dt and
        :meth:`run_horizon`'s status ladder.
        """
        global PLANNER_SYNCS
        W, N = int(waypoints), self.n_dim
        assert W >= 4
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        pin_matmul_precision()
        starts, ends = self._queries(starts, ends)
        B = starts.shape[1]
        obs, _ = self._obstacles_arg(obstacles, B)
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        is_ok = self._is_solution_ok_fn(W, per_query_obs=True)
        con3d = self._con3d()
        movable = pinned_movable_mask(W, device=self.device)
        dev = self.device

        x = calc_warm_start_batched(starts, ends, W)  # (2WN, B)
        status = torch.full((B,), _UNKNOWN, dtype=torch.int32, device=dev)
        ok = torch.zeros((B,), dtype=torch.bool, device=dev)
        k = torch.zeros((B,), dtype=torch.int32, device=dev)
        running = torch.ones((B,), dtype=torch.bool, device=dev)
        go = B > 0 and max_scp > 0
        sess = self._build_session(starts, ends, x, W, settings,
                                   obstacles=obs) if go else None
        while go:
            sess, res = ops_session.solve(sess, settings, active=running)
            xr = res.x.T
            x = torch.where(running, xr, x)
            status = torch.where(running, res.status, status)
            ok = torch.where(running, is_ok(xr, obs), ok)
            k = k + running.to(torch.int32)
            running = running & ~ok & (
                (status == _OPTIMAL) | (status == _UNKNOWN)
                | (status == _INACCURATE)) & (k < max_scp)
            go = bool(running.any())  # the round's one read
            PLANNER_SYNCS += 1
            if go:
                new_qp = linearize_workspace(
                    sess.base, self.balls, obs, con3d, xr, movable=movable)
                sess = ops_session.update(sess, new_qp, settings=settings)

        final_status = torch.where(
            ok,
            torch.where(status == _INACCURATE,
                        torch.full_like(status, _INACCURATE),
                        torch.full_like(status, _OPTIMAL)),
            torch.full_like(status, _UNKNOWN),
        )
        half = W * N
        x = torch.cat([x[:half], x[half:] / self.time_step], dim=0)
        return final_status, x.T.contiguous(), k

    # ------------------------------------------------------- lane path

    def _solve(self, qp_t, settings, x, y):
        """One batched solve of the trailing container, warm-started."""
        lane = from_trailing(qp_t, row_layout="waypoint")
        return solve_batched_lane(
            lane, settings, warm_x=x.T, warm_y=y.T, device=self.device
        )

    # --------------------------------------------------------- fixed horizon

    def run_batch_lane(
        self, starts, ends, waypoints: int, max_scp: Optional[int] = None,
        obstacles=None,
    ):
        """Batched fixed-horizon planner on the lane-major fused solve.

        SCP loop of solve → exact-FK check → re-linearize with the whole
        batch solved **together** each round.  Per-problem SCP convergence
        is masked: finished problems keep their accepted solution/status
        while the batch keeps iterating (re-solves of frozen problems are
        discarded — the batch is done when every problem is).

        ``obstacles``: optional PER-QUERY obstacles — a sequence matching
        the constructor's obstacle count whose leaves carry a trailing
        ``(B,)`` per-problem axis (``geometry.stack_obstacles``).  ``None``
        → the constructor's obstacles, shared by the whole batch.

        Returns ``(statuses (B,), trajectories (B, 2WN), scp_iters (B,))``;
        inaccurate acceptances stay visible as ``kOptimalInaccurate``.
        """
        W = int(waypoints)
        assert W >= 4
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        pin_matmul_precision()
        starts, ends = self._queries(starts, ends)
        obs, _ = self._obstacles_arg(obstacles, starts.shape[1])
        return self._plan_batch_lane_program(W, max_scp)(starts, ends, obs)

    def _plan_batch_lane_program(self, W: int, max_scp: int):
        """The batched fixed-horizon program behind :meth:`run_batch_lane`:
        takes batch-trailing ``(starts, ends, obstacles)``."""
        N = self.n_dim
        balls = self.balls
        n_obs = len(self.obstacles)
        con3d = self._con3d()
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        boxes = self._boxes()
        is_ok = self._is_solution_ok_fn(W, per_query_obs=True)
        movable = pinned_movable_mask(W, device=self.device)

        def plan_batch(starts, ends, obstacles):
            global PLANNER_SYNCS
            B = starts.shape[1]
            dev = self.device
            x = calc_warm_start_batched(starts, ends, W)
            qp_t = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], n_obs, self.dtype, dev,
                batch_shape=(B,),
            )
            qp_t = with_gomp_boxes(qp_t, starts, ends, *boxes)
            qp_t = linearize_workspace(
                qp_t, balls, obstacles, con3d, x, movable=movable
            )
            # Dual vectors live in the LANE row space (padded waypoint-major
            # rows).  The dual warm start is carried across SCP rounds.
            m = from_trailing(qp_t, row_layout="waypoint").m
            y = torch.zeros((m, B), dtype=self.dtype, device=dev)
            status = torch.full((B,), _UNKNOWN, dtype=torch.int32, device=dev)
            ok = torch.zeros((B,), dtype=torch.bool, device=dev)
            done = torch.zeros((B,), dtype=torch.bool, device=dev)
            k = torch.zeros((B,), dtype=torch.int32, device=dev)

            running = B > 0 and max_scp > 0
            while running:
                res = self._solve(qp_t, settings, x, y)
                x = torch.where(done, x, res.x.T)
                y = torch.where(done, y, res.y.T)
                status = torch.where(done, status, res.status)
                ok = torch.where(done, ok, is_ok(x, obstacles))
                solvable = (status == _OPTIMAL) | (status == _INACCURATE)
                k = k + (~done).to(torch.int32)
                done = done | ok | ~solvable
                flags = torch.stack([(~done).any().to(torch.int32), k.max()])
                any_left, k_max = flags.tolist()  # the round's one host sync
                PLANNER_SYNCS += 1
                running = bool(any_left) and k_max < max_scp
                if running:
                    qp_t = linearize_workspace(
                        qp_t, balls, obstacles, con3d, x, movable=movable
                    )

            final_status = torch.where(
                ok,
                torch.where(
                    status == _INACCURATE,
                    torch.full_like(status, _INACCURATE),
                    torch.full_like(status, _OPTIMAL),
                ),
                torch.full_like(status, _UNKNOWN),
            )
            half = W * N
            x = torch.cat([x[:half], x[half:] / self.time_step], dim=0)
            return final_status, x.T.contiguous(), k

        return plan_batch

    # --------------------------------------------------- full time-scaling

    def run_batch_padded(self, starts, ends, max_scp: Optional[int] = None,
                         warm_duals: bool = False, obstacles=None):
        """Batched FULL time-scaling planner: the 10-segment
        horizon-shrinking search (warm-start slicing quirk included) over a
        batch of (start, end) queries.

        Per segment the whole batch runs one masked SCP loop on the
        lane-major fused solve at the segment's horizon ``wa`` inside the
        ``W_max``-padded containers; per-query survival is masked — a query
        keeps its best feasible solution (``kOptimal`` at the shortest
        feasible horizon so far) while the batch descends segments, stops
        descending on a ``kOptimalInaccurate`` segment, and keeps descending
        through infeasible segments (``kUnknown``).

        Returns ``(statuses, trajectories, horizons, scp_rounds,
        admm_iters)``: statuses ``(B,)`` ExitCode ints (kOptimal iff some
        segment passed the exact-FK check); trajectories ``(B, 2·W_max·N)``
        in PADDED layout — positions ``[0, w·N)`` of the first half and
        velocities ``[0, w·N)`` of the second half are live, where ``w`` is
        the per-query winning horizon in ``horizons`` — with velocities
        dt-unscaled; ``scp_rounds``/``admm_iters`` ``(B,)`` total SCP
        re-linearizations / ADMM iterations across all segments.

        ``obstacles``: optional PER-QUERY obstacles, as in
        :meth:`run_batch_lane`.  ``warm_duals=True`` goes beyond the
        reference semantics: each segment's first solve starts from the
        previous segment's final duals (the padded layout keeps row
        meanings fixed across horizons).
        """
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        pin_matmul_precision()
        starts, ends = self._queries(starts, ends)
        obs, _ = self._obstacles_arg(obstacles, starts.shape[1])
        return self._plan_batch_padded_program(max_scp, bool(warm_duals))(
            starts, ends, obs
        )

    def _plan_batch_padded_program(self, max_scp: int, warm_duals: bool):
        """The full-search program behind :meth:`run_batch_padded`: takes
        batch-trailing ``(starts, ends, obstacles)``."""
        W, N = self.max_waypoints, self.n_dim
        balls = self.balls
        n_obs = len(self.obstacles)
        con3d = self._con3d()
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        boxes = self._boxes()
        is_ok = self._is_solution_ok_masked_fn(W, per_query_obs=True)
        segments = self.segments
        WN = W * N
        dev = self.device

        def build(starts, ends, warm, wa, obstacles):
            qp = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], n_obs, self.dtype, dev,
                batch_shape=(starts.shape[1],),
            )
            qp = with_horizon_mask(qp, wa)
            qp = with_gomp_boxes_masked(qp, starts, ends, *boxes, wa)
            return linearize(qp, warm, wa, obstacles)

        def linearize(qp, x, wa, obstacles):
            return linearize_workspace(
                qp, balls, obstacles, con3d, x, w_active=wa,
                movable=pinned_movable_mask(W, wa, device=dev),
            )

        def slice_warm(sol, w_prev, wa):
            """Reference warm-slicing quirk in padded layout: the first two
            ``wa·N`` windows of each query's previous COMPACT solution
            (``sol (2WN, B)``, ``w_prev (B,)`` its horizon)."""
            q, v = sol[:WN], sol[WN:]
            pn = (w_prev * N).to(torch.int64)[None, :]  # (1, B)
            wn = wa * N
            j = torch.arange(WN, device=dev)[:, None]  # (WN, 1)

            def compact_at(idx):  # (WN, 1) -> (WN, B)
                idx = idx.expand(WN, sol.shape[1])
                qi = idx.clamp(0, WN - 1)
                vi = (idx - pn).clamp(0, WN - 1)
                return torch.where(
                    idx < pn, torch.gather(q, 0, qi), torch.gather(v, 0, vi)
                )

            zero = torch.zeros_like(q)
            out_q = torch.where(j < wn, compact_at(j), zero)
            out_v = torch.where(j < wn, compact_at(wn + j), zero)
            return torch.cat([out_q, out_v], dim=0)

        def scp_segment(starts, ends, obstacles, warm, alive, wa, y0):
            """One masked SCP loop at horizon ``wa`` for the queries in
            ``alive`` (at least one).  Returns ``(x (2WN, B), y (m, B), ok,
            solver_status, rounds, admm_iters, any_descending)``; the last
            is a host bool: some query goes on to the next segment."""
            global PLANNER_SYNCS
            B = starts.shape[1]
            qp_t = build(starts, ends, warm, wa, obstacles)
            x, y = warm, y0
            status = torch.full((B,), _UNKNOWN, dtype=torch.int32, device=dev)
            ok = torch.zeros((B,), dtype=torch.bool, device=dev)
            done = ~alive
            k = torch.zeros((B,), dtype=torch.int32, device=dev)
            it = torch.zeros((B,), dtype=torch.int32, device=dev)
            descending = True
            running = max_scp > 0
            while running:
                res = self._solve(qp_t, settings, x, y)
                x = torch.where(done, x, res.x.T)
                y = torch.where(done, y, res.y.T)
                status = torch.where(done, status, res.status)
                it = it + torch.where(done, torch.zeros_like(it), res.iterations)
                ok = torch.where(done, ok, is_ok(x, wa, obstacles))
                solvable = (status == _OPTIMAL) | (status == _INACCURATE)
                k = k + (~done).to(torch.int32)
                done = done | ok | ~solvable
                # Who would go on descending if the segment ended now.
                stops = alive & ok & (status == _INACCURATE)
                flags = torch.stack([
                    (~done).any().to(torch.int32), k.max(),
                    (alive & ~stops).any().to(torch.int32),
                ])
                any_left, k_max, descending = flags.tolist()  # one host sync
                PLANNER_SYNCS += 1
                running = bool(any_left) and k_max < max_scp
                if running:
                    qp_t = linearize(qp_t, x, wa, obstacles)
            return x, y, ok, status, k, it, bool(descending)

        def plan_batch(starts, ends, obstacles):
            B = starts.shape[1]
            last_sol = calc_warm_start_masked(starts, ends, W, W)  # (2WN, B)
            last_w = torch.full((B,), W, dtype=torch.int32, device=dev)
            last_code = torch.full((B,), _UNKNOWN, dtype=torch.int32, device=dev)
            alive = torch.ones((B,), dtype=torch.bool, device=dev)
            total_scp = torch.zeros((B,), dtype=torch.int32, device=dev)
            total_it = torch.zeros((B,), dtype=torch.int32, device=dev)
            # Dual container: the lane's padded row count (static across
            # segments).
            m = from_trailing(
                empty_trajectory_qp(
                    W, N, [b.is_gripper for b in balls], n_obs, self.dtype,
                    dev, batch_shape=(1,),
                ),
                row_layout="waypoint",
            ).m
            last_y = torch.zeros((m, B), dtype=self.dtype, device=dev)
            any_alive = B > 0

            for i in range(segments):
                wa = W * (segments - i) // segments
                if wa < 4 or not any_alive:
                    continue  # no query runs: no solve, nothing changes
                warm = slice_warm(last_sol, last_w, wa)
                y0 = last_y if warm_duals else torch.zeros_like(last_y)
                x, last_y, ok, status, k, it, any_alive = scp_segment(
                    starts, ends, obstacles, warm, alive, wa, y0
                )
                zero = torch.zeros_like(k)
                total_scp = total_scp + torch.where(alive, k, zero)
                total_it = total_it + torch.where(alive, it, zero)
                # Segment outcome: kOptimal / kOptimalInaccurate only when
                # the exact-FK check passed; anything else is kUnknown.
                accepted = alive & ok
                improved = accepted & (status == _OPTIMAL)
                # Only a code other than kOptimal/kUnknown stops the descent.
                alive = alive & ~(accepted & (status == _INACCURATE))
                last_code = torch.where(
                    improved, torch.full_like(last_code, _OPTIMAL), last_code
                )
                last_sol = torch.where(improved, x, last_sol)
                last_w = torch.where(
                    improved, torch.full_like(last_w, wa), last_w
                )

            # Unscale the live velocity window; the padded tail is zeros.
            out = torch.cat(
                [last_sol[:WN], last_sol[WN:] / self.time_step], dim=0
            )
            return last_code, out.T.contiguous(), last_w, total_scp, total_it

        return plan_batch


__all__ = [
    "ERROR", "GOMPSolver", "MAX_ITERATIONS", "PlanResult", "SEGMENTS",
    "SegmentStats",
]
