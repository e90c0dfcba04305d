"""Obstacle geometry: horizontal-line obstacles, spherical and capsule
keep-outs.

Counterpart of ``osqp_solver_tpu/gomp/geometry.py`` (``HorizontalLine``,
``SphereObstacle``, ``CapsuleObstacle``, ``_keepout_cut_rows``,
``call_linearize_rows``, ``stack_obstacles``, ``stack_lines``).  Every
predicate is a vectorized tensor expression.  Point tensors carry their xyz
coordinates along ``axis`` (default: last); the trajectory-level methods
(``has_collision``, ``segment_closest``, ``violates``, ``linearize_rows``)
take ``(W, 3, *batch)`` — waypoints first, coordinates second, batch
trailing — which for an unbatched ``(W, 3)`` trajectory is the reference's
layout.

Obstacles are duck-typed: anything with ``violates(points, radius)`` and
``linearize_rows(points, jac, jq, radius)`` plugs into the planner.

PER-QUERY obstacles (:func:`stack_obstacles`) carry a TRAILING ``(B,)`` axis
on every leaf — ``center (3, B)``, ``radius (B,)`` — and are used with
``(W, 3, B)`` trajectories: the port's batch-trailing convention.  The JAX
package stacks on a LEADING axis and ``vmap``s; ``convert.py`` moves the axis
when obstacles cross from one package to the other.

Collision semantics mirror ``horizontal-line.h:78-92``: a waypoint
"collides" with the line iff the ball around the waypoint's XY projection is
within ``radius`` of the line, OR either adjacent trajectory segment crosses
the line in the XY plane.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from .constraints import INF  # noqa: F401  (re-exported convenience)

ERROR = 1e-3  # feasibility slack


def _coord(v, p, axis):
    """An obstacle's 3-vector leaf shaped to broadcast against the point
    tensor ``p`` whose coordinates run along ``axis``: ``(3,)`` for a shared
    obstacle, ``(3, *batch)`` for a per-query one (then everything after
    ``axis`` in ``p`` must be that batch)."""
    v = v.to(dtype=p.dtype, device=p.device)
    axis = axis % p.dim()
    if v.dim() == 1:
        shape = [1] * p.dim()
        shape[axis] = 3
        return v.reshape(shape)
    if axis + v.dim() != p.dim():
        raise ValueError(
            f"a per-query obstacle leaf of shape {tuple(v.shape)} needs "
            f"points shaped (..., 3, *batch) with the coordinates at axis "
            f"{p.dim() - v.dim()}; got {tuple(p.shape)} with axis {axis}"
        )
    return v.reshape((1,) * axis + tuple(v.shape))


def _scalar(v, like):
    """A scalar leaf (python float, ``()`` or per-query ``(B,)`` tensor) on
    ``like``'s dtype and device; ``(B,)`` broadcasts against ``(W, B)``."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _norm(v, axis):
    return torch.linalg.vector_norm(v, dim=axis)


def _moved(obstacle, device=None, dtype=None):
    """Copy of a dataclass obstacle with every tensor leaf on ``device`` /
    ``dtype``."""
    changes = {}
    for f in dataclasses.fields(obstacle):
        leaf = getattr(obstacle, f.name)
        if isinstance(leaf, torch.Tensor):
            changes[f.name] = leaf.to(device=device, dtype=dtype)
    return dataclasses.replace(obstacle, **changes)


@dataclasses.dataclass(frozen=True)
class HorizontalLine:
    """An infinite horizontal (XY-plane-parallel) line obstacle.

    ``direction``: unit 3-vector along the line with z == 0; ``point``: any
    point on the line; ``bypass_below``: +1.0 if robot balls must pass under
    the line, else -1.0.
    """

    direction: torch.Tensor  # (3,), unit, z = 0
    point: torch.Tensor  # (3,)
    # 1.0 = bypass from below, -1.0 = above: a python float, or a (B,)
    # tensor on a per-query stack.
    bypass_below: object

    @classmethod
    def create(cls, direction_xy, point, bypass_from_below: bool = False,
               dtype=torch.float64, device="cpu"):
        d = np.asarray(direction_xy, dtype=np.float64)
        d3 = np.array([d[0], d[1], 0.0]) / np.linalg.norm(d)
        return cls(
            direction=torch.tensor(d3, dtype=dtype, device=device),
            point=torch.tensor(
                np.asarray(point, dtype=np.float64), dtype=dtype, device=device
            ),
            bypass_below=1.0 if bypass_from_below else -1.0,
        )

    to = _moved

    def _below(self, like):
        """Bypass-from-below mask: a python bool, or a ``(B,)`` tensor."""
        if isinstance(self.bypass_below, torch.Tensor):
            return self.bypass_below.to(like.device) > 0
        return self.bypass_below > 0

    # --- geometry (coordinates along ``axis``) -------------------------------

    def distance_vec(self, p, axis: int = -1):
        """Perpendicular from ``p`` to the line, ``X - P``."""
        point = _coord(self.point, p, axis)
        direction = _coord(self.direction, p, axis)
        rel = p - point
        proj = (rel * direction).sum(dim=axis, keepdim=True)
        x = point + proj * direction
        return x - p

    def distance_vec_xy(self, p, axis: int = -1):
        """XY components of the perpendicular."""
        return self.distance_vec(p, axis).narrow(axis, 0, 2)

    def distance_xy(self, p, axis: int = -1):
        """Horizontal distance from ``p`` to the line."""
        return torch.linalg.vector_norm(self.distance_vec_xy(p, axis), dim=axis)

    def closest_point(self, p, axis: int = -1):
        """Point on the line closest to ``p``."""
        return p + self.distance_vec(p, axis)

    def on_opposite_sides(self, p, q, axis: int = -1):
        """True if ``p`` and ``q`` are on opposite sides in XY."""
        dp = self.distance_vec_xy(p, axis)
        dq = self.distance_vec_xy(q, axis)
        return (dp * dq).sum(dim=axis) < 0

    def is_close(self, p, radius, axis: int = -1):
        """Ball of ``radius`` at ``p`` intersects the line in XY."""
        return self.distance_xy(p, axis) < radius

    def has_collision(self, trajectory_xyz, radius):
        """Per-waypoint collision mask ``(W, *batch)`` for a
        ``(W, 3, *batch)`` trajectory: close to the line, or either adjacent
        segment crosses it in XY."""
        p = trajectory_xyz
        close = self.is_close(p, radius, axis=1)  # (W, *batch)
        crosses = self.on_opposite_sides(p[:-1], p[1:], axis=1)  # t..t+1
        false_pad = torch.zeros_like(close[:1])
        prev_cross = torch.cat([false_pad, crosses], dim=0)  # segment (t-1, t)
        next_cross = torch.cat([crosses, false_pad], dim=0)  # segment (t, t+1)
        return close | prev_cross | next_cross

    def is_above(self, p, radius, axis: int = -1):
        """Ball at ``p`` is clear on its required side of the line, with the
        ``radius ∓ ERROR`` slack."""
        dz = (p - _coord(self.point, p, axis)).select(axis, 2)
        below = self._below(dz)
        if isinstance(below, torch.Tensor):
            return torch.where(
                below, dz <= -radius + ERROR, dz >= radius - ERROR
            )
        if below:
            return dz <= -radius + ERROR
        return dz >= radius - ERROR

    @property
    def bypass_from_below(self):
        return self._below(self.point)

    # --- obstacle protocol ---------------------------------------------------

    def violates(self, points, radius):
        """Per-waypoint exact-FK infeasibility: collision-flagged AND not
        clear on the required side.  ``points (W, 3, *batch)``."""
        return self.has_collision(points, radius) & ~self.is_above(
            points, radius, axis=1
        )

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """One linearized collision row per waypoint: bound the ball's Z
        (via ``J_z``) above/below the line height at the closest point
        wherever :meth:`has_collision` flags the waypoint; dummy ``±INF``
        rows with the SAME coefficients elsewhere.

        ``points (W, 3, *batch)``; ``jac (W, 3, N, *batch)``;
        ``jq (W, 3, *batch)`` per-axis ``J·q0``.  ``movable`` is ignored:
        the Z-row is absolute.  Returns ``(row_jac (W, N, *batch),
        low (W, *batch), upp (W, *batch))`` with the ±``radius`` ball
        tightening applied."""
        del movable
        coll = self.has_collision(points, radius)
        bound = (
            self.closest_point(points, axis=1)[:, 2] - points[:, 2] + jq[:, 2]
        )
        below = torch.as_tensor(self._below(bound), device=bound.device)
        neg = torch.full_like(bound, -INF)
        pos = torch.full_like(bound, INF)
        low = torch.where(coll & ~below, bound, neg) + radius
        upp = torch.where(coll & below, bound, pos) - radius
        return jac[:, 2], low, upp


def _pad_segments(seg):
    """Per-segment mask ``(W-1, *batch)`` → per-waypoint: either adjacent
    segment flagged."""
    pad = seg.new_zeros((1,) + tuple(seg.shape[1:]))
    return torch.cat([pad, seg], dim=0) | torch.cat([seg, pad], dim=0)


@dataclasses.dataclass(frozen=True)
class SphereObstacle:
    """A spherical keep-out obstacle: every robot ball must stay at least
    ``radius + ball_radius`` from ``center``.

    Same duck-typed protocol as :class:`HorizontalLine`.  ``margin``: SCP
    activation gate — the linearized keep-out row is live whenever the ball
    is within ``radius + ball_radius + margin`` of the center; the exact-FK
    check uses the hard radius with the ``ERROR`` slack."""

    center: torch.Tensor  # (3,)  [per-query: (3, B)]
    radius: torch.Tensor  # scalar  [(B,)]
    margin: torch.Tensor  # scalar  [(B,)]

    @classmethod
    def create(cls, center, radius, margin: float = 0.1,
               dtype=torch.float64, device="cpu"):
        kw = dict(dtype=dtype, device=device)
        return cls(
            center=torch.tensor(np.asarray(center, dtype=np.float64), **kw),
            radius=torch.tensor(float(radius), **kw),
            margin=torch.tensor(float(margin), **kw),
        )

    to = _moved

    def distance(self, p, axis: int = -1):
        """Euclidean distance from ``p`` to the center."""
        return _norm(p - _coord(self.center, p, axis), axis)

    def segment_closest(self, points):
        """Closest approach of each trajectory segment ``[p_t, p_{t+1}]`` of
        ``points (W, 3, *batch)`` to the center: ``(rel (W-1, 3, *batch),
        dist (W-1, *batch), t (W-1, *batch))`` with ``rel`` from the center
        to the segment's closest point and ``t`` the on-segment parameter.
        Between-waypoint tunneling is caught here, not just waypoint
        penetration."""
        center = _coord(self.center, points, 1)
        a, b = points[:-1], points[1:]
        d = b - a
        denom = (d * d).sum(dim=1).clamp(min=1e-18)
        t = (((center - a) * d).sum(dim=1) / denom).clamp(0.0, 1.0)
        rel = a + t[:, None] * d - center
        return rel, _norm(rel, 1), t

    def violates(self, points, radius):
        """Ball at a waypoint penetrates the keep-out sphere, OR either
        adjacent trajectory segment's closest approach does — with the
        ``ERROR`` feasibility slack.  ``points (W, 3, *batch)``."""
        clear = _scalar(self.radius, points) + radius - ERROR
        wp = self.distance(points, axis=1) < clear
        _, seg_dist, _ = self.segment_closest(points)
        return wp | _pad_segments(seg_dist < clear)

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """Linearized keep-out row per waypoint, with between-waypoint
        tunneling handled.  Two cut forms, selected per waypoint by
        whichever approach to the sphere is closest:

        * **own proximity** → the radial supporting hyperplane
          ``n·(p − c) ≥ R + r`` with ``n = (p0 − c)/‖p0 − c‖`` (fallback ẑ
          at the exact center) — absolute: a waypoint clear of the sphere
          satisfies its own row;
        * **interior segment crossing** → a *relative* push
          ``n·J·q ≥ n·J·q0 + depth·lever`` along the center→closest-point
          direction, ``depth = R + r − d_seg``, ``lever ≈ 1/(1 − t*)``
          capped at 4.

        ``movable``: optional ``(W,)`` bool — immovable waypoints (the
        planner's pinned start/end) never receive segment cuts.  Rows are
        live inside the ``margin``-inflated radius, dummy ``±INF`` (same
        coefficients) elsewhere.  Same signature/returns as
        :meth:`HorizontalLine.linearize_rows`."""
        rel = points - _coord(self.center, points, 1)
        rel_s, _, t = self.segment_closest(points)
        Rtot = _scalar(self.radius, points) + radius
        return _keepout_cut_rows(
            points, jac, jq, rel, rel_s, t, Rtot,
            Rtot + _scalar(self.margin, points), movable,
        )


def _keepout_cut_rows(points, jac, jq, rel, rel_s, t, Rtot, gate, movable):
    """Shared SCP cut construction for convex keep-out obstacles: given the
    obstacle-specific closest-approach geometry, one linearized row per
    waypoint with the two cut forms documented on
    :meth:`SphereObstacle.linearize_rows`.

    ``points (W, 3, *batch)``, ``jac (W, 3, N, *batch)``,
    ``jq (W, 3, *batch)``; ``rel (W, 3, *batch)`` from the obstacle core's
    closest point to each waypoint; ``rel_s (W-1, 3, *batch)`` /
    ``t (W-1, *batch)``: closest-approach vector and on-segment parameter of
    each trajectory segment; ``Rtot``: hard keep-out distance (obstacle
    radius + ball radius); ``gate``: activation distance (``Rtot`` +
    margin)."""
    Wn = points.shape[0]
    nb = points.dim() - 2
    dist = _norm(rel, 1)  # (W, *batch)
    if movable is None:
        movable = torch.ones((Wn,), dtype=torch.bool, device=points.device)
    movable = movable.to(points.device).reshape((Wn,) + (1,) * nb)
    inf = float("inf")

    def unit(v):
        return v / _norm(v, 1).clamp(min=1e-9)[:, None]

    # --- own-proximity cut (absolute radial) -------------------------------
    zhat = torch.zeros_like(rel)
    zhat[:, 2] = 1.0
    n_own = unit(torch.where((dist > 1e-9)[:, None], rel, zhat))
    low_own = Rtot - (n_own * rel).sum(dim=1) + (n_own * jq).sum(dim=1)

    # --- interior-crossing cuts (relative push) ----------------------------
    dvec = points[1:] - points[:-1]
    d_seg = _norm(rel_s, 1)
    interior = (t > 1e-3) & (t < 1.0 - 1e-3)
    # push direction: core → closest point; through-core fallback: ⊥ to the
    # chord (horizontal), then ŷ
    perp = torch.linalg.cross(dvec, zhat[:-1], dim=1)
    yhat = torch.zeros_like(rel_s)
    yhat[:, 1] = 1.0
    n_seg = unit(torch.where(
        (d_seg > 1e-9)[:, None],
        rel_s,
        torch.where((_norm(perp, 1) > 1e-9)[:, None], perp, yhat),
    ))
    depth = Rtot - d_seg  # (W-1, *batch) > 0 iff the chord penetrates
    lev_a = 1.0 / (1.0 - t).clamp(0.25, 1.0)
    lev_b = 1.0 / t.clamp(0.25, 1.0)

    inf1 = torch.full_like(dist[:1], inf)
    zero1 = torch.zeros_like(rel[:1])
    zpad = torch.zeros_like(dist[:1])
    seg_d_eff = torch.where(interior, d_seg, torch.full_like(d_seg, inf))
    # prev candidate of waypoint w: segment w-1, endpoint b (lever 1/t)
    prev_d = torch.cat([inf1, seg_d_eff], dim=0)
    prev_n = torch.cat([zero1, n_seg], dim=0)
    prev_push = torch.cat([zpad, depth * lev_b], dim=0)
    # next candidate of waypoint w: segment w, endpoint a (lever 1/(1-t))
    next_d = torch.cat([seg_d_eff, inf1], dim=0)
    next_n = torch.cat([n_seg, zero1], dim=0)
    next_push = torch.cat([depth * lev_a, zpad], dim=0)
    # immovable waypoints cannot honor a demanded motion
    prev_d = torch.where(movable, prev_d, torch.full_like(prev_d, inf))
    next_d = torch.where(movable, next_d, torch.full_like(next_d, inf))

    use_prev = prev_d < torch.minimum(dist, next_d)
    use_next = (~use_prev) & (next_d < dist)
    n = torch.where(
        use_prev[:, None], prev_n,
        torch.where(use_next[:, None], next_n, n_own),
    )
    push = torch.where(
        use_prev, prev_push,
        torch.where(use_next, next_push, torch.zeros_like(prev_push)),
    )
    rq0 = (n * jq).sum(dim=1)  # (n·J)·q0
    low_sel = torch.where(use_prev | use_next, rq0 + push, low_own)
    dmin = torch.minimum(dist, torch.minimum(prev_d, next_d))
    live = dmin < gate
    row = (n[:, :, None] * jac).sum(dim=1)  # (W, N, *batch) = n·J
    low = torch.where(live, low_sel, torch.full_like(low_sel, -INF))
    upp = torch.full_like(low, INF)
    return row, low, upp


@dataclasses.dataclass(frozen=True)
class CapsuleObstacle:
    """A capsule keep-out (a cylinder with hemispherical caps around the
    axis segment ``[a, b]``): every robot ball must stay at least
    ``radius + ball_radius`` from the axis SEGMENT.  Same protocol and the
    same between-waypoint tunneling discipline as :class:`SphereObstacle`,
    sharing its cut construction (:func:`_keepout_cut_rows`)."""

    a: torch.Tensor  # (3,) axis segment start  [per-query: (3, B)]
    b: torch.Tensor  # (3,) axis segment end
    radius: torch.Tensor  # scalar  [(B,)]
    margin: torch.Tensor  # scalar  [(B,)]

    @classmethod
    def create(cls, a, b, radius, margin: float = 0.1, dtype=torch.float64,
               device="cpu"):
        kw = dict(dtype=dtype, device=device)
        return cls(
            a=torch.tensor(np.asarray(a, dtype=np.float64), **kw),
            b=torch.tensor(np.asarray(b, dtype=np.float64), **kw),
            radius=torch.tensor(float(radius), **kw),
            margin=torch.tensor(float(margin), **kw),
        )

    to = _moved

    def axis_closest(self, p, axis: int = -1):
        """Closest point on the axis segment ``[a, b]`` to ``p``."""
        a = _coord(self.a, p, axis)
        v = _coord(self.b, p, axis) - a
        vv = (v * v).sum(dim=axis, keepdim=True).clamp(min=1e-18)
        t = (((p - a) * v).sum(dim=axis, keepdim=True) / vv).clamp(0.0, 1.0)
        return a + t * v

    def distance(self, p, axis: int = -1):
        """Euclidean distance from ``p`` to the capsule axis segment."""
        return _norm(p - self.axis_closest(p, axis), axis)

    def segment_closest(self, points):
        """Closest approach of each trajectory segment ``[p_t, p_{t+1}]`` of
        ``points (W, 3, *batch)`` to the AXIS SEGMENT (segment-segment):
        ``(rel (W-1, 3, *batch), dist (W-1, *batch), t (W-1, *batch))`` with
        ``rel`` from the axis's nearest point to the trajectory's and ``t``
        the parameter on the trajectory segment.

        Solved by box-clamped coordinate descent on the convex quadratic
        (the interior solution, then two exact 1-D re-solves with the other
        parameter clamped) — exact except in the parallel-segments flat
        direction, where any minimizer is as good."""
        a = _coord(self.a, points, 1)
        v = _coord(self.b, points, 1) - a  # (1, 3, *batch)
        p0 = points[:-1]
        u = points[1:] - p0  # (S, 3, *batch)
        w0 = p0 - a
        A = (u * u).sum(dim=1).clamp(min=1e-18)
        Bc = (u * v).sum(dim=1)
        Cc = (v * v).sum(dim=1).clamp(min=1e-18)
        D = (u * w0).sum(dim=1)
        E = (w0 * v).sum(dim=1)
        den = A * Cc - Bc * Bc
        s = torch.where(
            den > 1e-18, (Bc * E - Cc * D) / den.clamp(min=1e-18),
            torch.zeros_like(den),
        ).clamp(0.0, 1.0)
        t_ax = ((Bc * s + E) / Cc).clamp(0.0, 1.0)  # axis param | s
        s = ((Bc * t_ax - D) / A).clamp(0.0, 1.0)  # traj param | t
        t_ax = ((Bc * s + E) / Cc).clamp(0.0, 1.0)
        rel = (p0 + s[:, None] * u) - (a + t_ax[:, None] * v)
        return rel, _norm(rel, 1), s

    def violates(self, points, radius):
        """Ball at a waypoint penetrates the capsule, OR either adjacent
        trajectory segment's closest approach to the axis segment does —
        with the ``ERROR`` feasibility slack.  ``points (W, 3, *batch)``."""
        clear = _scalar(self.radius, points) + radius - ERROR
        wp = self.distance(points, axis=1) < clear
        _, seg_dist, _ = self.segment_closest(points)
        return wp | _pad_segments(seg_dist < clear)

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """Linearized keep-out row per waypoint — the sphere's two cut
        forms with the capsule's closest-approach geometry: ``rel`` runs
        from the axis segment's nearest point instead of a fixed center."""
        rel = points - self.axis_closest(points, axis=1)
        rel_s, _, t = self.segment_closest(points)
        Rtot = _scalar(self.radius, points) + radius
        return _keepout_cut_rows(
            points, jac, jq, rel, rel_s, t, Rtot,
            Rtot + _scalar(self.margin, points), movable,
        )


def call_linearize_rows(obstacle, points, jac, jq, radius, movable=None):
    """Invoke an obstacle's ``linearize_rows``, forwarding ``movable`` only
    when the implementation accepts it (user obstacles written against the
    4-argument protocol keep working)."""
    try:
        params = inspect.signature(obstacle.linearize_rows).parameters
        accepts = "movable" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):  # builtins/partials without signatures
        accepts = True
    if accepts and movable is not None:
        return obstacle.linearize_rows(points, jac, jq, radius, movable=movable)
    return obstacle.linearize_rows(points, jac, jq, radius)


def obstacle_leaves(obstacle):
    """``{name: leaf}`` of a dataclass obstacle (tensors and floats)."""
    return {f.name: getattr(obstacle, f.name)
            for f in dataclasses.fields(obstacle)}


def stack_obstacles(obstacles):
    """Stack ``B`` same-type obstacles into ONE batched obstacle with a
    TRAILING per-problem axis on every leaf — the container the batched
    planner paths accept for PER-QUERY obstacles
    (``GOMPSolver.run_batch_padded(..., obstacles=[stacked, ...])``): a
    fleet where every query has its own keep-out pose.  (The JAX package
    stacks on a leading axis; see the module docstring.)

    ``obstacles``: sequence of ``B`` obstacles of the SAME dataclass type.
    Returns one obstacle whose leaves are ``(..., B)`` stacks.
    """
    first = obstacles[0]
    if any(type(o) is not type(first) for o in obstacles):
        raise TypeError(
            "stack_obstacles needs obstacles of one type per stack; got "
            + ", ".join(sorted({type(o).__name__ for o in obstacles}))
        )
    ref = next(
        leaf for leaf in obstacle_leaves(first).values()
        if isinstance(leaf, torch.Tensor)
    )
    stacked = {
        name: torch.stack(
            [
                torch.as_tensor(
                    getattr(o, name), dtype=ref.dtype, device=ref.device
                )
                for o in obstacles
            ],
            dim=-1,
        )
        for name in obstacle_leaves(first)
    }
    return type(first)(**stacked)


def stack_lines(lines, dtype=torch.float64, device="cpu") -> HorizontalLine:
    """Stack a list of ``HorizontalLine``s into one container with a
    LEADING obstacle axis (``direction (n, 3)``), as the reference does —
    a table of lines, not a per-query stack."""
    kw = dict(dtype=dtype, device=device)
    if not lines:
        return HorizontalLine(
            direction=torch.zeros((0, 3), **kw),
            point=torch.zeros((0, 3), **kw),
            bypass_below=torch.zeros((0,), **kw),
        )
    return HorizontalLine(
        direction=torch.stack([l.direction.to(**kw) for l in lines]),
        point=torch.stack([l.point.to(**kw) for l in lines]),
        bypass_below=torch.stack(
            [torch.as_tensor(l.bypass_below, **kw).reshape(()) for l in lines]
        ),
    )
