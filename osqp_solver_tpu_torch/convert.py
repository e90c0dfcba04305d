"""Hand numpy data to the port: problems, scalings, settings, lane
sessions, obstacles, a planner's constructor arguments and DH arms.

Lets a test (or any caller holding arrays from another framework) build the
port's containers from exactly what the JAX package built, without either
package importing the other.  Where a converter's result decides where an
entry point runs (a session, a planner), its ``device`` follows the entry
points' rule: CUDA unless ``device="cpu"`` is asked for.  The problem
containers go wherever the solve that takes them runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gomp import geometry
from .gomp.constraints import Constraint
from .gomp.trajectory_qp import TrajectoryQP
from .gomp.trajectory_qp_lane import _ARRAY_FIELDS, LaneFactor, LaneTrajectoryQP
from .ops.admm import Settings, resolve_device
from .ops.qp import DenseQP
from .ops.ruiz import Scaling
from .ops.session_lane import LaneSession

_STATIC_FIELDS = (
    "waypoints", "n_dim", "gripper_flags", "n_obstacles", "row_layout",
    "p_structure",
)


def lane_qp_from_numpy(static: dict, arrays: dict, device="cpu",
                       dtype=None) -> LaneTrajectoryQP:
    """Build a :class:`LaneTrajectoryQP` from batch-trailing numpy arrays.

    ``static``: ``waypoints, n_dim, gripper_flags, n_obstacles, row_layout,
    p_structure``; ``arrays``: the 21 array fields of the lane container.
    ``dtype`` defaults to each array's own."""
    missing = [k for k in _STATIC_FIELDS if k not in static]
    missing += [k for k in _ARRAY_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"lane_qp_from_numpy: missing {missing}")
    tensors = {
        k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
        for k in _ARRAY_FIELDS
    }
    return LaneTrajectoryQP(
        waypoints=int(static["waypoints"]),
        n_dim=int(static["n_dim"]),
        gripper_flags=tuple(bool(g) for g in static["gripper_flags"]),
        n_obstacles=int(static["n_obstacles"]),
        row_layout=str(static["row_layout"]),
        p_structure=str(static["p_structure"]),
        **tensors,
    )


def _trailing(a, batched: bool, device, dtype):
    """A JAX-package array (batch-LEADING when ``batched``) as a port tensor
    (batch-trailing)."""
    a = np.asarray(a)
    return torch.tensor(np.moveaxis(a, 0, -1) if batched else a, dtype=dtype,
                        device=device)


def dense_qp_from_numpy(P, q, A, l, u, device=None, dtype=None) -> DenseQP:
    """A :class:`~osqp_solver_tpu_torch.ops.qp.DenseQP` from the JAX
    package's arrays: one problem (``P (n, n)``, ``q (n,)``, ...) or a
    vmapped batch, batch-LEADING (``P (B, n, n)``, ``q (B, n)``, ...),
    which lands batch-trailing.  ``device``: CUDA unless ``"cpu"`` is
    asked for."""
    device = resolve_device(device)
    batched = np.ndim(q) == 2
    return DenseQP(*(_trailing(a, batched, device, dtype)
                     for a in (P, q, A, l, u)))


_TRAJ_STATIC = ("waypoints", "n_dim", "gripper_flags", "n_obstacles",
                "p_structure")


def trajectory_qp_from_numpy(static: dict, arrays: dict, device=None,
                             dtype=None) -> TrajectoryQP:
    """A :class:`~osqp_solver_tpu_torch.gomp.trajectory_qp.TrajectoryQP`
    from the JAX package's container data: ``static`` (``waypoints, n_dim,
    gripper_flags, n_obstacles, p_structure``) and its 21 array fields, one
    problem or a vmapped batch (batch-LEADING, landing batch-trailing).
    ``device``: CUDA unless ``"cpu"`` is asked for."""
    missing = [k for k in _TRAJ_STATIC if k not in static]
    missing += [k for k in _ARRAY_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"trajectory_qp_from_numpy: missing {missing}")
    device = resolve_device(device)
    batched = np.ndim(arrays["q_vec"]) == 2
    return TrajectoryQP(
        waypoints=int(static["waypoints"]),
        n_dim=int(static["n_dim"]),
        gripper_flags=tuple(bool(g) for g in static["gripper_flags"]),
        n_obstacles=int(static["n_obstacles"]),
        p_structure=str(static["p_structure"]),
        **{k: _trailing(arrays[k], batched, device, dtype)
           for k in _ARRAY_FIELDS},
    )


def trajectory_qp_to_numpy(qp):
    """``(static, arrays)`` of a trajectory container of either package
    (read by attribute; arrays as they are stored) — what
    :func:`trajectory_qp_from_numpy` takes from the JAX package."""
    return ({k: getattr(qp, k) for k in _TRAJ_STATIC},
            {k: _np(getattr(qp, k)) for k in _ARRAY_FIELDS})


def scaling_from_numpy(D, E, c, device="cpu", dtype=None) -> Scaling:
    """:class:`Scaling` from batch-trailing ``D (n, B)``, ``E (m, B)``,
    ``c (B,)``; the inverses are recomputed."""
    D, E, c = (
        torch.tensor(np.asarray(a), dtype=dtype, device=device)
        for a in (D, E, c)
    )
    return Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)


def settings_from_dict(values: dict) -> Settings:
    """:class:`Settings` from a mapping of field names (for example
    ``dataclasses.asdict`` of the JAX package's settings); unknown names
    raise."""
    names = {f.name for f in dataclasses.fields(Settings)}
    unknown = sorted(set(values) - names)
    if unknown:
        raise KeyError(f"settings_from_dict: unknown fields {unknown}")
    return Settings(**values)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lane_qp_to_numpy(qp):
    """``(static, arrays)`` of any lane container exposing the static and
    array fields as attributes (this package's, or another framework's
    mirror of it) — the inverse of :func:`lane_qp_from_numpy`."""
    static = {k: getattr(qp, k) for k in _STATIC_FIELDS}
    return static, {k: _np(getattr(qp, k)) for k in _ARRAY_FIELDS}


# ------------------------------------------------------------ lane sessions


def lane_session_to_numpy(session) -> dict:
    """Plain data of a lane session of either package (read by attribute):
    ``base``/``scaled`` as :func:`lane_qp_to_numpy` pairs, ``scaling`` as
    ``(D, E, c)``, ``warm_x``, ``warm_y``, ``rho_bar``, ``factor`` as
    ``("packed", cholp, gainp | None)`` or ``("blocks", chol, gain)``, and
    ``cache`` (a dict of arrays, or ``None``)."""
    f = session.factor
    if hasattr(f, "chol"):
        factor = ("blocks", _np(f.chol), _np(f.gain))
    else:
        factor = ("packed", _np(f[0]), None if f[1] is None else _np(f[1]))
    cache = session.cache
    sc = session.scaling
    return {
        "base": lane_qp_to_numpy(session.base),
        "scaled": lane_qp_to_numpy(session.scaled),
        "scaling": (_np(sc.D), _np(sc.E), _np(sc.c)),
        "warm_x": _np(session.warm_x),
        "warm_y": _np(session.warm_y),
        "rho_bar": _np(session.rho_bar),
        "factor": factor,
        "cache": None if cache is None else {k: _np(v) for k, v in cache.items()},
    }


def lane_session_from_numpy(data: dict, device=None, dtype=None) -> LaneSession:
    """The port's :class:`~osqp_solver_tpu_torch.ops.session_lane.
    LaneSession` from :func:`lane_session_to_numpy`'s data, so that a
    session another framework set up (and advanced) is continued here.

    A session's solves follow its tensors, so the device follows the entry
    points' rule: CUDA unless ``device="cpu"`` is asked for."""
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.tensor(
            np.asarray(a), dtype=dtype, device=device)

    kind, first, second = data["factor"]
    if kind == "blocks":
        factor = LaneFactor(chol=t(first), gain=t(second))
    elif kind == "packed":
        factor = (t(first), t(second))
    else:
        raise ValueError(f"lane_session_from_numpy: factor kind {kind!r}")
    cache = data.get("cache")
    return LaneSession(
        base=lane_qp_from_numpy(*data["base"], device=device, dtype=dtype),
        scaled=lane_qp_from_numpy(*data["scaled"], device=device, dtype=dtype),
        scaling=scaling_from_numpy(*data["scaling"], device=device, dtype=dtype),
        warm_x=t(data["warm_x"]),
        warm_y=t(data["warm_y"]),
        rho_bar=t(data["rho_bar"]),
        factor=factor,
        cache=None if cache is None else {k: t(v) for k, v in cache.items()},
    )


# ------------------------------------------------------------- obstacles

_OBSTACLE_TYPES = {
    "HorizontalLine": geometry.HorizontalLine,
    "SphereObstacle": geometry.SphereObstacle,
    "CapsuleObstacle": geometry.CapsuleObstacle,
}
_OBSTACLE_LEAVES = {
    "HorizontalLine": ("direction", "point", "bypass_below"),
    "SphereObstacle": ("center", "radius", "margin"),
    "CapsuleObstacle": ("a", "b", "radius", "margin"),
}


def obstacle_to_numpy(obstacle):
    """``(kind, arrays)`` of a line, sphere or capsule obstacle of either
    package (matched by class name, read by attribute)."""
    kind = type(obstacle).__name__
    if kind not in _OBSTACLE_LEAVES:
        raise TypeError(f"obstacle_to_numpy: unknown obstacle type {kind}")
    arrays = {}
    for name in _OBSTACLE_LEAVES[kind]:
        leaf = getattr(obstacle, name)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[name] = np.asarray(leaf, dtype=np.float64)
    return kind, arrays


def obstacle_from_numpy(kind: str, arrays: dict, per_query: bool = False,
                        device="cpu", dtype=torch.float64):
    """The port's obstacle from ``(kind, arrays)``.

    ``per_query``: the arrays carry the JAX package's LEADING ``(B,)``
    per-problem axis (its ``stack_obstacles``); it is moved to the port's
    TRAILING position (``center (B, 3)`` → ``(3, B)``)."""
    if kind not in _OBSTACLE_TYPES:
        raise TypeError(f"obstacle_from_numpy: unknown obstacle type {kind}")
    leaves = {}
    for name in _OBSTACLE_LEAVES[kind]:
        a = np.asarray(arrays[name], dtype=np.float64)
        if per_query:
            a = np.moveaxis(a, 0, -1)
        elif kind == "HorizontalLine" and name == "bypass_below":
            leaves[name] = float(a)
            continue
        leaves[name] = torch.tensor(a, dtype=dtype, device=device)
    return _OBSTACLE_TYPES[kind](**leaves)


def gomp_solver_kwargs_from_numpy(spec: dict, device=None,
                                  dtype=torch.float64) -> dict:
    """Keyword arguments of :class:`~osqp_solver_tpu_torch.gomp.planner.
    GOMPSolver` from plain data, so that two packages' planners can be built
    from one set of arrays.

    ``spec``: ``max_waypoints``, ``time_step``, the four constraints
    ``pos_con``/``vel_con``/``acc_con``/``con_3d`` as ``(lower, upper)``
    array pairs, ``obstacles`` as a list of :func:`obstacle_to_numpy`
    outputs, and optionally ``settings`` (a dict of field names),
    ``segments``, ``max_scp_iterations``.  The robot balls are callables and
    are passed to the constructor by the caller.  ``device`` (also the
    planner's): CUDA unless ``"cpu"`` is asked for."""
    device = resolve_device(device)

    def con(pair):
        lo, hi = (np.asarray(b, dtype=np.float64) for b in pair)
        return Constraint(lo.copy(), hi.copy())

    kwargs = dict(
        max_waypoints=int(spec["max_waypoints"]),
        time_step=float(spec["time_step"]),
        pos_con=con(spec["pos_con"]), vel_con=con(spec["vel_con"]),
        acc_con=con(spec["acc_con"]), con_3d=con(spec["con_3d"]),
        obstacles=[
            obstacle_from_numpy(kind, arrays, device=device, dtype=dtype)
            for kind, arrays in spec.get("obstacles", ())
        ],
        dtype=dtype, device=device,
    )
    if "settings" in spec:
        kwargs["settings"] = settings_from_dict(dict(spec["settings"]))
    for name in ("segments", "max_scp_iterations"):
        if name in spec:
            kwargs[name] = int(spec[name])
    return kwargs


def dh_robot_from(robot) -> "DHRobot":
    """The port's :class:`~osqp_solver_tpu_torch.models.dh_robot.DHRobot`
    of another package's DH arm, read by attribute: ``a``, ``d``,
    ``alpha``, ``theta`` as floats, ``joint_types`` and ``name`` as
    strings — so that one arm goes through both packages."""
    from .models.dh_robot import DHRobot

    floats = lambda v: tuple(float(x) for x in v)  # noqa: E731
    return DHRobot(
        a=floats(robot.a), d=floats(robot.d), alpha=floats(robot.alpha),
        name=str(robot.name),
        joint_types=tuple(str(t) for t in robot.joint_types),
        theta=floats(robot.theta),
    )
