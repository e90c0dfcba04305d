"""Hand numpy data to the port: problems, scalings and settings.

Lets a test (or any caller holding arrays from another framework) build the
port's containers from exactly what the JAX package built, without either
package importing the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gomp.trajectory_qp_lane import _ARRAY_FIELDS, LaneTrajectoryQP
from .ops.admm import Settings
from .ops.ruiz import Scaling

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


def lane_qp_to_numpy(qp):
    """``(static, arrays)`` of any lane container exposing the static and
    array fields as attributes (this package's, or another framework's
    mirror of it) — the inverse of :func:`lane_qp_from_numpy`."""
    static = {k: getattr(qp, k) for k in _STATIC_FIELDS}
    arrays = {}
    for k in _ARRAY_FIELDS:
        a = getattr(qp, k)
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        arrays[k] = np.asarray(a)
    return static, arrays
