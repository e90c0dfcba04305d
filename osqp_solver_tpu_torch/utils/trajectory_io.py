"""Trajectory ``.data`` file writers, byte-compatible with the reference.

Counterpart of ``osqp_solver_tpu/utils/trajectory_io.py`` (the port keeps
its own copy): the reference example dumps the optimized trajectory with
default ``std::ostream`` double formatting, 6 significant digits, which is
exactly ``%g``, so Python's ``format(v, 'g')`` reproduces the bytes.
"""
from __future__ import annotations

import numpy as np


def format_double(v: float) -> str:
    """One double, formatted as C++ ``operator<<(std::ostream&, double)``
    with default precision (6 significant digits)."""
    return f"{float(v):g}"


def ctrl_lines(q: np.ndarray) -> str:
    """``output_trajectory_ctrl.data`` contents for a ``(W, N)`` joint
    trajectory."""
    return "".join(
        " ".join(format_double(v) for v in row) + "\n" for row in np.asarray(q)
    )


def xyz_lines(points: np.ndarray) -> str:
    """``output_trajectory_xyz.data`` contents for ``(W, 3)`` FK
    positions."""
    return "".join(
        f"({format_double(p[0])}, {format_double(p[1])}, {format_double(p[2])})\n"
        for p in np.asarray(points)
    )


def write_trajectory_files(q, points, ctrl_path, xyz_path) -> None:
    with open(ctrl_path, "w") as f:
        f.write(ctrl_lines(q))
    with open(xyz_path, "w") as f:
        f.write(xyz_lines(points))
