"""Solver exit codes.

Counterpart of ``osqp_solver_tpu/ops/status.py`` (``ExitCode``, ``is_ok``,
``to_string``): the ``osqp::OsqpExitCode`` member set, carried as one
``int32`` status per problem of a batch.
"""
from __future__ import annotations

import enum


class ExitCode(enum.IntEnum):
    """Matches the osqp-cpp ``OsqpExitCode`` member set."""

    kOptimal = 0
    kPrimalInfeasible = 1
    kDualInfeasible = 2
    kOptimalInaccurate = 3
    kPrimalInfeasibleInaccurate = 4
    kDualInfeasibleInaccurate = 5
    kMaxIterations = 6
    kInterrupted = 7
    kTimeLimitReached = 8
    kNonConvex = 9
    kUnknown = 10


def is_ok(code: int) -> bool:
    return code in (ExitCode.kOptimal, ExitCode.kOptimalInaccurate)


def to_string(code) -> str:
    return ExitCode(int(code)).name
