"""Observability: profiler hooks and structured solve statistics.

Counterpart of ``osqp_solver_tpu/utils/observability.py`` (``solve_stats``,
``log_stats``, ``trace``, ``StageTimer``): per-problem statistics dicts in
place of OSQP's verbose log, and ``torch.profiler`` / NVTX trace scopes in
place of ``jax.profiler``'s.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..ops.status import ExitCode


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_stats(result) -> Dict[str, Any]:
    """Structured per-solve statistics of a :class:`SolveResult` (one problem
    or a batch): the same keys and values as the reference's.
    JSON-serialisable."""
    status = np.atleast_1d(_np(result.status))
    iters = np.atleast_1d(_np(result.iterations))
    rho = _np(result.rho)

    def count(code):
        return int(np.sum(status == code))

    return {
        "problems": int(status.size),
        "optimal": count(ExitCode.kOptimal),
        "optimal_inaccurate": count(ExitCode.kOptimalInaccurate),
        "primal_infeasible": count(ExitCode.kPrimalInfeasible),
        "dual_infeasible": count(ExitCode.kDualInfeasible),
        "max_iterations": count(ExitCode.kMaxIterations),
        "iterations": {
            "p50": float(np.median(iters)),
            "max": int(np.max(iters)),
            "mean": float(np.mean(iters)),
        },
        "prim_res_max": float(np.max(_np(result.prim_res))),
        "dual_res_max": float(np.max(_np(result.dual_res))),
        "rho_range": [float(np.min(rho)), float(np.max(rho))],
    }


def log_stats(result, stream=sys.stderr) -> Dict[str, Any]:
    s = solve_stats(result)
    print(json.dumps(s), file=stream, flush=True)
    return s


@contextlib.contextmanager
def trace(label: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile a region: a ``torch.profiler.record_function`` span (and an
    NVTX range when a CUDA device is present), a ``torch.profiler`` Chrome
    trace written into ``trace_dir`` when one is given, and the wall-clock
    span printed to stderr either way."""
    t0 = time.time()
    prof = None
    if trace_dir:
        from pathlib import Path

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    nvtx = torch.cuda.is_available()
    try:
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if prof is not None:
            prof.__exit__(None, None, None)
            out = Path(trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            safe = "".join(ch if ch.isalnum() else "_" for ch in label)
            prof.export_chrome_trace(str(out / f"{safe}.trace.json"))
        print(
            f"[trace] {label}: {time.time() - t0:.3f}s", file=sys.stderr,
            flush=True,
        )


class StageTimer:
    """Accumulating per-stage wall timers (assembly / factor / iterate /
    check) for host-orchestrated loops like the SCP planner.

    Wall clock, as the reference's: a region that launches CUDA work is
    timed as launched unless the caller synchronises inside it, just as
    JAX's dispatch is asynchronous."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
