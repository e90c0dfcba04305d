"""PyTorch port vs JAX package: the lane driver's ``kkt_refine``, ``polish``
and ``anderson`` settings.

The port runs on the CPU (the kernels' plain versions) and is held to the
JAX package's ``solve_batched_lane`` on its plain path
(``Settings(fused_chunk="off")``) on the same numpy problems: equal
statuses and ADMM iteration counts, solutions within 1e-7.  f64, W ≤ 12,
B ≤ 8: the waypoint-layout batch of ``tests/test_admm_fused.py`` (W=8, N=3,
two balls; its first 8 problems), with and without the block-P objective
of ``tests/test_torch_blockp.py``, and the box class of ``bench.py`` (W=12,
N=6).  ``kkt_refine > 0`` takes the unfused path in both packages; polish
and Anderson run on every path.  The four mechanism tests of
``_anderson_step`` are the JAX package's own (``tests/test_admm_lane.py``),
run through both packages on the same inputs.  Last, the batched planner
plans a float32 horizon above 1024 waypoints (one refinement step per KKT
solve) as the JAX package does.  The lane sessions with each setting, the
mechanism tests and the planner are in
``test_torch_lane_settings_sessions.py``."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory_qp_lane as jlane
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import LaneTrajectoryQP
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops.status import ExitCode

from test_torch_blockp import with_block_p
from test_torch_helpers import assert_close, to_np, wp_batch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's benchmark batches)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
B = 8
# The chunk cadence of the reference's own Anderson tests
# (tests/test_admm_lane.py), and their ρ-adaptation case.
AA = dict(check_termination=3, anderson=4)
AA_RHO = dict(AA, adaptive_rho_interval=6, rho=10.0)
_REFS = {}


@functools.lru_cache(maxsize=None)
def _problems(kind):
    """``(jax batch, port batch)`` of one kind, the same numbers in both."""
    if kind == "box":
        jqp = jax.jit(lambda: bench.build_box_batch(B, 12, 6,
                                                    jnp.float64))()
    else:
        static, arrays = convert.lane_qp_to_numpy(wp_batch(honest=True))
        arrays = {k: v[..., :B] for k, v in arrays.items()}
        jqp = jlane.LaneTrajectoryQP(
            **static, **{k: jnp.asarray(v) for k, v in arrays.items()})
        if kind == "block":
            jqp, _ = with_block_p(jqp)
    return jqp, convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jqp))


def _reference(kind, overrides):
    js = dataclasses.replace(jadmm.Settings(), fused_chunk="off", **overrides)
    key = (kind, js)
    if key not in _REFS:
        _REFS[key] = jax.jit(lambda q: jdrv.solve_batched_lane(q, js))(
            _problems(kind)[0])
    return _REFS[key]


def _same(got, ref, tol=1e-7):
    np.testing.assert_array_equal(to_np(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(to_np(got.iterations),
                                  np.asarray(ref.iterations))
    for name in ("x", "y", "z"):
        assert_close(getattr(got, name), getattr(ref, name), rtol=tol,
                     atol=tol)
    for name in ("prim_res", "dual_res"):
        assert_close(getattr(got, name), getattr(ref, name), rtol=1e-8,
                     atol=1e-8)


def _compare(kind, overrides, port_overrides=None):
    """The port's solve (its settings: ``overrides`` and
    ``port_overrides``) against the JAX package's, and the host reads it
    made (one per chunk)."""
    ref = _reference(kind, overrides)
    ts = dataclasses.replace(tadmm.Settings(),
                             **{**overrides, **(port_overrides or {})})
    syncs = tdrv.HOST_SYNCS
    got = tdrv.solve_batched_lane(_problems(kind)[1], ts, device="cpu")
    _same(got, ref)
    ct = ts.check_termination
    chunks = -(-(int(to_np(got.iterations).max()) - ts.termination_warmup)
               // ct)
    assert tdrv.HOST_SYNCS - syncs == chunks
    return got


class _Calls:
    """Counts calls of a method of the port's lane container."""

    def __init__(self, monkeypatch, name):
        self.n = 0
        fn = getattr(LaneTrajectoryQP, name)

        def counted(qp, *a, **kw):
            self.n += 1
            return fn(qp, *a, **kw)
        monkeypatch.setattr(LaneTrajectoryQP, name, counted)


@pytest.mark.parametrize("kind", ["balls", "box"])
@pytest.mark.parametrize("refine", [1, 2])
def test_kkt_refine_matches_reference(kind, refine, monkeypatch):
    """``kkt_refine=k``: the unfused path (whatever ``fused_chunk`` says),
    each KKT solve followed by ``k`` refinement solves."""
    solves = _Calls(monkeypatch, "kkt_solve")
    got = _compare(kind, dict(kkt_refine=refine))
    assert (to_np(got.status) == ExitCode.kOptimal).all()
    assert solves.n == (1 + refine) * int(to_np(got.iterations).max())


@pytest.mark.parametrize("kind,form", [
    ("balls", {}), ("balls", dict(fused_chunk="off")),
    ("box", {}), ("box", dict(fused_chunk="off")),
    ("block", {}), ("block", dict(fused_chunk="off")),
])
def test_polish_matches_reference(kind, form, monkeypatch):
    """``polish=True`` after the loop, fused and unfused, vel-diag and block
    P: one more factor and ``1 + polish_refine_iter`` solves, counted apart
    from the ρ refactors; the polished iterate is taken where it is better."""
    overrides = dict(polish=True, check_termination=5)
    factors = _Calls(monkeypatch, "kkt_factor")
    solves = _Calls(monkeypatch, "kkt_solve")
    before = tdrv.POLISH_FACTORS
    got = _compare(kind, overrides, form)
    assert tdrv.POLISH_FACTORS - before == 1
    plain = tdrv.solve_batched_lane(
        _problems(kind)[1],
        dataclasses.replace(tadmm.Settings(), check_termination=5, **form),
        device="cpu")
    np.testing.assert_array_equal(to_np(got.status), to_np(plain.status))
    if form or kind == "block":
        return  # the unfused and block-P paths factor and solve anyway
    assert factors.n == 1
    assert solves.n == 1 + tadmm.Settings().polish_refine_iter
    # Polish moved the optimal problems' solutions, by a little.
    moved = np.abs(to_np(got.x) - to_np(plain.x)).max()
    assert 0 < moved < 1e-2


@pytest.mark.parametrize("overrides,form", [
    (AA, {}),
    (AA, dict(term_fused="off")),
    (AA, dict(fused_chunk="off")),
    (AA_RHO, {}),
    (AA_RHO, dict(fused_chunk="off")),
], ids=["fused", "term_off", "unfused", "rho_fused", "rho_unfused"])
def test_anderson_matches_reference(overrides, form):
    """``anderson=4`` between chunks: fused (the chunk's termination fused
    and not) and unfused, and with ρ adaptation firing, which resets the
    adapted problems' history."""
    before = tdrv.RHO_REFACTORS
    got = _compare("balls", overrides, form)
    assert (to_np(got.status) == ExitCode.kOptimal).all()
    assert (tdrv.RHO_REFACTORS > before) == ("rho" in overrides)
