"""Batched block-tridiagonal Cholesky factor and solve on full blocks.

Counterpart of ``osqp_solver_tpu/ops/pallas_tridiag.py``
(``factor_lane_major``, ``solve_lane_major``); the plain versions wrap
:mod:`.tridiag`.  These carry the unfused lane path
(``LaneTrajectoryQP.kkt_factor`` / ``kkt_solve``): the ``"type"`` row
layout and ``Settings(fused_chunk="off")``.

Kernel note (``csrc/tridiag.cu`` replaces the Pallas bodies
``_factor_kernel`` and ``_solve_kernel``).  The TPU kernels spread a batch
tile over (sublane, lane) and stream each waypoint's full blocks through
double-buffered VMEM.  Both kernels here put a group of 16 threads (at
B2=12) on each problem and a few adjacent problems in a block.  The factor
(:func:`factor_plan`: up to 8 problems a block) has each lane copy the
entries of ``D_t`` and the row of ``L_t`` it reads itself with ``cp.async``
three steps ahead; a step is: each lane forms a few entries of the Schur
update ``D_t - G_{t-1} G_{t-1}'`` from ``G_{t-1}`` in shared memory, every
lane factors the whole 12x12 block in registers, and lane i forms row i of
``G_t`` and writes rows i of ``C_t`` and ``G_t`` out; bit for bit the
earlier one-thread kernel's.  The solve (:func:`plan`): a producer warp
stages each step's ``C_t``, gain block and right-hand side two steps ahead
into a three-stage ring, lane i forms row i of the step's right-hand side,
and every lane solves the whole triangular system in registers, row by row,
its divisions rounded as ``/`` rounds them (bit for bit the earlier
one-thread kernel's); ``w_t`` stays in shared memory between the sweeps
where it fits, else in ``x``.  Bound on
an H100: bytes on paper (~0.03-0.06 ms at B=1024, W=100, B2=12), each
problem's chain of steps in practice.  The block size ``B2`` is
compile-time (one build per ``B2``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .tridiag import BlockTridiagFactor, block_tridiag_factor, block_tridiag_solve


def factor_lane_major_plain(diag, lower):
    """Plain PyTorch version of :func:`factor_lane_major`."""
    f = block_tridiag_factor(diag, lower)
    return f.chol, f.gain


def solve_lane_major_plain(chol, gain, rhs):
    """Plain PyTorch version of :func:`solve_lane_major`."""
    return block_tridiag_solve(BlockTridiagFactor(chol, gain), rhs)


def _lib(B2):
    """The library for block size ``B2``; above 32 ``NotImplementedError``
    before any build (``_build.LIMITS``)."""
    sig = {"B2": int(B2)}
    _build.check_limits("tridiag", sig)
    return _build.library("tridiag", sig)


def _configure(lib):
    """Set the C signatures of a loaded ``csrc/tridiag.cu`` library
    (once)."""
    if lib.tridiag_solve_launch.argtypes is None:
        lib.tridiag_factor_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.tridiag_factor_launch.restype = ctypes.c_int
        lib.tridiag_solve_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.tridiag_solve_launch.restype = ctypes.c_int
        lib.tridiag_solve_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.tridiag_solve_plan.restype = ctypes.c_int
        lib.tridiag_factor_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.tridiag_factor_plan.restype = ctypes.c_int
    return lib


PLAN_KEYS = ("G", "Q", "stages", "w_on_chip", "shared_bytes", "blocks",
             "threads_per_block", "tile_stride", "copy_bytes")


def plan(lib, W, B, budget=0):
    """The solve kernel's launch plan for ``W`` steps and a batch of ``B``
    on the current device, as :func:`_launch` makes it: threads per
    problem, problems per block, ring stages, whether ``w`` stays in shared
    memory between the sweeps (else in ``x``), shared bytes, blocks,
    threads per block, the tile's row stride and the bytes of a staging
    copy (for 16-byte aligned arrays); ``budget``: the shared bytes a block
    may use (0: the device's)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib.tridiag_solve_plan(W, B, budget, out),
                 "tridiag_solve_plan")
    return dict(zip(PLAN_KEYS, out))


FACTOR_PLAN_KEYS = ("G", "Q", "stages", "shared_bytes", "blocks",
                    "threads_per_block", "copy_bytes")


def factor_plan(lib, B):
    """The factor kernel's launch plan for a batch of ``B`` on the current
    device, as :func:`_launch` makes it: threads per problem, problems per
    block, ring stages, shared bytes, blocks, threads per block and the
    bytes of a staging copy."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(FACTOR_PLAN_KEYS))()
    _build.check(lib.tridiag_factor_plan(B, out), "tridiag_factor_plan")
    return dict(zip(FACTOR_PLAN_KEYS, out))


def _launch(lib, name, a, b, c, d, budget=0):
    """Call ``tridiag_<name>_launch`` of ``csrc/tridiag.cu``: factor
    ``(diag, lower, chol, gain)`` or solve ``(chol, gain, rhs, x)``, all on
    one device, the first a ``(W, B2, B2, B)`` array; ``budget``: the
    solve's, as :func:`plan`."""
    W, _, _, B = a.shape
    lib = _configure(lib)
    p = _build.ptr
    args = [p(a), p(b), p(c), p(d), W, B]
    if name == "solve":
        args.append(int(budget))
    err = getattr(lib, f"tridiag_{name}_launch")(*args,
                                                  _build.stream(a.device))
    _build.check(err, f"tridiag_{name}_launch")


def factor_lane_major(diag, lower):
    """Block Cholesky of a batch of symmetric block-tridiagonal matrices.

    ``diag (W, B2, B2, B)``, ``lower (W-1, B2, B2, B)`` with
    ``lower[t] = M[t+1, t]`` → ``(chol (W, B2, B2, B), gain (W-1, B2, B2,
    B))``, ``M = C Cᵀ`` (upper triangle of ``chol`` zero).  A problem whose
    matrix is not positive definite gets NaN blocks from the failing one on.
    On a CUDA tensor the kernel runs (float32); on a CPU tensor the plain
    version.
    """
    from .admm_fused import _check_pack

    W, B2, _, B = diag.shape
    diag, lower = diag.contiguous(), lower.contiguous()
    _check_pack("lower", lower, (W - 1, B2, B2, B), diag)
    if diag.device.type == "cpu":
        return factor_lane_major_plain(diag, lower)
    if diag.dtype != torch.float32:
        raise TypeError(f"the CUDA tridiag kernel takes float32, got {diag.dtype}")
    chol = torch.empty_like(diag)
    gain = torch.empty_like(lower)
    _launch(_lib(B2), "factor", diag, lower, chol, gain)
    factor_lane_major.launches += 1
    return chol, gain


def solve_lane_major(chol, gain, rhs):
    """Solve ``M x = rhs`` from :func:`factor_lane_major`'s factor.

    ``chol (W, B2, B2, B)``, ``gain (W-1, B2, B2, B)``, ``rhs (W, B2, B)`` →
    ``x (W, B2, B)``.  On a CUDA tensor the kernel runs (float32); on a CPU
    tensor the plain version.
    """
    from .admm_fused import _check_pack

    W, B2, _, B = chol.shape
    chol, gain, rhs = chol.contiguous(), gain.contiguous(), rhs.contiguous()
    _check_pack("gain", gain, (W - 1, B2, B2, B), chol)
    _check_pack("rhs", rhs, (W, B2, B), chol)
    if chol.device.type == "cpu":
        return solve_lane_major_plain(chol, gain, rhs)
    if chol.dtype != torch.float32:
        raise TypeError(f"the CUDA tridiag kernel takes float32, got {chol.dtype}")
    x = torch.empty_like(rhs)
    _launch(_lib(B2), "solve", chol, gain, rhs, x)
    solve_lane_major.launches += 1
    return x


# Kernel launches since import.
factor_lane_major.launches = 0
solve_lane_major.launches = 0
