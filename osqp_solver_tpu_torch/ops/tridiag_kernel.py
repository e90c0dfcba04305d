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
compile-time (one build per ``B2``).  Above B2=32 both kernels take their
wide form, one problem a block of a group of several warps.  The factor's
is blocked (``csrc/wide_chol.cuh``): left-looking panels of 32 columns,
each a register-tiled product, its diagonal block factored by one warp in
registers, the rows below solved a thread a row, and ``G_t`` by column
panels the same way, in a working matrix ``[G | C]`` with ``D_t`` and
``L_t`` copied a phase ahead.  The solve's shuffles go through shared
memory, above B2=512 each of the group's 512 threads owning several rows
of a step.  Where the factor's matrix or the solve's ring does not fit on
chip its plan asks for a device-memory workspace, which :func:`_launch`
allocates.
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


def least_shared_bytes(B2):
    """The fewest bytes of shared memory a block of the kernels asks for at
    block size ``B2``: the solve's slot (2 values a row of its group's rows,
    ``S_SLOT`` of ``csrc/tridiag.cu``) with its ring and ``w`` in device
    memory; the factor's wide form keeps 64 values on chip (``W_HEAD``)
    with its matrix in device memory, never more than the solve's slot.
    Up to B2 = 32 the narrow forms' one placement, which fits the card."""
    if B2 <= 32:
        return 0
    G = _build.group_size(B2, 4)
    return 4 * 2 * G * (-(-B2 // G))


def _lib(B2):
    """The library for block size ``B2`` (above 32 the wide form, above 512
    a thread owning several rows); where not even the solve's smallest
    launch fits the card's shared memory, ``NotImplementedError`` before any
    build."""
    need = least_shared_bytes(B2)
    if need > _build.CARD_SHARED_BYTES:
        raise NotImplementedError(
            f"the CUDA tridiag kernels cannot place B2={B2} on the card: the "
            f"solve's smallest launch takes {need} bytes of shared memory a "
            f"block, the card {_build.CARD_SHARED_BYTES}")
    return _build.library("tridiag", {"B2": int(B2)})


def _configure(lib):
    """Set the C signatures of a loaded ``csrc/tridiag.cu`` library
    (once)."""
    if lib.tridiag_solve_launch.argtypes is None:
        lib.tridiag_factor_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.tridiag_factor_launch.restype = ctypes.c_int
        lib.tridiag_solve_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        lib.tridiag_solve_launch.restype = ctypes.c_int
        lib.tridiag_solve_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.tridiag_solve_plan.restype = ctypes.c_int
        lib.tridiag_factor_plan.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.tridiag_factor_plan.restype = ctypes.c_int
    return lib


PLAN_KEYS = ("G", "Q", "stages", "w_on_chip", "shared_bytes", "blocks",
             "threads_per_block", "tile_stride", "copy_bytes",
             "workspace_bytes")


def plan(lib, W, B, budget=0):
    """The solve kernel's launch plan for ``W`` steps and a batch of ``B``
    on the current device, as :func:`_launch` makes it: threads per
    problem, problems per block, ring stages, whether ``w`` stays in shared
    memory between the sweeps (else in ``x``), shared bytes, blocks,
    threads per block, the tile's row stride, the bytes of a staging copy
    (for 16-byte aligned arrays) and of the device-memory workspace (above
    B2=32, where the ring does not fit in ``budget``; else 0);
    ``budget``: the shared bytes a block may use (0: the device's)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib.tridiag_solve_plan(W, B, budget, out),
                 "tridiag_solve_plan")
    return dict(zip(PLAN_KEYS, out))


FACTOR_PLAN_KEYS = ("G", "Q", "stages", "shared_bytes", "blocks",
                    "threads_per_block", "copy_bytes", "workspace_bytes",
                    "blocks_per_problem", "launches_a_step")


def factor_plan(lib, B, budget=0):
    """The factor kernel's launch plan for a batch of ``B`` on the current
    device, as :func:`_launch` makes it: threads per problem, problems per
    block, ring stages (the narrow forms'), shared bytes, blocks, threads
    per block, the bytes of a staging copy and of the device-memory
    workspace (above B2=32, where the working matrix and the blocks copied
    ahead do not fit in ``budget``, or the form is split; else 0), the
    blocks a problem (above 1: the wide form split, each phase of a step a
    launch of that many blocks a problem, where the batch leaves SMs idle)
    and the split form's launches a step (0: one launch a call;
    :func:`factor_device_launches`); ``budget``: the shared bytes a block
    may use (0: the device's)."""
    lib = _configure(lib)
    out = (ctypes.c_longlong * len(FACTOR_PLAN_KEYS))()
    _build.check(lib.tridiag_factor_plan(B, int(budget), out),
                 "tridiag_factor_plan")
    return dict(zip(FACTOR_PLAN_KEYS, out))


def factor_device_launches(plan_, W):
    """The CUDA launches that one call of the factor makes under ``plan_``
    (:func:`factor_plan`) for ``W`` steps: 1, or the split form's 1 + W
    times its launches a step."""
    return 1 + W * plan_["launches_a_step"]


def _launch(lib, name, a, b, c, d, budget=0):
    """Call ``tridiag_<name>_launch`` of ``csrc/tridiag.cu``: factor
    ``(diag, lower, chol, gain)`` or solve ``(chol, gain, rhs, x)``, all on
    one device, the first a ``(W, B2, B2, B)`` array; ``budget``: the
    shared bytes a block may use, as :func:`plan` and :func:`factor_plan`
    take it (0: the device's), with the device-memory workspace the plan
    asks for."""
    W, _, _, B = a.shape
    lib = _configure(lib)
    p = _build.ptr
    stream = _build.stream(a.device)
    wide = _build.wide(lib, lambda lb: factor_plan(lb, 1)["G"])
    if name == "solve":
        work = _build.workspace(plan(lib, W, B, budget)["workspace_bytes"],
                                a.device) if wide else None
        err = lib.tridiag_solve_launch(p(a), p(b), p(c), p(d), W, B,
                                       int(budget), stream, p(work))
    else:
        work = _build.workspace(
            factor_plan(lib, B, budget)["workspace_bytes"],
            a.device) if wide else None
        err = lib.tridiag_factor_launch(p(a), p(b), p(c), p(d), W, B, stream,
                                        int(budget), p(work))
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
