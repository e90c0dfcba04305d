"""Batched dense Cholesky factor and fused two-sweep solve, lane-major.

Counterpart of ``osqp_solver_tpu/ops/pallas_dense.py``
(``factor_lane_major``, ``solve_lane_major``).  They carry the reduced KKT
system of the dense container (``DenseQP.kkt_factor`` / ``kkt_solve``):
``M = P + σI + Aᵀdiag(ρ)A`` of each problem, batch-trailing ``(n, n, B)``,
factored once per setup, ρ adaptation and polish, and solved once per ADMM
iteration.

Kernel note (``csrc/dense.cu`` replaces the Pallas bodies ``_factor_kernel``
and ``_solve_kernel``).  The TPU kernels put 128 problems on the vector
lanes and unroll the factorization statically over ``n``, which is why they
pad the batch to 128 with identity matrices and stop at ``n = 160`` (VMEM;
XLA's Cholesky above).  Here a group of threads (one or more warps) works on
each problem and a block takes a few adjacent problems, so that each load
and store of the lane-major arrays is coalesced; ``n`` is a run-time
argument: no padding, one build for every ``n``, and no limit on ``n``.  The
factor keeps each problem's triangle in shared memory while it fits
(``n ≤ 336`` in float32 on an H100) and otherwise works on it in a
device-memory scratch buffer; the solve stages the triangle the same way and
keeps the n-vector in shared memory (in ``x`` beyond 227 KB).  The group
size, the problems per block and the branch are planned at each launch from
``n``, ``B``, the card's shared memory per block and its SM count
(:func:`plan`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def factor_lane_major_plain(M):
    """Plain PyTorch version of :func:`factor_lane_major`: a problem whose
    matrix is not positive definite comes out all NaN (no exception), as
    the reference's ``jnp.linalg.cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(M.movedim(-1, 0))
    L = torch.where((info == 0)[:, None, None], L, float("nan"))
    return L.transpose(-1, -2).movedim(0, -1).contiguous()


def solve_lane_major_plain(Lt, rhs):
    """Plain PyTorch version of :func:`solve_lane_major`."""
    L = Lt.movedim(-1, 0).transpose(-1, -2)  # (B, n, n) lower
    b = rhs.movedim(-1, 0).unsqueeze(-1)  # (B, n, 1)
    tri = torch.linalg.solve_triangular
    z = tri(L, b, upper=False)
    x = tri(L.transpose(-1, -2), z, upper=True)
    return x.squeeze(-1).movedim(0, -1).contiguous()


def _lib():
    return configure(_build.library("dense", {}))


def configure(lib):
    """Set the C signatures of a loaded ``csrc/dense.cu`` library (once)."""
    if not getattr(lib, "dense_ready", False):
        lib.dense_device_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.dense_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.dense_plan.restype = None
        for name in ("factor", "solve"):
            fn = getattr(lib, f"dense_{name}_launch")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.dense_ready = True
    return lib


# Threads per block of both kernels on the card, at most (the group of each
# problem is a whole number of warps within it).
BLOCK_THREADS = 1024
_LIMITS: dict = {}
_PLANS: dict = {}


def device_limits(lib, device):
    """``(shared bytes a block may opt into, SM count)`` of a CUDA device,
    as the launch functions take them (read once per device)."""
    key = device.index
    if key is None:
        key = torch.cuda.current_device()
    if key not in _LIMITS:
        out = (ctypes.c_int * 2)()
        _build.check(lib.dense_device_limits(key, out), "dense_device_limits")
        _LIMITS[key] = (out[0], out[1])
    return _LIMITS[key]


PLAN_KEYS = ("groups", "threads", "stride", "smem_bytes", "branch", "blocks")


def plan(lib, which, n, B, budget, threads, sms):
    """The launch plan of ``csrc/dense.cu`` (``which``: ``"factor"`` or
    ``"solve"``): problems per block, threads per problem, the packed
    triangle's stride, shared bytes, the branch (factor: 0 shared memory, 1
    device-memory scratch; solve: 0 triangle and vector in shared memory, 1
    vector only, 2 neither) and the block count.  Cached."""
    key = (id(lib), which, n, B, budget, threads, sms)
    if key not in _PLANS:
        out = (ctypes.c_longlong * len(PLAN_KEYS))()
        lib.dense_plan(int(which == "solve"), n, B, budget, threads, sms, out)
        _PLANS[key] = dict(zip(PLAN_KEYS, out))
    return _PLANS[key]


def _launch(lib, name, *args, budget, threads, sms):
    """Call ``dense_<name>_launch`` of ``csrc/dense.cu``: factor ``(M, Lt)``
    or solve ``(Lt, rhs, x)``, all on one device, the first an
    ``(n, n, B)`` array, with the shared-memory ``budget`` (bytes per
    block), ``threads`` per block and the SM count to plan for.  The factor's
    device-memory scratch is allocated here when the plan needs it."""
    n, _, B = args[0].shape
    if name == "factor":
        p = plan(lib, "factor", n, B, budget, threads, sms)
        scratch = (torch.empty(p["stride"] * B, dtype=args[0].dtype,
                               device=args[0].device)
                   if p["branch"] == 1 else None)
        args = args + (scratch,)
    err = getattr(lib, f"dense_{name}_launch")(
        *(_build.ptr(a) for a in args), n, B, budget, threads, sms,
        _build.stream(args[0].device))
    _build.check(err, f"dense_{name}_launch (n={n}, B={B})")


def _launch_cuda(name, *args):
    lib = _lib()
    budget, sms = device_limits(lib, args[0].device)
    _launch(lib, name, *args, budget=budget, threads=BLOCK_THREADS, sms=sms)


def _check(name, t, shape, ref):
    from .admm_fused import _check_pack

    _check_pack(name, t, shape, ref)
    if t.device.type == "cuda" and t.dtype != torch.float32:
        raise TypeError(f"the CUDA dense kernels take float32, got {t.dtype}")


def factor_lane_major(M):
    """Batched dense Cholesky, lane-major: ``M (n, n, B)`` symmetric (its
    lower triangle is read) → ``Lt (n, n, B)`` with ``Lt[j]`` = column ``j``
    of ``L`` (``M = L Lᵀ``), zero above the diagonal.  A problem whose
    matrix is not positive definite gets NaN columns from the failing pivot
    on.  On a CUDA tensor the kernel runs (float32); on a CPU tensor the
    plain version."""
    M = M.contiguous()
    n, _, B = M.shape
    _check("M", M, (n, n, B), M)
    if M.device.type == "cpu":
        return factor_lane_major_plain(M)
    Lt = torch.empty_like(M)
    _launch_cuda("factor", M, Lt)
    factor_lane_major.launches += 1
    return Lt


def solve_lane_major(Lt, rhs):
    """Solve ``L Lᵀ x = rhs`` from :func:`factor_lane_major`'s factor:
    ``Lt (n, n, B)``, ``rhs (n, B)`` → ``x (n, B)``.  On a CUDA tensor the
    kernel runs (float32); on a CPU tensor the plain version."""
    Lt, rhs = Lt.contiguous(), rhs.contiguous()
    n, _, B = Lt.shape
    _check("Lt", Lt, (n, n, B), Lt)
    _check("rhs", rhs, (n, B), Lt)
    if Lt.device.type == "cpu":
        return solve_lane_major_plain(Lt, rhs)
    x = torch.empty_like(rhs)
    _launch_cuda("solve", Lt, rhs, x)
    solve_lane_major.launches += 1
    return x


# Kernel launches since import.
factor_lane_major.launches = 0
solve_lane_major.launches = 0
