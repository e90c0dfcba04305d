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
pad the batch to 128 with identity matrices and stop at ``n = 160`` (VMEM).
Here one thread owns one problem and loops over ``n`` at run time: no
padding, one build for every ``n``.  The factor works in place in its output
buffer in device memory (L2-resident at the main path's size); the solve
keeps the n-vector in shared memory, which holds ``n ≤ 1816`` on an H100
(227 KB per block of 32 threads); a larger ``n`` raises at launch.
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
    return _build.library("dense", {})


def _launch(lib, name, *args):
    """Call ``dense_<name>_launch`` of ``csrc/dense.cu``: factor ``(M, Lt)``
    or solve ``(Lt, rhs, x)``, all on one device, the first an
    ``(n, n, B)`` array."""
    n, _, B = args[0].shape
    fn = getattr(lib, f"dense_{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 2 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    err = fn(*(_build.ptr(a) for a in args), n, B,
             _build.stream(args[0].device))
    _build.check(err, f"dense_{name}_launch (n={n}, B={B})")


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
    _launch(_lib(), "factor", M, Lt)
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
    _launch(_lib(), "solve", Lt, rhs, x)
    solve_lane_major.launches += 1
    return x


# Kernel launches since import.
factor_lane_major.launches = 0
solve_lane_major.launches = 0
