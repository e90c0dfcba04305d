"""Block-tridiagonal solve by Schur-complement reduction over horizon chunks.

Counterpart of ``osqp_solver_tpu/parallel/schur.py``.  A ``W``-block
tridiagonal system is cut into ``K`` chunks with one ``B2×B2`` separator
block between neighbours::

    [ chunk_0 interior | s_0 | chunk_1 interior | s_1 | ... | chunk_{K-1} ]

Each chunk interior is factored on its own, contributes to the small
``(K-1)``-block separator system, and back-substitutes from the separator
values.

The port's idiom.  The reference ``vmap``s over a leading chunk axis; here
the ``K`` chunks are the FIRST TRAILING BATCH AXIS of the batch-trailing
layout (``Di (Wl, B2, B2, K, *batch)``), so one launch of
:func:`~osqp_solver_tpu_torch.ops.tridiag_kernel.factor_lane_major`
factors every interior and one launch of ``solve_lane_major`` solves them;
the reduced ``(K-1)``-block system goes through the same kernels at the
problem batch.  The kernels take one right-hand side per problem, so the
interface columns ``U``/``V`` (``2·B2`` right-hand sides a chunk) lay the
interior factor out once per column (``K·2·B2`` problems at ``Wl``
waypoints, one solve launch) — at factor time only.  The small products
(``r_right``, ``r_left``, the back-substitution) are torch glue, as they are
XLA glue in the reference.

Every function takes any number of trailing batch dims; the kernels see
them flattened into one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..ops import tridiag_kernel
from ..ops.tridiag import BlockTridiagFactor
from . import _comm
from .mesh import HORIZON_AXIS, axis_index, axis_size


# ---------------------------------------------------------------------------
# The kernels at any number of trailing batch dims
# ---------------------------------------------------------------------------


def _flat(a, lead: int):
    """``(*lead dims, *batch)`` → ``(*lead dims, prod(batch))``."""
    return a.reshape(tuple(a.shape[:lead]) + (math.prod(a.shape[lead:]),))


def tridiag_factor(diag, lower) -> BlockTridiagFactor:
    """Block Cholesky of ``diag (W, B2, B2, *batch)``, ``lower (W-1, B2, B2,
    *batch)`` through ``csrc/tridiag.cu`` (its plain version on the CPU)."""
    bs = tuple(diag.shape[3:])
    chol, gain = tridiag_kernel.factor_lane_major(_flat(diag, 3),
                                                  _flat(lower, 3))
    return BlockTridiagFactor(chol=chol.reshape(tuple(chol.shape[:3]) + bs),
                              gain=gain.reshape(tuple(gain.shape[:3]) + bs))


def tridiag_solve(factor: BlockTridiagFactor, rhs):
    """Solve with :func:`tridiag_factor`'s factor, ``rhs (W, B2, *batch)``."""
    bs = tuple(rhs.shape[2:])
    x = tridiag_kernel.solve_lane_major(
        _flat(factor.chol, 3), _flat(factor.gain, 3), _flat(rhs, 2))
    return x.reshape(tuple(x.shape[:2]) + bs)


def _map_tensors(obj, fn):
    """``obj`` (tensors in dataclasses, NamedTuples, tuples, dicts) with
    ``fn`` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _tile(factor, cols: int):
    """A factor with one more trailing batch dim of ``cols`` copies (one
    problem per right-hand side: the kernels take one each)."""
    return _map_tensors(
        factor, lambda t: t.unsqueeze(-1).expand(tuple(t.shape) + (cols,)))


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkedTridiag:
    """A block-tridiagonal system cut into ``K`` uniform chunks.

    ``Di (Wl, B2, B2, K, *batch)`` / ``Li (Wl-1, B2, B2, K, *batch)``: the
    chunk interiors; ``sepD (B2, B2, K, *batch)``: the separator diagonal
    blocks (slot ``K-1`` a dummy identity); ``Lleft[k] = M[s_k,
    last_int_k]``, ``Lright[k] = M[first_int_k, s_{k-1}]`` (zero at the
    edges), ``(B2, B2, K, *batch)``; ``n_blocks`` the ``W`` before
    padding."""

    Di: torch.Tensor
    Li: torch.Tensor
    sepD: torch.Tensor
    Lleft: torch.Tensor
    Lright: torch.Tensor
    n_blocks: int = 0


def _sizes(W: int, K: int) -> Tuple[int, int]:
    """``(Wl, W_pad)``: the interior length and ``K·Wl + (K-1)``."""
    Wl = -(-(W - (K - 1)) // K)  # ceil interior size
    return Wl, K * Wl + (K - 1)


def partition_blocks(diag, lower, n_chunks: int) -> ChunkedTridiag:
    """Split ``diag (W, B2, B2, *batch)``, ``lower (W-1, B2, B2, *batch)``
    into ``K`` uniform chunks, padding the tail with identity blocks so that
    ``W_pad = K·Wl + (K-1)``."""
    W, B2 = diag.shape[0], diag.shape[1]
    bs = tuple(diag.shape[3:])
    K = n_chunks
    Wl, W_pad = _sizes(W, K)
    pad = W_pad - W
    kw = dict(dtype=diag.dtype, device=diag.device)
    ones = (1,) * len(bs)
    eye = torch.eye(B2, **kw).reshape((1, B2, B2) + ones)
    if pad:
        diag = torch.cat([diag, eye.expand((pad, B2, B2) + bs)])
        zl = torch.zeros((pad, B2, B2) + bs, **kw)
        lower = torch.cat([lower, zl]) if W > 1 else zl
    stride = Wl + 1
    dev = diag.device
    idx = torch.arange(K, device=dev)
    # (Wl, K) row indices: gathering gives (Wl, K, B2, B2, *batch).
    int_rows = idx[None, :] * stride + torch.arange(Wl, device=dev)[:, None]
    Di = diag[int_rows].movedim(1, 3)
    li_rows = (idx[None, :] * stride
               + torch.arange(max(Wl - 1, 0), device=dev)[:, None])
    Li = lower[li_rows].movedim(1, 3)
    sep_rows = idx * stride + Wl
    first = (idx < K - 1).reshape((K, 1, 1) + ones)
    last = (idx > 0).reshape((K, 1, 1) + ones)
    zero = torch.zeros((), **kw)
    sepD = torch.where(first, diag[sep_rows.clamp(max=W_pad - 1)], eye[0])
    Lleft = torch.where(first, lower[(sep_rows - 1).clamp(max=W_pad - 2)],
                        zero)
    prev_sep = (idx - 1).clamp(min=0) * stride + Wl
    Lright = torch.where(last, lower[prev_sep.clamp(max=W_pad - 2)], zero)
    return ChunkedTridiag(
        Di=Di, Li=Li, sepD=sepD.movedim(0, 2), Lleft=Lleft.movedim(0, 2),
        Lright=Lright.movedim(0, 2), n_blocks=W,
    )


def partition_rhs(b, n_chunks: int):
    """Split ``b (W, B2, *batch)`` into the interiors ``(Wl, B2, K, *batch)``
    and the separators ``(B2, K, *batch)`` (slot ``K-1`` zero)."""
    W = b.shape[0]
    bs = tuple(b.shape[2:])
    K = n_chunks
    Wl, W_pad = _sizes(W, K)
    if W_pad > W:
        b = torch.cat([b, b.new_zeros((W_pad - W,) + tuple(b.shape[1:]))])
    stride = Wl + 1
    idx = torch.arange(K, device=b.device)
    rows = idx[None, :] * stride + torch.arange(Wl, device=b.device)[:, None]
    bi = b[rows].movedim(1, 2)
    sep = (idx * stride + Wl).clamp(max=W_pad - 1)
    keep = (idx < K - 1).reshape((K, 1) + (1,) * len(bs))
    bsep = torch.where(keep, b[sep], torch.zeros((), dtype=b.dtype,
                                                 device=b.device))
    return bi, bsep.movedim(0, 1)


def merge_solution(xi, xs, n_blocks: int):
    """Inverse of the partition: interiors ``(Wl, B2, K, *batch)`` and
    separators ``(B2, K-1, *batch)`` back into ``(W, B2, *batch)``."""
    Wl, B2, K = xi.shape[:3]
    bs = tuple(xi.shape[3:])
    seps = torch.cat([xs, xs.new_zeros((B2, 1) + bs)], dim=1)  # dummy s_{K-1}
    parts = torch.cat([xi.movedim(2, 0), seps.movedim(1, 0)[:, None]], dim=1)
    return parts.reshape((K * (Wl + 1), B2) + bs)[:n_blocks]


# ---------------------------------------------------------------------------
# Cached factor (per-ADMM-iteration path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchurFactor:
    """The cached split factor: the interiors' Cholesky factors (chunks on
    the batch axis), the interface columns ``U``/``V`` ``(Wl, B2, B2, K,
    *batch)``, the factored reduced separator system, and the Schur
    contributions ``(C_right, C_left, C_off)`` ``(B2, B2, K, *batch)``."""

    chunks: ChunkedTridiag
    interior: BlockTridiagFactor
    U: torch.Tensor
    V: torch.Tensor
    reduced: BlockTridiagFactor
    corr: Tuple


def _chunk_factor(Di, Li, Lleft, Lright, backend=None):
    """Factor chunk interiors (``Di (Wl, B2, B2, *batch)``) and their
    interface columns: ``(factor, U, V, C_right, C_left, C_off)``.

    ``backend``: an optional ``(factor_fn, solve_fn)`` pair in place of the
    tridiagonal kernels — e.g. a nested Schur split of the interior (the
    two-level decomposition of ``parallel/banded.py``'s ``local_chunks``).
    ``U`` and ``V`` are ``2·B2`` right-hand sides a chunk, solved in one
    call on a factor tiled once per column."""
    factor_fn, solve_fn = backend or (tridiag_factor, tridiag_solve)
    factor = factor_fn(Di, Li)
    Wl, B2 = Di.shape[0], Di.shape[1]
    bs = tuple(Di.shape[3:])
    cols = torch.zeros((Wl, B2, 2 * B2) + bs, dtype=Di.dtype,
                       device=Di.device)
    cols[Wl - 1, :, :B2] = Lleft.transpose(0, 1)  # columns for s_k
    cols[0, :, B2:] = Lright  # columns for s_{k-1}
    sol = solve_fn(_tile(factor, 2 * B2), cols.movedim(2, -1)).movedim(-1, 2)
    U, V = sol[:, :, :B2], sol[:, :, B2:]
    mm = "ij...,jk...->ik..."
    return (
        factor, U, V,
        torch.einsum(mm, Lleft, U[-1]),  # C_right into S[s_k, s_k]
        torch.einsum(mm, Lright.transpose(0, 1), V[0]),  # C_left
        torch.einsum(mm, Lright.transpose(0, 1), U[0]),  # C_off
    )


def _reduced_blocks(sepD, C_right, C_left, C_off):
    """The ``(K-1)``-block separator system from chunk-leading pieces
    ``(K, B2, B2, *batch)``: ``(Sdiag, Slower)``."""
    K = sepD.shape[0]
    Sdiag = sepD[: K - 1] - C_right[: K - 1] - C_left[1:K]
    Slower = -C_off[1 : K - 1].transpose(1, 2)  # S[s_{k+1}, s_k]
    return Sdiag, Slower


def schur_factor(diag, lower, n_chunks: int) -> SchurFactor:
    """Factor the partitioned system once: every interior in one factor
    launch (chunks on the batch axis), the interface columns in one solve
    launch, the reduced system in one more factor launch."""
    ch = partition_blocks(diag, lower, n_chunks)
    interior, U, V, C_right, C_left, C_off = _chunk_factor(
        ch.Di, ch.Li, ch.Lleft, ch.Lright)
    Sdiag, Slower = _reduced_blocks(*(a.movedim(2, 0) for a in
                                      (ch.sepD, C_right, C_left, C_off)))
    return SchurFactor(
        chunks=ch, interior=interior, U=U, V=V,
        reduced=tridiag_factor(Sdiag, Slower), corr=(C_right, C_left, C_off),
    )


def _neighbours(xs, K: int):
    """``(x_right, x_left)`` of every chunk, ``(B2, K, *batch)``, from the
    separator values ``xs (K-1, B2, *batch)`` (dummy separators zero)."""
    z = xs.new_zeros((1,) + tuple(xs.shape[1:]))
    return (torch.cat([xs, z]).movedim(0, 1),
            torch.cat([z, xs]).movedim(0, 1))


def _back_substitute(w, U, V, x_right, x_left):
    """``x_I = w − U·x_{s_k} − V·x_{s_{k-1}}``."""
    mv = "wbr...,r...->wb..."
    return w - torch.einsum(mv, U, x_right) - torch.einsum(mv, V, x_left)


def schur_solve_cached(sf: SchurFactor, b):
    """Solve ``b (W, B2, *batch)`` with a cached :class:`SchurFactor` (the
    per-ADMM-iteration path): one interior solve launch, one reduced solve
    launch."""
    ch = sf.chunks
    K = ch.Di.shape[3]
    bi, bsep = partition_rhs(b, K)
    w = tridiag_solve(sf.interior, bi)  # (Wl, B2, K, *batch)
    r_right = torch.einsum("ij...,j...->i...", ch.Lleft, w[-1])
    r_left = torch.einsum("ji...,j...->i...", ch.Lright, w[0])
    rS = bsep[:, : K - 1] - r_right[:, : K - 1] - r_left[:, 1:K]
    xs = tridiag_solve(sf.reduced, rS.movedim(1, 0))  # (K-1, B2, *batch)
    x_right, x_left = _neighbours(xs, K)
    xi = _back_substitute(w, sf.U, sf.V, x_right, x_left)
    return merge_solution(xi, xs.movedim(0, 1), ch.n_blocks)


# ---------------------------------------------------------------------------
# One-shot solves: the reference form and the sharded form
# ---------------------------------------------------------------------------


def _chunk_local(Di, Li, Lleft, Lright, bi):
    """A chunk's own work (chunks may ride the batch axis): factor the
    interior and push the right-hand side and the interface columns
    through it; the pieces of the Schur system."""
    factor, U, V, C_right, C_left, C_off = _chunk_factor(Di, Li, Lleft,
                                                         Lright)
    w = tridiag_solve(factor, bi)
    return dict(
        factor=factor, w=w, U=U, V=V,
        C_right=C_right, C_left=C_left, C_off=C_off,
        r_right=torch.einsum("ij...,j...->i...", Lleft, w[-1]),
        r_left=torch.einsum("ji...,j...->i...", Lright, w[0]),
    )


def _reduced_system(sepD, bs, C_right, C_left, C_off, r_right, r_left):
    """Assemble and solve the ``(K-1)``-block separator system from the
    gathered, chunk-leading pieces (``(K, B2, B2, *batch)`` / ``(K, B2,
    *batch)``); every rank runs it on the same bytes.  → ``xs (K-1, B2,
    *batch)``."""
    K = sepD.shape[0]
    rS = bs[: K - 1] - r_right[: K - 1] - r_left[1:K]
    if K == 1:  # one chunk: no separator to solve for
        return rS
    Sdiag, Slower = _reduced_blocks(sepD, C_right, C_left, C_off)
    return tridiag_solve(tridiag_factor(Sdiag, Slower), rS)


def schur_solve_reference(diag, lower, b, n_chunks: int):
    """One-process form of the distributed algorithm (the chunks on the
    batch axis instead of ranks): the same pieces, the same order."""
    K = n_chunks
    ch = partition_blocks(diag, lower, K)
    bi, bsep = partition_rhs(b, K)
    loc = _chunk_local(ch.Di, ch.Li, ch.Lleft, ch.Lright, bi)
    xs = _reduced_system(
        ch.sepD.movedim(2, 0), bsep.movedim(1, 0),
        loc["C_right"].movedim(2, 0), loc["C_left"].movedim(2, 0),
        loc["C_off"].movedim(2, 0), loc["r_right"].movedim(1, 0),
        loc["r_left"].movedim(1, 0),
    )
    x_right, x_left = _neighbours(xs, K)
    xi = _back_substitute(loc["w"], loc["U"], loc["V"], x_right, x_left)
    return merge_solution(xi, xs.movedim(0, 1), ch.n_blocks)


def schur_solve_sharded(diag, lower, b, mesh, axis: str = HORIZON_AXIS):
    """The split over ``mesh[axis]``: each rank factors and solves its own
    chunk, one ``all_gather`` of its ``(B2, B2)`` Schur pieces and one of its
    ``(B2,)`` right-hand-side pieces, the reduced system solved redundantly
    on every rank, local back-substitution; the interiors are gathered at
    the end to return the whole solution on every rank, as the reference's
    global array.  Inputs are global (every rank holds them)."""
    K = axis_size(mesh, axis)
    k = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    ch = partition_blocks(diag, lower, K)
    bi, bsep = partition_rhs(b, K)
    loc = _chunk_local(ch.Di[:, :, :, k], ch.Li[:, :, :, k],
                       ch.Lleft[:, :, k], ch.Lright[:, :, k], bi[:, :, k])
    blocks = _comm.all_gather(torch.stack(
        [ch.sepD[:, :, k], loc["C_right"], loc["C_left"], loc["C_off"]]),
        group)  # (K, 4, B2, B2, *batch)
    vecs = _comm.all_gather(torch.stack(
        [bsep[:, k], loc["r_right"], loc["r_left"]]), group)  # (K, 3, B2, ..)
    xs = _reduced_system(blocks[:, 0], vecs[:, 0], blocks[:, 1],
                         blocks[:, 2], blocks[:, 3], vecs[:, 1], vecs[:, 2])
    zero = xs.new_zeros(tuple(xs.shape[1:]))
    x_right = xs[k] if k < K - 1 else zero
    x_left = xs[k - 1] if k > 0 else zero
    xi_k = _back_substitute(loc["w"], loc["U"], loc["V"], x_right, x_left)
    xi = _comm.all_gather(xi_k, group, "gather_result").movedim(0, 2)
    return merge_solution(xi, xs.movedim(0, 1), ch.n_blocks)
