"""Checkpoint / resume for solver state.

Counterpart of ``osqp_solver_tpu/utils/checkpoint.py`` (``save``, ``load``):
a solver state — a :class:`~osqp_solver_tpu_torch.ops.session.Session`, a
:class:`~osqp_solver_tpu_torch.ops.session_lane.LaneSession`, a
:class:`~osqp_solver_tpu_torch.ops.admm.SolveResult` — round-trips to one
``.npz`` file, so long MPC sweeps and batched planning jobs can resume after
preemption.

The port's states are frozen dataclasses and ``NamedTuple``s of tensors, not
pytrees, so this module carries its own flatten/unflatten: it recurses over
dataclass fields in declaration order, ``NamedTuple``s, tuples, lists and
dicts (sorted keys); every tensor is a leaf, everything else is structure.
The file holds the leaves under zero-padded keys, a format-version marker
and a fingerprint of the structure (class names, field names and the
non-tensor values); :func:`load` checks the version, the fingerprint, the
leaf count and (``strict_shapes``) each leaf's shape and dtype against a
template.  A file written by the JAX package is not read: its structure
fingerprint is another (a JAX pytree's, not this flattening's).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List, Tuple

import numpy as np
import torch

_FORMAT_KEY = "__osqp_ckpt_format__"
_TREEDEF_KEY = "__osqp_ckpt_treedef__"
_FORMAT_VERSION = 2


def _flatten(obj) -> Tuple[List[torch.Tensor], Any]:
    """``(leaves, structure)``: the tensors in traversal order, and a nested
    description of everything else (rebuilt by :func:`_unflatten`)."""
    leaves: List[torch.Tensor] = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("*",)
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return ("dc", type(o), tuple(
                (f.name, walk(getattr(o, f.name)))
                for f in dataclasses.fields(o)))
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return ("nt", type(o), tuple((k, walk(getattr(o, k)))
                                         for k in o._fields))
        if isinstance(o, (tuple, list)):
            return (type(o).__name__, tuple(walk(v) for v in o))
        if isinstance(o, dict):
            return ("dict", tuple((k, walk(o[k])) for k in sorted(o)))
        return ("static", o)

    return leaves, walk(obj)


def _describe(node) -> str:
    kind = node[0]
    if kind == "*":
        return "*"
    if kind in ("dc", "nt"):
        cls = node[1]
        inner = ",".join(f"{k}={_describe(v)}" for k, v in node[2])
        return f"{cls.__module__}.{cls.__qualname__}({inner})"
    if kind in ("tuple", "list"):
        return f"{kind}[{','.join(_describe(v) for v in node[1])}]"
    if kind == "dict":
        return "{" + ",".join(f"{k!r}:{_describe(v)}" for k, v in node[1]) + "}"
    return repr(node[1])


def _unflatten(node, leaves):
    it = iter(leaves)

    def build(n):
        kind = n[0]
        if kind == "*":
            return next(it)
        if kind == "dc":
            vals = {k: build(v) for k, v in n[2]}
            return n[1](**vals)
        if kind == "nt":
            return n[1](**{k: build(v) for k, v in n[2]})
        if kind == "tuple":
            return tuple(build(v) for v in n[1])
        if kind == "list":
            return [build(v) for v in n[1]]
        if kind == "dict":
            return {k: build(v) for k, v in n[1]}
        return n[1]

    return build(node)


def _fingerprint(obj) -> str:
    """Stable hash of the structure: class names, field names, non-tensor
    values."""
    return hashlib.sha256(_describe(_flatten(obj)[1]).encode()).hexdigest()[:16]


def save(path: str, state) -> None:
    """Save the tensors of ``state`` to ``path`` (.npz) with structure
    metadata.  The structure itself is not serialised: pass a structurally
    identical template to :func:`load`."""
    leaves, _ = _flatten(state)
    arrs = {f"leaf_{i:06d}": t.detach().cpu().numpy()
            for i, t in enumerate(leaves)}
    arrs[_FORMAT_KEY] = np.asarray(_FORMAT_VERSION)
    arrs[_TREEDEF_KEY] = np.asarray(_fingerprint(state))
    np.savez(path, **arrs)


def load(path: str, template, strict_shapes: bool = True):
    """Load tensors saved by :func:`save` into the structure of
    ``template``; each leaf goes to the template leaf's device.

    Checks the format version, the structure fingerprint (a template of
    another class, other static fields or another field order fails with a
    clear error), the leaf count, and with ``strict_shapes`` (default) each
    leaf's shape and dtype; pass ``False`` to resume into a template of
    other shapes (e.g. a re-batched session)."""
    data = np.load(path)
    files = set(data.files)
    if _FORMAT_KEY not in files:
        raise ValueError(f"checkpoint {path}: no format marker")
    if int(data[_FORMAT_KEY]) != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path}: unsupported format version "
            f"{int(data[_FORMAT_KEY])} (expected {_FORMAT_VERSION})"
        )
    stored_fp = str(data[_TREEDEF_KEY])
    want_fp = _fingerprint(template)
    if stored_fp != want_fp:
        raise ValueError(
            f"checkpoint {path}: structure mismatch — stored fingerprint "
            f"{stored_fp} != template {want_fp} (different class, static "
            "fields, or field order)"
        )
    keys = sorted(k for k in files if k.startswith("leaf_"))
    leaves = [data[k] for k in keys]
    t_leaves, node = _flatten(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint {path}: {len(leaves)} stored leaves but template "
            f"has {len(t_leaves)}"
        )
    out = []
    for i, (got, want) in enumerate(zip(leaves, t_leaves)):
        got_t = torch.from_numpy(np.array(got))  # 0-d stays 0-d
        if strict_shapes and (tuple(got_t.shape) != tuple(want.shape)
                              or got_t.dtype != want.dtype):
            raise ValueError(
                f"checkpoint {path}: leaf {i} is {got_t.dtype}"
                f"{list(got_t.shape)} but template expects {want.dtype}"
                f"{list(want.shape)}"
            )
        out.append(got_t.to(want.device))
    return _unflatten(node, out)
