"""The one door through which every collective of ``parallel/`` passes.

Each call is counted with its payload (the bytes this rank contributes), by
kind, with the distinct payload sizes, so that tests and ``chip_smoke.py``
can hold the horizon-sharded solve's "separator only" property: no payload
of the solve grows with the horizon.  The gathers that assemble a finished
result for the caller are counted apart, as ``gather_result``.

Transport.  With one GPU per rank the group is NCCL and CUDA tensors go as
they are.  Several ranks on one GPU cannot share NCCL (it refuses two ranks
on one device), so such a world runs gloo, which moves CPU tensors only for
``all_gather`` and point-to-point: there this helper stages each payload
through the host and back.  The compute stays on the card; only the
``O(K·B2)`` payloads cross.  On the CPU (gloo) tensors go as they are.  A
world of one rank runs the collectives too (NCCL or gloo), so the transport
is the one a larger world uses.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

# kind -> {"calls": int, "bytes": int, "sizes": sorted distinct bytes per
# call} since the last reset().
COUNTS: Dict[str, Dict[str, int]] = {}


def reset() -> None:
    COUNTS.clear()


def counts() -> Dict[str, dict]:
    """A copy of the counts by kind."""
    return {k: dict(v, sizes=sorted(v["sizes"])) for k, v in COUNTS.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    c = COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "sizes": set()})
    nbytes = t.numel() * t.element_size()
    c["calls"] += 1
    c["bytes"] += nbytes
    c["sizes"].add(nbytes)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must cross through the host: a CUDA tensor in a gloo
    group (ranks sharing one GPU)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` ("max" or "sum") of ``t`` over ``group``: a new tensor, the
    same on every rank."""
    _count("all_reduce", t)
    out = t.detach().to("cpu" if _staged(t, group) else t.device,
                        copy=True).contiguous()
    dist.all_reduce(out, _OPS[op], group=group)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group, kind: str = "all_gather"
               ) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked in group-rank order on a new
    leading axis; ``kind``: the name it is counted under."""
    _count(kind, t)
    k = dist.get_world_size(group)
    src = t.detach().to("cpu" if _staged(t, group) else t.device).contiguous()
    out = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)
