#!/usr/bin/env python3
"""Find where a problem's float32 result on the card depends on which other
problems share its batch.

Each call runs twice in one process: first on the first half of a batch,
then on the whole batch.  A ``TorchDispatchMode`` sees every ATen operation
of both runs, in order.  In the half run it keeps, for each operation, the
name, the shapes and a digest of each tensor argument and result; in the
whole run it cuts each tensor to the first half along its batch axis (the
one axis whose size is twice the half run's) and digests that.  The script
reports:

* ``first_value_ops``: the first operations whose tensor arguments all
  equal the half run's bit for bit but whose result does not -- an
  operation that rounds otherwise at another batch size;
* ``first_input_diff``: the first operation with an argument that differs
  while every earlier result was equal -- it reads a tensor that a kernel
  outside the dispatcher (a ``ctypes`` launch) wrote;
* ``control_diverges_at``: the first operation whose name differs -- a
  batch-level host decision took another branch;

each with the operation's name, shapes and the calling lines of the
package; and the end results of the half run beside the whole run's first
half (statuses, iteration counts, max abs difference).  Views, copies
and allocations are left out of both sequences, and an operation that
makes a tensor from no tensor (``randn``) is not judged.  A batch axis may
be flattened with another axis, with the batch outer or inner: a tensor
matches where either cut does.

Calls: ``dense`` -- ``ops/admm.solve_batched`` on ``chip_smoke.py``'s
config-2 batch (1,024 QPs, n=64, m=96); ``planner`` --
``GOMPSolver.run_batch_padded`` on ``planner_full``'s 1,024 queries.

    python3 tools/batch_invariance.py [--calls dense,planner] [--out FILE]

Needs one NVIDIA Hopper GPU and ``nvcc``; not part of the solver.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from osqp_solver_tpu_torch import _build, convert  # noqa: E402
from osqp_solver_tpu_torch.ops import admm as gadmm  # noqa: E402
from osqp_solver_tpu_torch.ops.admm import Settings  # noqa: E402

_PRIME = 2147483647
_W = None
# Left out of both runs' sequences: views, copies that keep the values
# (whether ``reshape`` copies follows the operand's strides, which the batch
# size can change) and allocations whose contents are not yet written.
SKIPPED = {"view", "_unsafe_view", "reshape", "expand", "permute",
           "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
           "as_strided", "alias", "unbind", "split", "split_with_sizes",
           "chunk", "narrow", "diagonal", "unfold", "view_as_real",
           "flatten", "movedim", "detach", "lift_fresh", "clone",
           "contiguous", "copy", "_to_copy", "empty_like", "new_empty",
           "new_empty_strided", "empty", "empty_strided"}


def digest(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of ``t``'s bits modulo a prime, on the
    device: equal tensors give equal digests."""
    global _W
    t = t.detach().contiguous().flatten()
    if t.dtype in (torch.float32, torch.int32):
        bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    elif t.dtype in (torch.float64, torch.int64):
        b = t.view(torch.int64)
        bits = (b ^ (b >> 32)) & 0xFFFFFFFF
    elif t.dtype in (torch.float16, torch.bfloat16):
        bits = t.view(torch.int16).to(torch.int64) & 0xFFFF
    else:
        bits = t.to(torch.int64) & 0xFFFFFFFF
    n = bits.numel()
    if _W is None or _W.numel() < n or _W.device != bits.device:
        _W = (torch.arange(max(n, 1 << 20), dtype=torch.int64,
                           device=bits.device) * 2654435761 + 97) % 1048573 + 1
    return ((bits * _W[:n]) % _PRIME).sum()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _caller():
    return [f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} {f.name}"
            for f in traceback.extract_stack()[:-3]
            if f.filename.startswith(str(ROOT))
            and "batch_invariance" not in f.filename][-4:]


class Recorder(TorchDispatchMode):
    """Half run (``ref`` None): keep each operation's name, shapes and
    digests.  Whole run: compare against ``ref``."""

    def __init__(self, batch, ref=None, max_ops=400_000, report=8):
        super().__init__()
        self.batch = batch  # the whole run's batch; the half run's is half
        self.ref, self.max_ops, self.report = ref, max_ops, report
        self.log = []
        self.i = 0
        self.stopped = None
        self.first_values, self.first_input = [], None
        self.pending = []  # (i, name, in_d, out_d, shapes, caller)

    def _cuts(self, t, shape_h):
        """The whole run's ``t`` cut to the half run's problems: the
        candidates (the batch the outer or the inner factor of a flattened
        axis), or None where no axis can hold the batch."""
        if tuple(t.shape) == tuple(shape_h):
            return [t]
        if t.dim() != len(shape_h):
            return None
        d = [k for k in range(t.dim()) if t.shape[k] != shape_h[k]]
        if len(d) != 1 or t.shape[d[0]] != 2 * shape_h[d[0]]:
            return None
        d, h, B = d[0], shape_h[d[0]], self.batch
        out = [t.narrow(d, 0, h)]
        if t.shape[d] % B == 0 and t.shape[d] > B:
            out.append(t.unflatten(d, (t.shape[d] // B, B)).narrow(
                d + 1, 0, B // 2).flatten(d, d + 1))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.stopped is not None or self.i >= self.max_ops:
            return out
        name = func.overloadpacket.__name__
        if name.rstrip("_") in SKIPPED:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        i = self.i
        self.i += 1
        if self.ref is None:
            self.log.append((name, [tuple(t.shape) for t in ins],
                             [tuple(t.shape) for t in outs],
                             [digest(t) for t in ins],
                             [digest(t) for t in outs]))
            return out
        if i >= len(self.ref):
            self.stopped = dict(op=i, reason="half run recorded no more")
            return out
        r_name, r_in_s, r_out_s, r_in_d, r_out_d = self.ref[i]
        if name != r_name or len(ins) != len(r_in_s) or \
                len(outs) != len(r_out_s):
            self.stopped = dict(op=i, reason="control flow diverges",
                                whole=name, half=r_name, caller=_caller())
            return out
        if not ins:
            return out
        cut_in = [self._cuts(t, s) for t, s in zip(ins, r_in_s)]
        cut_out = [self._cuts(t, s) for t, s in zip(outs, r_out_s)]
        if any(c is None for c in cut_in + cut_out):
            return out
        # A result without the batch axis of a batched argument reduces
        # over the batch (``any``, a batch-wide max): not judged.
        batched = any(tuple(t.shape) != tuple(s)
                      for t, s in zip(ins, r_in_s))
        keep = [k for k, (t, s) in enumerate(zip(outs, r_out_s))
                if not batched or tuple(t.shape) != tuple(s)]
        if not keep:
            return out
        self.pending.append((
            i, name, [[digest(c) for c in cs] for cs in cut_in], r_in_d,
            [[digest(c) for c in cut_out[k]] for k in keep],
            [r_out_d[k] for k in keep],
            [list(t.shape) for t in ins], _caller()))
        if len(self.pending) >= 256:
            self.flush()
        return out

    def flush(self):
        """Compare the pending digests (one host read for many ops)."""
        if not self.pending:
            return
        flat = [d for p in self.pending
                for d in [x for cs in p[2] + p[4] for x in cs] + p[3] + p[5]]
        val = {}
        for dev in {d.device for d in flat}:  # one read per device
            at = [d for d in flat if d.device == dev]
            val.update(zip(map(id, at), torch.stack(at).tolist()))

        def same(cands, ref):
            return [val[id(ref)] in [val[id(c)] for c in cs]
                    for cs, ref in zip(cands, ref)]

        for i, name, din, rin, dout, rout, shapes, caller in self.pending:
            rec = dict(op=i, name=name, shapes=shapes, caller=caller)
            ins_same, outs_same = all(same(din, rin)), all(same(dout, rout))
            if ins_same and not outs_same and \
                    len(self.first_values) < self.report:
                self.first_values.append(rec)
            if not ins_same and self.first_input is None:
                self.first_input = rec
        self.pending.clear()


def summarize(half, whole_cut):
    """Statuses, iteration counts and max abs difference of matching
    outputs: ``half`` and ``whole_cut`` are dicts of tensors."""
    out = {}
    for k, a in half.items():
        b = whole_cut[k]
        if a.dtype.is_floating_point:
            out[k] = dict(max_abs_diff=(a - b).abs().max().item(),
                          bits_equal=bool(torch.equal(a, b)))
        else:
            diff = torch.nonzero(a != b).flatten()
            out[k] = dict(differ=int(diff.numel()),
                          first=[int(j) for j in diff[:8]])
    return out


def run_dense(B, device):
    arrays = cs.dense_problems(B)

    def call(n):
        qps = convert.dense_qp_from_numpy(*(a[:n] for a in arrays),
                                          device=device)
        res = gadmm.solve_batched(qps, Settings(), device=device)
        return dict(x=res.x, status=res.status, iterations=res.iterations)

    return call, lambda r, n: {k: v[:n] for k, v in r.items()}


def run_planner(B, device):
    solver = cs.ur5e_solver(50, [])
    starts, ends = cs.fleet_queries(B, np.random.default_rng(0))

    def call(n):
        st, tr, hz, rounds, iters = solver.run_batch_padded(starts[:n],
                                                            ends[:n])[:5]
        return dict(status=st, trajectory=tr, horizon=hz, scp_rounds=rounds,
                    admm_iters=iters)

    return call, lambda r, n: {k: v[:n] for k, v in r.items()}


CALLS = {"dense": run_dense, "planner": run_planner}


def probe(name, B, max_ops, device="cuda"):
    call, cut = CALLS[name](B, device)
    call(B)  # warm: plans, allocator, kernels loaded
    call(B // 2)
    t0 = time.perf_counter()
    with Recorder(B, max_ops=max_ops) as rec:
        half = call(B // 2)
    ref = rec.log
    with Recorder(B, ref=ref, max_ops=max_ops) as cmp:
        whole = call(B)
    cmp.flush()
    return dict(
        batch=B, half=B // 2, ops_recorded=len(ref), ops_compared=cmp.i,
        max_ops=max_ops, seconds=time.perf_counter() - t0,
        stopped=cmp.stopped, first_value_ops=cmp.first_values,
        first_input_diff=cmp.first_input,
        results=summarize(half, cut(whole, B // 2)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", default="dense,planner")
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--max-ops", type=int, default=400_000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a dry run of the dense call (plain versions)")
    opts = ap.parse_args()
    out = {}
    if opts.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("batch_invariance: no CUDA device")
        N = cs.N
        _build.build_all([{}, {"B2": 2 * N}, {"NDIM": N, "NX": 3},
                          {"NDIM": N, "NX": 3, "BLOCK_P": 0}])
        out["device"] = cs.nvidia_smi()
    for name in opts.calls.split(","):
        out[name] = probe(name, opts.batch, opts.max_ops, opts.device)
        print(json.dumps({name: out[name]}), flush=True)
    if opts.out:
        Path(opts.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
