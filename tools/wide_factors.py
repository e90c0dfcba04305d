#!/usr/bin/env python3
"""The two factors' wide forms alone on the card: ``csrc/tridiag.cu``'s
factor and ``csrc/kkt_factor.cu`` (both forms), each checked against its
plain version run in float64 and timed, optionally beside another
checkout's kernels on the same inputs.

On a machine with one NVIDIA Hopper GPU, from the repository root:

    python3 tools/wide_factors.py [--tridiag B2:W:B,...] [--kkt N:W:B,...] \\
        [--ref-tree DIR] [--budget BYTES] [--reps 5] [--out FILE]

The tridiagonal factor runs on ``chip_smoke.spd_blocks`` (seeded SPD
blocks), the KKT factor on ``chip_smoke.size_batch`` (the lane path's
batch at that joint count, Ruiz-scaled, the bench.py settings).  Every
library is built first, all compilers started together (with
``--ref-tree`` that tree's too).  Per case: the largest error over the
largest float64 value, the values that differ bit for bit between two
launches, the time of a launch (median of ``--reps``, CUDA events), the
bound of ``chip_smoke.bound``, the plan and the CUDA launches a call
makes under it (``device_launches``), where the plan splits a problem
over several blocks also the one-block form on the same inputs (a budget
below the split form's shared bytes: ``one_block_ms`` and its error),
with ``--ref-tree`` the other
tree's time on the same inputs (``ref_ms``; the KKT factor's launch alone,
as ``launch_ms``), and with ``--profile`` the device time by kernel of one
launch (``torch.profiler``: the split forms' phases are kernels of their
own).  Prints one JSON line
(the card's name and power limit in it); exits 1 where a case is outside
its tolerance (``chip_smoke.TOL_TRIDIAG``, ``TOL_FACTOR``) or not equal
run to run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from osqp_solver_tpu_torch import _build  # noqa: E402
from osqp_solver_tpu_torch.ops import (  # noqa: E402
    admm_fused, admm_lane, kkt_factor, tridiag_kernel,
)
from osqp_solver_tpu_torch.ops.admm import Settings, _rho_vec  # noqa: E402


def cases(text):
    return [tuple(int(v) for v in c.split(":")) for c in text.split(",") if c]


def build(tri, kkt):
    """Every library of the cases (and of --ref-tree), all at once; the
    seconds and the ptxas report of each of this tree's."""
    sigs = [("tridiag", {"B2": b2}) for b2 in sorted({c[0] for c in tri})]
    sigs += [("kkt_factor", {"NDIM": n, "NX": 5})
             for n in sorted({c[0] for c in kkt})]
    t0 = time.time()
    ref = [_build.start_build(n, s, csrc=cs.ref_csrc())
           for n, s in sigs] if cs.REF_TREE else []
    built = _build.build_all([s for _, s in sigs],
                             names=("tridiag", "kkt_factor"))
    for h in ref:
        _build.finish_build(h)
    report = {}
    for (name, sig), path in built.items():
        info = _build.ptxas_report(path)
        report[name + ":" + ",".join(f"{k}={v}" for k, v in sig)] = {
            k[:48]: v for k, v in info.items()
            if k == "build_seconds" or "factor" in k}
    return round(time.time() - t0, 1), report


def profile(launch):
    """Device time by kernel of one ``launch()`` (``torch.profiler``; the
    split forms' phases are kernels of their own): ``{name: [ms,
    launches]}``, or the profiler's error where it gives no device time."""
    from torch.profiler import ProfilerActivity
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            launch()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            if t:
                out[e.key[:60]] = [t / 1e3, e.count]
        return out
    except Exception as exc:  # noqa: BLE001  (no profile is no failure)
        return {"error": repr(exc)}


def tridiag_case(B2, Wd, B, budget, reps, prof=False):
    diag, lower, _ = cs.spd_blocks(B2, Wd, B)
    lib = _build.library("tridiag", {"B2": B2})

    def launch(lb=lib, budget1=None):
        c, g = torch.empty_like(diag), torch.empty_like(lower)
        tridiag_kernel._launch(lb, "factor", diag, lower, c, g,
                               budget=budget1 or budget)
        return c, g
    ck, gk = launch()
    c64, g64 = tridiag_kernel.factor_lane_major_plain(diag.double(),
                                                      lower.double())
    again = launch()
    torch.cuda.synchronize()
    err = max(cs.rel_err(ck.double(), c64)[1], cs.rel_err(gk.double(),
                                                          g64)[1])
    rep = cs.bits_differing(ck, again[0])[0] + cs.bits_differing(
        gk, again[1])[0]
    b_ms, b_by = cs.bound(cs.tril_bytes(diag) + cs.nbytes(lower, ck, gk),
                          cs.ops_tridiag_factor(Wd, B2, B))
    rec = dict(B2=B2, W=Wd, batch=B, rel_err=err, bits_differing=rep,
               ms=cs.time_ms(launch, reps=reps, warm=1), bound_ms=b_ms,
               bound_by=b_by, plan=tridiag_kernel.factor_plan(lib, B, budget),
               ok=bool(err <= cs.TOL_TRIDIAG and not rep))
    rec["device_launches"] = tridiag_kernel.factor_device_launches(
        rec["plan"], Wd)
    if rec["plan"]["blocks_per_problem"] > 1:
        # The one-block form on the same inputs (a budget below the split
        # form's shared bytes: the matrix in the workspace).
        one = lambda: launch(budget1=1)  # noqa: E731
        c1, g1 = one()
        rec["one_block_rel_err"] = max(cs.rel_err(c1.double(), c64)[1],
                                       cs.rel_err(g1.double(), g64)[1])
        rec["one_block_ms"] = cs.time_ms(one, reps=reps, warm=1)
        rec["ok"] = rec["ok"] and rec["one_block_rel_err"] <= cs.TOL_TRIDIAG
        del c1, g1
    if cs.REF_TREE:
        rl = cs.ref_library("tridiag", (("B2", B2),))
        rec["ref_ms"] = cs.time_ms(lambda: launch(rl), reps=reps, warm=1)
    if prof:
        rec["profile"] = profile(launch)
    del diag, lower, ck, gk, c64, g64, again
    torch.cuda.empty_cache()
    return rec


def kkt_case(Nj, Wd, B, prof=False):
    bench = dataclasses.replace(Settings(), **cs.BENCH)
    qp = cs.size_batch(Nj, batch=B, Wd=Wd)
    scaled, scaling = admm_lane.ruiz_equilibrate_lane(qp, bench.scaling)
    packs = admm_lane.build_const_packs(scaled, scaling)
    rho_vec = _rho_vec(torch.full((B,), bench.rho, device="cuda"),
                       scaled.l, scaled.u)
    (ck, cg, gg), recs = cs.kkt_factor_records(
        scaled, cs.cast(scaled, torch.float64), rho_vec, bench,
        packs["coef"], Nj)
    lib = _build.library("kkt_factor", admm_fused.layout_signature(
        scaled))
    if kkt_factor.plan(lib, Wd, B)["blocks_per_problem"] > 1:
        # The one-block form on the same packs (a budget below the split
        # form's shared bytes: the matrix in the workspace), against the
        # split form's outputs.
        Pd, Pl = kkt_factor.build_p_vel_packs(scaled)
        rho3 = rho_vec.reshape(Wd, -1, B).contiguous()
        for name, g, want in (("kkt_factor", False, [ck]),
                              ("kkt_factor_gain", True, [cg, gg])):
            o = [torch.empty_like(ck) for _ in range(1 + g)]

            def one(g=g, o=o):
                kkt_factor._launch_factor(lib, packs["coef"], rho3, Pd, Pl,
                                          o[0], bench.sigma,
                                          o[1] if g else None, budget=1)
            one()
            torch.cuda.synchronize()
            recs[name]["one_block_vs_split"] = max(
                cs.rel_err(a.double(), w.double())[1]
                for a, w in zip(o, want))
            recs[name]["one_block_ms"] = cs.time_ms(one, reps=3, warm=1)
    if prof:
        for g, name in ((False, "kkt_factor"), (True, "kkt_factor_gain")):
            recs[name]["profile"] = profile(
                lambda g=g: kkt_factor.factor_packed_lane(
                    scaled, rho_vec, bench.sigma, coef=packs["coef"],
                    emit_gain=g))
    del qp, scaled, packs
    torch.cuda.empty_cache()
    return {k: dict(v, N=Nj, W=Wd, batch=B) for k, v in recs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tridiag", default="80:100:256,512:20:8,600:10:8")
    ap.add_argument("--kkt", default="40:100:256,256:20:8")
    ap.add_argument("--ref-tree", default=None)
    ap.add_argument("--budget", type=int, default=0,
                    help="shared bytes a block may use (1: the workspace)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="also the device time by kernel of one launch")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_factors: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cs.REF_TREE = opts.ref_tree
    tri, kkt = cases(opts.tridiag), cases(opts.kkt)
    seconds, ptx = build(tri, kkt)
    out = dict(card=cs.nvidia_smi(), build_seconds=seconds, ptxas=ptx,
               tridiag={}, kkt={})
    for B2, Wd, B in tri:
        out["tridiag"][f"B2_{B2}_W{Wd}_B{B}"] = tridiag_case(
            B2, Wd, B, opts.budget, opts.reps, opts.profile)
        print(json.dumps(out["tridiag"][f"B2_{B2}_W{Wd}_B{B}"]),
              file=sys.stderr, flush=True)
    for Nj, Wd, B in kkt:
        out["kkt"][f"N{Nj}_W{Wd}_B{B}"] = kkt_case(Nj, Wd, B, opts.profile)
        print(json.dumps(out["kkt"][f"N{Nj}_W{Wd}_B{B}"]), file=sys.stderr,
              flush=True)
    if opts.out:
        Path(opts.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    bad = [k for k, v in out["tridiag"].items() if not v["ok"]]
    bad += [f"{k}:{f}" for k, v in out["kkt"].items() for f, r in v.items()
            if not r["ok"]]
    if bad:
        print(f"wide_factors: outside tolerance or not equal run to run: "
              f"{bad}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
