#!/usr/bin/env python3
"""Compare the machine code of every lane build that ``chip_smoke.py``
makes, this tree's sources against another checkout's.

On a machine with ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), from the
repository root:

    mkdir -p ref_tree && git archive 9080a8b osqp_solver_tpu_torch/csrc \\
        | tar -x -C ref_tree
    python3 tools/sass_compare.py --ref-tree ref_tree [--max-joints 256] \\
        [--max-b2 512] [--out FILE]

Builds the Ruiz, KKT-factor, chunk and residual sources at every layout
signature of ``chip_smoke.py``'s phases up to ``--max-joints`` joints and
the tridiagonal pair up to ``--max-b2``, from both trees, all compilers
started together, and compares each pair's ``cuobjdump -sass`` listing
(``chip_smoke.sass_differs``).  The wide builds (2N or B2 above 32) of
the KKT factor and of the tridiagonal pair, whose factors were redesigned
(``chip_smoke.same_code_expected``), are compared in their solve kernels
alone (the tridiagonal pair's ``tridiag_solve_kernel`` functions) or not
at all (the KKT factor's).  Each build that differs is built again from
this tree into another directory and compared with its first build,
which tells a change of the code from a compiler that is not
deterministic.  Prints one JSON line: the builds compared, those that
differ, those left out, and the second builds' verdicts; exits 1 where
any differs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from osqp_solver_tpu_torch import _build  # noqa: E402

LANE = ("ruiz", "kkt_factor", "admm_chunk", "residuals", "tridiag")


def tag(name, sig):
    return name + ":" + ",".join(f"{k}={v}" for k, v in sig)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-tree", required=True,
                    help="root of the other checkout (its csrc/ is used)")
    ap.add_argument("--max-joints", type=int, default=256)
    ap.add_argument("--max-b2", type=int, default=512)
    ap.add_argument("--out", default=None, help="also write the record here")
    opts = ap.parse_args()
    cs.REF_TREE = opts.ref_tree
    sigs = [s for s in cs.build_signatures(set(cs.PHASES.split(",")))
            if s and s.get("NDIM", 0) <= opts.max_joints
            and s.get("B2", 0) <= opts.max_b2]
    wanted = sorted({(n, tuple(sorted(s.items()))) for s in sigs for n in LANE
                     if set(s) == set(_build.KERNELS[n])})
    t0 = time.time()
    ref = [(n, s, _build.start_build(n, dict(s), csrc=cs.ref_csrc()))
           for n, s in wanted]
    built = _build.build_all([dict(s) for _, s in wanted], LANE)

    def only(n, s):  # the functions compared (None: all)
        if cs.same_code_expected(n, dict(s)):
            return None
        return "tridiag_solve" if n == "tridiag" else False

    skipped = [tag(n, s) for n, s in wanted if only(n, s) is False]
    differ = [(n, s) for n, s, h in ref if only(n, s) is not False
              and cs.sass_differs(_build.finish_build(h), built[(n, s)],
                                  only(n, s))]
    again = {}
    if differ:
        os.environ["OSQP_TORCH_BUILD_DIR"] = str(_build.build_dir()) + "_again"
        handles = [(n, s, _build.start_build(n, dict(s))) for n, s in differ]
        again = {tag(n, s): cs.sass_differs(_build.finish_build(h),
                                            built[(n, s)], only(n, s))
                 for n, s, h in handles}
    rec = dict(seconds=round(time.time() - t0, 1), builds=len(wanted),
               max_joints=opts.max_joints, max_b2=opts.max_b2,
               differ=[tag(n, s) for n, s in differ],
               solve_kernels_only=[tag(n, s) for n, s in wanted
                                   if only(n, s)],
               not_compared=skipped,
               second_build_differs_from_first=again,
               card=cs.nvidia_smi())
    if opts.out:
        Path(opts.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
