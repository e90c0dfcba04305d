#!/usr/bin/env python3
"""Where the tier-1 test run's time goes: worker-seconds by test file, and
which files each xdist worker ran when.

As a script, from the repository root:

    python3 tools/tier1_times.py RUN.xml [OTHER.xml]
    python3 tools/tier1_times.py --timeline DIR

The first form reads the junit of a run (``--junitxml``) and prints the
worker-seconds of every test file, the port's (``test_torch_*``) and the
JAX package's summed apart; with a second junit, the two side by side and
their difference, file by file.  The second form reads the records of the
plugin below and prints, for each worker, the files it ran in order with
their start, end and seconds from the run's start.

As a pytest plugin it records each test's worker, start and end:

    TIER1_TIMES_DIR=DIR PYTHONPATH=tools python -m pytest tests/ \\
        -p tier1_times -n 6 --dist loadfile ...

writing one ``DIR/<worker>.jsonl`` a worker, flushed after every test, so
that a run cut by its time limit still shows what ran.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import sys
import time
import xml.etree.ElementTree as ET

_OUT = None


def pytest_configure(config):
    global _OUT
    out = os.environ.get("TIER1_TIMES_DIR")
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if not out or (worker is None and getattr(config.option, "numprocesses",
                                              None)):
        return  # off, or the xdist controller: its workers record
    os.makedirs(out, exist_ok=True)
    _OUT = open(os.path.join(out, f"{worker or 'main'}.jsonl"), "w")
    _OUT.write(json.dumps({"configure": time.time()}) + "\n")
    _OUT.flush()


def pytest_runtest_logstart(nodeid, location):
    if _OUT is not None:
        _OUT.write(json.dumps({"node": nodeid, "t0": time.time()}) + "\n")
        _OUT.flush()


def pytest_runtest_logfinish(nodeid, location):
    if _OUT is not None:
        _OUT.write(json.dumps({"node": nodeid, "t1": time.time()}) + "\n")
        _OUT.flush()


def file_seconds(path):
    """``{file: (worker-seconds, tests)}`` of a junit."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for tc in ET.parse(path).getroot().iter("testcase"):
        f = (tc.get("classname") or "?").split(".")[-1]
        out[f][0] += float(tc.get("time", 0))
        out[f][1] += 1
    return out


def _totals(files):
    port = sum(v[0] for k, v in files.items() if k.startswith("test_torch_"))
    return port, sum(v[0] for v in files.values()) - port


def report(paths):
    runs = [file_seconds(p) for p in paths]
    for p, r in zip(paths, runs):
        port, jax = _totals(r)
        print(f"{p}: port {port:.1f} worker-seconds, JAX package {jax:.1f}, "
              f"{sum(v[1] for v in r.values())} tests")
    names = sorted(set().union(*runs),
                   key=lambda f: -max(r.get(f, (0, 0))[0] for r in runs))
    for f in names:
        cells = [r.get(f, (0.0, 0)) for r in runs]
        row = " ".join(f"{s:8.1f} {n:3d}" for s, n in cells)
        diff = (f" {cells[1][0] - cells[0][0]:+8.1f}"
                if len(cells) == 2 else "")
        print(f"{row}{diff} {f}")


def timeline(d):
    recs = {}
    for path in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
        recs[os.path.basename(path)[:-6]] = [json.loads(line)
                                             for line in open(path)]
    t_start = min(r[0]["configure"] for r in recs.values())
    for worker, rs in recs.items():
        starts = {r["node"]: r["t0"] for r in rs if "t0" in r}
        files, last = [], None
        for r in rs:
            if "node" not in r:
                continue
            f = r["node"].split("::")[0]
            t = r.get("t1", r.get("t0"))
            if f != last:
                files.append([f, starts.get(r["node"], t), t, 0])
                last = f
            files[-1][2] = t
            files[-1][3] += "t1" in r
        unfinished = [n for n in starts
                      if not any(r.get("node") == n and "t1" in r
                                 for r in rs)]
        end = max(f[2] for f in files) - t_start if files else 0.0
        print(f"{worker}: last event at {end:.0f} s"
              + (f", unfinished {unfinished}" if unfinished else ""))
        for f, a, b, n in files:
            print(f"  {a - t_start:7.0f} {b - t_start:7.0f} {b - a:7.0f} "
                  f"{n:3d} {f}")


def main(argv):
    if len(argv) == 2 and argv[0] == "--timeline":
        timeline(argv[1])
    elif 1 <= len(argv) <= 2:
        report(argv)
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
