"""The port's five example drivers (``osqp_solver_tpu_torch/examples``) on
the CPU, run in-process through ``main(argv)``.

``solver_example`` is held to the JAX script run as a script (as
``tests/test_example_app.py`` runs it) at ``--cpu --waypoints 22
--segments 1``, both in float64: the ``.data`` files byte for byte, with one
exception, and the printed summary line for line (the wall time aside).
The exception is the last joint's column of the control file: the plan
never moves that joint, and both packages leave ADMM round-off of 1e-28 to
1e-23 there, printed by ``%g`` with its own digits; every other field of
both files is byte-identical.  The other four examples run at their
smallest sizes and must exit 0 and print the JAX scripts' lines (formats
only: their float32 planners with obstacles do not agree count for count
with JAX, ``ROADMAP.md`` C4; what they call is held by the earlier slices'
tests).  Without a card the default device raises: there is no fallback.
"""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from osqp_solver_tpu_torch.examples import (
    dh_robot_example,
    fleet_planning_example,
    grasp_example,
    mpc_fleet_example,
    solver_example,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
# A value printed by %g, or a numpy array of them.
NUM = r"[-+]?(?:\d+(?:\.\d*)?|\.\d+)(?:e[-+]?\d+)?"
ARR = rf"\[\s*{NUM}(?:\s+{NUM})*\s*\]"
# The last joint of the example's plan stays at 0: round-off only.
NOISE = 1e-20


def _run(module, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    rc = module.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def _match(lines, patterns):
    """Every pattern matches a line, in order."""
    it = iter(lines)
    for pat in patterns:
        assert any(re.fullmatch(pat, ln) for ln in it), (pat, lines)


def test_solver_example_matches_the_jax_script(tmp_path, monkeypatch,
                                               capsys):
    argv = ["--cpu", "--waypoints", "22", "--segments", "1"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "solver_example.py"), *argv],
        cwd=jdir, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stdout + out.stderr
    rc, lines = _run(solver_example, argv, tdir, monkeypatch, capsys)
    assert rc == 0
    jlines = out.stdout.splitlines()
    wall = re.compile(r"wall: \S+s")
    assert [wall.sub("", ln) for ln in lines] == [wall.sub("", ln)
                                                  for ln in jlines]
    assert lines[0].startswith("status: kOptimal  waypoints: 22  wall: ")

    name = "output_trajectory_xyz.data"
    assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    name = "output_trajectory_ctrl.data"
    got = (tdir / name).read_text().splitlines()
    ref = (jdir / name).read_text().splitlines()
    assert len(got) == len(ref) == 22
    for g, r in zip(got, ref):
        gf, rf = g.split(" "), r.split(" ")
        assert len(gf) == len(rf) == 6
        assert gf[:5] == rf[:5]
        assert gf[5] == rf[5] or max(abs(float(gf[5])),
                                     abs(float(rf[5]))) < NOISE


def test_dh_robot_example_runs(tmp_path, monkeypatch, capsys):
    rc, lines = _run(dh_robot_example, ["--cpu", "--robot", "scara"],
                     tmp_path, monkeypatch, capsys)
    assert rc == 0
    _match(lines, [
        r"robot: scara \(4 DOF\)",
        rf"goal xyz: {ARR} -> q_end: {ARR}",
        r"status: kOptimal  \(\d+\.\ds inc\. compile\)",
        rf"horizon: \d+ waypoints; gripper FK at the endpoint "
        rf"\(waypoint W-3\): {ARR}",
        rf"goal error: {NUM} m",
    ])


def test_mpc_fleet_example_runs(tmp_path, monkeypatch, capsys):
    rc, lines = _run(mpc_fleet_example, ["--cpu", "--batch", "2", "--ticks",
                                         "3", "--waypoints", "20"],
                     tmp_path, monkeypatch, capsys)
    assert rc == 0
    _match(lines, [
        r"building a fleet of 2 UR5e controllers \(W=20\)\.\.\.",
        r"tick 0 \(cold\): 2/2 optimal, median \d+ iters",
        r"3 ticks x 2 controllers: 6/6 optimal, warm re-solves median \d+ "
        r"iters, \d+\.\d ms/tick \(incl\. compile on first call\)",
    ])


def test_fleet_planning_example_runs(tmp_path, monkeypatch, capsys):
    rc, lines = _run(fleet_planning_example,
                     ["--cpu", "--batch", "2", "--waypoints", "30",
                      "--segments", "2", "--per-query"],
                     tmp_path, monkeypatch, capsys)
    assert rc == 0
    _match(lines, [
        r"device: cpu \(cpu\)",
        r"per-query keep-outs: 2 spheres, 3 cm pose jitter",
        r"fleet of 2 full time-scaling queries in \d+\.\d\ds .*",
        r"optimal: [12]/2",
        r"winning horizons: \d+x\d+(, \d+x\d+)*  \(W_max=30, 2 segments\)",
        r"ADMM iterations/query: p50=\d+ max=\d+  SCP rounds p50=\d+",
        rf"query \d: tool keep-out clearance min = {NUM} m",
        r"OK",
    ])


def test_grasp_example_runs(tmp_path, monkeypatch, capsys):
    rc, lines = _run(grasp_example, ["--cpu", "--grasps", "2", "--waypoints",
                                     "12", "--segments", "2"],
                     tmp_path, monkeypatch, capsys)
    assert rc == 0
    _match(lines, [
        r"device: cpu \(cpu\)",
        rf"IK: 2 grasp poses -> joint targets \(analytic 8-branch; DLS "
        rf"pose-IK cross-check max tool-point deviation {NUM} m\)",
        r"planned 2 grasp approaches in \d+\.\d\ds \(compile\+solve\), "
        r"optimal [12]/2, winning horizon p50=\d+",
        rf"grasp-pose audit over optimal plans: max tool position error "
        rf"{NUM} m, max orientation error {NUM} deg",
        "Summary:",
        rf"Ground-truth start {ARR} -> optimized start {ARR}",
        rf"Middle position after optimization: {ARR}",
        rf"Ground-truth grasp point {ARR} -> optimized end {ARR}",
        r"OK",
    ])
    ctrl = (tmp_path / "output_trajectory_ctrl.data").read_text()
    xyz = (tmp_path / "output_trajectory_xyz.data").read_text()
    assert all(len(ln.split(" ")) == 6 for ln in ctrl.splitlines())
    assert all(re.fullmatch(rf"\({NUM}, {NUM}, {NUM}\)", ln)
               for ln in xyz.splitlines())


@pytest.mark.parametrize("module", [solver_example, dh_robot_example,
                                    mpc_fleet_example, fleet_planning_example,
                                    grasp_example],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_default_to_the_card(module):
    """Without ``--cpu`` an example asks for the CUDA device; without one it
    raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])
