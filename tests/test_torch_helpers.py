"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages: the JAX
package builds its ``LaneTrajectoryQP`` from the arrays directly, the port
through ``convert.lane_qp_from_numpy``.  Everything runs on the CPU in f64.
"""
import dataclasses
import functools
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory_qp_lane as jlane
from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jlane_drv
from osqp_solver_tpu_torch import _build, convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

W, N, B = 8, 3, 8
FLAGS = (False, True)
N_OBS = 1


@functools.lru_cache(maxsize=None)
def wp_batch(honest=True):
    """``tests/test_admm_fused.py::build_wp_batch`` (W=8, N=3, B=128, f64)
    built under ``jax.jit``: one compiled program instead of the eager
    vmap, ~1 s instead of ~8 s on the CPU; its values equal the eager
    build's within 2.3e-16."""
    from test_admm_fused import build_wp_batch

    return jax.jit(lambda: build_wp_batch(honest=honest))()


def jit_vmap(f, **kw):
    """``jax.vmap(f)`` under ``jax.jit``: a reference computed as one
    compiled program instead of op by op (each eager op compiles its own)."""
    return jax.jit(jax.vmap(f, **kw))


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def random_lane_problem(seed=0, W=W, N=N, B=B, flags=FLAGS, n_obs=N_OBS,
                        row_layout="waypoint"):
    """``(static, arrays)`` of a random vel-diag lane batch whose KKT matrix
    is positive definite and whose bounds mix equalities, boxes and loose
    rows."""
    rng = np.random.default_rng(seed)
    nb = len(flags)
    B2 = 2 * N
    P_diag = np.zeros((W, B2, B2, B))
    P_lower = np.zeros((W - 1, B2, B2, B))
    for j in range(N):
        P_diag[:, N + j, N + j] = rng.uniform(2.0, 3.0, (W, B))
        P_lower[:, N + j, N + j] = rng.uniform(-1.0, -0.5, (W - 1, B))

    def bounds(shape, p_eq=0.2, p_loose=0.3):
        mid = rng.normal(size=shape)
        half = rng.uniform(0.1, 1.0, shape)
        kind = rng.uniform(size=shape)
        lo = np.where(kind < p_eq, mid, mid - half)
        hi = np.where(kind < p_eq, mid, mid + half)
        loose = kind > 1.0 - p_loose
        side = rng.uniform(size=shape)
        lo = np.where(loose & (side < 0.7), -1e30, lo)
        hi = np.where(loose & (side > 0.3), 1e30, hi)
        return lo, hi

    arrays = dict(
        P_diag=P_diag, P_lower=P_lower,
        q_vec=rng.normal(size=(2 * W * N, B)),
        dyn_coef=rng.normal(size=(W - 1, N, 3, B)),
        pos_coef=rng.normal(size=(W, N, B)),
        vel_coef=rng.normal(size=(W - 1, N, B)),
        acc_coef=rng.normal(size=(W - 2, N, 2, B)),
        ws_jac=rng.normal(size=(nb, W, 3, N, B))
        * np.asarray(flags, float).reshape(nb, 1, 1, 1, 1),
        obs_jac=rng.normal(size=(nb, n_obs, W, N, B)),
    )
    for name, shape in (
        ("dyn", (W - 1, N, B)), ("pos", (W, N, B)), ("vel", (W - 1, N, B)),
        ("acc", (W - 2, N, B)), ("ws", (nb, W, 3, B)),
        ("obs", (nb, n_obs, W, B)),
    ):
        arrays[name + "_l"], arrays[name + "_u"] = bounds(shape)
    static = dict(
        waypoints=W, n_dim=N, gripper_flags=tuple(flags), n_obstacles=n_obs,
        row_layout=row_layout, p_structure="vel_diag",
    )
    return static, arrays


def jax_lane(static, arrays):
    return jlane.LaneTrajectoryQP(
        **static, **{k: jnp.asarray(v) for k, v in arrays.items()}
    )


def torch_lane(static, arrays):
    return convert.lane_qp_from_numpy(static, arrays, device="cpu")


def both(seed=0, **kw):
    static, arrays = random_lane_problem(seed, **kw)
    return jax_lane(static, arrays), torch_lane(static, arrays)


def assert_close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


def t_(a):
    return torch.from_numpy(np.array(a))


def chunk_case(seed=0, n_iter=3, flags=FLAGS, n_obs=N_OBS, W=W, B=B):
    """A scaled problem, a non-trivial state, a mixed done mask — in both
    frameworks — and the reference's result of ``n_iter`` iterations.
    Cached by value (a default spelled out shares the case): callers clone
    what they write to."""
    return _chunk_case(seed, n_iter, tuple(flags), n_obs, W, B)


@functools.lru_cache(maxsize=None)
def _chunk_case(seed, n_iter, flags, n_obs, W, B):
    jqp, _ = both(seed, flags=flags, n_obs=n_obs, W=W, B=B)
    settings = dataclasses.replace(jadmm.Settings(), check_termination=n_iter)
    rng = np.random.default_rng(seed + 100)
    wx = rng.normal(size=(jqp.n, B))
    wy = 0.1 * rng.normal(size=(jqp.m, B))
    done = np.zeros(B, bool)
    done[[1, 6]] = True

    @jax.jit  # one compiled program: the eager steps take ~15 s on the CPU
    def reference(jqp, wx, wy, done):
        jscaled, js = jlane_drv._ruiz_equilibrate_lane_jnp(jqp, 5)
        st = jlane_drv.init_state_lane(jscaled, settings, wx, wy, js)
        st = st.replace(done=done)
        ref = st
        for _ in range(n_iter):
            ref = jlane_drv._iteration(jscaled, ref.replace(factor=None),
                                       st.factor, settings)
        tq = jlane_drv._termination_quantities(jqp, jscaled, js, ref)
        return jscaled, js, st, ref, tq

    jscaled, js, st, ref, tq = reference(
        jqp, jnp.asarray(wx), jnp.asarray(wy), jnp.asarray(done))

    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(jscaled))
    ts = convert.scaling_from_numpy(*(to_np(a) for a in (js.D, js.E, js.c)))
    tsettings = convert.settings_from_dict(dataclasses.asdict(settings))
    rho_vec = t_(st.rho_vec)
    packs = tlane_drv.build_const_packs(tscaled, ts)
    args = dict(
        coef=packs["coef"], lu=tfused.build_lu_pack(tscaled),
        packed_factor=tfactor.factor_packed_lane(
            tscaled, rho_vec, settings.sigma, coef=packs["coef"]),
        state_pack=tfused.pack_state(tscaled, t_(st.x), t_(st.z), t_(st.y)),
        term_packs=(packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"]),
    )
    return (jscaled, ref, tq), (tscaled, ts, tsettings, rho_vec, t_(done),
                                packs, args)


def host_lib_signature(name, signature):
    """A kernel's source built with g++ in host emulation (double) for one
    layout signature."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation of the CUDA sources needs g++")
    return _build.library(name, signature, host=True)


def host_lib(name, qp):
    """A lane kernel's source in host emulation for ``qp``'s layout (and,
    for the kernels that read P, its P form)."""
    if "BLOCK_P" in _build.KERNELS[name]:
        return host_lib_signature(name, tfused.p_signature(qp))
    return host_lib_signature(name, tfused.layout_signature(qp))


# Cases of the emulated Ruiz kernel beyond the base batch (W=8, B=8: one
# block of 8 problems): a batch that is not a multiple of the problems per
# block (the last block masked), the gate's fewest waypoints, runs of
# several waypoints with a shorter last one (W=11 at 16 threads a block:
# runs of 6 and 5), and shared-memory budgets (bytes of the
# double-precision emulation) too small for the rows, which put the
# constant rows and D/E in device memory: with runs of several waypoints
# ("state_shared", a budget that held D/E alone when the plan had that
# placement) and of one ("nothing_shared").
ODD_BATCH = 13
RUIZ_CASES = {"odd_batch": dict(B=ODD_BATCH), "w4": dict(W=4),
              "uneven_runs": dict(W=11, threads=16),
              "state_shared": dict(W=11, B=ODD_BATCH, threads=16,
                                   budget=4096),
              "nothing_shared": dict(W=11, B=ODD_BATCH, budget=1)}
# The cases whose plan keeps the rows in device memory.
RUIZ_OFF_CHIP = ("state_shared", "nothing_shared")
RUIZ_PARAMS = [
    pytest.param(i, f, n, "base", id=f"{fid}-{i}")
    for f, n, fid in [((False, True), 1, "flags0-1"), ((), 0, "flags1-0")]
    for i in (1, 4)
] + [pytest.param(4, (False, True), 1, c, id=c) for c in RUIZ_CASES]


def emulated_ruiz(tqp, iters, case):
    """The Ruiz kernel in host emulation on ``tqp`` with the budget and
    thread cap of ``RUIZ_CASES[case]`` (none for "base"): ``(D, E, c)``;
    asserts that the plan reaches what the case is for."""
    kw = RUIZ_CASES.get(case, {})
    budget, threads = kw.get("budget", 0), kw.get("threads", 0)
    lib = host_lib("ruiz", tqp)
    p = truiz.plan(lib, tqp.waypoints, tqp.batch, budget, threads)
    if case in ("uneven_runs", "state_shared"):
        assert p["rpt"] > 1 and tqp.waypoints % p["rpt"] != 0
    assert p["rows_in_shared"] == (case not in RUIZ_OFF_CHIP)
    packs = truiz._ruiz_kernel_packs(tqp)
    for t in packs[4:]:
        t.fill_(float("nan"))
    truiz._launch_ruiz(lib, *packs, iters, budget=budget, threads=threads)
    return truiz._unpack_scalings(tqp, *packs[4:])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port pulls in neither ``jax``/``flax``
    nor ``osqp_solver_tpu`` (checked in a fresh interpreter)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import osqp_solver_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'osqp_solver_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")
