"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages: the JAX
package builds its ``LaneTrajectoryQP`` from the arrays directly, the port
through ``convert.lane_qp_from_numpy``.  Everything runs on the CPU in f64.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.gomp import trajectory_qp_lane as jlane
from osqp_solver_tpu_torch import convert

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

W, N, B = 8, 3, 8
FLAGS = (False, True)
N_OBS = 1


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
