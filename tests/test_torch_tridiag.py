"""PyTorch port vs JAX package: the batched block-tridiagonal factor and
solve (``ops/tridiag_kernel.py``).  The plain versions are held to
``pallas_tridiag.factor_lane_major`` / ``solve_lane_major`` in interpret
mode, and ``csrc/tridiag.cu`` compiled in host emulation (g++, double) to
the plain versions, the factor and the solve at the edges of their launch
plans.  f64, CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import pallas_tridiag as jtri
from osqp_solver_tpu.ops import tridiag as jref
from osqp_solver_tpu_torch import _build
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import assert_close, host_lib_signature, to_np

pytestmark = pytest.mark.torch_port


def spd_batch(W, B2, B, seed=0):
    """Batch-trailing ``diag (W, B2, B2, B)``, ``lower (W-1, B2, B2, B)`` of
    block-tridiagonal SPD matrices (diagonally dominant blocks) and a
    right-hand side ``(W, B2, B)``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(W, B2, B2, B))
    diag = np.einsum("wikb,wjkb->wijb", a, a) + (2.0 * B2) * np.eye(B2)[
        None, :, :, None]
    lower = 0.5 * rng.normal(size=(max(W - 1, 0), B2, B2, B))
    rhs = rng.normal(size=(W, B2, B))
    return diag, lower, rhs


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("W,B2,B", [(5, 4, 3), (16, 12, 7), (1, 4, 2)])
def test_plain_matches_pallas_interpret(W, B2, B):
    """The shapes of ``tests/test_pallas_tridiag.py``.  The factor runs in
    interpret mode at B2=4; at B2=12 (where tracing the unrolled 12x12
    kernel in interpret mode costs ~35 s of one CPU) it is held to the
    reference's scan ``block_tridiag_factor``, which its Pallas kernel
    matches; the solve runs in interpret mode at every shape."""
    diag, lower, rhs = spd_batch(W, B2, B)
    if B2 == 4:
        jchol, jgain = jtri.factor_lane_major(
            jnp.asarray(diag), jnp.asarray(lower), interpret=True)
    else:
        jf = jax.vmap(jref.block_tridiag_factor, in_axes=-1, out_axes=-1)(
            jnp.asarray(diag), jnp.asarray(lower))
        jchol, jgain = jf.chol, jf.gain
    chol, gain = ttri.factor_lane_major(t_(diag), t_(lower))
    assert_close(chol, jchol, rtol=1e-10, atol=1e-12)
    assert tuple(gain.shape) == (W - 1, B2, B2, B)
    assert_close(gain, jgain, rtol=1e-10, atol=1e-12)
    jx = jtri.solve_lane_major(jchol, jgain, jnp.asarray(rhs), interpret=True)
    x = ttri.solve_lane_major(chol, gain, t_(rhs))
    assert_close(x, jx, rtol=1e-10, atol=1e-12)
    assert ttri.factor_lane_major.launches == 0
    assert ttri.solve_lane_major.launches == 0


def _emulated(diag, lower, rhs, budget=0):
    """Factor and solve through ``csrc/tridiag.cu`` in host emulation (the
    solve with the shared-memory ``budget`` of :func:`ttri.plan`)."""
    W, B2, _, B = diag.shape
    lib = host_lib_signature("tridiag", {"B2": B2})
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain)
    x = torch.full_like(rhs, float("nan"))
    ttri._launch(lib, "solve", chol, gain, rhs, x, budget=budget)
    return chol, gain, x


# The emulated solve's cases: B = 37 (ten blocks of 4 problems, the last
# with one), one problem (a block with three empty columns), and w_t kept
# in x between the sweeps (a budget of one byte), with one and with several
# steps.
SOLVE_PARAMS = [
    pytest.param(W, B2, 37, 0, id=f"{W}-{B2}")
    for B2 in (12, 14) for W in (1, 2, 5)
] + [
    pytest.param(5, 12, 1, 0, id="B1"),
    pytest.param(2, 12, 1, 0, id="B1-W2"),
    pytest.param(1, 12, 37, 1, id="w_in_x-1"),
    pytest.param(2, 14, 37, 1, id="w_in_x-2"),
    pytest.param(5, 12, 37, 1, id="w_in_x-5"),
]


@pytest.mark.parametrize("W,B2,B,budget", SOLVE_PARAMS)
def test_emulated_kernels_match_plain(W, B2, B, budget, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, rhs = (t_(a) for a in spd_batch(W, B2, B, seed=W + B2))
    p = ttri.plan(host_lib_signature("tridiag", {"B2": B2}), W, B, budget)
    assert (p["G"], p["w_on_chip"]) == (16, int(budget == 0))
    assert p["blocks"] == -(-B // p["Q"])
    chol, gain, x = _emulated(diag, lower, rhs, budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()  # upper triangle written zero
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)


def _non_spd_block_gives_nan(t_bad):
    """A block that is not positive definite at waypoint ``t_bad`` of one
    problem: that problem's factor is NaN from there on — in the kernel and
    in the plain version alike — and no other problem is touched."""
    W, B2, B, bad = 5, 12, 37, 7
    diag, lower, rhs = spd_batch(W, B2, B, seed=3)
    diag[t_bad, :, :, bad] = -np.eye(B2)
    diag, lower, rhs = t_(diag), t_(lower), t_(rhs)
    chol, gain, x = _emulated(diag, lower, rhs)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    il = torch.tril_indices(B2, B2)
    low, plow = chol[:, il[0], il[1]], pchol[:, il[0], il[1]]
    np.testing.assert_array_equal(to_np(torch.isnan(low)),
                                  to_np(torch.isnan(plow)))
    assert torch.isnan(low[t_bad:, :, bad]).all()
    assert torch.isfinite(low[:t_bad, :, bad]).all()
    assert torch.isnan(gain[t_bad:, ..., bad]).all()
    assert torch.isfinite(gain[:t_bad, ..., bad]).all()
    others = torch.arange(B) != bad
    assert torch.isfinite(chol[..., others]).all()
    assert torch.isfinite(x[..., others]).all()
    assert torch.isnan(x[..., bad]).all()
    assert_close(torch.nan_to_num(low), torch.nan_to_num(plow),
                 rtol=1e-9, atol=1e-12)
    assert_close(torch.nan_to_num(gain), torch.nan_to_num(pgain),
                 rtol=1e-9, atol=1e-12)


def test_emulated_non_spd_block_gives_nan(tmp_path, monkeypatch):
    """A block that is not positive definite turns that problem's factor
    into NaN from that waypoint on — in the kernel and in the plain
    version alike — and touches no other problem."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    _non_spd_block_gives_nan(2)


@pytest.mark.parametrize("t_bad", [0, 4], ids=["first", "last"])
def test_emulated_non_spd_block_at_the_ends_gives_nan(t_bad, tmp_path,
                                                      monkeypatch):
    """The same at the first waypoint (every block of the problem NaN) and
    at the last (no gain block after it)."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    _non_spd_block_gives_nan(t_bad)


# The emulated factor at the edges of its plan: a last block part empty
# (B = 37: five blocks of 8 problems, the last with 5), one problem (a block
# with seven empty columns), one waypoint (no gain), two, and B2 = 14 (a
# group of 16 threads with 14 rows).
FACTOR_PARAMS = [
    pytest.param(5, 12, 37, id="B37"),
    pytest.param(5, 12, 1, id="B1"),
    pytest.param(1, 12, 37, id="W1"),
    pytest.param(2, 12, 37, id="W2"),
    pytest.param(5, 14, 37, id="B2_14"),
    pytest.param(2, 14, 1, id="B2_14-W2-B1"),
]


@pytest.mark.parametrize("W,B2,B", FACTOR_PARAMS)
def test_emulated_factor_matches_plain(W, B2, B, tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, _ = (t_(a) for a in spd_batch(W, B2, B, seed=10 * W + B2))
    lib = host_lib_signature("tridiag", {"B2": B2})
    chol = torch.full_like(diag, float("nan"))
    gain = torch.full_like(lower, float("nan"))
    ttri._launch(lib, "factor", diag, lower, chol, gain)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()  # upper triangle written zero


@pytest.mark.parametrize("B2,B", [(12, 37), (12, 1), (14, 1024)])
def test_emulated_factor_plan(B2, B, tmp_path, monkeypatch):
    """The factor's plan: a group of 16 threads per problem, up to 8
    problems a block (the emulated device has one SM, so always 8 there),
    one block per 8 problems, and shared memory that a block of float32
    values gets on the card without opting in (48 KB)."""
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    p = ttri.factor_plan(host_lib_signature("tridiag", {"B2": B2}), B)
    assert (p["G"], p["Q"], p["stages"]) == (16, 8, 3)
    assert p["blocks"] == -(-B // p["Q"])
    assert p["threads_per_block"] == p["G"] * p["Q"]
    assert p["copy_bytes"] == 8  # double in host emulation, 4 on the card
    assert 0 < p["shared_bytes"] // 2 <= 48 * 1024


def test_wrappers_refuse_bad_arguments():
    diag, lower, rhs = (t_(a) for a in spd_batch(4, 4, 3))
    with pytest.raises(ValueError):
        ttri.factor_lane_major(diag, lower[:-1])
    with pytest.raises(TypeError):
        ttri.factor_lane_major(diag, lower.float())
    chol, gain = ttri.factor_lane_major(diag, lower)
    with pytest.raises(ValueError):
        ttri.solve_lane_major(chol, gain, rhs[:, :-1])
    with pytest.raises(ValueError):
        ttri.solve_lane_major(chol, gain[:, :-1], rhs)
    assert "tridiag" in _build.KERNELS and _build.KERNELS["tridiag"] == ("B2",)


# Above 8 joints (B2 > 16) the factor's entry tables hold 16 bits a field
# and a group of threads is a whole warp (32 threads): N = 9 and 10, a
# batch whose last block is partly empty, one problem, and the solve's w_t
# on chip and in x.
WIDE_PARAMS = [
    pytest.param(5, 18, 13, 0, id="B2_18"),
    pytest.param(3, 18, 1, 1, id="B2_18-B1-w_in_x"),
    pytest.param(4, 20, 13, 1, id="B2_20-w_in_x"),
    pytest.param(2, 20, 1, 0, id="B2_20-W2-B1"),
    # Above B2 = 20 (N = 12 and 16) a step's rows are split among the
    # group's lanes in both kernels.
    pytest.param(4, 24, 2, 0, id="B2_24"),
    pytest.param(4, 32, 2, 1, id="B2_32-w_in_x"),
]


@pytest.mark.parametrize("W,B2,B,budget", WIDE_PARAMS)
def test_emulated_kernels_above_8_joints_match_plain(W, B2, B, budget,
                                                     tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    diag, lower, rhs = (t_(a) for a in spd_batch(W, B2, B, seed=W + B2 + B))
    lib = host_lib_signature("tridiag", {"B2": B2})
    p = ttri.plan(lib, W, B, budget)
    assert (p["G"], p["w_on_chip"]) == (32, int(budget == 0))
    fp = ttri.factor_plan(lib, B)
    assert (fp["G"], fp["Q"]) == (32, 8)
    assert fp["blocks"] == -(-B // fp["Q"])
    chol, gain, x = _emulated(diag, lower, rhs, budget)
    pchol, pgain = ttri.factor_lane_major_plain(diag, lower)
    assert_close(chol, pchol, rtol=1e-9, atol=1e-12)
    assert_close(gain, pgain, rtol=1e-9, atol=1e-12)
    iu = torch.triu_indices(B2, B2, offset=1)
    assert (chol[:, iu[0], iu[1]] == 0).all()
    assert_close(x, ttri.solve_lane_major_plain(pchol, pgain, rhs),
                 rtol=1e-9, atol=1e-12)


def test_block_size_above_32_is_refused_before_any_build(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a build was started")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "start_build", no_build)
    for B2 in (34, 40):
        with pytest.raises(NotImplementedError,
                           match=rf"tridiag.*B2={B2}.*B2 <= 32"):
            ttri._lib(B2)
    for B2 in (20, 22, 32):  # built up to one warp a problem
        with pytest.raises(AssertionError, match="a build was started"):
            ttri._lib(B2)


def test_build_all_starts_one_compiler_per_target(monkeypatch):
    """A signature listed twice (as ``chip_smoke.py``'s build phase lists
    B2=18 for two of its sizes) starts one compiler: two compilers of one
    target would write the same temporary file."""
    started = []
    monkeypatch.setattr(_build, "start_build",
                        lambda n, s, *a, **kw: started.append((n, s)) or n)
    monkeypatch.setattr(_build, "finish_build", lambda h: h)
    built = _build.build_all([{"B2": 18}, {"B2": 18}, {"B2": 20}])
    assert started == [("tridiag", {"B2": 18}), ("tridiag", {"B2": 20})]
    assert sorted(built) == [("tridiag", (("B2", 18),)),
                             ("tridiag", (("B2", 20),))]


def test_lane_driver_above_10_joints_is_refused_before_any_build(
        monkeypatch):
    """On a CUDA device every lane kernel is built up to N = 16 (a group of
    threads a problem is at most one warp): N = 11 and 16 pass the check on
    both paths, and N = 17 is refused by name of the fused path's factor
    kernel, or of the tridiagonal kernels on the unfused path and with
    polish, before any build and before the batch moves.  Here the device
    is only named: nothing reaches it."""
    from osqp_solver_tpu_torch.ops import admm_lane, session_lane
    from osqp_solver_tpu_torch.ops.admm import Settings

    from test_torch_helpers import torch_lane, random_lane_problem

    def no_build(*a, **kw):
        raise AssertionError("a build was started")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "start_build", no_build)
    cuda = torch.device("cuda")
    monkeypatch.setattr(admm_lane, "resolve_device", lambda d: cuda)
    monkeypatch.setattr(session_lane, "resolve_device", lambda d: cuda)
    off = Settings(fused_chunk="off")
    for n in (11, 16):
        qp = torch_lane(*random_lane_problem(W=4, N=n, B=1))
        for s in (Settings(), off, Settings(term_fused="off"),
                  Settings(polish=True)):
            admm_lane.check_kernel_limits(qp, s, cuda)
    qp17 = torch_lane(*random_lane_problem(W=4, N=17, B=2))
    with pytest.raises(NotImplementedError, match=r"kkt_factor.*N <= 16"):
        admm_lane.solve_batched_lane(qp17, Settings())
    with pytest.raises(NotImplementedError, match=r"kkt_factor.*N <= 16"):
        session_lane.setup_lane(qp17, Settings())
    with pytest.raises(NotImplementedError, match=r"tridiag.*B2=34"):
        admm_lane.check_kernel_limits(qp17, off, cuda)
    with pytest.raises(NotImplementedError, match=r"kkt_factor"):
        admm_lane.check_kernel_limits(qp17, Settings(), cuda)
    admm_lane.check_kernel_limits(qp17, Settings(), torch.device("cpu"))
