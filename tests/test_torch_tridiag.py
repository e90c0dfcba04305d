"""PyTorch port vs JAX package: the batched block-tridiagonal factor and
solve (``ops/tridiag_kernel.py``).  The plain versions are held to
``pallas_tridiag.factor_lane_major`` / ``solve_lane_major`` in interpret
mode, and ``csrc/tridiag.cu`` compiled in host emulation (g++, double) to
the plain versions: here the NaN pivots and the plans (the solve's and the
factor's main cases are ``test_torch_tridiag_emulated.py``'s, B2 = 18-32
``test_torch_tridiag_wide.py``'s), and the refusals before any build.
f64, CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import pallas_tridiag as jtri
from osqp_solver_tpu.ops import tridiag as jref
from osqp_solver_tpu_torch import _build
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

from test_torch_helpers import (
    assert_close, host_lib_signature, jit_vmap, to_np,
)

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
        jf = jit_vmap(jref.block_tridiag_factor, in_axes=-1, out_axes=-1)(
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
def test_tridiag_refuses_what_the_card_cannot_place_before_any_build(
        monkeypatch):
    """Above B2 = 32 the kernels build in their wide form, above 512 with
    each thread owning several rows of a step: B2 = 514 and 1000 start a
    build as every size from 20 does.  A block size whose solve cannot be
    placed even with its ring and ``w`` in device memory (the group's slot,
    two values a row, past the card's shared memory: above B2 = 28672) is
    refused by name before any build."""
    def no_build(*a, **kw):
        raise AssertionError("a build was started")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "start_build", no_build)
    assert (ttri.least_shared_bytes(28672) <= _build.CARD_SHARED_BYTES
            < ttri.least_shared_bytes(28673))
    for B2 in (28673, 30000):
        with pytest.raises(NotImplementedError,
                           match=rf"tridiag.*cannot place B2={B2}"):
            ttri._lib(B2)
    for B2 in (20, 22, 32, 34, 40, 96, 512, 514, 1000):  # built
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


def test_lane_driver_refuses_what_the_card_cannot_place_before_any_build(
        monkeypatch):
    """On a CUDA device every lane kernel takes any joint count whose
    smallest launch fits the card's shared memory, on every path: N = 11,
    16, 17, 24, 32, 257, 300 and 907 pass the check (above 256 a thread
    owns several columns).  Past it the solve and the session refuse by the
    kernel's name, before any build and before the batch moves: from N = 908
    (W=4) the Ruiz kernel's slots (a warp of threads, 2N values each, and
    two partial sums) do not fit.  Here the device is only named: nothing
    reaches it."""
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
    forms = (Settings(), Settings(fused_chunk="off"), Settings(polish=True))
    for n in (11, 16, 17, 24, 32, 257, 300, 907):
        qp = torch_lane(*random_lane_problem(W=4, N=n, B=1))
        for s in forms:
            admm_lane.check_kernel_limits(qp, cuda, s)
    big = torch_lane(*random_lane_problem(W=4, N=908, B=1))
    for s in forms:
        with pytest.raises(NotImplementedError,
                           match=r"ruiz cannot be placed on the card at "
                                 r"N=908"):
            admm_lane.solve_batched_lane(big, s)
    with pytest.raises(NotImplementedError, match=r"ruiz.*N=908"):
        session_lane.setup_lane(big, Settings())
    admm_lane.check_kernel_limits(big, torch.device("cpu"), Settings())
