"""The lane kernels' launch plans on an NVIDIA H100, computed on the CPU.

Each source is built with g++ in float with warps of 32, as the card's
build (``_build.float_library``), and asked for its plans as on an H100
(232,448 bytes of shared memory a block may use, 132 SMs): at the shapes
the card has already run (W=100, B=1024, N=6: the plans ``chip_smoke.py``
records there), at the reference example's
W=802 with B=512 (``chip_smoke.py w802``), and at N = 40, 100, 256 and 300
joints at the shapes ``chip_smoke.py lane_wide`` runs them (groups of 128,
256 and 512 threads; at N=300 the 512 threads own the 2N = 600 columns,
88 of them two).
The refusal before any build (``admm_lane.least_shared_bytes``) mirrors
the smallest of these plans.  ``chip_smoke.py`` records the card's own
plans beside its checks.  A plan that does not fit the card's shared
memory raises; none is launched clipped."""
import ctypes
import shutil
from types import SimpleNamespace

import pytest

from osqp_solver_tpu_torch import _build
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz
from osqp_solver_tpu_torch.ops import tridiag_kernel as ttri

pytestmark = pytest.mark.torch_port
H100_SMEM, H100_SMS = 232448, 132
# A card with 2 KB of shared memory a block, and the kernels asked for
# their plans there.
SMALL_SMEM = 2048
SMALL_KERNELS = ("ruiz", "kkt_factor", "residuals", "tridiag")
NX = 5  # the honest class's dense rows (two balls, one obstacle)


def _sig(name, N):
    if name == "tridiag":
        return {"B2": 2 * N}
    sig = {"NDIM": N, "NX": NX}
    if "BLOCK_P" in _build.KERNELS[name]:
        sig["BLOCK_P"] = 0
    return sig


@pytest.fixture(scope="module", autouse=True)
def _build_dir(tmp_path_factory):
    """One build of each library for the whole module, all compilers
    started together."""
    if shutil.which("g++") is None:
        pytest.skip("the float builds need g++")
    mp = pytest.MonkeyPatch()
    mp.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path_factory.mktemp("build")))
    handles = [_build.start_float_build(name, _sig(name, n), H100_SMEM,
                                        H100_SMS)
               for n in (6, 40, 100, 256, 300)
               for name in ("ruiz", "kkt_factor", "admm_chunk", "residuals",
                            "tridiag")]
    handles += [_build.start_float_build(name, _sig(name, n), SMALL_SMEM,
                                         H100_SMS)
                for n in (6, 40) for name in SMALL_KERNELS]
    for h in handles:
        _build.finish_build(h)
    yield
    mp.undo()


def _lib(name, N, smem=H100_SMEM, sms=H100_SMS):
    return _build.float_library(name, _sig(name, N), smem, sms)


def _chunk(N, B, mode, gain):
    """The chunk's plan (``admm_chunk_plan``) and its workspace bytes."""
    lib = _lib("admm_chunk", N)
    fn = lib.admm_chunk_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 9)()
    fn(B, H100_SMS, mode, int(gain), out)
    ws = lib.admm_chunk_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    keys = ("G", "Q", "stages", "shared_bytes", "blocks", "threads_per_block",
            "slot_values", "tile_stride", "copy_bytes")
    return dict(zip(keys, out), workspace_bytes=ws(B, mode, int(gain), 0))


def _plans(N, W, B):
    """Every lane kernel's plan at ``N`` joints, ``W`` waypoints and a
    batch of ``B`` on the H100."""
    tri = _lib("tridiag", N)
    return {
        "ruiz": truiz.plan(_lib("ruiz", N), W, B),
        "kkt_factor": tfactor.plan(_lib("kkt_factor", N), W, B),
        **{f"admm_chunk_{m}{'_gain' if g else ''}": _chunk(N, B, mode, g)
           for m, mode in (("warmup", 0), ("term", 1), ("dxdy", 2))
           for g in (False, True)},
        "residuals": tresid.plan(_lib("residuals", N), B),
        "tridiag_factor": ttri.factor_plan(tri, B),
        "tridiag_solve": ttri.plan(tri, W, B),
    }


@pytest.fixture(scope="module")
def main_plans():
    return _plans(6, 100, 1024)


@pytest.fixture(scope="module")
def w802_plans():
    return _plans(6, 802, 512)


def test_main_shape_plans_are_the_cards(main_plans):
    """At the honest class's W=100, B=1024 the plans are those the card
    reports (``chip_smoke.py``'s records): Ruiz's rows on chip in 230,176 B,
    the factor's windows of 50 waypoints for 8 problems in 157,728 B, the
    chunk's 69,472 B (warm-up 54,208 B), 256 blocks of 96 threads for the
    chunk, the residuals (22,144 B) and the tridiagonal solve (30,688 B),
    128 of 128 threads for the tridiagonal factor (32,768 B)."""
    p = main_plans
    assert (p["ruiz"]["rows_in_shared"], p["ruiz"]["shared_bytes"],
            p["ruiz"]["Q"]) == (1, 230176, 4)
    assert (p["kkt_factor"]["Q"], p["kkt_factor"]["window"],
            p["kkt_factor"]["shared_bytes"]) == (8, 50, 157728)
    assert p["admm_chunk_term"]["shared_bytes"] == 69472
    assert p["admm_chunk_warmup"]["shared_bytes"] == 54208
    for k in ("admm_chunk_term", "residuals", "tridiag_solve"):
        assert (p[k]["blocks"], p[k]["threads_per_block"]) == (256, 96), k
    assert p["residuals"]["shared_bytes"] == 22144
    assert p["tridiag_solve"]["shared_bytes"] == 30688
    assert (p["tridiag_factor"]["blocks"],
            p["tridiag_factor"]["threads_per_block"],
            p["tridiag_factor"]["shared_bytes"]) == (128, 128, 32768)


def test_w802_ruiz_rows_in_device_memory(w802_plans):
    """At W=802 the constant rows and D/E of even one problem do not fit a
    block's shared memory: the plan keeps them in device memory without a
    forced budget, 4 problems a block of 64 threads each (runs of 13
    waypoints), 128 blocks."""
    p = w802_plans["ruiz"]
    assert p["rows_in_shared"] == 0
    assert (p["G"], p["Q"], p["rpt"], p["blocks"]) == (64, 4, 13, 128)
    assert p["shared_bytes"] <= H100_SMEM


def test_w802_factor_windows(w802_plans):
    """The KKT factor walks W=802 in 6 windows of at most 134 waypoints,
    4 problems a block (128 blocks on the 132 SMs), all on chip."""
    p = w802_plans["kkt_factor"]
    assert (p["Q"], p["window"], p["windows"], p["blocks"]) == (4, 134, 6,
                                                                 128)
    assert 134 * 6 >= 802 and p["workspace_bytes"] == 0
    assert p["shared_bytes"] <= H100_SMEM


def test_w802_streaming_plans(w802_plans):
    """The chunk in every form, the residual kernel and the tridiagonal
    pair at W=802, B=512: 4 problems a block, 128 blocks, everything on
    chip (their rings do not grow with W; the solve keeps w_t on chip)."""
    for k, p in w802_plans.items():
        if k in ("ruiz", "kkt_factor"):
            continue
        assert (p["Q"], p["blocks"]) == (4, 128), k
        assert p["workspace_bytes"] == 0 and p["shared_bytes"] <= H100_SMEM, k
    assert w802_plans["tridiag_solve"]["w_on_chip"] == 1


# N: (W, B, group of threads, the plans with a device-memory workspace).
# The KKT factor's wide form keeps its working matrix (2N rounded up to
# whole panels of 32, [G | C] rows) on chip up to 2N = 160: at N=100 its
# 224 x 452 values take the workspace.
WIDE = {
    40: (100, 256, 128, set()),
    100: (50, 64, 256, {"kkt_factor", "admm_chunk_warmup",
                        "admm_chunk_warmup_gain",
                        "admm_chunk_term", "admm_chunk_term_gain",
                        "admm_chunk_dxdy", "admm_chunk_dxdy_gain",
                        "tridiag_factor", "tridiag_solve"}),
    256: (20, 8, 512, {"kkt_factor", "admm_chunk_warmup",
                       "admm_chunk_warmup_gain", "admm_chunk_term",
                       "admm_chunk_term_gain", "admm_chunk_dxdy",
                       "admm_chunk_dxdy_gain", "tridiag_factor",
                       "tridiag_solve"}),
    # Two columns a thread; the residual kernel's ring (~188 KB) beside its
    # slot no longer fits on chip either.
    300: (10, 8, 512, {"kkt_factor", "admm_chunk_warmup",
                       "admm_chunk_warmup_gain", "admm_chunk_term",
                       "admm_chunk_term_gain", "admm_chunk_dxdy",
                       "admm_chunk_dxdy_gain", "residuals",
                       "tridiag_factor", "tridiag_solve"}),
}


# The two factors' blocks a problem (the KKT factor's, the tridiagonal
# factor's): where the batch leaves SMs idle, the split form (one launch a
# phase), up to one block a panel of 32 rows of the working matrix (N=100:
# 224 rows, 132 SMs / 64 problems = 2; 256: 512; 300: 608, 132 SMs / 8
# problems), the KKT factor's from 4 blocks a problem only.
SPLIT = {40: (1, 1), 100: (1, 2), 256: (16, 16), 300: (16, 16)}


@pytest.mark.parametrize("N", sorted(WIDE))
def test_wide_plans(N):
    """Above 32 joints: one problem a block (the factors: SPLIT's blocks a
    problem), a group of the smallest power
    of two >= 2N threads, at most 512 (the streaming kernels and the solve
    with as many producers: up to 1,024 threads a block), every footprint on
    chip within the card's shared memory, the rings and windows that do
    not fit in the workspace, unforced; Ruiz with its rows in device
    memory."""
    W, B, group, off_chip = WIDE[N]
    plans = _plans(N, W, B)
    for k, p in plans.items():
        if k == "ruiz":
            assert p["shared_bytes"] <= H100_SMEM
            continue
        split = (SPLIT[N][0] if k == "kkt_factor" else
                 SPLIT[N][1] if k == "tridiag_factor" else 1)
        assert p.get("blocks_per_problem", 1) == split, k
        assert p["blocks"] == B * split, k
        assert (p["workspace_bytes"] > 0) == (k in off_chip), k
        # The chunk's plan gives the ring's bytes on chip; where they do
        # not fit, the launch takes the workspace and its slots alone.
        assert p["shared_bytes"] <= H100_SMEM or (
            k.startswith("admm_chunk") and p["workspace_bytes"] > 0), k
        assert p["G"] == group, k
        producers = group if k.startswith(("admm_chunk", "residuals",
                                           "tridiag_solve")) else 0
        assert p["threads_per_block"] == group + producers, k
    assert plans["ruiz"]["rows_in_shared"] == 0


@pytest.mark.parametrize("N", [6, 40])
def test_over_budget_plans_raise(N):
    """On a card with 2 KB of shared memory a block, every plan that
    cannot fit raises, as the launch refuses it: at N=6 all of them (not
    one waypoint of the factor fits); at N=40 Ruiz's and the residual
    kernel's slots alone do not fit, while the factor's window and the
    tridiagonal rings take the workspace instead."""
    refused = "refused by its launch plan"
    libs = {k: _lib(k, N, smem=SMALL_SMEM) for k in SMALL_KERNELS}
    with pytest.raises(RuntimeError, match=refused):
        truiz.plan(libs["ruiz"], 802, 512)
    with pytest.raises(RuntimeError, match=refused):
        tresid.plan(libs["residuals"], 512)
    if N == 6:
        for fn in (lambda: tfactor.plan(libs["kkt_factor"], 802, 512),
                   lambda: ttri.factor_plan(libs["tridiag"], 512),
                   lambda: ttri.plan(libs["tridiag"], 802, 512)):
            with pytest.raises(RuntimeError, match=refused):
                fn()
    else:
        assert tfactor.plan(libs["kkt_factor"], 100, 256)[
            "workspace_bytes"] > 0
        assert ttri.factor_plan(libs["tridiag"], 256)["workspace_bytes"] > 0
        assert ttri.plan(libs["tridiag"], 100, 256)["workspace_bytes"] > 0


def test_refusal_floor_is_the_plans():
    """At N=300 the shared memory that ``admm_lane.least_shared_bytes``
    holds a size to before any build is what the plans take with every
    ring and window in the workspace: the chunk's slot, the residual
    kernel's (its ring in the workspace unforced), and the tridiagonal
    solve's with ``w`` in ``x`` too (a budget below its ``w``)."""
    W, B = WIDE[300][:2]
    plans = _plans(300, W, B)
    qp = SimpleNamespace(n_dim=300, waypoints=W, row_layout="waypoint",
                         rows_per_waypoint_padded=-(-(4 * 300 + NX) // 8) * 8)
    least = tdrv.least_shared_bytes(qp, tadmm.Settings(polish=True))
    assert set(least) == {"ruiz", "admm_chunk", "residuals", "tridiag_solve"}
    for k in ("admm_chunk_term", "admm_chunk_dxdy_gain"):
        assert 4 * plans[k]["slot_values"] == least["admm_chunk"], k
    assert plans["residuals"]["shared_bytes"] == least["residuals"]
    tri = _lib("tridiag", 300)
    p = ttri.plan(tri, W, B, least["tridiag_solve"])
    assert (p["w_on_chip"], p["shared_bytes"]) == (0,
                                                   least["tridiag_solve"])
    assert ttri.least_shared_bytes(600) == least["tridiag_solve"]
    ruiz = _lib("ruiz", 300)
    assert truiz.plan(ruiz, W, B, least["ruiz"])["G"] > 0
    with pytest.raises(RuntimeError, match="refused by its launch plan"):
        truiz.plan(ruiz, W, B, least["ruiz"] - 4)  # one value less
