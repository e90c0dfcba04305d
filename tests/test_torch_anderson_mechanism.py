"""PyTorch port vs JAX package: the four mechanism tests of the lane
driver's Anderson step (``_anderson_step``), the JAX package's own
(``tests/test_admm_lane.py``: a reset when ρ adapted or the residual grew
past the safeguard, an accepted extrapolation, frozen done problems), run
through both packages on the same inputs.  f64, CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops.admm import ADMMState

from test_torch_helpers import assert_close, to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _fixture():
    """The reference's fixture (``tests/test_admm_lane.py::_aa_fixture``,
    history primed by ``_prime_history``) built under ``jax.jit``: one
    compiled program instead of its eager ops; the step itself too."""
    from test_admm_lane import _aa_fixture, _prime_history

    def build():
        scaled, st, _, v_out = _aa_fixture()
        return scaled, _prime_history(st, v_out)
    scaled, st = jax.jit(build)()
    settings = dataclasses.replace(jadmm.Settings(), anderson=3)
    step = jax.jit(lambda sc, st, reset: jdrv._anderson_step(
        sc, st, settings, use_fused=False, reset_mask=reset))
    return scaled, st, settings, step


def _aa_case(case):
    """``(JAX out, port out, JAX in)`` of one step of the reference's
    mechanism tests, on their fixture (``tests/test_admm_lane.py``)."""
    scaled, st, settings, step = _fixture()
    reset = jnp.zeros_like(st.done)
    if case == "rho_reset":
        reset = jnp.ones_like(st.done)
    elif case == "safeguard":
        st = st.replace(aa_vin=st.aa_vin - 10.0)
    else:
        st = st.replace(aa_vin=st.aa_vin - 0.01)
        if case == "done":
            st = st.replace(done=jnp.zeros_like(st.done).at[1].set(True))
    out = step(scaled, st, reset)

    t = lambda a: torch.from_numpy(np.array(a))
    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(scaled))
    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(
        ADMMState) if f.name != "factor"}
    tst = ADMMState(factor=None, **{
        k: None if v is None else t(v) for k, v in fields.items()})
    ts = dataclasses.replace(tadmm.Settings(), anderson=settings.anderson)
    got = tdrv._anderson_step(tscaled, tst, ts, False, t(reset))
    return out, got, st, tscaled


def _same_step(got, out):
    for name in ("x", "z", "y", "aa_g", "aa_f", "aa_vin", "aa_fnorm"):
        assert_close(getattr(got, name), getattr(out, name), rtol=1e-10,
                     atol=1e-12)
    np.testing.assert_array_equal(to_np(got.aa_n), np.asarray(out.aa_n))


@pytest.mark.parametrize("case", ["rho_reset", "safeguard"])
def test_anderson_reset_mechanism(case):
    """A reset (ρ adapted, or the residual grew past the safeguard): every
    slot refilled with the current pair, the counter back to 1, the plain
    iterate kept exactly."""
    out, got, st, _ = _aa_case(case)
    _same_step(got, out)
    np.testing.assert_array_equal(to_np(got.aa_n), 1)
    v_out = torch.cat([got.x, got.z + got.y / got.rho_vec])
    for s in range(got.aa_g.shape[0]):
        assert_close(got.aa_g[s], v_out, atol=1e-12)
    assert_close(got.x, np.asarray(st.x), atol=1e-12)
    assert_close(got.y, np.asarray(st.y), atol=1e-12)


def test_anderson_accept_extrapolates_consistently():
    """The accept path: the iterate moves, the counter grows, and z, y are
    recovered consistently from w."""
    out, got, st, scaled = _aa_case("accept")
    _same_step(got, out)
    np.testing.assert_array_equal(to_np(got.aa_n), 3)
    assert float((got.x - torch.from_numpy(np.array(st.x))).abs().max()) > 1e-9
    w = got.z + got.y / got.rho_vec
    assert_close(got.z, torch.minimum(torch.maximum(w, scaled.l), scaled.u),
                 atol=1e-12)
    assert_close(got.y, got.rho_vec * (w - got.z), atol=1e-12)


def test_anderson_done_problems_frozen():
    """A done problem keeps its iterate, counter and safeguard norm; the
    live ones move."""
    out, got, st, _ = _aa_case("done")
    _same_step(got, out)
    x0 = torch.from_numpy(np.array(st.x))
    assert_close(got.x[:, 1], x0[:, 1], atol=1e-15)
    assert int(got.aa_n[1]) == int(st.aa_n[1])
    assert float(got.aa_fnorm[1]) == float(st.aa_fnorm[1])
    assert float((got.x[:, 0] - x0[:, 0]).abs().max()) > 1e-9
