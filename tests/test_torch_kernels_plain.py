"""PyTorch port vs JAX package: the plain versions of the KKT factor and
Ruiz kernels against the reference's plain paths, and their wrappers'
argument checks (the fused ADMM chunk's: ``test_torch_kernels_plain_
chunk.py``).  f64, CPU.  The CUDA sources' arithmetic in host emulation is
in ``test_torch_kernels_emulated*.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jlane_drv
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_lane as tlane_drv
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import (
    B, assert_close, both, t_ as _t, to_np,
)

pytestmark = pytest.mark.torch_port


# ------------------------------------------------------------------ factor


# The JAX references under jax.jit: one program each, not op by op.
@jax.jit
def _jax_pack_factor(jqp, rho):
    return jfused.pack_factor(jqp, jqp.kkt_factor(rho, 1e-6))


_jax_ruiz = jax.jit(jlane_drv._ruiz_equilibrate_lane_jnp,
                    static_argnums=1)


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_factor_plain_matches_reference(flags, n_obs):
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    rho = np.random.default_rng(3).uniform(0.05, 5.0, (jqp.m, B))
    ref = _jax_pack_factor(jqp, jnp.asarray(rho))[0]
    cholp, gainp = tfactor.factor_packed_lane(tqp, _t(rho), 1e-6)
    assert gainp is None
    assert_close(cholp, ref, rtol=1e-10, atol=1e-13)
    assert tfactor.factor_packed_lane.launches == 0


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_factor_plain_gain_matches_reference(flags, n_obs):
    """``emit_gain=True``: the packed upper-triangular G_t beside cholp, the
    last waypoint's row zero (the reference's ``pack_factor``)."""
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    rho = np.random.default_rng(4).uniform(0.05, 5.0, (jqp.m, B))
    ref_c, ref_g = _jax_pack_factor(jqp, jnp.asarray(rho))
    cholp, gainp = tfactor.factor_packed_lane(tqp, _t(rho), 1e-6,
                                              emit_gain=True)
    assert_close(cholp, ref_c, rtol=1e-10, atol=1e-13)
    assert_close(gainp, ref_g, rtol=1e-10, atol=1e-13)
    assert (to_np(gainp)[-1] == 0.0).all()
    assert tfactor.factor_packed_lane.launches_gain == 0


def test_factor_wrapper_refuses_bad_arguments():
    _, tqp = both()
    rho = torch.full((tqp.m, B), 0.1, dtype=torch.float64)
    with pytest.raises(ValueError):
        tfactor.factor_packed_lane(tqp, rho[:-1], 1e-6)
    with pytest.raises(TypeError):
        tfactor.factor_packed_lane(tqp, rho.float(), 1e-6)
    with pytest.raises(ValueError):
        tfactor.factor_packed_lane(tqp.replace(row_layout="type"), rho, 1e-6)


# -------------------------------------------------------------------- Ruiz


@pytest.mark.parametrize("iters", [3, 10])
@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_ruiz_plain_matches_reference(iters, flags, n_obs):
    jqp, tqp = both(flags=flags, n_obs=n_obs)
    jscaled, js = _jax_ruiz(jqp, iters)
    tscaled, ts = truiz.ruiz_equilibrate_lane_kernel(tqp, iters)
    for name in ("D", "E", "c", "Dinv", "Einv", "cinv"):
        assert_close(getattr(ts, name), getattr(js, name), rtol=1e-12)
    for k, v in convert.lane_qp_to_numpy(tscaled)[1].items():
        assert_close(v, getattr(jscaled, k), rtol=1e-12, atol=1e-14)
    assert truiz.ruiz_equilibrate_lane_kernel.launches == 0


def test_ruiz_type_layout_and_bad_arguments():
    jqp, tqp = both(row_layout="type")
    _, js = _jax_ruiz(jqp, 3)
    _, ts = tlane_drv.ruiz_equilibrate_lane(tqp, 3)
    assert_close(ts.E, js.E, rtol=1e-12)
    with pytest.raises(ValueError):
        truiz.ruiz_equilibrate_lane_kernel(tqp, 3)  # needs waypoint layout
    with pytest.raises(ValueError):
        truiz.ruiz_equilibrate_lane_kernel(both()[1], 0)


# The chunk case's gain form (test_torch_kernels_plain_chunk.py and the
# host-emulation files use it).


def _gain_args(tscaled, tsettings, rho_vec, args):
    """The chunk case's arguments with the gain-form packed factor."""
    gf = tfactor.factor_packed_lane(tscaled, rho_vec, tsettings.sigma,
                                    coef=args["coef"], emit_gain=True)
    return dict(args, packed_factor=gf)
