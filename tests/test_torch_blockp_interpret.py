"""PyTorch port vs JAX package: the block-P kernel forms against the JAX
package's Pallas kernels and their references.

On ``test_torch_blockp.py``'s block-P batch (the GOMP smoothness term plus
``chip_smoke.block_p_terms``; B=128, the kernels' lane tile; W=8, N=3;
f64): the plain version of the Ruiz kernel against the JAX Ruiz kernel in
interpret mode (its one interpret-mode case here; the block branch), the
port's ``pack_factor`` against the reference's, and the plain versions of
the gain chunk and the residual kernel against the references the JAX
package's own tests hold those kernels to in interpret mode (three
unfused iterations: ``tests/test_admm_fused.py::
test_block_p_structure_fused_driver`` holds the fused block-P solve, gain
chunk and residual kernel interpreted, to the unfused one; the jnp
termination quantities: ``tests/test_residuals_pallas.py::
test_quantities_match_jnp``).  The vel-diag forms' interpret-mode cases
are ``test_torch_residuals_interpret.py``'s."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jdrv
from osqp_solver_tpu.ops.ruiz_pallas import ruiz_equilibrate_lane_kernel
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.trajectory_qp_lane import LaneFactor
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import residuals as tresid
from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_admm_fused import B
from test_torch_blockp import _batch
from test_torch_helpers import assert_close, t_, to_np

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _scaled():
    """The batch scaled by the JAX package (jnp Ruiz), a cold state, its
    factor, and the same in the port."""
    jqp, _ = _batch()
    settings = dataclasses.replace(jadmm.Settings(), check_termination=3,
                                   factor_form="gain")
    # The JAX glue under jax.jit: compiled once, not op by op.
    scaled, scaling = jax.jit(
        lambda q: jdrv._ruiz_equilibrate_lane_jnp(q, 3))(jqp)
    st = jax.jit(lambda q: jdrv.init_state_lane(q, settings))(scaled)
    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(scaled))
    ts = convert.scaling_from_numpy(
        *(to_np(a) for a in (scaling.D, scaling.E, scaling.c)))
    tsettings = convert.settings_from_dict(dataclasses.asdict(settings))
    return settings, scaled, scaling, st, tsettings, tscaled, ts


def test_block_p_ruiz_plain_matches_interpreted_kernel():
    jqp, tqp = _batch()
    js, jsc = ruiz_equilibrate_lane_kernel(jqp, 2, interpret=True)
    ts, tsc = truiz.ruiz_equilibrate_lane_kernel(tqp, 2)  # CPU: plain
    for name in ("D", "E", "c"):
        assert_close(getattr(tsc, name), getattr(jsc, name), rtol=1e-12)
    assert_close(ts.P_diag, js.P_diag, rtol=1e-12, atol=1e-14)
    assert_close(ts.P_lower, js.P_lower, rtol=1e-12, atol=1e-14)
    assert truiz.ruiz_equilibrate_lane_kernel.launches_block == 0


def test_block_p_pack_factor_matches_reference():
    """Entry for entry: the reference's packing of one full-block factor,
    and the whole route (each package's block-tridiagonal factor, then
    ``pack_factor``) within 1e-12."""
    settings, scaled, _, st, tsettings, tscaled, _ = _scaled()

    @jax.jit
    def reference(scaled, rho_vec):
        jf = scaled.kkt_factor(rho_vec, settings.sigma)
        return jf, jfused.pack_factor(scaled, jf)
    jf, (jc, jg) = reference(scaled, st.rho_vec)
    tc, tg = tfused.pack_factor(tscaled, LaneFactor(chol=t_(jf.chol),
                                                    gain=t_(jf.gain)))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(tg), np.asarray(jg))
    tc2, tg2 = tdrv._packed_factor(tscaled, t_(st.rho_vec), tsettings)
    assert_close(tc2, jc, rtol=1e-12, atol=1e-12)
    assert_close(tg2, jg, rtol=1e-12, atol=1e-12)
    # The coupling blocks are upper-triangular, so the gain is too: packing
    # it drops nothing.
    full = tfused.unpack_gain(tscaled, tg)
    assert_close(full, jf.gain, rtol=1e-12, atol=1e-12)


def test_block_p_gain_chunk_plain_matches_interpreted_kernel():
    """The JAX package's reference of its chunk kernel on block P (three
    unfused iterations, the form the interpreted fused solve is held to)
    and the port's plain chunk, in its gain form, from the same state and
    the same factor: state and deltas within 1e-9 (two routes through 3
    iterations); a frozen problem emits exact zeros."""
    settings, scaled, _, st, tsettings, tscaled, _ = _scaled()
    done = jnp.zeros((B,), bool).at[9].set(True)

    @jax.jit
    def reference(scaled, st):
        factor = scaled.kkt_factor(st.rho_vec, settings.sigma)
        it = st.replace(done=done)
        for _ in range(settings.check_termination):
            it = jdrv._iteration(scaled, it.replace(factor=None), factor,
                                 settings)
        return (jfused.pack_factor(scaled, factor),
                jfused.pack_state(scaled, it.x, it.z, it.y),
                jfused.pack_dxdy(scaled, jnp.where(done, 0.0, it.dx),
                                 jnp.where(done, 0.0, it.dy)))
    pf, ref_state, ref_dxdy = reference(scaled, st)
    out, dxdy = tfused.fused_admm_chunk(
        tscaled, t_(st.rho_vec), t_(done), tsettings,
        coef=tfused.build_coef_pack(tscaled),
        lu=tfused.build_lu_pack(tscaled),
        packed_factor=(t_(pf[0]), t_(pf[1])),
        state_pack=tfused.pack_state(tscaled, t_(st.x), t_(st.z), t_(st.y)),
        emit_dxdy=True)
    assert_close(out, ref_state, rtol=1e-9, atol=1e-9)
    assert_close(dxdy, ref_dxdy, rtol=1e-9, atol=1e-9)
    assert (to_np(dxdy)[..., 9] == 0.0).all()
    assert tfused.fused_admm_chunk.launches_block == 0


def test_block_p_residual_plain_matches_interpreted_kernel():
    """Every ``TermQuantities`` field of the port's plain pass against the
    JAX package's jnp termination quantities (the reference of its residual
    kernel, block branch) on the same random state and deltas."""
    settings, scaled, scaling, st, _, tscaled, ts = _scaled()
    jqp, _ = _batch()
    rng = np.random.default_rng(12)
    x = st.x + rng.normal(size=st.x.shape)
    z = st.z + rng.normal(size=st.z.shape)
    y = st.y + 0.1 * rng.normal(size=st.y.shape)
    dx, dy = rng.normal(size=st.x.shape), rng.normal(size=st.y.shape)
    it = st.replace(x=jnp.asarray(x), z=jnp.asarray(z), y=jnp.asarray(y),
                    dx=jnp.asarray(dx), dy=jnp.asarray(dy))
    ref = jax.jit(jdrv._termination_quantities)(jqp, scaled, scaling, it)
    sp = jfused.pack_state(scaled, it.x, it.z, it.y)
    dp = jfused.pack_dxdy(scaled, it.dx, it.dy)
    got = tresid.termination_quantities_kernel(
        tscaled, t_(sp), t_(dp), tfused.build_coef_pack(tscaled),
        tresid.build_residual_packs(tscaled, ts) + (ts.cinv,))
    for name in ref._fields:
        if name == "blew_up":
            np.testing.assert_array_equal(to_np(got.blew_up),
                                          np.asarray(ref.blew_up))
        else:
            assert_close(getattr(got, name), getattr(ref, name), rtol=1e-12,
                         atol=1e-12)
    assert tresid.termination_quantities_kernel.launches_block == 0
