"""PyTorch port vs JAX package: the unfused-termination path against the
JAX package's Pallas kernels in interpret mode.

The plain version of the streaming residual kernel against the JAX
package's residual kernel (B=128, each ``TermQuantities`` field within
1e-10: same formulas in f64, other summation order), and the chunk's
delta-writing plain form against the JAX chunk kernel, both on one chunk
of 3 iterations from a cold start.  On the honest batch the JAX kernels run
in interpret mode (the one interpret-mode case of each kernel's vel-diag
form here); on the box batch their plain references run, which the JAX
package's own tests hold the interpreted kernels to at this form: three
unfused iterations (``tests/test_admm_fused.py::
test_fused_chunk_matches_unfused_iterations[False-hrec]``, within 1e-9)
and the jnp quantities (``tests/test_residuals_pallas.py::
test_quantities_match_jnp[False]``, within 1e-9).  The wrappers and the
CUDA sources in host emulation are ``test_torch_residuals.py``'s.  f64,
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm as jadmm
from osqp_solver_tpu.ops import admm_fused as jfused
from osqp_solver_tpu.ops import admm_lane as jlane_drv
from osqp_solver_tpu.ops import residuals_pallas as jresid
from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import kkt_factor as tfactor
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import assert_close, t_, to_np, wp_batch
from test_torch_residuals import _port_packs

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", params=[True, False], ids=["honest", "box"])
def interpreted(request):
    """One chunk of 3 iterations from a cold start (problems 5 and 77
    frozen), its packed outputs and the residual quantities on them: on
    the honest batch by the JAX chunk and residual kernels in interpret
    mode (B=128), on the box batch by their plain references (three
    unfused iterations, the frozen problems' deltas zero as the kernel
    emits them; the jnp quantities); and the same problem in the port."""
    honest = request.param
    settings = dataclasses.replace(jadmm.Settings(), check_termination=3)
    lane = wp_batch(honest=honest)
    # The JAX glue under jax.jit: compiled once, not op by op.
    scaled, scaling = jax.jit(lambda q: jlane_drv.ruiz_equilibrate_lane(
        q, settings.scaling))(lane)
    st = jax.jit(lambda q: jlane_drv.init_state_lane(q, settings))(scaled)
    done = jnp.zeros((lane.batch,), bool).at[5].set(True).at[77].set(True)
    if honest:
        x2, z2, y2, dx2, dy2 = jfused.fused_admm_chunk(
            scaled, st.factor, st.x, st.z, st.y, st.rho_vec, done, settings,
            interpret=True,
        )
        sp = jfused.pack_state(scaled, x2, z2, y2)
        dp = jfused.pack_dxdy(scaled, dx2, dy2)
        jpacks = jresid.build_residual_packs(scaled, scaling) + (
            scaling.cinv,)
        ref = jresid.termination_quantities_kernel(
            scaled, sp, dp, jfused.build_coef_pack(scaled), jpacks,
            interpret=True,
        )
    else:
        @jax.jit
        def plain(lane, scaled, scaling, st):
            it = st.replace(done=done)
            for _ in range(settings.check_termination):
                it = jlane_drv._iteration(scaled, it.replace(factor=None),
                                          st.factor, settings)
            it = it.replace(dx=jnp.where(done, 0.0, it.dx),
                            dy=jnp.where(done, 0.0, it.dy))
            return (jfused.pack_state(scaled, it.x, it.z, it.y),
                    jfused.pack_dxdy(scaled, it.dx, it.dy),
                    jlane_drv._termination_quantities(lane, scaled, scaling,
                                                      it))
        sp, dp, ref = plain(lane, scaled, scaling, st)
    tscaled = convert.lane_qp_from_numpy(*convert.lane_qp_to_numpy(scaled))
    ts = convert.scaling_from_numpy(
        *(to_np(a) for a in (scaling.D, scaling.E, scaling.c)))
    tsettings = convert.settings_from_dict(dataclasses.asdict(settings))
    return dict(ref=ref, sp=sp, dp=dp, st=st, done=done, tscaled=tscaled,
                ts=ts, tsettings=tsettings)


def test_residual_plain_matches_interpreted_kernel(interpreted):
    c = interpreted
    got = tresid.termination_quantities_kernel(
        c["tscaled"], t_(c["sp"]), t_(c["dp"]),
        tfused.build_coef_pack(c["tscaled"]), _port_packs(c["tscaled"], c["ts"]),
    )
    for name in c["ref"]._fields:
        if name == "blew_up":
            np.testing.assert_array_equal(to_np(got.blew_up),
                                          np.asarray(c["ref"].blew_up))
        else:
            assert_close(getattr(got, name), getattr(c["ref"], name),
                         rtol=1e-10, atol=1e-10)
    assert tresid.termination_quantities_kernel.launches == 0


def test_chunk_dxdy_plain_matches_interpreted_kernel(interpreted):
    """Same state and same delta pack as the JAX chunk kernel without
    ``term_packs`` (honest), or its reference (box) (1e-9: two routes
    through a 3-iteration recurrence)."""
    c = interpreted
    tscaled, st = c["tscaled"], c["st"]
    rho_vec = t_(st.rho_vec)
    out, dxdy = tfused.fused_admm_chunk(
        tscaled, rho_vec, t_(c["done"]), c["tsettings"],
        coef=tfused.build_coef_pack(tscaled), lu=tfused.build_lu_pack(tscaled),
        packed_factor=tfactor.factor_packed_lane(
            tscaled, rho_vec, c["tsettings"].sigma),
        state_pack=tfused.pack_state(tscaled, t_(st.x), t_(st.z), t_(st.y)),
        emit_dxdy=True,
    )
    assert_close(out, c["sp"], rtol=1e-9, atol=1e-9)
    assert_close(dxdy, c["dp"], rtol=1e-9, atol=1e-9)
    assert (to_np(dxdy)[..., [5, 77]] == 0.0).all()  # frozen: exact zeros
    dx, dy = tfused.unpack_dxdy(tscaled, dxdy)
    assert_close(tfused.pack_dxdy(tscaled, dx, dy), dxdy)
    assert tfused.fused_admm_chunk.launches_dxdy == 0
