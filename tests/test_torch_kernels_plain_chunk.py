"""PyTorch port vs JAX package: the plain version of the fused ADMM chunk
(both factor forms, with and without its accumulators, writing its
deltas) against the reference's plain path, and the chunk wrapper's
argument checks.  f64, CPU.  Split from ``test_torch_kernels_plain.py``
(the KKT factor and Ruiz)."""
import pytest
import torch

from osqp_solver_tpu_torch.ops import admm_fused as tfused
from osqp_solver_tpu_torch.ops import residuals as tresid

from test_torch_helpers import (
    B, assert_close, chunk_case as _chunk_case, to_np,
)
from test_torch_kernels_plain import _gain_args

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_chunk_plain_matches_reference(flags, n_obs):
    (jscaled, ref, tq), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case(flags=flags, n_obs=n_obs))
    before = args["state_pack"].clone()
    out, acc = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings, **args)
    assert_close(args["state_pack"], before)  # CPU: input left untouched
    x, z, y = tfused.unpack_state(tscaled, out)
    tol = dict(rtol=1e-10, atol=1e-10)
    assert_close(x, ref.x, **tol)
    assert_close(z, ref.z, **tol)
    assert_close(y, ref.y, **tol)
    # Frozen problems kept their state bit for bit.
    assert_close(out[..., [1, 6]], before[..., [1, 6]])
    got = tresid.assemble_term_quantities(acc, ts.cinv, packs["norm_Dq"])
    for name in tq._fields:
        assert_close(getattr(got, name), getattr(tq, name),
                     rtol=1e-9, atol=1e-9)
    assert tfused.fused_admm_chunk.launches == 0


def test_chunk_without_term_packs_advances_state_only():
    _, (tscaled, ts, tsettings, rho_vec, done, packs, args) = _chunk_case()
    with_acc, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                          **args)
    args = dict(args, term_packs=None)
    out, acc = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                       n_iter=3, **args)
    assert acc is None
    assert_close(out, with_acc)


@pytest.mark.parametrize("flags,n_obs", [((False, True), 1), ((), 0)])
def test_chunk_emit_dxdy_matches_reference_deltas(flags, n_obs):
    """The delta-writing form: same state, and the packed deltas are the
    reference's ``dx``/``dy`` of the last iteration (zero where frozen)."""
    (jscaled, ref, _), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case(flags=flags, n_obs=n_obs))
    args = dict(args, term_packs=None)
    out, dxdy = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                        emit_dxdy=True, **args)
    plain_out, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                           **args)
    assert_close(out, plain_out)
    dx, dy = tfused.unpack_dxdy(tscaled, dxdy)
    assert_close(dx, ref.dx, rtol=1e-10, atol=1e-10)
    assert_close(dy, ref.dy, rtol=1e-10, atol=1e-10)
    assert dxdy.shape == (tscaled.waypoints, tfused.dxdy_rows(tscaled)[1], B)
    assert (to_np(dxdy)[..., [1, 6]] == 0.0).all()
    assert tfused.fused_admm_chunk.launches_dxdy == 0


@pytest.mark.parametrize("mode", ["term", "plain", "dxdy"])
def test_chunk_plain_gain_form_matches_reference(mode):
    """The gain form of each mode: the streamed G_t gives the reference's
    iterations (its unfused solve is the gain algebra), accumulators and
    deltas; the state equals the hrec form's."""
    (jscaled, ref, tq), (tscaled, ts, tsettings, rho_vec, done, packs, args) = (
        _chunk_case())
    gargs = _gain_args(tscaled, tsettings, rho_vec, args)
    if mode != "term":
        gargs["term_packs"] = args["term_packs"] = None
    kw = dict(emit_dxdy=True) if mode == "dxdy" else {}
    out, extra = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                         **gargs, **kw)
    hrec_out, _ = tfused.fused_admm_chunk(tscaled, rho_vec, done, tsettings,
                                          **args, **kw)
    x, z, y = tfused.unpack_state(tscaled, out)
    tol = dict(rtol=1e-10, atol=1e-10)
    assert_close(x, ref.x, **tol)
    assert_close(z, ref.z, **tol)
    assert_close(y, ref.y, **tol)
    assert_close(out, hrec_out, rtol=1e-10, atol=1e-10)
    if mode == "term":
        got = tresid.assemble_term_quantities(extra, ts.cinv, packs["norm_Dq"])
        for name in tq._fields:
            assert_close(getattr(got, name), getattr(tq, name),
                         rtol=1e-9, atol=1e-9)
    elif mode == "dxdy":
        dx, dy = tfused.unpack_dxdy(tscaled, extra)
        assert_close(dx, ref.dx, **tol)
        assert_close(dy, ref.dy, **tol)
    else:
        assert extra is None
    assert tfused.fused_admm_chunk.launches_gain == 0


def test_chunk_wrapper_refuses_bad_arguments():
    _, (tscaled, ts, tsettings, rho_vec, done, packs, args) = _chunk_case()
    call = lambda **kw: tfused.fused_admm_chunk(  # noqa: E731
        tscaled, rho_vec, done, tsettings, **dict(args, **kw))
    with pytest.raises(ValueError):
        call(state_pack=args["state_pack"][:, :-1].contiguous())
    with pytest.raises(TypeError):
        call(coef=args["coef"].float())
    with pytest.raises(ValueError):
        call(lu=args["lu"].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        call(n_iter=0)
    with pytest.raises(ValueError):
        tfused.fused_admm_chunk(tscaled, rho_vec, done[:-1], tsettings, **args)
    # A block-P chunk runs only in the gain form and without term_packs (the
    # reference asserts both): with no gain pack, or with the packs of the
    # fused accumulators, it raises.
    cholp = args["packed_factor"][0]
    block = tscaled.replace(p_structure="block")
    with pytest.raises(ValueError, match="gain form"):
        tfused.fused_admm_chunk(block, rho_vec, done, tsettings, **args)
    with pytest.raises(ValueError, match="gain form"):
        tfused.fused_admm_chunk(
            block, rho_vec, done, tsettings,
            **dict(args, packed_factor=(cholp, cholp), term_packs=(
                packs["EEinv"], packs["varc"], packs["Pdp"], packs["Plf"])))
    with pytest.raises(ValueError):
        call(packed_factor=(cholp, cholp[:-1].contiguous()))
