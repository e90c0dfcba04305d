"""PyTorch port: the lane sessions' device rule (CUDA unless the CPU is
asked for, a carried-over session too) and the path a batch takes on CUDA
by its row layout, P structure and settings.  Split from
``test_torch_session_lane.py``, whose settings it imports; its honest
batch is built here by the port alone (nothing here is compared with the
JAX package)."""
import dataclasses
import functools
import types

import pytest
import torch

from osqp_solver_tpu_torch import convert
from osqp_solver_tpu_torch.gomp.honest_batch import build_honest_batch
from osqp_solver_tpu_torch.ops import admm as tadmm
from osqp_solver_tpu_torch.ops import admm_lane as tdrv
from osqp_solver_tpu_torch.ops import session_lane as tsess

from test_torch_helpers import assert_close
from test_torch_session_lane import B, N, W, _settings

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _batch():
    """``test_torch_session_lane.py``'s honest batch (B=8, W=20, f64),
    built by the port."""
    return build_honest_batch(B, W, N, dtype=torch.float64, device="cpu")


def test_setup_lane_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    tqp = _batch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsess.setup_lane(tqp, _settings("hrec"))


def test_lane_session_from_numpy_default_device_is_cuda():
    """A carried-over session follows the entry points' device rule: its
    solves run where its tensors lie, so without ``device=`` it is put on
    CUDA, and without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    tqp = _batch()
    sess = tsess.setup_lane(tqp, _settings("hrec"), device="cpu")
    data = convert.lane_session_to_numpy(sess)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lane_session_from_numpy(data)
    back = convert.lane_session_from_numpy(data, device="cpu")
    assert back.warm_x.device.type == "cpu"
    assert_close(back.rho_bar, sess.rho_bar)


@pytest.mark.parametrize("row_layout,p_structure,fused_chunk,fused", [
    ("waypoint", "vel_diag", "auto", True),
    ("waypoint", "vel_diag", "off", False),
    ("type", "vel_diag", "auto", False),
    ("type", "block", "on", False),
])
def test_path_choice_on_cuda(row_layout, p_structure, fused_chunk, fused):
    """Which path a CUDA batch takes (decided from the container alone, so
    it is checked here without a card): the packed chunk for a
    waypoint-layout batch, the unfused path for ``"off"`` and for the
    ``"type"`` layout; a waypoint-layout block-P batch is fused as a
    vel-diag one is (the reference's ``fused_chunk_supported``)."""
    qp = types.SimpleNamespace(device=torch.device("cuda"),
                               row_layout=row_layout, p_structure=p_structure)
    s = dataclasses.replace(tadmm.Settings(), fused_chunk=fused_chunk)
    assert tdrv._use_fused(qp, s) == fused
    block = types.SimpleNamespace(device=torch.device("cuda"),
                                  row_layout="waypoint", p_structure="block")
    assert tdrv._use_fused(block, s) == (fused_chunk != "off")
