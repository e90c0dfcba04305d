"""The Ruiz kernel's CUDA source (``csrc/ruiz.cu``) compiled with g++ in host
emulation (double) against its plain version, on the cases of
``tests/test_torch_helpers.py`` ``RUIZ_CASES``.  Split from
``test_torch_kernels_emulated.py``, whose set-up it imports."""
import pytest
import torch

from osqp_solver_tpu_torch.ops import ruiz_kernel as truiz

from test_torch_helpers import (
    RUIZ_CASES, RUIZ_PARAMS, assert_close, both, emulated_ruiz,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("iters,flags,n_obs,case", RUIZ_PARAMS)
def test_emulated_ruiz_kernel_matches_plain(iters, flags, n_obs, case,
                                            tmp_path, monkeypatch):
    monkeypatch.setenv("OSQP_TORCH_BUILD_DIR", str(tmp_path))
    kw = {k: v for k, v in RUIZ_CASES.get(case, {}).items()
          if k in ("W", "B")}
    _, tqp = both(flags=flags, n_obs=n_obs, **kw)
    D, E, c = truiz._ruiz_scalings_plain(tqp, iters)
    Dk, Ek, ck = emulated_ruiz(tqp, iters, case)
    assert_close(Dk, D, rtol=1e-12)
    assert_close(Ek, E, rtol=1e-12)
    assert_close(ck, c, rtol=1e-12)
