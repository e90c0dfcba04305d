"""PyTorch port vs JAX package: ``ConstraintBuilder``'s assembling scenarios
(those of ``tests/test_builder.py``, the stateful FK mirrored) and
``TrajectoryLayout`` for six shapes, against the JAX package's at 1e-12.
Split from ``test_torch_builder.py``, whose set-up it imports."""
import pytest
import torch

from osqp_solver_tpu.gomp.layout import make_layout as jmake_layout
from osqp_solver_tpu_torch import make_layout as tmake_layout

from test_torch_builder import assert_lau, scenario

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


BUILDER_SCENARIOS = [
    "linking_velocity_to_position", "joint_position", "velocity",
    "acceleration", "all_constraint_kinds", "position3d_stateful_fk",
    "position3d_identity_fk", "position3d_jac_pow2",
    "ignore_velocity_trajectory", "radius_tightens_bounds",
    "obstacle_rows_collision_and_dummy",
]


@pytest.mark.parametrize("name", BUILDER_SCENARIOS)
def test_builder_scenario_matches_reference(name):
    """Each assembling scenario of ``tests/test_builder.py``: the port's
    ``(l, A, u)`` equal the JAX builder's."""
    assert_lau(*scenario(name))


LAYOUTS = [(3, 2, (), 0), (4, 2, (), 0), (10, 6, (False, True), 2),
           (7, 3, (True,), 1), (5, 7, (True, False, True), 3),
           (20, 6, (False, True), 0)]


@pytest.mark.parametrize("W,N,flags,n_obs", LAYOUTS)
def test_layout_matches_reference(W, N, flags, n_obs):
    """``make_layout``'s offsets, row counts and indices equal JAX's exactly
    (the mirrors of ``test_indices`` and
    ``test_row_count_matches_reference_overallocation``)."""
    j, t = jmake_layout(W, N, flags, n_obs), tmake_layout(W, N, flags, n_obs)
    for attr in ("n_vars", "n_balls", "dynamics_offset", "n_dynamics_rows",
                 "user_offset", "position_offset", "velocity_offset",
                 "acceleration_offset", "workspace_offset",
                 "n_used_workspace_rows", "n_allocated_workspace_rows",
                 "n_rows"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert [t.nth_pos(i) for i in range(W)] == [j.nth_pos(i) for i in range(W)]
    assert ([t.nth_velocity(i) for i in range(W - 1)]
            == [j.nth_velocity(i) for i in range(W - 1)])
    assert ([t.nth_acceleration(i) for i in range(W - 2)]
            == [j.nth_acceleration(i) for i in range(W - 2)])
    for b in range(len(flags)):
        assert t.ball_offset(b) == j.ball_offset(b)
        assert t.rows_per_waypoint(b) == j.rows_per_waypoint(b)
        assert ([t.workspace_row(b, w, k) for w in range(W)
                 for k in range(t.rows_per_waypoint(b))]
                == [j.workspace_row(b, w, k) for w in range(W)
                    for k in range(j.rows_per_waypoint(b))])
