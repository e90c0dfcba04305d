"""PyTorch/CUDA port of the batched ADMM QP solver + GOMP trajectory stack.

The JAX package ``osqp_solver_tpu`` is the reference; this package mirrors
its sub-packages (``ops``, ``gomp``, ``models``, ``utils``) module for
module, imports ``torch`` and numpy only, and runs on an NVIDIA Hopper GPU
through hand-written CUDA kernels (``csrc/``).  Every entry point takes an explicit
``device``; the default is ``"cuda"`` and CPU execution (through the plain
PyTorch versions of the kernels) must be requested with ``device="cpu"``.
"""

from .gomp import constraints
from .gomp.builder import ConstraintBuilder
from .gomp.geometry import (
    CapsuleObstacle,
    HorizontalLine,
    SphereObstacle,
    stack_obstacles,
)
from .gomp.layout import TrajectoryLayout, make_layout
from .gomp.planner import GOMPSolver, PlanResult
from .gomp.trajectory import (
    calc_warm_start,
    linspace_configs,
    smoothness_objective,
    tri_diagonal_matrix,
)
from .gomp.trajectory_qp import (
    TrajectoryQP,
    empty_trajectory_qp,
    linearize_workspace,
    with_gomp_boxes,
)
from .models.robot import RobotBall
from .ops.admm import Settings, SolveResult, solve, solve_batched
from .ops.admm_lane import solve_batched_lane
from .ops.session_lane import (
    LaneSession,
    mpc_scan_lane,
    setup_lane,
    solve_lane,
    update_bounds_lane,
)
from .ops.qp import DenseQP, dense_qp
from .ops.status import ExitCode

__all__ = [
    "CapsuleObstacle", "ConstraintBuilder", "DenseQP", "ExitCode",
    "GOMPSolver", "HorizontalLine", "LaneSession", "PlanResult", "RobotBall",
    "Settings", "SolveResult", "SphereObstacle", "TrajectoryLayout",
    "TrajectoryQP", "calc_warm_start", "constraints", "convert", "dense_qp",
    "empty_trajectory_qp", "gomp", "linearize_workspace", "linspace_configs",
    "make_layout", "models", "mpc_scan_lane", "ops", "setup_lane",
    "smoothness_objective", "solve", "solve_batched", "solve_batched_lane",
    "solve_lane", "stack_obstacles", "tri_diagonal_matrix",
    "update_bounds_lane", "with_gomp_boxes",
]
