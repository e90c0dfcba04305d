"""Multi-process scaling surface over ``torch.distributed``.

Counterpart of ``osqp_solver_tpu/parallel/``: the batch axis (independent
problems), the horizon axis (the separator-only Schur split of one long
trajectory), the 2-D ``(batch, horizon)`` mesh, and the multi-process
runtime (:mod:`.multihost`).  Nothing here starts a process group at import.
"""
from .banded import (  # noqa: F401
    BandedQP,
    ShardedBandedQP,
    banded_from_trajectory,
    solve_banded_sharded,
    solve_banded_sharded_2d,
)
from .batch import solve_batch, solve_batch_sharded  # noqa: F401
from .horizon import (  # noqa: F401
    ChunkedTrajectoryQP,
    as_chunked,
    auto_chunks,
    solve_horizon_sharded,
)
from .mesh import BATCH_AXIS, HORIZON_AXIS, make_mesh  # noqa: F401
from .schur import (  # noqa: F401
    schur_factor,
    schur_solve_cached,
    schur_solve_reference,
    schur_solve_sharded,
)
