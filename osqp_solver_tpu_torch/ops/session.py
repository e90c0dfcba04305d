"""Solver session: set up once, update values, re-solve warm-started.

Counterpart of ``osqp_solver_tpu/ops/session.py`` (``Session``, ``setup``,
``update``, ``update_bounds``, ``solve``, ``mpc_scan``) for the generic
path (any container of the operator protocol: ``DenseQP``,
``TrajectoryQP``), with OSQP's session semantics:

* ``setup``  — equilibrate once (the Ruiz scaling is computed here and
  frozen) and factor the KKT once;
* ``update`` — new problem values with the frozen scaling; the factor is
  recomputed unless ``refactor=False`` (bounds/q-only changes);
* ``solve``  — ADMM warm-started from the previous solution and ρ, on the
  cached factor.

A container with no batch dims is a session of one problem (the reference's
unbatched session); one with a trailing batch dim is a batch of independent
sessions stepped together.  The tensors live on the session's device across
re-solves.  The reference's ``lax.scan`` over updates is a host loop here
(:func:`mpc_scan`) with no device read of its own: each solve reads once per
chunk, and a guarded bounds update once, all counted in
:data:`.admm.HOST_SYNCS`.
"""
from __future__ import annotations

import dataclasses

import torch

from . import admm
from .admm import Settings
from .ruiz import Scaling


@dataclasses.dataclass(frozen=True)
class Session:
    base: object  # unscaled container, one trailing batch dim
    scaled: object  # scaled container (scaling frozen at setup)
    scaling: Scaling
    warm_x: torch.Tensor  # (n, B) unscaled primal warm start
    warm_y: torch.Tensor  # (m, B) unscaled dual warm start
    rho_bar: torch.Tensor  # (B,) carried ρ (adapted across solves)
    factor: object  # cached KKT factor for (scaled, rho_bar)
    batched: bool = True  # False: set up from a container with no batch dim

    def replace(self, **changes) -> "Session":
        return dataclasses.replace(self, **changes)


def _user_view(session: Session, qp):
    """A container as the caller sees it: without the batch-of-one dim of
    an unbatched session."""
    return qp if session.batched else qp.map_arrays(lambda a: a.squeeze(-1))


def _session_view(session: Session, qp):
    """A caller's container (or field value) as the session stores it."""
    dev = session.base.q.device
    if isinstance(qp, torch.Tensor):
        qp = qp.to(device=dev, dtype=session.base.q.dtype)
        return qp if session.batched else qp.unsqueeze(-1)
    return admm.as_batch(qp, dev)[0]


def _factor(scaled, rho_bar, settings: Settings):
    rho_vec = admm._rho_vec(rho_bar, scaled.l, scaled.u)
    return admm.kkt_factor(scaled, rho_vec, settings.sigma, settings)


def setup(qp, settings: Settings = Settings(), warm_x=None, warm_y=None,
          device=None) -> Session:
    """Equilibrate, factor and create a session (``OsqpSolver::Init`` +
    ``SetPrimalWarmStart``).  ``warm_x``/``warm_y``: unscaled, ``(n,)`` /
    ``(m,)`` for an unbatched container, batch-leading ``(B, n)`` /
    ``(B, m)`` for a batched one.  ``device``: ``"cuda"`` unless the caller
    passes ``"cpu"`` (raises when CUDA is absent and the CPU was not asked
    for); the problem is moved there."""
    dev = admm.resolve_device(device)
    admm.check_supported(settings, generic=True)
    admm.pin_matmul_precision()
    base, batched = admm.as_batch(qp, dev)
    base = admm.prepare(base)
    scaled, scaling = admm.equilibrate(base, settings)
    n, B = base.q.shape
    kw = dict(dtype=base.q.dtype, device=dev)

    def warm(v, rows):
        v = admm._lane_warm(v, batched, kw["dtype"], dev)
        return torch.zeros((rows, B), **kw) if v is None else v

    rho_bar = torch.full((B,), settings.rho, **kw)
    return Session(
        base=base,
        scaled=scaled,
        scaling=scaling,
        warm_x=warm(warm_x, n),
        warm_y=warm(warm_y, base.l.shape[0]),
        rho_bar=rho_bar,
        factor=_factor(scaled, rho_bar, settings),
        batched=batched,
    )


def _rebased(session: Session, base, refactor: bool,
             settings: Settings) -> Session:
    """The session on new base values (stored form), rescaled with the
    frozen scaling; refactored when asked."""
    s = session.scaling
    base = admm.prepare(base)
    scaled = admm.prepare(base.scale_data(s.D, s.E, s.c))
    session = session.replace(base=base, scaled=scaled)
    if refactor:
        session = session.replace(
            factor=_factor(scaled, session.rho_bar, settings))
    return session


def update(session: Session, new_qp, refactor: bool = True,
           settings: Settings = Settings()) -> Session:
    """Values-only problem update with the frozen scaling (OSQP
    ``osqp_update_A``/``osqp_update_bounds``; shapes unchanged).  ``new_qp``
    in the caller's form (unbatched for an unbatched session).
    ``refactor=False`` keeps the cached factor — valid when only bounds/q
    changed, the MPC fast path."""
    return _rebased(session, _session_view(session, new_qp), refactor,
                    settings)


def update_bounds(session: Session, guard_reclassification: bool = False,
                  settings: Settings = Settings(),
                  **bound_fields) -> Session:
    """Bounds/q-only update (``SetBounds``): new field values on the base
    container (in the caller's form), factor kept.

    The cached factor stays valid only while each row's classification
    (equality / loose, hence ρ_vec) is unchanged.  With
    ``guard_reclassification=True`` the classification is compared
    elementwise, ONE device read (counted in :data:`.admm.HOST_SYNCS`)
    decides whether any row of any problem flipped, and only then the whole
    batch refactors."""
    old_rho = (
        admm._rho_vec(session.rho_bar, session.scaled.l, session.scaled.u)
        if guard_reclassification else None
    )
    fields = {k: _session_view(session, torch.as_tensor(v))
              for k, v in bound_fields.items()}
    session = _rebased(session, session.base.replace(**fields), False,
                       settings)
    if not guard_reclassification:
        return session
    new_rho = admm._rho_vec(session.rho_bar, session.scaled.l,
                            session.scaled.u)
    changed = bool(torch.any(old_rho != new_rho))  # the guard's one read
    admm.HOST_SYNCS += 1
    if not changed:
        return session
    return session.replace(
        factor=admm.kkt_factor(session.scaled, new_rho, settings.sigma,
                               settings))


def solve(session: Session, settings: Settings = Settings()):
    """Solve warm-started from the session's carried iterates, ρ and cached
    factor.  Returns ``(advanced session, SolveResult)`` — iterates, ρ and
    factor advance, OSQP's cross-``Solve()`` carry; the result is
    batch-leading, without a batch dim for an unbatched session."""
    admm.check_supported(settings, generic=True)
    st = admm.init_state(
        session.scaled, settings,
        warm_x=session.warm_x, warm_y=session.warm_y,
        scaling=session.scaling, rho_bar=session.rho_bar,
        factor=session.factor,
    )
    st = admm.run_admm(session.base, session.scaled, session.scaling, st,
                       settings)
    res = admm.finalize(session.base, session.scaling, st)
    session = session.replace(
        warm_x=res.x.T, warm_y=res.y.T, rho_bar=st.rho_bar, factor=st.factor)
    return session, (res if session.batched else admm.unbatch_result(res))


def mpc_scan(session: Session, updates, apply_update,
             settings: Settings = Settings()):
    """MPC sweep: a host loop over parameter updates with the carried state
    (warm starts + cached factor).  ``apply_update(base, upd) -> new_qp``
    gets and returns containers in the caller's form and must change only
    bounds or ``q`` (A/P untouched) so that the cached factor stays valid.
    Returns ``(session, (x, status, iterations))`` stacked over the updates
    (``(T, n)``/``(T,)`` for an unbatched session, ``(T, B, n)``/``(T, B)``
    for a batched one).  The loop itself reads nothing from the device."""
    xs, status, iters = [], [], []
    for t in range(len(updates)):
        new_qp = apply_update(_user_view(session, session.base), updates[t])
        session = update(session, new_qp, refactor=False)
        session, res = solve(session, settings)
        xs.append(res.x)
        status.append(res.status)
        iters.append(res.iterations)
    return session, (torch.stack(xs), torch.stack(status), torch.stack(iters))
