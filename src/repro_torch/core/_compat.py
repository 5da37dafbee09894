"""The pre-protocol balancer entry points, kept as deprecated shims.

The reference keeps its four module-level entry points
(``equilibrium.balance``, ``equilibrium_jax.balance_fast``,
``equilibrium_batch.balance_batch``, ``mgr_balancer.balance``) as shims
that warn once per name and delegate to the planner protocol; the port
keeps them under the names :mod:`repro_torch.core` exports
(``equilibrium_balance``, ``balance_fast``, ``balance_batch``,
``mgr_balance``), on the same terms.  Each returns what the reference's
returns and delegates to :func:`repro_torch.core.planner.create_planner`.
Nothing inside ``src/repro_torch/`` calls them.
"""

from __future__ import annotations

import warnings

_WARNED: set[str] = set()

#: ``balance_fast``'s engines and the planners that run them
_FAST_ENGINES = {"numpy": "equilibrium", "batch": "equilibrium_batch",
                 "jax-legacy": "equilibrium_jax_legacy"}


def warn_deprecated(old: str, replacement: str) -> None:
    """Emit one DeprecationWarning per process for ``old``."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated; use repro_torch.core.planner.{replacement} "
        f"(the unified Planner protocol) instead",
        DeprecationWarning, stacklevel=3)


def _plan(name: str, state, record_trajectory: bool,
          record_free_space: bool, **options):
    from .planner import create_planner
    res = create_planner(name, **options).plan(
        state, record_trajectory=record_trajectory,
        record_free_space=record_free_space)
    return res.moves, res.records


def equilibrium_balance(state, cfg=None, record_trajectory: bool = False,
                        record_free_space: bool = True):
    """Deprecated: use ``create_planner("equilibrium_faithful")`` (same
    move sequences, unified PlanResult).  Returns (movements, records)."""
    warn_deprecated("repro_torch.core.equilibrium_balance",
                    'create_planner("equilibrium_faithful")')
    return _plan("equilibrium_faithful", state, record_trajectory,
                 record_free_space, cfg=cfg)


def balance_fast(state, cfg=None, record_trajectory: bool = False,
                 use_jax: bool = False, pad_rows: int = 256,
                 record_free_space: bool = True, engine: str | None = None,
                 device=None):
    """Deprecated: use ``create_planner("equilibrium")`` (the ``numpy``
    engine, the default), ``create_planner("equilibrium_batch")``
    (``use_jax=True`` or ``engine="batch"``) or
    ``create_planner("equilibrium_jax_legacy")`` (``engine="jax-legacy"``).
    The planners pad the legacy lane's rows to 256, so another
    ``pad_rows`` raises; ``device`` is the card lanes' (CUDA when None).
    Returns (movements, records)."""
    warn_deprecated("repro_torch.core.balance_fast",
                    'create_planner("equilibrium")')
    if engine is None:
        engine = "batch" if use_jax else "numpy"
    if engine not in _FAST_ENGINES or pad_rows != 256:
        raise ValueError(f"engine {engine!r}, pad_rows {pad_rows!r}: the "
                         f"planners take the engines {sorted(_FAST_ENGINES)}"
                         f" and pad rows to 256")
    name = _FAST_ENGINES[engine]
    options = {} if engine == "numpy" else {"device": device}
    return _plan(name, state, record_trajectory, record_free_space, cfg=cfg,
                 **options)


def balance_batch(state, cfg=None, record_trajectory: bool = False,
                  record_free_space: bool = True, chunk: int = 64,
                  source_block: int = 1, row_block: int = 8,
                  row_capacity: int | None = None, *,
                  legality_cache: bool = False, source_bounds: bool = True,
                  device=None):
    """Deprecated: use ``create_planner("equilibrium_batch")``, or hold a
    :class:`~repro_torch.core.equilibrium_batch.BatchPlanner` for warm
    incremental planning.  ``source_block`` x ``row_block`` is the walk's
    tile; ``device`` is CUDA when None.  The reference's ``select_backend``
    has no counterpart (a card runs K1, the CPU its plain version), so the
    options after ``row_capacity`` are keywords.  Returns (movements,
    records)."""
    warn_deprecated("repro_torch.core.balance_batch",
                    'create_planner("equilibrium_batch")')
    return _plan("equilibrium_batch", state, record_trajectory,
                 record_free_space, cfg=cfg, chunk=chunk,
                 source_block=source_block, row_block=row_block,
                 row_capacity=row_capacity, legality_cache=legality_cache,
                 source_bounds=source_bounds, device=device)


def mgr_balance(state, cfg=None, record_trajectory: bool = False):
    """Deprecated: use ``create_planner("mgr")``.  Returns (movements,
    trajectory): with ``record_trajectory`` one dict per move (``move``,
    ``variance``, ``free_space``, ``moved_bytes``), as the reference's
    ``mgr_balancer.balance`` records it."""
    warn_deprecated("repro_torch.core.mgr_balance", 'create_planner("mgr")')
    moves, records = _plan("mgr", state, record_trajectory, True, cfg=cfg)
    trajectory = [{"move": i + 1, "variance": r.variance_after,
                   "free_space": r.free_space_after,
                   "moved_bytes": r.movement.size}
                  for i, r in enumerate(records)]
    return moves, trajectory
