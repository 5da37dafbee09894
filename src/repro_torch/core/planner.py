"""Unified Planner protocol and registry of the port.

The single front door to the port's balancers, with the reference's
names and calling convention (:mod:`repro.core.planner`):

* :class:`Planner` — the protocol every balancer implements::

      plan(state, *, budget=None, ...) -> PlanResult   # plan + apply
      observe(delta) -> bool                           # stay warm?
      reset()                                          # drop warm state

* :class:`PlanResult` — moves, per-move records, engine metadata and
  stats under the one :data:`repro_torch.obs.schema.STATS_SCHEMA`;
* :func:`register_planner` / :func:`create_planner` — the registry.

Registered here: ``equilibrium_faithful`` (the §3.1 loop, the port's host
reference), ``equilibrium`` (the dense-NumPy lane, on the host: the
planner every consumer calls), ``equilibrium_jax_legacy`` (the
per-source lane through K1's standalone reduction), ``equilibrium_batch``
(the device-resident engine), ``mgr`` and ``none``; ``fleet``
(:mod:`repro_torch.fleet.planner`, the lane-batched multi-cluster
engine) and ``equilibrium_batch_sharded`` (:mod:`repro_torch.core.shard`,
the batch engine over a device axis split across a process group's
ranks) register when first looked up.  The legacy, batch, fleet and
sharded lanes run on the CUDA card unless the caller passes
``device="cpu"``.  The six Equilibrium planners share the ``equilibrium``
equivalence tag: they emit bitwise-identical move streams.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import time
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

from .cluster import (ClusterDelta, ClusterState, DeviceAddDelta,
                      DeviceOutDelta, Movement, MovementDelta,
                      PoolCreateDelta, PoolGrowthDelta)
from .equilibrium import EquilibriumConfig, MoveRecord, _balance
from .mgr_balancer import MgrBalancerConfig, _balance as _mgr_balance
from .. import obs as _obs
from ..device import resolve_device
from ..obs import finalize_stats

__all__ = [
    "ClusterDelta", "MovementDelta", "PoolGrowthDelta", "DeviceAddDelta",
    "DeviceOutDelta", "PoolCreateDelta", "PlanResult", "Planner",
    "PlannerSpec", "register_planner", "create_planner", "get_planner_spec",
    "available_planners", "planners_in_class",
]


# ---------------------------------------------------------------------------
# Unified plan result


@dataclass
class PlanResult:
    """What one :meth:`Planner.plan` call produced.

    ``moves`` were already applied to the planned-against state.
    ``records`` is the per-move trajectory (empty unless
    ``record_trajectory=True``); ``stats`` carries exactly the
    :data:`repro_torch.obs.schema.STATS_SCHEMA` keys for every planner.
    """

    moves: list[Movement]
    records: list[MoveRecord]
    planner: str                     # registry name
    stats: dict = field(default_factory=dict)

    @property
    def variance_trajectory(self) -> list[float]:
        """Utilization variance after each move (needs trajectory)."""
        return [r.variance_after for r in self.records]

    def as_tuple(self) -> tuple[list[Movement], list[MoveRecord]]:
        """The ``(movements, records)`` pair."""
        return self.moves, self.records

    def __len__(self) -> int:
        return len(self.moves)


# ---------------------------------------------------------------------------
# Protocol + registry


@runtime_checkable
class Planner(Protocol):
    """Anything that can plan shard movements against a ClusterState."""

    name: str

    def plan(self, state: ClusterState, *, budget: int | None = None,
             record_trajectory: bool = False,
             record_free_space: bool = True) -> PlanResult:
        """Plan up to ``budget`` moves (planner default when None),
        applying them to ``state``; return the unified result."""
        ...

    def observe(self, delta: ClusterDelta) -> bool:
        """Note one cluster mutation; True iff warm state survives it."""
        ...

    def reset(self) -> None:
        """Drop any warm state; the next plan() cold-starts."""
        ...


@dataclass(frozen=True)
class PlannerSpec:
    name: str
    factory: type | object           # callable returning a Planner
    sim_config_attr: str | None      # simulator config field of its config
    description: str = ""
    #: planners sharing a tag must emit bitwise-identical move streams
    equivalence: str | None = None


_REGISTRY: dict[str, PlannerSpec] = {}

#: planners whose defining module lives *above* repro_torch.core
#: (importing it here eagerly would be a dependency cycle): resolved on
#: first lookup by importing the named module, whose import-time
#: ``@register_planner`` fills the registry slot.
_LAZY_PLANNERS: dict[str, str] = {
    "fleet": "repro_torch.fleet.planner",
    "equilibrium_batch_sharded": "repro_torch.core.shard",
}


def register_planner(name: str, *, sim_config_attr: str | None = None,
                     description: str = "", replace: bool = False,
                     equivalence: str | None = None):
    """Class/factory decorator adding a planner to the registry."""
    def deco(factory):
        if name in _REGISTRY and not replace:
            raise ValueError(f"planner {name!r} already registered")
        _REGISTRY[name] = PlannerSpec(
            name, factory, sim_config_attr,
            description or inspect.getdoc(factory) or "",
            equivalence)
        return factory
    return deco


def get_planner_spec(name: str) -> PlannerSpec:
    if name not in _REGISTRY and name in _LAZY_PLANNERS:
        importlib.import_module(_LAZY_PLANNERS[name])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown planner {name!r}: expected one of "
                         f"{available_planners()}") from None


def available_planners() -> tuple[str, ...]:
    """Registered planner names (lazy ones included), sorted."""
    return tuple(sorted(_REGISTRY.keys() | _LAZY_PLANNERS.keys()))


def planners_in_class(equivalence: str) -> tuple[str, ...]:
    """Registered planner names tagged with ``equivalence``, sorted; the
    lazy planners' modules are imported first, so that their
    registrations count."""
    for name, module in _LAZY_PLANNERS.items():
        if name not in _REGISTRY:
            importlib.import_module(module)
    return tuple(sorted(n for n, spec in _REGISTRY.items()
                        if spec.equivalence == equivalence))


def create_planner(name: str, **kwargs) -> Planner:
    """Instantiate a registered planner.

    Keyword arguments not accepted by the planner's factory are dropped,
    so one call site can configure heterogeneous planners.  Factories
    accepting ``**kwargs`` receive everything.
    """
    spec = get_planner_spec(name)
    sig = inspect.signature(spec.factory)
    params = sig.parameters.values()
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        accepted = {p.name for p in params
                    if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                  inspect.Parameter.KEYWORD_ONLY)}
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    return spec.factory(**kwargs)


# ---------------------------------------------------------------------------
# The built-in planners


def _with_budget(cfg, budget: int | None):
    return cfg if budget is None else dataclasses.replace(cfg,
                                                          max_moves=budget)


def _plan_span(name: str):
    """The per-plan telemetry span every built-in planner wraps its
    plan() in (``counters=True`` attributes registry increments made
    while planning to this call in the trace)."""
    return _obs.span("planner.plan", cat="planner", counters=True,
                     planner=name)


def _finish(result: PlanResult, sp) -> PlanResult:
    """Normalize and publish one plan result: fill the stats schema, bump
    the planner throughput counters, annotate the span."""
    finalize_stats(result.stats)
    reg = _obs.registry()
    reg.inc("planner.plans", planner=result.planner)
    reg.inc("planner.moves", len(result.moves), planner=result.planner)
    sp.set(moves=len(result.moves),
           planning_seconds=result.stats["planning_seconds"],
           engine=result.stats["engine"])
    return result


class _StatelessPlanner:
    """Shared base for planners that rebuild from the state every call:
    every delta is trivially absorbed and reset() is a no-op."""

    name = "stateless"

    def observe(self, delta: ClusterDelta) -> bool:
        return True

    def reset(self) -> None:
        pass


@register_planner("equilibrium_faithful", sim_config_attr="equilibrium",
                  description="paper-faithful §3.1 loop (semantic reference)",
                  equivalence="equilibrium")
class FaithfulEquilibriumPlanner(_StatelessPlanner):
    """The paper's §3.1 planning loop, unchanged — the host reference the
    batch engine is held to move for move."""

    name = "equilibrium_faithful"

    def __init__(self, cfg: EquilibriumConfig | None = None,
                 source_bounds: bool = False):
        self.cfg = cfg or EquilibriumConfig()
        self.source_bounds = source_bounds

    def plan(self, state, *, budget=None, record_trajectory=False,
             record_free_space=True):
        with _plan_span(self.name) as sp:
            t0 = time.perf_counter()
            aux: dict = {}
            moves, records = _balance(state, _with_budget(self.cfg, budget),
                                      record_trajectory=record_trajectory,
                                      record_free_space=record_free_space,
                                      stats_out=aux,
                                      source_bounds=self.source_bounds)
            return _finish(PlanResult(moves, records, self.name, stats={
                "planning_seconds": time.perf_counter() - t0,
                "budget": budget, "engine": "faithful", **aux}), sp)


class _DensePlanner(_StatelessPlanner):
    """Shared plan() for the dense lanes of
    :mod:`~repro_torch.core.equilibrium_dense`."""

    engine = "numpy"
    device = None                        # the legacy lane's

    def __init__(self, cfg: EquilibriumConfig | None = None,
                 source_bounds: bool = False):
        self.cfg = cfg or EquilibriumConfig()
        self.source_bounds = source_bounds

    def plan(self, state, *, budget=None, record_trajectory=False,
             record_free_space=True):
        from .equilibrium_dense import _balance_fast
        with _plan_span(self.name) as sp:
            t0 = time.perf_counter()
            aux: dict = {}
            moves, records = _balance_fast(
                state, _with_budget(self.cfg, budget),
                record_trajectory=record_trajectory,
                record_free_space=record_free_space, engine=self.engine,
                stats_out=aux, source_bounds=self.source_bounds,
                device=self.device)
            return _finish(PlanResult(moves, records, self.name, stats={
                "planning_seconds": time.perf_counter() - t0,
                "budget": budget, "engine": self.engine, **aux}), sp)


@register_planner("equilibrium", sim_config_attr="equilibrium",
                  description="dense-NumPy Equilibrium (small-cluster "
                              "default, no warm-up cost)",
                  equivalence="equilibrium")
class EquilibriumPlanner(_DensePlanner):
    name = "equilibrium"


@register_planner("equilibrium_jax_legacy", sim_config_attr="equilibrium",
                  description="first-generation per-source jitted path "
                              "(benchmark baseline)",
                  equivalence="equilibrium")
class LegacyJaxEquilibriumPlanner(_DensePlanner):
    """The per-source lane: one upload, one launch of K1's standalone
    reduction and one fetch a source.  ``device=None`` runs on the CUDA
    card and raises when there is none; ``device="cpu"`` runs the same
    lane with K1's plain version."""

    name = "equilibrium_jax_legacy"
    engine = "jax-legacy"

    def __init__(self, cfg: EquilibriumConfig | None = None,
                 source_bounds: bool = False, device=None):
        super().__init__(cfg, source_bounds)
        self.device = resolve_device(device, "equilibrium_jax_legacy")


@register_planner("equilibrium_batch", sim_config_attr="equilibrium",
                  description="device-resident chunked engine on the CUDA "
                              "card (kernel K1); warm across calls while "
                              "the state is unchanged",
                  equivalence="equilibrium")
class BatchEquilibriumPlanner:
    """Protocol adapter over :class:`~repro_torch.core.equilibrium_batch
    .BatchPlanner`.

    The engine binds one ClusterState and keeps its device carry between
    :meth:`plan` calls; passing a different state object rebinds (and
    cold-starts).  ``warm=False`` forces a cold start on every call.
    ``device=None`` runs on the CUDA card and raises when there is none;
    ``device="cpu"`` runs the same engine with the kernels' plain
    versions.  ``legality_cache``, ``pipeline`` (on by default),
    ``source_block`` and ``row_block`` (the walk's tile) are the engine's
    options.
    """

    name = "equilibrium_batch"
    engine = "batch"                     # PlanResult.stats["engine"]

    def __init__(self, cfg: EquilibriumConfig | None = None, chunk: int = 64,
                 source_block: int = 1, row_block: int = 8,
                 row_capacity: int | None = None, warm: bool = True,
                 legality_cache: bool = False, source_bounds: bool = True,
                 pipeline: bool = True, device=None):
        self.cfg = cfg or EquilibriumConfig()
        self.warm = warm
        self.device = resolve_device(device, "equilibrium_batch")
        self._engine_kwargs = dict(chunk=chunk, source_block=source_block,
                                   row_block=row_block,
                                   row_capacity=row_capacity,
                                   legality_cache=legality_cache,
                                   source_bounds=source_bounds,
                                   pipeline=pipeline, device=self.device)
        self._impl = None                # BatchPlanner, bound lazily

    def _bind(self, state: ClusterState):
        from .equilibrium_batch import BatchPlanner
        if self._impl is None or self._impl.state is not state:
            self._impl = BatchPlanner(state, self.cfg, **self._engine_kwargs)
        return self._impl

    def plan(self, state, *, budget=None, record_trajectory=False,
             record_free_space=True):
        impl = self._bind(state)
        if not self.warm:
            impl.reset()
        with _plan_span(self.name) as sp:
            t0 = time.perf_counter()
            aux: dict = {}
            moves, records = impl.plan(max_moves=budget,
                                       record_trajectory=record_trajectory,
                                       record_free_space=record_free_space,
                                       stats_out=aux)
            return _finish(PlanResult(moves, records, self.name, stats={
                "planning_seconds": time.perf_counter() - t0,
                "budget": budget, "engine": self.engine, "warm": self.warm,
                **aux}), sp)

    def observe(self, delta: ClusterDelta) -> bool:
        if self._impl is None:
            return True                  # nothing warm yet
        return self._impl.observe(delta)

    def reset(self) -> None:
        if self._impl is not None:
            self._impl.reset()


@register_planner("mgr", sim_config_attr="mgr",
                  description="Ceph's built-in size-blind upmap balancer "
                              "(the paper's baseline)")
class MgrPlanner(_StatelessPlanner):
    """The §2.3.1 baseline behind the same protocol.  Its per-move
    trajectory dicts are normalized into :class:`MoveRecord`
    (``sources_tried`` is always 1: the mgr balancer never falls through
    to another source)."""

    name = "mgr"

    def __init__(self, cfg: MgrBalancerConfig | None = None):
        self.cfg = cfg or MgrBalancerConfig()

    def plan(self, state, *, budget=None, record_trajectory=False,
             record_free_space=True):
        with _plan_span(self.name) as sp:
            t0 = time.perf_counter()
            moves, trajectory = _mgr_balance(
                state, _with_budget(self.cfg, budget),
                record_trajectory=record_trajectory)
            dt = time.perf_counter() - t0
            per_move = dt / max(len(moves), 1)
            records = [MoveRecord(movement=mv, variance_after=t["variance"],
                                  free_space_after=t["free_space"],
                                  planning_seconds=per_move, sources_tried=1)
                       for mv, t in zip(moves, trajectory)]
            hist = {"1": len(moves)} if moves else {}
            return _finish(PlanResult(moves, records, self.name, stats={
                "planning_seconds": dt, "budget": budget, "engine": "mgr",
                "sources_tried_hist": hist, "selection_seconds": dt,
                "moves_seconds": dt}), sp)


@register_planner("none", description="no-op baseline: never plans a move")
class NonePlanner(_StatelessPlanner):
    name = "none"

    def plan(self, state, *, budget=None, record_trajectory=False,
             record_free_space=True):
        with _plan_span(self.name) as sp:
            return _finish(PlanResult([], [], self.name, stats={
                "planning_seconds": 0.0, "budget": budget,
                "engine": "none"}), sp)
