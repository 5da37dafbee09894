"""Continuous-balancing service loop over a :class:`FleetPlanner`.

The deployment shape the fleet engine exists for: a daemon that owns N
cluster lanes, ingests each cluster's streaming
:class:`~repro_torch.core.cluster.ClusterDelta` feed between ticks,
and runs one SLO-bounded fleet tick per balancing interval.  Deltas
route to the named lane's :meth:`BatchPlanner.observe` (absorption into
the warm device carry at the next tick — rebuilds only on the
documented fallback cases), so an absorb-only stream keeps every cluster warm
across the daemon's whole life.

This is a library loop, not a process: :meth:`FleetService.tick` is one
balancing interval, :meth:`FleetService.run` iterates it; the fleet
load generator (:mod:`repro_torch.fleet.loadgen`) drives it
synchronously.
"""

from __future__ import annotations

import dataclasses
import time

from ..core.cluster import ClusterDelta, ClusterState
from ..core.equilibrium import EquilibriumConfig
from ..core.planner import PlanResult
from .planner import FleetPlanner

__all__ = ["FleetService", "FleetTickResult"]


@dataclasses.dataclass
class FleetTickResult:
    """One balancing interval's outcome across the fleet."""

    results: dict[object, PlanResult]   # lane key -> that cluster's plan
    wall_seconds: float                 # whole-tick wall time
    slo_expired: bool                   # True if any lane was SLO-cut

    @property
    def total_moves(self) -> int:
        return sum(len(r.moves) for r in self.results.values())

    def __len__(self) -> int:
        return len(self.results)


class FleetService:
    """Daemon-shaped wrapper: attach clusters, ingest deltas, tick.

    ``slo_seconds`` (and any other ``FleetPlanner`` keyword) configures
    the planner when one is not passed in; a shared planner instance can
    also be handed over so other drivers (the scenario engine through
    the registry protocol) see the same warm lanes.
    """

    def __init__(self, planner: FleetPlanner | None = None,
                 slo_seconds: float | None = None, **planner_kwargs):
        if planner is None:
            planner = FleetPlanner(slo_seconds=slo_seconds,
                                   **planner_kwargs)
        elif slo_seconds is not None:
            planner.slo_seconds = slo_seconds
        self.planner = planner
        self.ticks = 0

    # -- membership + ingestion ----------------------------------------------

    def attach(self, key, state: ClusterState,
               cfg: EquilibriumConfig | None = None) -> None:
        """Add one cluster lifecycle to the service."""
        self.planner.add_cluster(key, state, cfg)

    def detach(self, key) -> None:
        self.planner.remove_cluster(key)

    def ingest(self, key, delta: ClusterDelta) -> bool:
        """Route one streamed delta to lane ``key``; True iff the warm
        carry absorbs it (False = that lane rebuilds next tick).  Deltas
        produced by mutating an attached state directly are already
        delivered through the state's subscription — ingest() is for
        feeds that arrive out-of-band (a mirrored cluster's log)."""
        return self.planner.observe_cluster(key, delta)

    # -- the balancing loop ---------------------------------------------------

    def tick(self, budgets: dict | None = None, *,
             record_trajectory: bool = False) -> FleetTickResult:
        """One balancing interval: plan every requested lane (all lanes
        when ``budgets`` is None) under the service's latency SLO."""
        t0 = time.perf_counter()
        results = self.planner.plan_fleet(
            budgets, record_trajectory=record_trajectory)
        self.ticks += 1
        return FleetTickResult(
            results=results,
            wall_seconds=time.perf_counter() - t0,
            slo_expired=any(r.stats["slo_expired"]
                            for r in results.values()))

    def run(self, n_ticks: int,
            budgets: dict | None = None) -> list[FleetTickResult]:
        """``n_ticks`` back-to-back intervals (synchronous driver)."""
        return [self.tick(budgets) for _ in range(n_ticks)]
