"""Fleet load generator: N concurrent cluster lifecycles, one planner.

Drives the declarative sim scenarios (:mod:`repro_torch.sim.scenarios`)
as *concurrent* cluster lifecycles against a single shared
:class:`FleetPlanner`: the workload shape the fleet service exists for.

Each lifecycle reuses :class:`~repro_torch.sim.engine.ScenarioEngine`
as it is through its phased tick API
(:meth:`~repro_torch.sim.engine.ScenarioEngine.apply_tick_events`, then
:meth:`~repro_torch.sim.engine.ScenarioEngine.finish_tick`): per global
tick, every engine first applies its timeline events (growth,
expansions, failures — mutations whose deltas stream into that
cluster's lane), with its
``RebalanceTick`` planning *deferred* into a budget request; then one
SLO-bounded :meth:`FleetService.tick` plans every requesting cluster in
one lane-batched pass; finally each engine books its plan and finishes
the tick (throttle + metrics).  Deferral is the one semantic difference
from the serial engine: a tick's plan sees all of that tick's events,
not just those before the ``RebalanceTick`` in the timeline (and if a
timeline fires several RebalanceTicks in one tick, the last request
wins — one fleet plan per cluster per tick).
"""

from __future__ import annotations

from ..sim.engine import ScenarioEngine, SimConfig
from ..sim.events import Event, RebalanceTick
from ..sim.scenarios import SCENARIOS
from .. import obs as _obs
from .planner import FleetPlanner
from .service import FleetService, FleetTickResult

__all__ = ["FleetLoadGen", "FleetScenarioEngine"]


class FleetScenarioEngine(ScenarioEngine):
    """A scenario lifecycle whose rebalance ticks request instead of
    plan: the fleet driver collects every engine's request and answers
    them all with one fleet tick."""

    def __init__(self, state, events: list[Event], cfg: SimConfig,
                 fleet_planner: FleetPlanner):
        super().__init__(state, events, cfg, planner=fleet_planner)
        self.request: int | None = None     # this tick's budget, if any

    def _rebalance(self, t: int, ev: RebalanceTick) -> None:
        budget = self._tick_budget(ev)
        if budget is not None:
            self.request = budget           # last request wins

    def run(self):  # pragma: no cover - guard against misuse
        raise RuntimeError("FleetScenarioEngine ticks are driven by "
                           "FleetLoadGen, not run() — the plan phase is "
                           "fleet-wide")


class FleetLoadGen:
    """Build and drive N scenario lifecycles on one fleet planner.

    ``scenarios`` is a list of registered scenario names (repeats
    allowed — each entry is an independent cluster, seeded
    ``seeds[i]``).  The shared planner's chunk is aligned to the largest
    per-tick budget in the fleet, mirroring the scenario engine's
    single-cluster default.  ``device`` is the planner's (None: the CUDA
    card).
    """

    def __init__(self, scenarios: list[str], seeds: list[int] | None = None,
                 *, quick: bool = True, slo_seconds: float | None = None,
                 source_bounds: bool = True, row_block: int = 8,
                 device=None):
        if seeds is None:
            seeds = list(range(len(scenarios)))
        if len(seeds) != len(scenarios):
            raise ValueError("need one seed per scenario entry")
        built = []
        for i, (name, seed) in enumerate(zip(scenarios, seeds)):
            state, events, cfg = SCENARIOS[name].build(seed, quick)
            built.append((f"{name}-{i}", state, events, cfg))
        chunk = max([max(1, cfg.moves_per_tick)
                     for _, _, _, cfg in built] or [64])
        self.planner = FleetPlanner(chunk=chunk, row_block=row_block,
                                    source_bounds=source_bounds,
                                    slo_seconds=slo_seconds, device=device)
        self.service = FleetService(planner=self.planner)
        self.engines: dict[str, FleetScenarioEngine] = {}
        for key, state, events, cfg in built:
            self.engines[key] = FleetScenarioEngine(state, events, cfg,
                                                    self.planner)
            self.planner.add_cluster(key, state, cfg.equilibrium)
        self.ticks = max((eng.cfg.ticks for eng in self.engines.values()),
                         default=0)
        self.tick_results: list[FleetTickResult] = []

    def step(self, t: int) -> FleetTickResult | None:
        """One global tick across the fleet: events, one fleet plan for
        every requesting cluster, then per-cluster bookkeeping."""
        budgets: dict[str, int] = {}
        for key, eng in self.engines.items():
            if t >= eng.cfg.ticks:
                continue
            eng.request = None
            eng.apply_tick_events(t)
            if eng.request is not None:
                budgets[key] = eng.request
        result = None
        if budgets:
            result = self.service.tick(budgets)
            self.tick_results.append(result)
            for key, plan in result.results.items():
                self.engines[key]._accept(plan)
        for key, eng in self.engines.items():
            if t < eng.cfg.ticks:
                eng.finish_tick(t)
        return result

    def run(self) -> dict:
        """Drive every lifecycle to completion; returns each cluster's
        :class:`~repro_torch.sim.metrics.MetricsCollector` keyed by lane."""
        with _obs.span("fleet.loadgen", cat="fleet", counters=True,
                       clusters=len(self.engines), ticks=self.ticks):
            for t in range(self.ticks):
                self.step(t)
        return {key: eng.metrics for key, eng in self.engines.items()}

    def summary(self) -> dict:
        """Aggregate per-cluster plan-stream stats over the run:
        plan counts, moves, sync-phase rebuild/absorb totals, SLO
        hit/miss split, mean plan freshness."""
        per: dict[str, dict] = {
            key: {"plans": 0, "moves": 0, "rebuilds": 0,
                  "absorbed_deltas": 0, "slo_expired": 0,
                  "freshness_seconds": 0.0}
            for key in self.engines}
        for tick in self.tick_results:
            for key, plan in tick.results.items():
                acc = per[key]
                acc["plans"] += 1
                acc["moves"] += len(plan.moves)
                acc["rebuilds"] += plan.stats["rebuilds"]
                acc["absorbed_deltas"] = plan.stats["absorbed_deltas"]
                acc["slo_expired"] += int(plan.stats["slo_expired"])
                acc["freshness_seconds"] += \
                    plan.stats["plan_freshness_seconds"]
        for acc in per.values():
            acc["freshness_seconds"] = (acc["freshness_seconds"]
                                        / max(acc["plans"], 1))
        ticks_with_plans = len(self.tick_results)
        expired = sum(t.slo_expired for t in self.tick_results)
        return {
            "clusters": len(self.engines),
            "ticks": self.ticks,
            "fleet_ticks": ticks_with_plans,
            "slo_hit_rate": ((ticks_with_plans - expired)
                             / max(ticks_with_plans, 1)),
            "total_moves": sum(a["moves"] for a in per.values()),
            "per_cluster": per,
        }
