"""Declarative scenario registry: named cluster lifecycles.

Each scenario is a function returning ``(initial_state, events,
SimConfig)`` for a given seed; :func:`run_scenario` binds a balancer and
runs it.  The registry is the workload generator of the lifecycle
comparison: every planner can be ranked against these same timelines,
and each run's metrics JSON equals the reference's
(:mod:`repro.sim.scenarios`) byte for byte.

Scenario design notes: growth events use ``every=2`` so half the
rebalance ticks see an unmutated cluster and exercise the batch engine's
warm-start path; clusters come from
:func:`repro_torch.core.clustergen.sim_cluster` (two HDD capacity tiers +
per-PG size jitter), the regime where count-balancing and
size-balancing disagree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.cluster import GiB, PlacementRule, TiB
from ..core.clustergen import sim_cluster
from ..core.equilibrium import EquilibriumConfig
from ..core.simulate import ThrottleConfig
from .. import obs as _obs
from .engine import ScenarioEngine, SimConfig
from .events import (DeviceFail, DeviceOut, Event, HostAdd, PoolCreate,
                     PoolGrowth, RebalanceTick)

BuildFn = Callable[[int, bool], tuple]


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build: BuildFn


SCENARIOS: dict[str, Scenario] = {}


def register(name: str, description: str):
    def deco(fn: BuildFn) -> BuildFn:
        SCENARIOS[name] = Scenario(name, description, fn)
        return fn
    return deco


def _ticks(n: int, quick: bool) -> int:
    return max(10, n // 4) if quick else n


def _cadence(ticks: int) -> list[Event]:
    return [RebalanceTick(t) for t in range(ticks)]


def _throttle(max_concurrent: int = 8,
              bw: float = 256 * GiB) -> ThrottleConfig:
    return ThrottleConfig(max_concurrent=max_concurrent,
                          device_bytes_per_tick=bw)


def _eq_cfg() -> EquilibriumConfig:
    """Scenario-tuned Equilibrium: don't move data for negligible variance
    gains — in a live cluster every move costs backfill bandwidth, so the
    convergence tail (ever-smaller deltas) is not worth its bytes.  1e-5
    is ~1% of the initial variance at sim_cluster scale."""
    return EquilibriumConfig(min_variance_delta=1e-5)


@register("steady-growth",
          "sustained ingest into the two big pools; the balancer chases a "
          "slowly rising waterline")
def steady_growth(seed: int, quick: bool = False):
    ticks = _ticks(60, quick)
    drain = max(4, ticks // 6)          # quiet tail: backlog drains, the
    state = sim_cluster(seed=seed, n_ssd=0, fill=0.45)  # physical series
    events = _cadence(ticks)                            # converges
    events += [
        PoolGrowth(0, pool_id=0, bytes_per_tick=0.7 * TiB,
                   duration=ticks - drain, every=2),
        PoolGrowth(1, pool_id=1, bytes_per_tick=0.4 * TiB,
                   duration=ticks - drain, every=2),
    ]
    return state, events, SimConfig(ticks=ticks, throttle=_throttle(),
                                    moves_per_tick=32, equilibrium=_eq_cfg(), seed=seed)


@register("flash-expansion",
          "two new hosts land in quick succession on a filling cluster; "
          "CRUSH backfill and the balancer compete for bandwidth")
def flash_expansion(seed: int, quick: bool = False):
    ticks = _ticks(80, quick)
    drain = max(4, ticks // 4)
    state = sim_cluster(seed=seed, n_ssd=0, fill=0.65)
    t_add = max(3, ticks // 6)
    events = _cadence(ticks)
    events += [
        PoolGrowth(0, pool_id=0, bytes_per_tick=0.5 * TiB,
                   duration=ticks - drain, every=2),
        HostAdd(t_add, n_osds=3, capacity_each=10 * TiB, device_class="hdd"),
        HostAdd(t_add + 2, n_osds=3, capacity_each=10 * TiB,
                device_class="hdd"),
    ]
    # operators crank recovery limits during an expansion window
    return state, events, SimConfig(ticks=ticks,
                                    throttle=_throttle(16, 512 * GiB),
                                    moves_per_tick=32, equilibrium=_eq_cfg(),
                                    seed=seed)


@register("cascading-failures",
          "three staggered device failures; recovery spikes utilization on "
          "the survivors while the balancer re-levels")
def cascading_failures(seed: int, quick: bool = False):
    ticks = _ticks(50, quick)
    state = sim_cluster(seed=seed, fill=0.55)
    step = max(2, ticks // 6)
    events = _cadence(ticks)
    events += [
        DeviceFail(step, osd_id=2),
        DeviceFail(2 * step, osd_id=7),
        DeviceFail(3 * step, osd_id=13),
        PoolGrowth(0, pool_id=0, bytes_per_tick=0.25 * TiB,
                   duration=ticks, every=2),
    ]
    return state, events, SimConfig(ticks=ticks, throttle=_throttle(),
                                    moves_per_tick=32, equilibrium=_eq_cfg(), seed=seed)


@register("mixed-class-upgrade",
          "an HDD-only cluster gains SSD hosts and a new SSD pool; the "
          "balancer must keep both classes level independently")
def mixed_class_upgrade(seed: int, quick: bool = False):
    ticks = _ticks(50, quick)
    state = sim_cluster(seed=seed, n_ssd=0, fill=0.5)
    t0 = max(2, ticks // 8)
    events = _cadence(ticks)
    events += [
        HostAdd(t0, n_osds=2, capacity_each=3 * TiB, device_class="ssd"),
        HostAdd(t0 + 1, n_osds=2, capacity_each=3 * TiB, device_class="ssd"),
        HostAdd(t0 + 2, n_osds=2, capacity_each=3 * TiB, device_class="ssd"),
        PoolCreate(t0 + 3, name="fast", pg_count=64,
                   rule=PlacementRule.replicated(3, "host", "ssd"),
                   stored_bytes=0.05 * TiB),
        PoolGrowth(t0 + 4, pool_id=3, bytes_per_tick=0.2 * TiB,
                   duration=ticks - t0 - 4, every=2),
        PoolGrowth(0, pool_id=0, bytes_per_tick=0.3 * TiB,
                   duration=ticks, every=2),
    ]
    return state, events, SimConfig(ticks=ticks, throttle=_throttle(),
                                    moves_per_tick=32, equilibrium=_eq_cfg(), seed=seed)


@register("near-full-emergency",
          "a nearly full cluster takes a burst of writes; time above the "
          "fullness threshold is the figure of merit")
def near_full_emergency(seed: int, quick: bool = False):
    ticks = _ticks(40, quick)
    state = sim_cluster(seed=seed, fill=0.78)
    events = _cadence(ticks)
    events += [
        PoolGrowth(2, pool_id=0, bytes_per_tick=1.2 * TiB,
                   duration=max(4, ticks // 3), every=2),
    ]
    return state, events, SimConfig(ticks=ticks, throttle=_throttle(),
                                    moves_per_tick=48, equilibrium=_eq_cfg(),
                                    fullness_threshold=0.88, seed=seed)


@register("churn-heavy",
          "everything at once: growth, a drain, an expansion, a failure "
          "and a new pool inside one window")
def churn_heavy(seed: int, quick: bool = False):
    ticks = _ticks(60, quick)
    state = sim_cluster(seed=seed, fill=0.5)
    s = max(1, ticks // 10)
    events = _cadence(ticks)
    events += [
        PoolGrowth(0, pool_id=0, bytes_per_tick=0.4 * TiB,
                   duration=ticks, every=2),
        PoolGrowth(0, pool_id=1, bytes_per_tick=0.25 * TiB,
                   duration=ticks, every=2),
        DeviceOut(2 * s, osd_id=4),
        HostAdd(3 * s, n_osds=3, capacity_each=10 * TiB,
                device_class="hdd"),
        DeviceFail(4 * s, osd_id=11),
        PoolCreate(5 * s, name="scratch", pg_count=32,
                   rule=PlacementRule.replicated(3, "host", "hdd"),
                   stored_bytes=0.1 * TiB),
        PoolGrowth(5 * s + 1, pool_id=4, bytes_per_tick=0.2 * TiB,
                   duration=ticks - 5 * s - 1, every=2),
    ]
    return state, events, SimConfig(ticks=ticks, throttle=_throttle(),
                                    moves_per_tick=32, equilibrium=_eq_cfg(), seed=seed)


# ---------------------------------------------------------------------------


def run_scenario(name: str, balancer: str = "equilibrium_batch",
                 seed: int = 0, quick: bool = False, device=None) -> dict:
    """Build and run one scenario with one balancer; returns a JSON-able
    result dict (metrics series + summary).  ``device`` goes to the
    planner (see :class:`~repro_torch.sim.engine.ScenarioEngine`):
    ``None`` runs ``equilibrium_batch`` on the CUDA card."""
    scenario = SCENARIOS[name]
    state, events, cfg = scenario.build(seed, quick)
    cfg.balancer = balancer
    engine = ScenarioEngine(state, events, cfg, device=device)
    # counters=True: the span's args carry every registry increment made
    # over the run (rebuilds, syncs, absorb runs, moved bytes), so one
    # trace row summarizes the whole scenario for tools/tracestat.py
    with _obs.span("sim.scenario", cat="sim", counters=True,
                   scenario=name, balancer=balancer, seed=seed,
                   quick=quick) as sp:
        metrics = engine.run()
        sp.set(ticks=cfg.ticks)
    return {
        "scenario": name,
        "description": scenario.description,
        "balancer": balancer,
        "seed": seed,
        "quick": quick,
        "ticks": cfg.ticks,
        "metrics": metrics.to_dict(),
    }
