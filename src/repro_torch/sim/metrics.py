"""Time-series metrics for lifecycle scenarios.

The collector samples the cluster once per tick on **physical** occupancy
(target map corrected by the throttle's in-flight transfers — what a real
``ceph osd df`` would show), restricted to in (weighted) devices:

* utilization variance (physical and target-map),
* max device utilization + count of devices above the fullness threshold,
* cumulative ticks with any device above the threshold (the paper's
  "cluster is effectively full when one device is" §2.2, over time),
* per-pool max-avail on physical occupancy (a pool created mid-scenario
  has a shorter, right-aligned series starting at its creation tick),
* cumulative transferred bytes / planned moves / backlog depth,
* degraded shards (re-placement found no legal destination).

``to_dict`` is pure built-ins so ``json.dumps(..., sort_keys=True)`` is
byte-stable for identical runs — the deterministic-replay guarantee is
regression-tested in tests/test_scenarios.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.cluster import ClusterState
from ..core.simulate import MovementThrottle


@dataclass
class MetricsCollector:
    fullness_threshold: float = 0.85

    ticks: list[int] = field(default_factory=list)
    variance: list[float] = field(default_factory=list)
    variance_target: list[float] = field(default_factory=list)
    max_util: list[float] = field(default_factory=list)
    overfull_devices: list[int] = field(default_factory=list)
    pool_max_avail: dict[int, list[float]] = field(default_factory=dict)
    transferred_bytes: list[float] = field(default_factory=list)
    planned_moves: list[int] = field(default_factory=list)
    backlog_moves: list[int] = field(default_factory=list)
    degraded: list[int] = field(default_factory=list)
    event_log: list[tuple[int, str]] = field(default_factory=list)

    def log_event(self, tick: int, description: str) -> None:
        self.event_log.append((tick, description))

    def collect(self, tick: int, state: ClusterState,
                throttle: MovementThrottle, planned_moves: int,
                degraded: int) -> None:
        cap = state.capacity_vector()
        phys = throttle.physical_used(state)
        util = phys / cap
        mask = state.in_mask()
        util_in = util[mask] if mask.any() else util
        self.ticks.append(tick)
        self.variance.append(float(np.var(util_in)))
        tgt = state.used() / cap
        self.variance_target.append(float(np.var(tgt[mask]))
                                    if mask.any() else float(np.var(tgt)))
        self.max_util.append(float(util_in.max()) if util_in.size else 0.0)
        self.overfull_devices.append(
            int((util_in > self.fullness_threshold).sum()))
        free = np.maximum(cap - phys, 0.0)
        for pid, pool in sorted(state.pools.items()):
            growth = state.pool_growth_vector(pool)
            eligible = growth > 0
            avail = (float(np.min(free[eligible] / growth[eligible]))
                     if eligible.any() else 0.0)
            self.pool_max_avail.setdefault(pid, []).append(avail)
        self.transferred_bytes.append(float(throttle.transferred_bytes))
        self.planned_moves.append(int(planned_moves))
        self.backlog_moves.append(int(throttle.backlog_moves))
        self.degraded.append(int(degraded))

    # -- aggregation ---------------------------------------------------------

    @property
    def ticks_above_threshold(self) -> int:
        return sum(1 for n in self.overfull_devices if n > 0)

    def summary(self) -> dict:
        if not self.ticks:
            return {}
        return {
            "ticks": len(self.ticks),
            "final_variance": self.variance[-1],
            "final_variance_target": self.variance_target[-1],
            "final_max_util": self.max_util[-1],
            "mean_variance": float(np.mean(self.variance)),
            "total_transferred_bytes": self.transferred_bytes[-1],
            "total_planned_moves": self.planned_moves[-1],
            "ticks_above_threshold": self.ticks_above_threshold,
            "final_degraded": self.degraded[-1],
            "min_pool_max_avail": {
                str(pid): min(series)
                for pid, series in sorted(self.pool_max_avail.items())
            },
        }

    def to_dict(self) -> dict:
        return {
            "ticks": list(self.ticks),
            "variance": list(self.variance),
            "variance_target": list(self.variance_target),
            "max_util": list(self.max_util),
            "overfull_devices": list(self.overfull_devices),
            "pool_max_avail": {str(pid): list(series) for pid, series
                               in sorted(self.pool_max_avail.items())},
            "transferred_bytes": list(self.transferred_bytes),
            "planned_moves": list(self.planned_moves),
            "backlog_moves": list(self.backlog_moves),
            "degraded": list(self.degraded),
            "events": [[t, d] for t, d in self.event_log],
            "summary": self.summary(),
        }
