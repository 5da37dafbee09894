"""Equilibrium-planned MoE expert placement (the counterpart of
``src/repro/sharding/expert_placement.py``).

The mapping is exact, not metaphorical — we instantiate the paper's cluster
model on the training fleet and run the *same* balancer:

* OSD         → accelerator chip (capacity = HBM bytes budgeted for
                expert weights, scaled by serving load so "utilization"
                is load-aware)
* PG          → one expert of one MoE layer
* PG shard    → one replica of that expert
* CRUSH rule  → "R replicas on distinct hosts" (failure domain = host, so
                a host loss never removes every replica of an expert)
* shard size  → expert bytes × (1 + α·normalized token load) — the
                **size-aware** part: hot experts weigh more, so Equilibrium
                drains them off overloaded chips first

``plan()`` produces the initial placement (CRUSH pseudo-random, as Ceph
would); ``rebalance()`` emits explicit expert-migration instructions with
their byte cost — the paper's "more capacity, less movement" objective
becomes "more HBM headroom per chip, fewer expert-weight copies over the
interconnect".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import (ClusterState, Device, EquilibriumConfig, Movement,
                    PlacementRule, Pool, build_cluster)
from ..core.planner import create_planner


@dataclass
class ExpertClusterSpec:
    n_chips: int
    chips_per_host: int = 4
    hbm_budget_bytes: float = 8e9          # HBM reserved for expert weights
    replicas: int = 2
    load_alpha: float = 1.0                # weight of load in shard size


@dataclass
class ExpertPlacement:
    """assignment[(layer, expert, replica)] -> chip index."""
    spec: ExpertClusterSpec
    n_layers: int
    n_experts: int
    state: ClusterState

    def assignment(self) -> np.ndarray:
        out = np.zeros((self.n_layers, self.n_experts, self.spec.replicas),
                       dtype=np.int64)
        for (pool_id, pg), osds in self.state.acting.items():
            out[pool_id, pg, :] = osds
        return out

    def chip_utilization(self) -> np.ndarray:
        return self.state.utilization()


def _chips(spec: ExpertClusterSpec) -> list[Device]:
    return [Device(id=i, capacity=spec.hbm_budget_bytes, device_class="hbm",
                   host=f"host{i // spec.chips_per_host:04d}")
            for i in range(spec.n_chips)]


def _pools(n_layers: int, n_experts: int, expert_bytes: float,
           spec: ExpertClusterSpec) -> list[Pool]:
    rule = PlacementRule.replicated(spec.replicas, "host", "hbm")
    # stored_bytes so that nominal shard size == expert_bytes:
    # nominal = stored / pg_count (replicated pools)
    return [Pool(l, f"moe-layer{l}", n_experts, rule,
                 stored_bytes=expert_bytes * n_experts)
            for l in range(n_layers)]


def plan(n_layers: int, n_experts: int, expert_bytes: float,
         spec: ExpertClusterSpec, seed: int = 0) -> ExpertPlacement:
    """Initial CRUSH-style placement (capacity-weighted pseudo-random, one
    replica per host) — deliberately imbalanced, like a fresh Ceph pool."""
    state = build_cluster(_chips(spec), _pools(n_layers, n_experts,
                                               expert_bytes, spec),
                          seed=seed, size_jitter=0.0)
    return ExpertPlacement(spec, n_layers, n_experts, state)


def apply_loads(placement: ExpertPlacement, loads: np.ndarray,
                expert_bytes: float) -> None:
    """Fold measured token loads (L, E) into shard sizes:
    size = bytes × (1 + α·load/mean_load).  Re-derives device usage."""
    spec = placement.spec
    mean = max(float(loads.mean()), 1e-9)
    sizes = expert_bytes * (1.0 + spec.load_alpha * loads / mean)
    state = placement.state
    new_sizes = {pg: float(sizes[pg[0], pg[1]]) for pg in state.acting}
    placement.state = ClusterState(state.devices, list(state.pools.values()),
                                   state.acting, new_sizes)


def rebalance(placement: ExpertPlacement,
              cfg: EquilibriumConfig | None = None) -> list[Movement]:
    """Equilibrium pass: explicit expert-replica migrations, fullest chip
    drained first, host-disjointness preserved, load variance minimized."""
    cfg = cfg or EquilibriumConfig(k=16)
    movements = create_planner("equilibrium",
                               cfg=cfg).plan(placement.state).moves
    return movements


def migration_bytes(movements: list[Movement]) -> float:
    return float(sum(m.size for m in movements))
