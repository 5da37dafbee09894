"""Equilibrium-planned checkpoint-shard placement (the counterpart of
``src/repro/checkpoint/placement.py``).

Checkpoint writes are gated exactly like Ceph capacity: the fullest
storage host decides whether the next full checkpoint fits.  Mapping:

* OSD        → storage host (heterogeneous capacities are the norm)
* PG         → one parameter-leaf shard file
* PG shard   → one replica of that file (R replicas, rack failure domain)
* shard size → file bytes (leaves differ by orders of magnitude — embed
               tables vs norm scales — so count-balancing would skew badly;
               this is the paper's size-aware case verbatim)

``plan_placement`` does CRUSH-style initial placement then an Equilibrium
pass; steady-state checkpoint loops call ``rebalance`` after membership
changes (host loss / join) and get minimal-movement migration plans.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import (ClusterState, Device, EquilibriumConfig, Movement,
                    PlacementRule, Pool, build_cluster)
from ..core.planner import create_planner


@dataclass(frozen=True)
class StorageHost:
    name: str
    capacity: float
    rack: str = "rack0"


@dataclass
class CheckpointPlacement:
    hosts: list[StorageHost]
    replicas: int
    state: ClusterState
    shard_names: list[str]                  # pg index -> shard name

    def hosts_of(self, shard_name: str) -> list[str]:
        pg = (0, self.shard_names.index(shard_name))
        return [self.hosts[i].name for i in self.state.acting[pg]]

    def assignment(self) -> dict[str, list[str]]:
        return {name: self.hosts_of(name) for name in self.shard_names}

    def utilization(self) -> np.ndarray:
        return self.state.utilization()


def plan_placement(shards: dict[str, float], hosts: list[StorageHost],
                   replicas: int = 2, seed: int = 0,
                   balance: bool = True) -> CheckpointPlacement:
    """``shards``: name → bytes.  Returns placement with ≥``replicas``
    copies of each shard on distinct racks when possible, else hosts."""
    racks = {h.rack for h in hosts}
    domain = "rack" if len(racks) >= replicas else "host"
    devices = [Device(id=i, capacity=h.capacity, device_class="disk",
                      host=h.name, rack=h.rack)
               for i, h in enumerate(hosts)]
    names = sorted(shards)
    pool = Pool(0, "ckpt", len(names),
                PlacementRule.replicated(replicas, domain, "disk"),
                stored_bytes=float(sum(shards.values())))
    state = build_cluster(devices, [pool], seed=seed, size_jitter=0.0)
    # overwrite the uniform nominal sizes with the real per-shard bytes
    sizes = {(0, i): float(shards[name]) for i, name in enumerate(names)}
    state = ClusterState(devices, [pool], state.acting, sizes)
    placement = CheckpointPlacement(hosts, replicas, state, names)
    if balance:
        rebalance(placement)
    return placement


def rebalance(placement: CheckpointPlacement,
              cfg: EquilibriumConfig | None = None) -> list[Movement]:
    cfg = cfg or EquilibriumConfig(k=8, count_slack=1e9)
    movements = create_planner("equilibrium",
                               cfg=cfg).plan(placement.state).moves
    return movements
