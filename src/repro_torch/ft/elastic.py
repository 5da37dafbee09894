"""Elastic rescale with minimal data movement (the counterpart of
``src/repro/ft/elastic.py``).

Scale-up is *literally* an Equilibrium run: new devices join empty, are
therefore the emptiest candidates, and the balancer migrates exactly the
largest shards off the fullest incumbents until variance converges —
bounded, explicit movement instead of the full reshuffle a from-scratch
CRUSH re-placement would cause (the paper's movement-reduction claim in
elastic form).

Scale-down evacuates depart-listed devices with Equilibrium's destination
criteria (emptiest legal survivor), then smooths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import ClusterState, Device, EquilibriumConfig, Movement
from ..core.planner import create_planner


@dataclass
class RescalePlan:
    movements: list[Movement]
    moved_bytes: float
    total_bytes: float
    variance_before: float
    variance_after: float

    @property
    def moved_fraction(self) -> float:
        return self.moved_bytes / max(self.total_bytes, 1e-9)


def plan_rescale(state: ClusterState, add_devices: list[Device] = (),
                 remove_osds: list[int] = (),
                 cfg: EquilibriumConfig | None = None) -> RescalePlan:
    """Plan membership change; mutates ``state`` to the target layout."""
    cfg = cfg or EquilibriumConfig(k=16)
    total = float(sum(state.shard_sizes[pg] * len(osds)
                      for pg, osds in state.acting.items()))
    var_before = state.utilization_variance()
    movements: list[Movement] = []

    # 1. evacuation of departing devices (forced moves, emptiest-legal-first)
    devices = [d for d in state.devices if d.id not in set(remove_osds)]
    devices += list(add_devices)
    work = ClusterState(devices + [d for d in state.devices
                                   if d.id in set(remove_osds)],
                        list(state.pools.values()),
                        state.acting, state.shard_sizes)
    for dead in remove_osds:
        for (pg, slot) in sorted(work.shards_on[dead],
                                 key=lambda s: -work.shard_sizes[s[0]]):
            util = work.utilization()
            order = np.argsort(util, kind="stable")
            for di in order:
                dst = work.devices[int(di)].id
                if dst in set(remove_osds) or dst == dead:
                    continue
                if work.move_is_legal(pg, slot, dst):
                    mv = Movement(pg, slot, dead, dst, work.shard_sizes[pg])
                    work.apply(mv)
                    movements.append(mv)
                    break
            else:
                raise RuntimeError(f"cannot evacuate {pg}:{slot} from {dead}")

    # 2. Equilibrium smoothing over the new membership (scale-up: this is
    #    the whole plan — empty joiners pull the largest shards first)
    final = ClusterState(devices, list(state.pools.values()),
                         work.acting, work.shard_sizes)
    moves = create_planner("equilibrium", cfg=cfg).plan(final).moves
    movements += moves

    moved = float(sum(m.size for m in movements))
    return RescalePlan(movements, moved, total, var_before,
                       final.utilization_variance())


def naive_rescale_bytes(state: ClusterState, add_devices: list[Device] = (),
                        remove_osds: list[int] = (), seed: int = 0) -> float:
    """Bytes a from-scratch CRUSH re-placement would move (baseline for the
    movement-reduction comparison)."""
    from ..core.crush import place_pg
    devices = [d for d in state.devices if d.id not in set(remove_osds)]
    devices += list(add_devices)
    moved = 0.0
    for pg, osds in state.acting.items():
        pool = state.pools[pg[0]]
        new = place_pg(devices, pool, pg[1], seed=seed)
        stay = set(osds) & set(new)
        moved += state.shard_sizes[pg] * (pool.size - len(stay))
    return float(moved)
