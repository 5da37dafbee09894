"""Failure recovery: re-replicate lost shards, then rebalance (the
counterpart of ``src/repro/ft/recovery.py``).

When a device dies, every shard it held loses one replica.  Recovery uses
the *same destination criteria as Equilibrium's §3.1* — emptiest legal
device first, CRUSH rule respected — so recovery traffic lands where there
is headroom instead of re-overloading hot devices (the classic Ceph
backfill pathology the paper's users see).  Afterwards an optional
Equilibrium pass smooths the post-recovery distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import ClusterState, EquilibriumConfig, Movement
from ..core.planner import create_planner


@dataclass
class RecoveryPlan:
    re_replications: list[Movement]     # lost-replica rebuilds (src = dead)
    rebalance: list[Movement]           # post-recovery Equilibrium moves
    unrecoverable: list                 # (pg, slot) with no legal target

    @property
    def recovery_bytes(self) -> float:
        return float(sum(m.size for m in self.re_replications))

    @property
    def rebalance_bytes(self) -> float:
        return float(sum(m.size for m in self.rebalance))


def plan_recovery(state: ClusterState, failed_osd: int,
                  rebalance: bool = True,
                  cfg: EquilibriumConfig | None = None) -> RecoveryPlan:
    """Plan replica rebuilds for every shard on ``failed_osd``.

    The state is mutated to the recovered layout (like the balancers, the
    planner works against its own projected state).
    """
    lost = sorted(state.shards_on[failed_osd])
    re_reps: list[Movement] = []
    unrecoverable = []
    util = state.utilization()
    for (pg, slot) in lost:
        order = np.argsort(util, kind="stable")
        placed = False
        for di in order:
            dst = state.devices[int(di)].id
            if dst == failed_osd:
                continue
            if state.move_is_legal(pg, slot, dst):
                mv = Movement(pg, slot, failed_osd, dst, state.shard_sizes[pg])
                state.apply(mv)
                util = state.utilization()
                re_reps.append(mv)
                placed = True
                break
        if not placed:
            unrecoverable.append((pg, slot))

    moves: list[Movement] = []
    if rebalance:
        # rebalance the surviving membership: rebuild the cluster view
        # without the dead device (it holds nothing after re-replication)
        # so Equilibrium cannot pick it as a destination.
        survivors = [d for d in state.devices if d.id != failed_osd]
        surv_state = ClusterState(survivors, list(state.pools.values()),
                                  state.acting, state.shard_sizes)
        cfg = cfg or EquilibriumConfig(k=8)
        moves = create_planner("equilibrium", cfg=cfg).plan(surv_state).moves
        for mv in moves:
            state.apply(mv)
    return RecoveryPlan(re_reps, moves, unrecoverable)
