"""Event vocabulary for the cluster lifecycle simulator.

Every event is a frozen dataclass pinned to a simulation ``tick``.  The
paper evaluates Equilibrium on frozen snapshots; these events are the
things that *unfreeze* a cluster — the lifecycle transitions ASURA
(arXiv:1309.7720) and the rebalancing-cost literature (arXiv:2205.06257)
study — and the scenario engine (:mod:`repro_torch.sim.engine`)
interprets them against a :class:`repro_torch.core.ClusterState`:

* :class:`PoolGrowth` — sustained ingest: a pool's shards inflate by the
  pool's growth factor for ``duration`` ticks (every ``every``-th tick).
* :class:`PoolCreate` — a new pool appears and is CRUSH-placed on the
  current topology.
* :class:`DeviceAdd` / :class:`HostAdd` — expansion; CRUSH re-places a
  capacity-weighted subset of existing shards onto the new devices, as
  backfill through the movement throttle.
* :class:`DeviceOut` — graceful drain: weight to 0, shards re-placed and
  transferred off (the device keeps serving until each transfer lands).
* :class:`DeviceFail` — abrupt loss: weight to 0, physical bytes gone,
  shards re-placed with recovery reads from surviving peers.
* :class:`ForeignMovement` — interleaved upmaps from outside the
  balancer (seeded random legal movements), the cross-client traffic a
  warm planner must absorb without a rebuild.
* :class:`RebalanceTick` — invoke the scenario's registered balancer with
  a per-tick move budget.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cluster import PlacementRule


@dataclass(frozen=True)
class Event:
    """Base: something that happens to the cluster at ``tick``."""

    tick: int


@dataclass(frozen=True)
class PoolGrowth(Event):
    """Ingest ``bytes_per_tick`` user bytes into ``pool_id`` on each
    matching tick in ``[tick, tick + duration)``; ``every`` thins the
    cadence (2 = every other tick), which also leaves quiet ticks where a
    warm-started planner can reuse its dense state."""

    pool_id: int = 0
    bytes_per_tick: float = 0.0
    duration: int = 1
    every: int = 1

    def applies_at(self, t: int) -> bool:
        return (self.tick <= t < self.tick + self.duration
                and (t - self.tick) % self.every == 0)


@dataclass(frozen=True)
class PoolCreate(Event):
    """Create a pool (CRUSH-placed on the in-devices at event time).
    ``stored_bytes`` appears in place without transfer — a new pool is
    written, not backfilled; keep it small and grow it with
    :class:`PoolGrowth`."""

    pool_id: int = -1
    name: str = "pool"
    pg_count: int = 32
    rule: PlacementRule | None = None
    stored_bytes: float = 0.0
    ec_k: int = 0
    is_user_data: bool = True


@dataclass(frozen=True)
class DeviceAdd(Event):
    """Add one OSD (id assigned by the engine)."""

    capacity: float = 0.0
    device_class: str = "hdd"
    host: str = ""
    rack: str = "rack0"


@dataclass(frozen=True)
class HostAdd(Event):
    """Add a whole host of ``n_osds`` identical OSDs (one new failure
    domain); host name auto-generated when empty."""

    n_osds: int = 0
    capacity_each: float = 0.0
    device_class: str = "hdd"
    host: str = ""
    rack: str = ""


@dataclass(frozen=True)
class DeviceOut(Event):
    """Graceful drain: weight the OSD out and backfill its shards away."""

    osd_id: int = -1


@dataclass(frozen=True)
class DeviceFail(Event):
    """Abrupt loss: the OSD's data is gone; recovery re-reads from peers."""

    osd_id: int = -1


@dataclass(frozen=True)
class ForeignMovement(Event):
    """``count`` random-but-legal shard movements applied outside any
    planner — another client of the upmap channel (a manual ``ceph osd
    pg-upmap-items``, a different balancer module).  Drawn from the
    engine's seeded rng, applied to the target map and backfilled
    through the throttle like any planner move."""

    count: int = 1


@dataclass(frozen=True)
class RebalanceTick(Event):
    """Run the scenario's balancer; ``max_moves`` overrides the per-tick
    budget from :class:`repro_torch.sim.engine.SimConfig` when >= 0."""

    max_moves: int = -1
