"""Cluster state model: devices (OSDs), pools, placement groups, shards.

This is the data model both balancers (the ``mgr`` baseline and
``Equilibrium``) operate on, mirroring the entities of a Ceph cluster as
described in the paper (§2.1):

* A :class:`Device` is an OSD: capacity, device class (hdd/ssd/nvme) and a
  position in the failure-domain hierarchy (datacenter → rack → host → osd).
* A :class:`Pool` groups ``pg_count`` placement groups under a
  :class:`PlacementRule` (the CRUSH rule): replicated (``size`` copies) or
  erasure-coded (``k + m`` shards), each shard on a distinct failure domain.
* A :class:`ClusterState` holds the shard→device mapping plus per-device
  accounting, and can answer the two questions balancing cares about:
  per-pool *max-avail* free space (gated by the fullest participating
  device, §2.2) and the cluster-wide utilization variance.

Everything is plain Python + NumPy; the vectorized planner
(:mod:`repro_torch.core.dense`) builds dense views from this model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

TiB = 1024.0**4
GiB = 1024.0**3

# --------------------------------------------------------------------------
# Topology


@dataclass(frozen=True)
class Device:
    """An OSD: one physical storage device in the cluster."""

    id: int
    capacity: float                 # bytes
    device_class: str               # "hdd" | "ssd" | "nvme"
    host: str
    rack: str = "rack0"
    datacenter: str = "dc0"

    def domain(self, level: str) -> str:
        """Failure-domain token of this device at ``level``."""
        if level == "osd":
            return f"osd.{self.id}"
        if level == "host":
            return self.host
        if level == "rack":
            return self.rack
        if level == "datacenter":
            return self.datacenter
        raise ValueError(f"unknown failure-domain level: {level!r}")


@dataclass(frozen=True)
class RuleStep:
    """One step of a placement rule: pick ``count`` shards from devices of
    ``device_class`` (None = any class), at most one per ``failure_domain``.

    A plain replicated rule is a single step, e.g. ``RuleStep(None, 3,
    "host")``.  Cluster D's hybrid rule (§3.2) is two steps:
    ``[RuleStep("ssd", 1, "host"), RuleStep("hdd", 2, "host")]``.
    """

    device_class: str | None
    count: int
    failure_domain: str = "host"


@dataclass(frozen=True)
class PlacementRule:
    steps: tuple[RuleStep, ...]

    @property
    def size(self) -> int:
        return sum(s.count for s in self.steps)

    @staticmethod
    def replicated(size: int, failure_domain: str = "host",
                   device_class: str | None = None) -> "PlacementRule":
        return PlacementRule((RuleStep(device_class, size, failure_domain),))

    @staticmethod
    def erasure(k: int, m: int, failure_domain: str = "host",
                device_class: str | None = None) -> "PlacementRule":
        return PlacementRule((RuleStep(device_class, k + m, failure_domain),))

    @staticmethod
    def hybrid(steps: Sequence[RuleStep]) -> "PlacementRule":
        return PlacementRule(tuple(steps))

    def step_of_slot(self, slot: int) -> RuleStep:
        """Rule step governing shard index ``slot`` within a PG."""
        for step in self.steps:
            if slot < step.count:
                return step
            slot -= step.count
        raise IndexError("slot out of range for rule")


@dataclass(frozen=True)
class Pool:
    """A Ceph pool: ``pg_count`` PGs placed under ``rule``.

    ``ec_k`` > 0 marks an erasure-coded pool with k data shards (then the
    rule size is k+m); ec_k == 0 means replication (each shard stores the
    full PG payload).
    """

    id: int
    name: str
    pg_count: int
    rule: PlacementRule
    ec_k: int = 0                   # 0 => replicated
    stored_bytes: float = 0.0       # user bytes stored in the pool
    is_user_data: bool = True

    @property
    def size(self) -> int:
        return self.rule.size

    @property
    def shard_growth_factor(self) -> float:
        """Bytes a single shard grows per user byte written to the pool.

        Replicated: each PG receives 1/pg_count of new data and every
        replica shard stores all of it.  EC(k,m): each shard stores 1/k of
        its PG's payload.
        """
        per_pg = 1.0 / self.pg_count
        return per_pg if self.ec_k == 0 else per_pg / self.ec_k

    @property
    def nominal_shard_size(self) -> float:
        return self.stored_bytes * self.shard_growth_factor


PGId = tuple[int, int]              # (pool_id, pg_index)


# --------------------------------------------------------------------------
# Cluster state


@dataclass
class Movement:
    """One upmap instruction: move ``pg``'s shard in ``slot`` from
    ``src_osd`` to ``dst_osd`` (``ceph osd pg-upmap-items`` semantics)."""

    pg: PGId
    slot: int
    src_osd: int
    dst_osd: int
    size: float                      # shard bytes moved


# --------------------------------------------------------------------------
# Cluster deltas — the typed mutation vocabulary of the planner API
#
# Every ClusterState mutator emits exactly one delta per mutation_epoch
# bump to its subscribers, so an incremental planner can reconstruct *what
# changed* between two epochs instead of diffing snapshots.  The taxonomy
# is re-exported by :mod:`repro_torch.core.planner` (the API home); see
# ``Planner.observe``.


@dataclass(frozen=True)
class ClusterDelta:
    """Base: one state mutation.  ``epoch`` is ``mutation_epoch`` *after*
    the mutation, so a subscriber that has seen every delta in
    ``(synced_epoch, state.mutation_epoch]`` has seen every change."""

    epoch: int


@dataclass(frozen=True)
class MovementDelta(ClusterDelta):
    """One applied shard movement (:meth:`ClusterState.apply`)."""

    movement: Movement


@dataclass(frozen=True)
class PoolGrowthDelta(ClusterDelta):
    """``user_bytes`` ingested into ``pool_id``: every shard of the pool
    grew by the pool's per-shard growth factor."""

    pool_id: int
    user_bytes: float


@dataclass(frozen=True)
class DeviceAddDelta(ClusterDelta):
    """``device`` joined the cluster empty (expansion)."""

    device: Device


@dataclass(frozen=True)
class DeviceOutDelta(ClusterDelta):
    """``osd_id`` weighted out (``out=True``) or back in (``out=False``)."""

    osd_id: int
    out: bool


@dataclass(frozen=True)
class PoolCreateDelta(ClusterDelta):
    """Pool ``pool_id`` registered with its CRUSH-placed acting sets."""

    pool_id: int


class ClusterState:
    """Mutable placement state + accounting.

    ``acting[(pool, pg)]`` is the ordered list of OSD ids holding the PG's
    shards (slot i = i-th shard of the rule).  ``shard_sizes[(pool, pg)]``
    gives per-shard bytes (equal within a PG for replication; 1/k of the PG
    payload for EC — per the paper, shard sizes within a pool are almost
    equal, so sizes vary per-PG via jitter, not per-slot).
    """

    def __init__(self, devices: Sequence[Device], pools: Sequence[Pool],
                 acting: dict[PGId, list[int]],
                 shard_sizes: dict[PGId, float],
                 out_osds: Iterable[int] = ()):
        self.devices: list[Device] = list(devices)
        self.pools: dict[int, Pool] = {p.id: p for p in pools}
        self.acting: dict[PGId, list[int]] = {k: list(v) for k, v in acting.items()}
        self.shard_sizes: dict[PGId, float] = dict(shard_sizes)
        self.dev_by_id: dict[int, Device] = {d.id: d for d in self.devices}
        # OSDs marked "out" (weight 0): excluded from ideal counts, pool
        # growth, and move destinations — a draining or failed device.
        self.out_osds: set[int] = set(out_osds)
        # Bumped on every mutation (apply / add_device / mark_out /
        # grow_pool / add_pool): lets incremental planners detect that their
        # dense mirror of this state went stale (see BatchPlanner).
        self.mutation_epoch: int = 0
        # Delta subscribers (see subscribe()): each mutator emits exactly
        # one ClusterDelta per epoch bump, so subscribed planners can
        # replan incrementally instead of rebuilding from a snapshot.
        # Copies start with no subscribers.
        self._subscribers: list = []

        self._capacity = np.array([d.capacity for d in self.devices], dtype=np.float64)
        self._id_to_idx = {d.id: i for i, d in enumerate(self.devices)}
        self._used = np.zeros(len(self.devices), dtype=np.float64)
        # per-device shard registry: osd id -> set of (pg, slot)
        self.shards_on: dict[int, set[tuple[PGId, int]]] = {d.id: set() for d in self.devices}
        # per-pool per-device shard counts: pool -> np.array[n_dev]
        self.pool_counts: dict[int, np.ndarray] = {
            p: np.zeros(len(self.devices), dtype=np.int64) for p in self.pools
        }
        # per-pool PG registry (maintained by add_pool; pool membership of a
        # PG never changes after creation)
        self.pgs_of_pool: dict[int, list[PGId]] = {p: [] for p in self.pools}
        for pg in sorted(self.acting):
            self.pgs_of_pool[pg[0]].append(pg)
        for pg, osds in self.acting.items():
            size = self.shard_sizes[pg]
            for slot, osd in enumerate(osds):
                self._used[self._id_to_idx[osd]] += size
                self.shards_on[osd].add((pg, slot))
                self.pool_counts[pg[0]][self._id_to_idx[osd]] += 1

    # -- plumbing ----------------------------------------------------------

    def subscribe(self, fn) -> None:
        """Register ``fn(delta: ClusterDelta)`` to be called on every
        mutation.  A callback that returns ``False`` is pruned (the hook
        for weakly-bound subscribers whose owner died); any other return
        value keeps it registered."""
        self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        try:
            self._subscribers.remove(fn)
        except ValueError:
            pass

    def _notify(self, delta: ClusterDelta) -> None:
        for fn in list(self._subscribers):
            if fn(delta) is False:
                self.unsubscribe(fn)

    def idx(self, osd_id: int) -> int:
        return self._id_to_idx[osd_id]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def copy(self) -> "ClusterState":
        return ClusterState(self.devices, list(self.pools.values()),
                            self.acting, self.shard_sizes, self.out_osds)

    # -- plain form (carrying a state across packages) -----------------------

    def to_plain(self) -> dict:
        """The state as dicts, lists and NumPy arrays only: devices with
        every field, pools with their rules, ``acting`` in insertion
        order, shard sizes, out OSDs, the per-device ``used`` bytes and
        the mutation epoch.  :meth:`from_plain` rebuilds an equal state
        from it; a reference ``repro.core.cluster.ClusterState`` turned
        into the same form (field for field) rebuilds here bit-identically.

        ``used`` is carried as the array itself: moves and pool growth
        update it incrementally, and re-summing the shard sizes can
        differ from that in the last bit."""
        return {
            "devices": [dataclasses.asdict(d) for d in self.devices],
            "pools": [{"id": p.id, "name": p.name, "pg_count": p.pg_count,
                       "rule": [dataclasses.asdict(s) for s in p.rule.steps],
                       "ec_k": p.ec_k, "stored_bytes": p.stored_bytes,
                       "is_user_data": p.is_user_data}
                      for p in self.pools.values()],
            "acting": {pg: list(osds) for pg, osds in self.acting.items()},
            "shard_sizes": dict(self.shard_sizes),
            "out_osds": sorted(self.out_osds),
            "used": self._used.copy(),
            "mutation_epoch": self.mutation_epoch,
        }

    @classmethod
    def from_plain(cls, d: dict) -> "ClusterState":
        """Rebuild a state from :meth:`to_plain`'s form.  Shards are
        accounted in ``acting`` order, as ``__init__`` always does; the
        carried ``used`` then replaces the re-summed bytes."""
        devices = [Device(**x) for x in d["devices"]]
        pools = [Pool(id=p["id"], name=p["name"], pg_count=p["pg_count"],
                      rule=PlacementRule(tuple(RuleStep(**s)
                                               for s in p["rule"])),
                      ec_k=p["ec_k"], stored_bytes=p["stored_bytes"],
                      is_user_data=p["is_user_data"])
                 for p in d["pools"]]
        state = cls(devices, pools, d["acting"], d["shard_sizes"],
                    d["out_osds"])
        used = np.asarray(d["used"], dtype=np.float64)
        if used.shape != state._used.shape:
            raise ValueError(f"plain state: used has shape {used.shape}, "
                             f"expected {state._used.shape}")
        state._used = used.copy()
        state.mutation_epoch = int(d["mutation_epoch"])
        return state

    def in_mask(self) -> np.ndarray:
        """Boolean per-device vector: True for weighted ("in") devices."""
        if not self.out_osds:
            return np.ones(self.n_devices, dtype=bool)
        return np.array([d.id not in self.out_osds for d in self.devices])

    # -- accounting --------------------------------------------------------

    def used(self, osd_id: int | None = None):
        if osd_id is None:
            return self._used.copy()
        return float(self._used[self._id_to_idx[osd_id]])

    def capacity_vector(self) -> np.ndarray:
        return self._capacity.copy()

    def utilization(self, osd_id: int | None = None):
        """Relative utilization used/capacity (the paper's sort key)."""
        if osd_id is None:
            return self._used / self._capacity
        i = self._id_to_idx[osd_id]
        return float(self._used[i] / self._capacity[i])

    def utilization_variance(self, device_class: str | None = None) -> float:
        util = self._used / self._capacity
        if device_class is not None:
            mask = np.array([d.device_class == device_class for d in self.devices])
            if not mask.any():
                return 0.0
            util = util[mask]
        return float(np.var(util))

    def eligible_devices(self, pool: Pool) -> list[Device]:
        """Devices legal for *some* slot of the pool's rule (class filter)."""
        classes = {s.device_class for s in pool.rule.steps}
        if None in classes:
            return list(self.devices)
        return [d for d in self.devices if d.device_class in classes]

    def ideal_shard_count(self, pool: Pool) -> np.ndarray:
        """Per-device ideal PG-shard count for ``pool`` (§2.2):
        total shards × (device share of eligible capacity), class-aware —
        for hybrid rules each step's shards are apportioned within its own
        device class."""
        ideal = np.zeros(self.n_devices, dtype=np.float64)
        in_mask = self.in_mask()
        for step in pool.rule.steps:
            if step.device_class is None:
                mask = in_mask.copy()
            else:
                mask = np.array([d.device_class == step.device_class
                                 for d in self.devices]) & in_mask
            cap = np.where(mask, self._capacity, 0.0)
            total = cap.sum()
            if total <= 0:
                continue
            ideal += pool.pg_count * step.count * cap / total
        return ideal

    def pool_growth_vector(self, pool: Pool) -> np.ndarray:
        """Bytes device i stores per user byte written to ``pool``, under
        CRUSH's capacity-weighted distribution of future writes (this is
        what Ceph's ``MAX AVAIL`` assumes).  Replicated: each of the rule's
        shards stores the full payload; EC(k,m): each shard stores 1/k."""
        growth = np.zeros(self.n_devices, dtype=np.float64)
        in_mask = self.in_mask()
        payload_per_shard = 1.0 if pool.ec_k == 0 else 1.0 / pool.ec_k
        for step in pool.rule.steps:
            if step.device_class is None:
                mask = in_mask.copy()
            else:
                mask = np.array([d.device_class == step.device_class
                                 for d in self.devices]) & in_mask
            cap = np.where(mask, self._capacity, 0.0)
            total = cap.sum()
            if total <= 0:
                continue
            growth += step.count * payload_per_shard * cap / total
        return growth

    def pool_free_space(self, pool_id: int) -> float:
        """Max-avail of a pool, Ceph semantics: the most-filled eligible
        device gates how much more user data fits (§2.2).
        ``free = min_i device_free_i / growth_i`` over devices with
        ``growth_i > 0`` — maximal exactly when utilization is equal across
        eligible devices, which is the paper's core premise."""
        pool = self.pools[pool_id]
        growth = self.pool_growth_vector(pool)
        eligible = growth > 0
        if not eligible.any():
            return 0.0
        free = np.maximum(self._capacity - self._used, 0.0)
        return float(np.min(free[eligible] / growth[eligible]))

    def total_pool_free_space(self, user_data_only: bool = True) -> float:
        return sum(self.pool_free_space(pid)
                   for pid, p in self.pools.items()
                   if p.is_user_data or not user_data_only)

    # -- placement legality -------------------------------------------------

    def slot_rule_step(self, pg: PGId, slot: int) -> RuleStep:
        return self.pools[pg[0]].rule.step_of_slot(slot)

    def move_is_legal(self, pg: PGId, slot: int, dst_osd: int,
                      headroom: float = 0.0) -> bool:
        """Would moving ``pg``'s shard ``slot`` to ``dst_osd`` keep the
        placement valid?

        * destination must match the slot's device class,
        * destination must not already hold a shard of this PG,
        * the rule step's failure-domain separation must hold among the
          shards governed by the same step,
        * destination must have room for the shard (plus ``headroom``
          fraction of capacity kept free).
        """
        pool = self.pools[pg[0]]
        step = pool.rule.step_of_slot(slot)
        dst = self.dev_by_id[dst_osd]
        if dst_osd in self.out_osds:
            return False
        if step.device_class is not None and dst.device_class != step.device_class:
            return False
        osds = self.acting[pg]
        if dst_osd in osds:
            return False
        # failure-domain check among slots of the same rule step
        base = 0
        for s in pool.rule.steps:
            if s is step:
                break
            base += s.count
        peer_domains = set()
        for j in range(base, base + step.count):
            if j == slot:
                continue
            peer_domains.add(self.dev_by_id[osds[j]].domain(step.failure_domain))
        if dst.domain(step.failure_domain) in peer_domains:
            return False
        size = self.shard_sizes[pg]
        i = self._id_to_idx[dst_osd]
        if self._used[i] + size > self._capacity[i] * (1.0 - headroom):
            return False
        return True

    # -- mutation ------------------------------------------------------------

    def apply(self, mv: Movement) -> None:
        osds = self.acting[mv.pg]
        if osds[mv.slot] != mv.src_osd:
            raise ValueError(f"stale movement: slot {mv.slot} of {mv.pg} is on "
                             f"{osds[mv.slot]}, not {mv.src_osd}")
        size = self.shard_sizes[mv.pg]
        si, di = self._id_to_idx[mv.src_osd], self._id_to_idx[mv.dst_osd]
        osds[mv.slot] = mv.dst_osd
        self._used[si] -= size
        self._used[di] += size
        self.shards_on[mv.src_osd].discard((mv.pg, mv.slot))
        self.shards_on[mv.dst_osd].add((mv.pg, mv.slot))
        self.pool_counts[mv.pg[0]][si] -= 1
        self.pool_counts[mv.pg[0]][di] += 1
        self.mutation_epoch += 1
        if self._subscribers:
            self._notify(MovementDelta(self.mutation_epoch, mv))

    def undo(self, mv: Movement) -> None:
        self.apply(Movement(mv.pg, mv.slot, mv.dst_osd, mv.src_osd, mv.size))

    # -- lifecycle mutation (the scenario engine's event surface) ------------

    def add_device(self, dev: Device) -> None:
        """Grow the cluster by one OSD (expansion).  The new device starts
        empty; CRUSH re-placement of existing PGs is the caller's job
        (see repro_torch.sim.engine)."""
        if dev.id in self.dev_by_id:
            raise ValueError(f"osd.{dev.id} already exists")
        self.devices.append(dev)
        self.dev_by_id[dev.id] = dev
        self._id_to_idx[dev.id] = len(self.devices) - 1
        self._capacity = np.append(self._capacity, float(dev.capacity))
        self._used = np.append(self._used, 0.0)
        self.shards_on[dev.id] = set()
        for p in self.pool_counts:
            self.pool_counts[p] = np.append(self.pool_counts[p], 0)
        self.mutation_epoch += 1
        if self._subscribers:
            self._notify(DeviceAddDelta(self.mutation_epoch, dev))

    def mark_out(self, osd_id: int, out: bool = True) -> None:
        """Set an OSD's weight to 0 ("out") or restore it ("in").  An out
        device stops receiving placements (ideal counts, pool growth, move
        destinations); data already on it must be re-placed by the caller."""
        if osd_id not in self.dev_by_id:
            raise KeyError(f"unknown osd.{osd_id}")
        if out:
            self.out_osds.add(osd_id)
        else:
            self.out_osds.discard(osd_id)
        self.mutation_epoch += 1
        if self._subscribers:
            self._notify(DeviceOutDelta(self.mutation_epoch, osd_id, out))

    def grow_pool(self, pool_id: int, user_bytes: float) -> None:
        """Ingest ``user_bytes`` of user data into a pool: every PG's shard
        grows by the pool's per-shard growth factor (uniform across PGs —
        the paper's "shard sizes in a pool are almost equal" premise; the
        initial per-PG jitter is preserved as an offset)."""
        pool = self.pools[pool_id]
        delta = user_bytes * pool.shard_growth_factor
        if delta == 0.0:
            return
        self.pools[pool_id] = dataclasses.replace(
            pool, stored_bytes=pool.stored_bytes + user_bytes)
        for pg in self.pgs_of_pool[pool_id]:
            self.shard_sizes[pg] += delta
            for osd in self.acting[pg]:
                self._used[self._id_to_idx[osd]] += delta
        self.mutation_epoch += 1
        if self._subscribers:
            self._notify(PoolGrowthDelta(self.mutation_epoch, pool_id,
                                         user_bytes))

    def add_pool(self, pool: Pool, acting: dict[PGId, list[int]],
                 shard_sizes: dict[PGId, float]) -> None:
        """Register a freshly created pool with its (CRUSH-placed) acting
        sets and per-PG shard sizes."""
        if pool.id in self.pools:
            raise ValueError(f"pool {pool.id} already exists")
        self.pools[pool.id] = pool
        self.pool_counts[pool.id] = np.zeros(self.n_devices, dtype=np.int64)
        self.pgs_of_pool[pool.id] = []
        for pg in sorted(acting):
            if pg[0] != pool.id:
                raise ValueError(f"acting key {pg} not in pool {pool.id}")
            osds = list(acting[pg])
            size = shard_sizes[pg]
            self.acting[pg] = osds
            self.shard_sizes[pg] = size
            self.pgs_of_pool[pool.id].append(pg)
            for slot, osd in enumerate(osds):
                self._used[self._id_to_idx[osd]] += size
                self.shards_on[osd].add((pg, slot))
                self.pool_counts[pool.id][self._id_to_idx[osd]] += 1
        self.mutation_epoch += 1
        if self._subscribers:
            self._notify(PoolCreateDelta(self.mutation_epoch, pool.id))

    # -- integrity (used by tests / property checks) -------------------------

    def check_valid(self) -> None:
        """Raise if any placement violates its pool's rule."""
        for pg, osds in self.acting.items():
            pool = self.pools[pg[0]]
            if len(osds) != pool.size:
                raise AssertionError(f"{pg}: acting size {len(osds)} != rule size")
            if len(set(osds)) != len(osds):
                raise AssertionError(f"{pg}: duplicate OSD in acting set {osds}")
            base = 0
            for step in pool.rule.steps:
                doms = set()
                for j in range(base, base + step.count):
                    d = self.dev_by_id[osds[j]]
                    if step.device_class is not None and d.device_class != step.device_class:
                        raise AssertionError(
                            f"{pg} slot {j}: class {d.device_class} != {step.device_class}")
                    dom = d.domain(step.failure_domain)
                    if dom in doms:
                        raise AssertionError(f"{pg}: failure domain {dom} reused")
                    doms.add(dom)
                base += step.count
        used = np.zeros(self.n_devices)
        for pg, osds in self.acting.items():
            for osd in osds:
                used[self._id_to_idx[osd]] += self.shard_sizes[pg]
        if not np.allclose(used, self._used, rtol=1e-9, atol=1.0):
            raise AssertionError("used-bytes accounting drifted")
