"""Event-driven cluster lifecycle simulator.

The paper's harness (:mod:`repro_torch.core.simulate`) replays one
precomputed move list against one frozen snapshot.  This engine advances a
live :class:`~repro_torch.core.cluster.ClusterState` through a timeline of
lifecycle events — ingest, expansion, failures, rebalance ticks — under the
movement throttle, so the three planner engines can be compared over a
cluster's *lifetime* rather than at a single instant.

Semantics mirror how Ceph actually executes placement changes:

* Balancer plans and CRUSH re-placements land in the **target map**
  immediately (the upmap/osdmap view every planner plans against — this
  is why planning against the mutated state mid-backfill is faithful).
* Data lands later: every placement change is a transfer in the
  :class:`~repro_torch.core.simulate.MovementThrottle` (max concurrent
  backfills + per-device recovery bandwidth), and all utilization metrics
  are sampled from **physical** occupancy.
* Balancers are resolved through the planner registry
  (:mod:`repro_torch.core.planner`) — any registered :class:`Planner`
  can tick, with no per-balancer dispatch here.  The planner instance
  persists across ticks, so warm planners (``equilibrium_batch``) resume
  from their device-resident carry; because every state mutation this
  engine performs goes through a
  :class:`~repro_torch.core.cluster.ClusterState` mutator, the typed
  :class:`~repro_torch.core.cluster.ClusterDelta` stream reaches the
  planner automatically and every event class this engine emits — pool
  growth, device adds, outs/fails (an out-delta plus the
  drain's movement burst), pool creates — is absorbed without a dense
  rebuild, so a lifecycle builds the dense mirror exactly once.

Determinism: one seeded generator drives every random draw (re-placement
destinations, CRUSH subset selection, new-pool jitter) in a fixed order,
so a scenario + seed reproduces byte-identical metrics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..core.cluster import ClusterState, Device, Movement, PlacementRule, Pool
from ..core.crush import place_pg
from ..core.equilibrium import EquilibriumConfig
from ..core.mgr_balancer import MgrBalancerConfig
from ..core.planner import (Planner, available_planners, create_planner,
                            get_planner_spec)
from ..core.simulate import MovementThrottle, ThrottleConfig
from .. import obs as _obs
from .events import (DeviceAdd, DeviceFail, DeviceOut, Event,
                     ForeignMovement, HostAdd, PoolCreate, PoolGrowth,
                     RebalanceTick)
from .metrics import MetricsCollector


def __getattr__(name: str):
    # BALANCERS is a live view of the planner registry (PEP 562), so
    # third-party planners registered after import still appear.
    if name == "BALANCERS":
        return available_planners()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass
class SimConfig:
    ticks: int = 50
    balancer: str = "equilibrium_batch"
    throttle: ThrottleConfig = field(default_factory=ThrottleConfig)
    #: default per-RebalanceTick planning budget (RebalanceTick.max_moves
    #: overrides when >= 0)
    moves_per_tick: int = 48
    #: skip RebalanceTicks while the transfer backlog is at least this
    #: deep (None = always plan) — planning into a saturated queue only
    #: front-loads movement
    backlog_cap: int | None = None
    fullness_threshold: float = 0.85
    seed: int = 0
    equilibrium: EquilibriumConfig = field(default_factory=EquilibriumConfig)
    mgr: MgrBalancerConfig = field(default_factory=MgrBalancerConfig)


class ScenarioEngine:
    """Run one timeline against one cluster with one balancer."""

    def __init__(self, state: ClusterState, events: list[Event],
                 cfg: SimConfig | None = None,
                 planner: Planner | None = None, device=None):
        self.cfg = cfg or SimConfig()
        self._planner = planner if planner is not None \
            else self._make_planner(self.cfg, device)
        self.state = state
        self.growth = [ev for ev in events if isinstance(ev, PoolGrowth)]
        self.timeline: dict[int, list[Event]] = {}
        for ev in events:
            if not isinstance(ev, PoolGrowth):
                self.timeline.setdefault(ev.tick, []).append(ev)
        self.throttle = MovementThrottle(self.cfg.throttle)
        self.metrics = MetricsCollector(self.cfg.fullness_threshold)
        self.rng = np.random.default_rng((self.cfg.seed, 0x51D3))
        self._planned_moves = 0
        self._degraded = 0
        self._next_osd = 1 + max((d.id for d in state.devices), default=-1)
        self._expansions = 0

    @staticmethod
    def _make_planner(cfg: SimConfig, device=None, **options) -> Planner:
        """Resolve ``cfg.balancer`` through the planner registry.

        The planner's own config comes from the SimConfig field its
        registration names (``sim_config_attr``); ``chunk`` is aligned to
        the per-tick budget purely as a latency default — the device
        plans no further than the tick can emit.  (Absorption covers
        every known delta type with or without an overshoot stash, so
        warm planners stay warm across arbitrary timelines regardless of
        chunk geometry.)  Unaccepted kwargs are dropped by
        :func:`~repro_torch.core.planner.create_planner`, so ``device``
        reaches only the planners that run on one (``equilibrium_batch``,
        ``equilibrium_jax_legacy`` and ``fleet``): ``None`` is the CUDA
        card, and they raise without one.  ``options`` go to the planner
        too.
        """
        spec = get_planner_spec(cfg.balancer)    # ValueError when unknown
        kwargs = {"chunk": max(1, cfg.moves_per_tick), "device": device,
                  **options}
        if spec.sim_config_attr is not None:
            kwargs["cfg"] = getattr(cfg, spec.sim_config_attr)
        return create_planner(cfg.balancer, **kwargs)

    # -- main loop -----------------------------------------------------------

    def run(self) -> MetricsCollector:
        for t in range(self.cfg.ticks):
            self.step(t)
        return self.metrics

    def step(self, t: int) -> None:
        """One lifecycle tick: events (including inline planning), then
        the transfer/metrics bookkeeping.  The tick is split so callers
        that plan *between* the phases — the fleet load generator
        (:mod:`repro_torch.fleet.loadgen`) batches every engine's
        rebalance request into one fleet tick — reuse the exact event and
        bookkeeping semantics."""
        # one span per lifecycle tick: the nested planner.plan span
        # carries the plan wall time; moved bytes and the throttle
        # backlog land here
        with _obs.span("sim.tick", cat="sim", tick=t) as sp:
            planned0 = self._planned_moves
            self.apply_tick_events(t)
            self.finish_tick(t, planned0=planned0, sp=sp)

    def apply_tick_events(self, t: int) -> None:
        """Phase 1 of a tick: pool growth, then this tick's timeline
        events in order (RebalanceTicks plan through ``_rebalance``)."""
        for g in self.growth:
            if g.applies_at(t):
                self.state.grow_pool(g.pool_id, g.bytes_per_tick)
                if t == g.tick:
                    self.metrics.log_event(t, self._describe(g))
        for ev in self.timeline.get(t, ()):
            self._apply(t, ev)

    def finish_tick(self, t: int, planned0: int = 0, sp=None) -> None:
        """Phase 2 of a tick: advance the movement throttle, sample
        physical-occupancy metrics, update the sim registry counters."""
        reg = _obs.registry()
        moved = self.throttle.tick()
        self.metrics.collect(t, self.state, self.throttle,
                             self._planned_moves, self._degraded)
        reg.inc("sim.ticks")
        reg.inc("sim.moved_bytes", moved)
        reg.set_gauge("sim.backlog_moves",
                      self.throttle.backlog_moves)
        if sp is not None:
            sp.set(planned=self._planned_moves - planned0,
                   moved_bytes=moved,
                   backlog=self.throttle.backlog_moves)

    # -- event application ---------------------------------------------------

    def _apply(self, t: int, ev: Event) -> None:
        if isinstance(ev, RebalanceTick):
            self._rebalance(t, ev)
            return
        self.metrics.log_event(t, self._describe(ev))
        if isinstance(ev, DeviceAdd):
            host = ev.host or f"{ev.device_class}-exp{self._expansions:03d}"
            self._expansions += 1
            dev = Device(id=self._next_osd, capacity=float(ev.capacity),
                         device_class=ev.device_class, host=host,
                         rack=ev.rack or "rack0")
            self._next_osd += 1
            self.state.add_device(dev)
            self._expand_onto([dev])
        elif isinstance(ev, HostAdd):
            host = ev.host or f"{ev.device_class}-exp{self._expansions:03d}"
            rack = ev.rack or f"{ev.device_class}-exprack"
            self._expansions += 1
            devs = []
            for _ in range(ev.n_osds):
                dev = Device(id=self._next_osd,
                             capacity=float(ev.capacity_each),
                             device_class=ev.device_class, host=host,
                             rack=rack)
                self._next_osd += 1
                self.state.add_device(dev)
                devs.append(dev)
            self._expand_onto(devs)
        elif isinstance(ev, DeviceOut):
            self._drain(ev.osd_id, lost=False)
        elif isinstance(ev, DeviceFail):
            # in-flight transfers into the dead device are superseded by
            # the recovery moves; reads from it fall back to peers
            self.throttle.cancel_to(ev.osd_id)
            self.throttle.source_lost(ev.osd_id)
            self._drain(ev.osd_id, lost=True)
        elif isinstance(ev, PoolCreate):
            self._create_pool(ev)
        elif isinstance(ev, ForeignMovement):
            self._foreign(ev.count)
        else:
            raise TypeError(f"unhandled event {ev!r}")

    @staticmethod
    def _describe(ev: Event) -> str:
        return f"{type(ev).__name__}({dataclasses.asdict(ev)})"

    # -- balancing -----------------------------------------------------------

    def _tick_budget(self, ev: RebalanceTick) -> int | None:
        """Resolve one RebalanceTick to a positive planning budget, or
        None when it should not plan (saturated backlog / zero budget)."""
        cap = self.cfg.backlog_cap
        if cap is not None and self.throttle.backlog_moves >= cap:
            _obs.registry().inc("sim.backlog_skips")
            return None
        budget = ev.max_moves if ev.max_moves >= 0 else self.cfg.moves_per_tick
        return budget if budget > 0 else None

    def _accept(self, result) -> None:
        """Book one plan's moves into the tick: counters + throttle."""
        self._planned_moves += len(result.moves)
        _obs.registry().inc("sim.planned_moves", len(result.moves))
        self.throttle.enqueue(result.moves)

    def _rebalance(self, t: int, ev: RebalanceTick) -> None:
        budget = self._tick_budget(ev)
        if budget is None:
            return
        self._accept(self._planner.plan(self.state, budget=budget))

    # -- placement surgery ---------------------------------------------------

    def _pick_destination(self, pg, slot) -> int | None:
        """Seeded capacity-weighted draw among devices the CRUSH rule
        accepts — the stand-in for CRUSH's re-placement after a topology
        change."""
        cands = [d for d in self.state.devices
                 if self.state.move_is_legal(pg, slot, d.id)]
        if not cands:
            return None
        weights = np.array([d.capacity for d in cands], dtype=np.float64)
        weights /= weights.sum()
        return cands[int(self.rng.choice(len(cands), p=weights))].id

    def _foreign(self, count: int) -> None:
        """Apply ``count`` seeded random legal movements that did not come
        from the scenario's planner — cross-client upmap traffic.  Each
        draw picks a shard uniformly, then a capacity-weighted legal
        destination; draws with no legal destination are retried a few
        times and then skipped (a full cluster simply sees less foreign
        churn)."""
        moves: list[Movement] = []
        pgs = sorted(self.state.acting)
        for _ in range(count):
            for _attempt in range(8):
                pg = pgs[int(self.rng.integers(len(pgs)))]
                slot = int(self.rng.integers(len(self.state.acting[pg])))
                dst = self._pick_destination(pg, slot)
                if dst is None:
                    continue
                src = self.state.acting[pg][slot]
                mv = Movement(pg, slot, src, dst,
                              self.state.shard_sizes[pg])
                self.state.apply(mv)
                moves.append(mv)
                break
        self.throttle.enqueue(moves)

    def _drain(self, osd_id: int, lost: bool) -> None:
        """Re-place every shard off a failed/out device; transfers go
        through the throttle (recovery reads from peers when the source's
        copy is lost)."""
        self.state.mark_out(osd_id)
        moves: list[Movement] = []
        for (pg, slot) in sorted(self.state.shards_on[osd_id]):
            dst = self._pick_destination(pg, slot)
            if dst is None:
                self._degraded += 1
                continue
            mv = Movement(pg, slot, osd_id, dst, self.state.shard_sizes[pg])
            self.state.apply(mv)
            moves.append(mv)
        self.throttle.enqueue(moves, src_holds=not lost)

    def _expand_onto(self, new_devs: list[Device]) -> None:
        """CRUSH re-placement after expansion: each new device receives
        its capacity-weighted ideal share of every pool's shards, the
        subset drawn pseudo-randomly — added capacity attracts data in
        proportion, which is exactly ASURA/CRUSH's movement lower bound
        for a weighted join."""
        moves: list[Movement] = []
        taken: set[tuple] = set()
        for pid in sorted(self.state.pools):
            pool = self.state.pools[pid]
            ideal = self.state.ideal_shard_count(pool)
            pool_shards = [(pg, slot)
                           for pg in self.state.pgs_of_pool[pid]
                           for slot in range(pool.size)]
            if not pool_shards:
                continue
            for dev in new_devs:
                want = int(round(ideal[self.state.idx(dev.id)]))
                if want <= 0:
                    continue
                placed = 0
                for j in self.rng.permutation(len(pool_shards)):
                    key = pool_shards[int(j)]
                    if key in taken:
                        continue
                    pg, slot = key
                    if not self.state.move_is_legal(pg, slot, dev.id):
                        continue
                    src = self.state.acting[pg][slot]
                    mv = Movement(pg, slot, src, dev.id,
                                  self.state.shard_sizes[pg])
                    self.state.apply(mv)
                    moves.append(mv)
                    taken.add(key)
                    placed += 1
                    if placed >= want:
                        break
        self.throttle.enqueue(moves)

    def _create_pool(self, ev: PoolCreate) -> None:
        pid = ev.pool_id if ev.pool_id >= 0 else 1 + max(self.state.pools,
                                                         default=-1)
        rule = ev.rule or PlacementRule.replicated(3, "host")
        pool = Pool(pid, ev.name, ev.pg_count, rule, ec_k=ev.ec_k,
                    stored_bytes=float(ev.stored_bytes),
                    is_user_data=ev.is_user_data)
        devices = [d for d in self.state.devices
                   if d.id not in self.state.out_osds]
        acting, sizes = {}, {}
        nominal = pool.nominal_shard_size
        for pg in range(pool.pg_count):
            pgid = (pid, pg)
            acting[pgid] = place_pg(devices, pool, pg, seed=self.cfg.seed)
            jitter = float(self.rng.normal(1.0, 0.05)) if nominal > 0 else 0.0
            sizes[pgid] = max(nominal * max(jitter, 0.1), 0.0)
        self.state.add_pool(pool, acting, sizes)
