"""Seed-deterministic lifecycle generator for differential fuzzing.

:func:`generate_timeline` turns ``(seed, FuzzProfile)`` into a
:class:`GeneratedTimeline` — a small heterogeneous cluster plus a
random-but-replayable event timeline (growth bursts, pool creates,
device add/out/fail cascades, foreign movements, a rebalance tick per
simulation tick).  The same seed always produces the same timeline, and
a timeline round-trips through :meth:`GeneratedTimeline.to_dict` /
:func:`timeline_from_dict` byte-exactly, so every fuzz find can be
serialized into ``tests/regressions/`` and replayed forever after
(the reference's :mod:`repro.fuzz`).

The generator never decides *who plans*: the balancer is chosen at
:meth:`GeneratedTimeline.build` time, which is what lets one timeline be
run differentially through every registered planner engine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..core.cluster import (ClusterState, GiB, PlacementRule, Pool, RuleStep,
                            TiB)
from ..core.clustergen import (_MAX_INITIAL_UTIL, _make_devices,
                               dataclass_replace)
from ..core.crush import build_cluster
from ..core.equilibrium import EquilibriumConfig
from ..core.simulate import ThrottleConfig
from .engine import SimConfig
from .events import (DeviceAdd, DeviceFail, DeviceOut, Event,
                     ForeignMovement, HostAdd, PoolCreate, PoolGrowth,
                     RebalanceTick)

__all__ = [
    "FuzzProfile", "PROFILES", "GeneratedTimeline", "fuzz_cluster",
    "generate_timeline", "timeline_from_dict", "event_to_dict",
    "event_from_dict",
]

_GEN_SALT = 0xF022                 # the generator's rng stream salt


# ---------------------------------------------------------------------------
# Profile: the knobs one fuzz campaign draws from


@dataclass(frozen=True)
class FuzzProfile:
    """Ranges (inclusive lo, exclusive hi for integers) the generator
    draws one timeline's shape from.  ``weights`` biases the lifecycle
    event mix; ``max_out_frac`` caps how much of the initial cluster an
    out/fail cascade may remove (a cluster that loses most of its
    failure domains cannot satisfy 3-replica rules and every lane would
    just report degraded shards)."""

    name: str = "quick"
    ticks: tuple[int, int] = (5, 13)
    n_hdd: tuple[int, int] = (8, 17)
    n_ssd: tuple[int, int] = (3, 6)
    fill: tuple[float, float] = (0.30, 0.55)
    moves_per_tick: tuple[int, int] = (6, 25)
    n_events: tuple[int, int] = (2, 9)
    max_concurrent: tuple[int, int] = (4, 13)
    device_gib_per_tick: tuple[float, float] = (128.0, 768.0)
    max_out_frac: float = 0.25
    weights: tuple[tuple[str, float], ...] = (
        ("growth", 3.0), ("create", 1.0), ("add", 1.0), ("host_add", 0.5),
        ("out", 1.0), ("fail", 0.5), ("foreign", 2.0))


PROFILES: dict[str, FuzzProfile] = {
    "quick": FuzzProfile(),
    "nightly": FuzzProfile(name="nightly", ticks=(10, 31), n_hdd=(10, 25),
                           n_ssd=(3, 8), n_events=(4, 17),
                           moves_per_tick=(8, 49)),
}


# ---------------------------------------------------------------------------
# The cluster: a shrunken sim_cluster with fuzz-scale PG counts


def fuzz_cluster(seed: int = 0, n_hdd: int = 12, n_ssd: int = 3,
                 fill: float = 0.45) -> ClusterState:
    """Small heterogeneous cluster for generated lifecycles: two HDD
    capacity tiers across ≥3 host failure domains per class, three HDD
    pools plus an SSD meta pool (when ``n_ssd ≥ 3``) — the same regime
    as :func:`repro_torch.core.clustergen.sim_cluster` at roughly a
    quarter of the PG count, so a 200-timeline sweep across every engine stays
    CI-sized."""
    specs = [(n_hdd, n_hdd * 8 * TiB, "hdd")]
    if n_ssd >= 3:
        specs.append((n_ssd, n_ssd * 3 * TiB, "ssd"))
    devices = _make_devices(specs, osds_per_host=2, seed=seed)
    r3_hdd = PlacementRule.replicated(3, "host", "hdd")
    budget = fill * n_hdd * 8 * TiB / 3.0
    pools = [
        Pool(0, "rbd", 24, r3_hdd, stored_bytes=budget * 0.55),
        Pool(1, "objects", 12, r3_hdd, stored_bytes=budget * 0.35),
        Pool(2, "backup", 8, r3_hdd, stored_bytes=budget * 0.10),
    ]
    if n_ssd >= 3:
        r3_ssd = PlacementRule.replicated(3, "host", "ssd")
        pools.append(Pool(3, "meta", 8, r3_ssd,
                          stored_bytes=fill * n_ssd * 3 * TiB / 2 * 0.4,
                          is_user_data=False))
    state = build_cluster(devices, pools, seed=seed, size_jitter=0.12)
    max_util = float(state.utilization().max())
    if max_util > _MAX_INITIAL_UTIL:
        scale = _MAX_INITIAL_UTIL / max_util
        pools = [dataclass_replace(p, stored_bytes=p.stored_bytes * scale)
                 for p in pools]
        state = build_cluster(devices, pools, seed=seed, size_jitter=0.12)
    return state


# ---------------------------------------------------------------------------
# Event (de)serialization


_EVENT_TYPES: dict[str, type] = {
    cls.__name__: cls for cls in
    (PoolGrowth, PoolCreate, DeviceAdd, HostAdd, DeviceOut, DeviceFail,
     ForeignMovement, RebalanceTick)
}


def _rule_to_dict(rule: PlacementRule | None):
    if rule is None:
        return None
    return {"steps": [[s.device_class, s.count, s.failure_domain]
                      for s in rule.steps]}


def _rule_from_dict(d) -> PlacementRule | None:
    if d is None:
        return None
    return PlacementRule(tuple(RuleStep(c, int(n), dom)
                               for c, n, dom in d["steps"]))


def event_to_dict(ev: Event) -> dict:
    """One event as a JSON-safe dict (``kind`` + constructor fields)."""
    import dataclasses
    d = {"kind": type(ev).__name__}
    for f in dataclasses.fields(ev):
        v = getattr(ev, f.name)
        d[f.name] = _rule_to_dict(v) if isinstance(v, PlacementRule) else v
    return d


def event_from_dict(d: dict) -> Event:
    """Inverse of :func:`event_to_dict`."""
    kw = dict(d)
    cls = _EVENT_TYPES[kw.pop("kind")]
    if "rule" in kw:
        kw["rule"] = _rule_from_dict(kw["rule"])
    return cls(**kw)


# ---------------------------------------------------------------------------
# The generated timeline


@dataclass
class GeneratedTimeline:
    """One replayable fuzz input: cluster recipe + SimConfig knobs +
    event list.  ``provenance`` is free-form (which seed/profile or
    which shrink produced it) and travels with the serialized form."""

    seed: int
    profile: str
    cluster: dict                     # fuzz_cluster kwargs
    sim: dict                         # SimConfig knobs (see build())
    events: list[Event] = field(default_factory=list)
    provenance: dict = field(default_factory=dict)

    # -- construction --------------------------------------------------------

    def build_state(self) -> ClusterState:
        return fuzz_cluster(**self.cluster)

    def build_cfg(self, balancer: str = "equilibrium") -> SimConfig:
        th = self.sim.get("throttle", {})
        eq = self.sim.get("equilibrium", {})
        return SimConfig(
            ticks=int(self.sim["ticks"]),
            balancer=balancer,
            throttle=ThrottleConfig(
                max_concurrent=int(th.get("max_concurrent", 8)),
                device_bytes_per_tick=float(
                    th.get("device_bytes_per_tick", 512 * GiB))),
            moves_per_tick=int(self.sim["moves_per_tick"]),
            seed=int(self.sim.get("seed", self.seed)),
            equilibrium=EquilibriumConfig(**eq),
        )

    def build(self, balancer: str = "equilibrium"):
        """Fresh ``(state, events, cfg)`` triple for one lane."""
        return self.build_state(), list(self.events), self.build_cfg(balancer)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format": 1,
            "seed": self.seed,
            "profile": self.profile,
            "cluster": dict(self.cluster),
            "sim": self.sim,
            "events": [event_to_dict(ev) for ev in self.events],
            "provenance": dict(self.provenance),
        }


def timeline_from_dict(d: dict) -> GeneratedTimeline:
    """Rebuild a timeline from its serialized form (corpus files)."""
    if d.get("format") != 1:
        raise ValueError(f"unknown timeline format {d.get('format')!r}")
    return GeneratedTimeline(
        seed=int(d["seed"]),
        profile=str(d.get("profile", "quick")),
        cluster=dict(d["cluster"]),
        sim=dict(d["sim"]),
        events=[event_from_dict(e) for e in d["events"]],
        provenance=dict(d.get("provenance", {})),
    )


# ---------------------------------------------------------------------------
# The generator


def _rint(rng, lohi) -> int:
    return int(rng.integers(lohi[0], lohi[1]))


def _runi(rng, lohi) -> float:
    return float(rng.uniform(lohi[0], lohi[1]))


def generate_timeline(seed: int,
                      profile: FuzzProfile | str = "quick"
                      ) -> GeneratedTimeline:
    """Draw one timeline.  All randomness flows from one generator
    seeded with ``(seed, salt)`` in a fixed draw order, so the mapping
    seed → timeline is stable across runs and processes."""
    prof = PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng((int(seed), _GEN_SALT))

    n_hdd = _rint(rng, prof.n_hdd)
    n_ssd = _rint(rng, prof.n_ssd)
    have_ssd = n_ssd >= 3
    fill = round(_runi(rng, prof.fill), 4)
    ticks = _rint(rng, prof.ticks)
    moves_per_tick = _rint(rng, prof.moves_per_tick)
    max_concurrent = _rint(rng, prof.max_concurrent)
    bw = round(_runi(rng, prof.device_gib_per_tick), 2) * GiB

    # pools known to exist, keyed by id -> (create_tick, device_class)
    pools: dict[int, tuple[int, str | None]] = {0: (-1, "hdd"),
                                                1: (-1, "hdd"),
                                                2: (-1, "hdd")}
    if have_ssd:
        pools[3] = (-1, "ssd")
    next_pid = 1 + max(pools)
    n_initial = n_hdd + (n_ssd if have_ssd else 0)
    out_budget = max(1, int(prof.max_out_frac * n_initial))
    outed: set[int] = set()

    # initial host layout (mirrors _make_devices geometry) so out/fail
    # and pool-create draws can be kept mutually satisfiable: a created
    # pool must always have enough live failure domains of its class for
    # CRUSH to place it, regardless of the tick order events land in —
    # the check is conservative (counts every out drawn so far, ignores
    # later expansion)
    per_host = {"hdd": min(2, max(1, n_hdd // 6)),
                "ssd": min(2, max(1, n_ssd // 6)) if have_ssd else 1}
    cls_of = {i: "hdd" for i in range(n_hdd)}
    host_of = {i: i // per_host["hdd"] for i in range(n_hdd)}
    if have_ssd:
        for j in range(n_ssd):
            cls_of[n_hdd + j] = "ssd"
            host_of[n_hdd + j] = j // per_host["ssd"]

    def hosts_alive(cls: str, without: int | None = None) -> int:
        alive = {host_of[i] for i in range(n_initial)
                 if cls_of[i] == cls and i not in outed and i != without}
        return len(alive)

    # minimum live hosts per class any generated PoolCreate requires
    required = {"hdd": 0, "ssd": 0}

    kinds = [k for k, _ in prof.weights]
    w = np.array([v for _, v in prof.weights], dtype=np.float64)
    w /= w.sum()

    events: list[Event] = [RebalanceTick(tick=t) for t in range(ticks)]
    n_events = _rint(rng, prof.n_events)
    for _ in range(n_events):
        t = int(rng.integers(0, ticks))
        kind = kinds[int(rng.choice(len(kinds), p=w))]
        if kind in ("out", "fail") and len(outed) >= out_budget:
            kind = "foreign"
        if kind == "growth":
            # only pools already created strictly before t (growth is
            # applied in the pre-event phase of a tick)
            cands = sorted(p for p, (ct, _) in pools.items() if ct < t)
            events.append(PoolGrowth(
                tick=t, pool_id=int(cands[int(rng.integers(len(cands)))]),
                bytes_per_tick=round(_runi(rng, (2.0, 40.0)), 2) * GiB,
                duration=int(rng.integers(1, 5)),
                every=int(rng.integers(1, 3))))
        elif kind == "create":
            cls = "ssd" if have_ssd and rng.random() < 0.3 else "hdd"
            size = 2 if rng.random() < 0.3 else 3
            # keep the create satisfiable under every out drawn so far
            if hosts_alive(cls) < size:
                cls = "hdd"
            size = min(size, hosts_alive(cls))
            if size < 2:
                events.append(ForeignMovement(tick=t, count=1))
                continue
            events.append(PoolCreate(
                tick=t, pool_id=next_pid, name=f"fuzz{next_pid}",
                pg_count=int(rng.integers(4, 17)),
                rule=PlacementRule.replicated(size, "host", cls),
                stored_bytes=round(_runi(rng, (16.0, 256.0)), 2) * GiB))
            pools[next_pid] = (t, cls)
            required[cls] = max(required[cls], size)
            next_pid += 1
        elif kind == "add":
            cls = "ssd" if have_ssd and rng.random() < 0.25 else "hdd"
            events.append(DeviceAdd(
                tick=t, capacity=float(rng.choice([6, 8, 12])) * TiB,
                device_class=cls))
        elif kind == "host_add":
            events.append(HostAdd(
                tick=t, n_osds=int(rng.integers(1, 3)),
                capacity_each=float(rng.choice([6, 8])) * TiB,
                device_class="hdd"))
        elif kind in ("out", "fail"):
            # never out a device whose loss would leave a generated
            # PoolCreate without enough failure domains of its class
            cands = sorted(
                i for i in set(range(n_initial)) - outed
                if hosts_alive(cls_of[i], without=i) >= required[cls_of[i]])
            if not cands:
                events.append(ForeignMovement(tick=t, count=1))
                continue
            osd = int(cands[int(rng.integers(len(cands)))])
            outed.add(osd)
            ev_cls = DeviceOut if kind == "out" else DeviceFail
            events.append(ev_cls(tick=t, osd_id=osd))
        else:                         # foreign
            events.append(ForeignMovement(tick=t,
                                          count=int(rng.integers(1, 4))))

    # stable order: by tick, RebalanceTick first within a tick (the list
    # above already interleaves that way: all ticks' RebalanceTicks come
    # first, and the engine buckets by tick preserving relative order)
    events.sort(key=lambda ev: ev.tick)

    # pool ids must be monotone in *event order* — Ceph allocates them at
    # create time, and the warm engines' pool-create absorption relies on
    # new pools sorting after everything already mirrored.  The loop
    # above assigned ids in draw order, so renumber the creates by final
    # tick order and remap any growth reference to a created pool.
    base_pid = 4 if have_ssd else 3
    creates = [ev for ev in events if isinstance(ev, PoolCreate)]
    remap = {ev.pool_id: base_pid + i for i, ev in enumerate(creates)}
    events = [
        dataclasses.replace(ev, pool_id=remap[ev.pool_id],
                            name=f"fuzz{remap[ev.pool_id]}")
        if isinstance(ev, PoolCreate)
        else dataclasses.replace(ev, pool_id=remap.get(ev.pool_id,
                                                       ev.pool_id))
        if isinstance(ev, PoolGrowth) else ev
        for ev in events
    ]

    # config-space fuzzing: the §3.1 knobs that widen/narrow the legal
    # move set.  count_slack > 0 admits off-ideal-count destinations
    # (including zero-ideal off-class ones were class_ok ever broken);
    # headroom > 0 raises the capacity floor into the occupied band.
    eq: dict = {"min_variance_delta": 1e-5}
    if rng.random() < 0.25:
        eq["count_slack"] = round(_runi(rng, (0.5, 1.5)), 2)
    if rng.random() < 0.25:
        eq["headroom"] = round(_runi(rng, (0.1, 0.4)), 2)

    return GeneratedTimeline(
        seed=int(seed),
        profile=prof.name,
        cluster={"seed": int(seed), "n_hdd": n_hdd,
                 "n_ssd": n_ssd if have_ssd else 0, "fill": fill},
        sim={"ticks": ticks, "moves_per_tick": moves_per_tick,
             "seed": int(seed),
             "throttle": {"max_concurrent": max_concurrent,
                          "device_bytes_per_tick": bw},
             "equilibrium": eq},
        events=events,
        provenance={"generator": "generate_timeline", "seed": int(seed),
                    "profile": prof.name},
    )
