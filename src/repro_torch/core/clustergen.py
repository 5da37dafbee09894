"""Synthetic clusters A–F matching the paper's §3.2 descriptions.

The paper evaluated on six private production osdmaps; only their shape is
published (PG count, device counts/sizes/classes, pool counts, data
volume).  These generators reproduce that shape with seeded randomness:
heterogeneous device sizes, power-law pool sizes, CRUSH-placed shards.
Absolute numbers differ from the paper's Table 1; the qualitative claims
are the validation target.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cluster import Device, PlacementRule, Pool, RuleStep, TiB
from .crush import build_cluster

PiB = 1024.0 * TiB

_MAX_INITIAL_UTIL = 0.92


def _build_capped(devices, pools, seed):
    """Build the cluster, rescaling pool payloads if random placement would
    overfill any device (>92%) — a real cluster cannot exceed capacity, and
    Ceph stops writes at ``osd_full_ratio`` (default 0.95)."""
    from .crush import build_cluster

    state = build_cluster(devices, pools, seed=seed)
    max_util = float(state.utilization().max())
    if max_util > _MAX_INITIAL_UTIL:
        scale = _MAX_INITIAL_UTIL / max_util
        pools = [dataclass_replace(p, stored_bytes=p.stored_bytes * scale)
                 for p in pools]
        state = build_cluster(devices, pools, seed=seed)
    return state


def dataclass_replace(p, **kw):
    import dataclasses
    return dataclasses.replace(p, **kw)


def _make_devices(specs: list[tuple[int, float, str]], osds_per_host: int = 8,
                  hosts_per_rack: int = 8, het: float = 0.35,
                  seed: int = 0) -> list[Device]:
    """``specs`` = [(count, total_bytes, device_class), ...].

    Device capacities within a class are heterogeneous (two size tiers ±het)
    — the realistic condition under which size-aware balancing wins (§2.2).
    Hosts are assigned per class so every class spans enough failure
    domains for 3-replica rules (≥6 hosts per class when possible).
    """
    rng = np.random.default_rng((seed, 0xD0D0))
    devices: list[Device] = []
    osd_id = 0
    for count, total, dclass in specs:
        per_host = min(osds_per_host, max(1, count // 6))
        mean = total / count
        sizes = np.where(rng.random(count) < 0.5, mean * (1 - het), mean * (1 + het))
        sizes *= total / sizes.sum()            # renormalize to exact total
        for j in range(count):
            h = j // per_host
            host = f"{dclass}-host{h:04d}"
            rack = f"{dclass}-rack{h // hosts_per_rack:03d}"
            devices.append(Device(id=osd_id, capacity=float(sizes[j]),
                                  device_class=dclass, host=host, rack=rack))
            osd_id += 1
    return devices


def _pool_set(total_pgs: int, big: list[tuple[int, float, PlacementRule, int]],
              n_small_user: int, n_meta: int, small_rule: PlacementRule,
              meta_rule: PlacementRule, small_bytes: float, meta_bytes: float,
              seed: int = 0) -> list[Pool]:
    """Build a pool list: explicit big pools + power-law small/meta pools,
    padding PG counts so the total matches the paper's figure exactly."""
    rng = np.random.default_rng((seed, 0xB00B5))
    pools: list[Pool] = []
    pid = 0
    used_pgs = 0
    for pg_count, stored, rule, ec_k in big:
        pools.append(Pool(pid, f"user{pid}", pg_count, rule, ec_k=ec_k,
                          stored_bytes=stored, is_user_data=True))
        used_pgs += pg_count
        pid += 1
    remaining = total_pgs - used_pgs
    n_rest = n_small_user + n_meta
    if n_rest > 0:
        weights = rng.pareto(1.5, size=n_rest) + 1.0
        weights /= weights.sum()
        counts = np.maximum(1, np.round(weights * remaining)).astype(int)
        # pad/trim to hit the exact total
        while counts.sum() > remaining:
            counts[int(np.argmax(counts))] -= 1
        while counts.sum() < remaining:
            counts[int(np.argmin(counts))] += 1
        for i in range(n_small_user):
            stored = small_bytes * float(rng.uniform(0.3, 1.7))
            pools.append(Pool(pid, f"user{pid}", int(counts[i]), small_rule,
                              stored_bytes=stored, is_user_data=True))
            pid += 1
        for i in range(n_small_user, n_rest):
            stored = meta_bytes * float(rng.uniform(0.3, 1.7))
            pools.append(Pool(pid, f"meta{pid}", int(counts[i]), meta_rule,
                              stored_bytes=stored, is_user_data=False))
            pid += 1
    return pools


# --------------------------------------------------------------------------
# The six paper clusters.  Counts/capacities/classes/pool-splits from §3.2.


def cluster_a(seed: int = 1):
    """225 PGs, 14×HDD 68 TiB, 7 pools, 2 with user data."""
    devices = _make_devices([(14, 68 * TiB, "hdd")], osds_per_host=2, seed=seed)
    r3 = PlacementRule.replicated(3, "host")
    pools = _pool_set(
        total_pgs=225,
        big=[(128, 11.0 * TiB, r3, 0), (64, 3.5 * TiB, r3, 0)],
        n_small_user=0, n_meta=5,
        small_rule=r3, meta_rule=r3,
        small_bytes=0.0, meta_bytes=0.02 * TiB, seed=seed)
    return _build_capped(devices, pools, seed=seed)


def cluster_b(seed: int = 2, scale: int = 1):
    """8731 PGs, 810×HDD 5 PiB, 185×SSD 1 PiB, 94 pools (55 user/40 meta per
    the paper; we use 54+40 so the count sums to 94), 3 pools ~1 PiB.

    ``scale`` multiplies device counts, capacities, PG counts and payload
    uniformly — ``scale=2`` is the ≥1000-OSD "2× paper-scale" cluster the
    planner-throughput benchmarks (benchmarks/bench_planner.py) run on.
    """
    devices = _make_devices([(810 * scale, scale * 5 * PiB, "hdd"),
                             (185 * scale, scale * 1 * PiB, "ssd")],
                            osds_per_host=12, seed=seed)
    ec83 = PlacementRule.erasure(8, 3, "host", "hdd")
    r3_hdd = PlacementRule.replicated(3, "host", "hdd")
    r3_ssd = PlacementRule.replicated(3, "host", "ssd")
    pools = _pool_set(
        total_pgs=8731 * scale,
        big=[(2048 * scale, scale * 1.0 * PiB, ec83, 8),
             (2048 * scale, scale * 0.9 * PiB, ec83, 8),
             (1024 * scale, scale * 0.95 * PiB, r3_hdd, 0)],
        n_small_user=51, n_meta=40,
        small_rule=r3_hdd, meta_rule=r3_ssd,
        small_bytes=scale * 4.0 * TiB, meta_bytes=scale * 0.15 * TiB,
        seed=seed)
    return _build_capped(devices, pools, seed=seed)


def cluster_c(seed: int = 3):
    """1249 PGs, 40×HDD 164 TiB, 10×NVMe 9 TiB, 10 pools, 3 with user data."""
    devices = _make_devices([(40, 164 * TiB, "hdd"), (10, 9 * TiB, "nvme")],
                            osds_per_host=5, seed=seed)
    r3_hdd = PlacementRule.replicated(3, "host", "hdd")
    r3_nvme = PlacementRule.replicated(3, "host", "nvme")
    pools = _pool_set(
        total_pgs=1249,
        big=[(512, 28.0 * TiB, r3_hdd, 0), (256, 9.0 * TiB, r3_hdd, 0),
             (128, 1.6 * TiB, r3_nvme, 0)],
        n_small_user=0, n_meta=7,
        small_rule=r3_hdd, meta_rule=r3_nvme,
        small_bytes=0.0, meta_bytes=0.05 * TiB, seed=seed)
    return _build_capped(devices, pools, seed=seed)


def cluster_d(seed: int = 4):
    """4181 PGs, 246×HDD 621 TiB, 60×SSD 105 TiB, 11 pools, 6 user data,
    hybrid class storage 1×SSD + 2×HDD."""
    devices = _make_devices([(246, 621 * TiB, "hdd"), (60, 105 * TiB, "ssd")],
                            osds_per_host=9, seed=seed)
    hybrid = PlacementRule.hybrid([RuleStep("ssd", 1, "host"),
                                   RuleStep("hdd", 2, "host")])
    r3_hdd = PlacementRule.replicated(3, "host", "hdd")
    r3_ssd = PlacementRule.replicated(3, "host", "ssd")
    pools = _pool_set(
        total_pgs=4181,
        big=[(1024, 55.0 * TiB, hybrid, 0), (1024, 48.0 * TiB, r3_hdd, 0),
             (512, 30.0 * TiB, hybrid, 0), (512, 22.0 * TiB, r3_hdd, 0)],
        n_small_user=2, n_meta=5,
        small_rule=r3_hdd, meta_rule=r3_ssd,
        small_bytes=6.0 * TiB, meta_bytes=0.1 * TiB, seed=seed)
    return _build_capped(devices, pools, seed=seed)


def cluster_e(seed: int = 5):
    """8321 PGs, 608×HDD 8.04 PiB, 9×SSD 4 TiB, 3 pools, 1 with user data."""
    devices = _make_devices([(608, 8.04 * PiB, "hdd"), (9, 4 * TiB, "ssd")],
                            osds_per_host=16, seed=seed)
    ec83 = PlacementRule.erasure(8, 3, "host", "hdd")
    r3_ssd = PlacementRule.replicated(3, "host", "ssd")
    pools = _pool_set(
        total_pgs=8321,
        big=[(8192, 3.6 * PiB, ec83, 8)],
        n_small_user=0, n_meta=2,
        small_rule=ec83, meta_rule=r3_ssd,
        small_bytes=0.0, meta_bytes=0.1 * TiB, seed=seed)
    return _build_capped(devices, pools, seed=seed)


def cluster_f(seed: int = 6):
    """577 PGs, 78×HDD 425 TiB, 3 pools, 1 with user data."""
    devices = _make_devices([(78, 425 * TiB, "hdd")], osds_per_host=6, seed=seed)
    r3 = PlacementRule.replicated(3, "host")
    pools = _pool_set(
        total_pgs=577,
        big=[(512, 95.0 * TiB, r3, 0)],
        n_small_user=0, n_meta=2,
        small_rule=r3, meta_rule=r3,
        small_bytes=0.0, meta_bytes=0.05 * TiB, seed=seed)
    return _build_capped(devices, pools, seed=seed)


PAPER_CLUSTERS = {
    "A": cluster_a, "B": cluster_b, "C": cluster_c,
    "D": cluster_d, "E": cluster_e, "F": cluster_f,
}


def sim_cluster(seed: int = 0, n_hdd: int = 30, n_ssd: int = 6,
                fill: float = 0.5, size_jitter: float = 0.12):
    """Mid-size heterogeneous cluster for lifecycle scenarios
    (:mod:`repro_torch.sim`): two HDD capacity tiers (±35%), a big EC-style pool
    with large shards next to small-shard pools — the regime where
    count-balanced (mgr) and size-balanced (Equilibrium) placements
    diverge, and small enough that a multi-hundred-tick scenario runs in
    CI seconds.  ``fill`` sets initial utilization so growth/failure
    events have headroom to push against."""
    specs = [(n_hdd, n_hdd * 10 * TiB, "hdd")]
    if n_ssd > 0:
        specs.append((n_ssd, n_ssd * 3 * TiB, "ssd"))
    devices = _make_devices(specs, osds_per_host=3, seed=seed)
    r3_hdd = PlacementRule.replicated(3, "host", "hdd")
    hdd_total = n_hdd * 10 * TiB
    budget = fill * hdd_total / 3.0              # user bytes @ 3x replication
    pools = [
        Pool(0, "rbd", 128, r3_hdd, stored_bytes=budget * 0.55),
        Pool(1, "objects", 64, r3_hdd, stored_bytes=budget * 0.35),
        Pool(2, "backup", 32, r3_hdd, stored_bytes=budget * 0.10),
    ]
    if n_ssd > 0:
        r3_ssd = PlacementRule.replicated(3, "host", "ssd")
        ssd_total = n_ssd * 3 * TiB
        pools.append(Pool(3, "meta", 32, r3_ssd,
                          stored_bytes=fill * ssd_total / 2 * 0.4,
                          is_user_data=False))
    state = build_cluster(devices, pools, seed=seed, size_jitter=size_jitter)
    max_util = float(state.utilization().max())
    if max_util > _MAX_INITIAL_UTIL:         # same guard as _build_capped,
        scale = _MAX_INITIAL_UTIL / max_util  # keeping the larger jitter
        pools = [dataclass_replace(p, stored_bytes=p.stored_bytes * scale)
                 for p in pools]
        state = build_cluster(devices, pools, seed=seed,
                              size_jitter=size_jitter)
    return state


def small_test_cluster(n_hdd: int = 12, n_ssd: int = 4, seed: int = 0,
                       fill: float = 0.6):
    """Tiny heterogeneous cluster for unit/property tests."""
    devices = _make_devices([(n_hdd, n_hdd * 8 * TiB, "hdd"),
                             (n_ssd, n_ssd * 2 * TiB, "ssd")],
                            osds_per_host=2, seed=seed)
    r3 = PlacementRule.replicated(3, "host", "hdd")
    r2 = PlacementRule.replicated(2, "host", "ssd")
    hdd_total = n_hdd * 8 * TiB
    ssd_total = n_ssd * 2 * TiB
    pools = [
        Pool(0, "rbd", 64, r3, stored_bytes=fill * hdd_total / 3 * 0.7),
        Pool(1, "fs", 32, r3, stored_bytes=fill * hdd_total / 3 * 0.3),
        Pool(2, "meta", 16, r2, stored_bytes=fill * ssd_total / 2 * 0.5,
             is_user_data=False),
    ]
    return _build_capped(devices, pools, seed=seed)
