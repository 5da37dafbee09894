"""CRUSH-like pseudo-random initial placement.

Ceph's CRUSH maps each PG to devices via straw2 draws down the bucket
hierarchy, weighted by subtree capacity, constrained by the rule's failure
domain and device class (§2.2).  The *exact* hash is irrelevant to balancing
semantics — what matters is that placement is (a) pseudo-random, (b)
capacity-weighted, and (c) constraint-respecting, producing the natural
imbalance the balancers then fix.  We implement a deterministic, seeded
weighted draw with those three properties.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .cluster import ClusterState, Device, PGId, Pool, RuleStep


class _DeviceIndex:
    """The devices as arrays, for the draws of many PGs: per (device
    class, failure-domain level), the eligible devices' ids and capacities
    in the devices' order and each one's failure domain as a code."""

    def __init__(self, devices: Sequence[Device]):
        self.devices = devices
        self._steps: dict = {}

    def step(self, device_class, level: str) -> tuple:
        key = (device_class, level)
        if key not in self._steps:
            pool_devs = [d for d in self.devices
                         if device_class is None
                         or d.device_class == device_class]
            codes: dict[str, int] = {}
            dom = np.array([codes.setdefault(d.domain(level), len(codes))
                            for d in pool_devs], dtype=np.int64)
            self._steps[key] = (
                np.array([d.id for d in pool_devs], dtype=np.int64),
                np.array([d.capacity for d in pool_devs], dtype=np.float64),
                dom, codes)
        return self._steps[key]


def _select_step(rng: np.random.Generator, devices: Sequence[Device],
                 step: RuleStep, taken_osds: set[int],
                 taken_domains: set[str],
                 index: _DeviceIndex | None = None) -> list[int]:
    """Pick ``step.count`` devices for one rule step: capacity-weighted
    draws without replacement, one per failure domain.  The candidates'
    weights are the eligible devices' capacities in the devices' order,
    normalised by their sum, as one float64 array per draw."""
    index = index if index is not None else _DeviceIndex(devices)
    ids, caps, dom, codes = index.step(step.device_class, step.failure_domain)
    free = ~np.isin(ids, np.fromiter(taken_osds, dtype=np.int64,
                                      count=len(taken_osds)))
    dom_taken = np.zeros(len(codes), dtype=bool)
    for name in taken_domains:
        if name in codes:
            dom_taken[codes[name]] = True
    chosen: list[int] = []
    for _ in range(step.count):
        pos = np.flatnonzero(free & ~dom_taken[dom])
        if not len(pos):
            raise RuntimeError(
                f"cannot satisfy rule step {step}: no candidate device left "
                f"(domains taken: {len(set(taken_domains)) + len(chosen)})")
        weights = caps[pos]
        weights /= weights.sum()
        pick = int(pos[int(rng.choice(len(pos), p=weights))])
        chosen.append(int(ids[pick]))
        taken_osds.add(int(ids[pick]))
        free[pick] = False
        dom_taken[dom[pick]] = True
    return chosen


def place_pg(devices: Sequence[Device], pool: Pool, pg_index: int,
             seed: int = 0, index: _DeviceIndex | None = None) -> list[int]:
    """Place all shards of one PG (deterministic in (seed, pool, pg));
    ``index``: the devices' :class:`_DeviceIndex`, kept across PGs."""
    rng = np.random.default_rng((seed, pool.id, pg_index))
    index = index if index is not None else _DeviceIndex(devices)
    taken_osds: set[int] = set()
    acting: list[int] = []
    for step in pool.rule.steps:
        # Failure-domain separation applies within a rule step; Ceph hybrid
        # rules (e.g. 1×ssd + 2×hdd) allow ssd and hdd shards to share a
        # host, matching per-step `take` semantics.
        acting += _select_step(rng, devices, step, taken_osds, set(), index)
    return acting


def build_cluster(devices: Sequence[Device], pools: Sequence[Pool],
                  seed: int = 0, size_jitter: float = 0.05) -> ClusterState:
    """Create a cluster state with CRUSH-style initial placement.

    ``size_jitter`` models the paper's "PG shard sizes in a pool are almost
    equal": per-PG payloads get a small multiplicative jitter around the
    pool's nominal shard size.
    """
    acting: dict[PGId, list[int]] = {}
    shard_sizes: dict[PGId, float] = {}
    rng = np.random.default_rng((seed, 0xC0FFEE))
    index = _DeviceIndex(devices)
    for pool in pools:
        nominal = pool.nominal_shard_size
        for pg in range(pool.pg_count):
            pgid: PGId = (pool.id, pg)
            acting[pgid] = place_pg(devices, pool, pg, seed=seed,
                                    index=index)
            jitter = float(rng.normal(1.0, size_jitter)) if nominal > 0 else 0.0
            shard_sizes[pgid] = max(nominal * max(jitter, 0.1), 0.0)
    state = ClusterState(devices, pools, acting, shard_sizes)
    state.check_valid()
    return state
