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


def _select_step(rng: np.random.Generator, devices: Sequence[Device],
                 step: RuleStep, taken_osds: set[int],
                 taken_domains: set[str]) -> list[int]:
    """Pick ``step.count`` devices for one rule step: capacity-weighted
    draws without replacement, one per failure domain."""
    chosen: list[int] = []
    domains = set(taken_domains)
    pool_devs = [d for d in devices
                 if (step.device_class is None or d.device_class == step.device_class)]
    for _ in range(step.count):
        cands = [d for d in pool_devs
                 if d.id not in taken_osds and d.domain(step.failure_domain) not in domains]
        if not cands:
            raise RuntimeError(
                f"cannot satisfy rule step {step}: no candidate device left "
                f"(domains taken: {len(domains)})")
        weights = np.array([d.capacity for d in cands], dtype=np.float64)
        weights /= weights.sum()
        pick = cands[int(rng.choice(len(cands), p=weights))]
        chosen.append(pick.id)
        taken_osds.add(pick.id)
        domains.add(pick.domain(step.failure_domain))
    return chosen


def place_pg(devices: Sequence[Device], pool: Pool, pg_index: int,
             seed: int = 0) -> list[int]:
    """Place all shards of one PG (deterministic in (seed, pool, pg))."""
    rng = np.random.default_rng((seed, pool.id, pg_index))
    taken_osds: set[int] = set()
    acting: list[int] = []
    for step in pool.rule.steps:
        # Failure-domain separation applies within a rule step; Ceph hybrid
        # rules (e.g. 1×ssd + 2×hdd) allow ssd and hdd shards to share a
        # host, matching per-step `take` semantics.
        acting += _select_step(rng, devices, step, taken_osds, set())
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
    for pool in pools:
        nominal = pool.nominal_shard_size
        for pg in range(pool.pg_count):
            pgid: PGId = (pool.id, pg)
            acting[pgid] = place_pg(devices, pool, pg, seed=seed)
            jitter = float(rng.normal(1.0, size_jitter)) if nominal > 0 else 0.0
            shard_sizes[pgid] = max(nominal * max(jitter, 0.1), 0.0)
    state = ClusterState(devices, pools, acting, shard_sizes)
    state.check_valid()
    return state
