"""Baseline: Ceph's built-in ``mgr balancer`` (upmap mode), reimplemented.

Semantics mirror ``osdmaptool <map> --upmap out --upmap-max N
--upmap-deviation 1`` as described in the paper (§2.3.1) and the Ceph
sources' documented behavior:

* operates **per pool, independently** — no cross-pool view;
* optimizes **PG-shard counts** toward each device's ideal count for the
  pool (capacity-weighted), entirely **size-blind** (neither device fill
  level nor shard size is consulted);
* a move is accepted if it brings both endpoints' counts closer to ideal
  and respects the CRUSH rule;
* candidate-selection limitation (§2.3.1): sources are tried from the
  highest count-deviation down; if the current worst source has no legal
  move the pool's optimization **aborts** rather than falling through to
  other devices — faithfully reproducing the early-stop the paper calls out;
* stops at max |count − ideal| ≤ ``deviation`` (default 1, as in the
  paper's invocation) or after ``max_moves``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from .cluster import ClusterState, Movement, PGId


@dataclass
class MgrBalancerConfig:
    deviation: float = 1.0          # --upmap-deviation
    max_moves: int = 10_000         # --upmap-max
    headroom: float = 0.0


class _PoolShardIndex:
    """Maintained per-(pool, device) sorted shard lists + cached ideal
    counts.

    The naive ``_pool_round`` re-sorted the source device's whole
    ``shards_on`` registry (every pool's shards) and recomputed the pool's
    ideal vector on *every attempted move*; at cluster-B scale the sort
    alone dominated baseline runs.  Both are loop-invariant per pool:
    ideal counts don't change while balancing (capacities are fixed), and
    the per-pool shard lists change by exactly one remove + one insert per
    applied move.  Scan order is identical to ``sorted(...)`` — ascending
    (pg, slot) — so the move sequence is unchanged (regression-tested in
    tests/test_balancers.py).
    """

    def __init__(self, state: ClusterState):
        self.state = state
        self._ideal: dict[int, np.ndarray] = {}
        self._shards: dict[int, dict[int, list[tuple[PGId, int]]]] = {}

    def ideal(self, pool_id: int) -> np.ndarray:
        if pool_id not in self._ideal:
            self._ideal[pool_id] = self.state.ideal_shard_count(
                self.state.pools[pool_id])
        return self._ideal[pool_id]

    def _pool_lists(self, pool_id: int) -> dict[int, list[tuple[PGId, int]]]:
        by_dev = self._shards.get(pool_id)
        if by_dev is None:
            by_dev = {}
            for pg in self.state.pgs_of_pool[pool_id]:
                for slot, osd in enumerate(self.state.acting[pg]):
                    by_dev.setdefault(osd, []).append((pg, slot))
            for lst in by_dev.values():
                lst.sort()
            self._shards[pool_id] = by_dev
        return by_dev

    def shards(self, pool_id: int, osd: int) -> list[tuple[PGId, int]]:
        return self._pool_lists(pool_id).get(osd, [])

    def apply(self, mv: Movement) -> None:
        by_dev = self._pool_lists(mv.pg[0])
        src = by_dev.get(mv.src_osd, [])
        i = bisect.bisect_left(src, (mv.pg, mv.slot))
        if i < len(src) and src[i] == (mv.pg, mv.slot):
            del src[i]
        bisect.insort(by_dev.setdefault(mv.dst_osd, []), (mv.pg, mv.slot))


class _DensePoolLedger:
    """Stacked per-pool count bookkeeping for the sweep loop.

    ``_balance`` historically recomputed each pool's deviation vector —
    a dense ``counts - ideal`` over every device — *inside* the
    sequential per-pool loop, once per pool per sweep, plus a fresh
    ``state.pool_counts`` copy each time.  Both stack: ideals are
    loop-invariant (capacities don't change while balancing) and counts
    change by exactly ±1 at a move's two endpoints, so this ledger keeps
    one ``(n_pools, n_devices)`` float64 counts matrix maintained
    incrementally and materializes **all** pools' deviations, worst
    sources and stable destination orders in one vectorized pass per
    sweep (:meth:`sweep`).

    Bit-identity with the per-pool recompute is structural: counts are
    integer-valued (±1.0 updates are exact in float64), so each row of
    ``counts - ideal`` is the same expression on the same values the old
    loop evaluated, and a move only perturbs its *own* pool's row — rows
    read later in the same sweep are untouched (the mgr balancer has no
    cross-pool coupling).  Verified move-sequence-identical against the
    per-pool reference in tests/test_balancers.py.
    """

    def __init__(self, state: ClusterState):
        self.state = state
        self.pool_ids = sorted(state.pools.keys())
        self.row = {pid: i for i, pid in enumerate(self.pool_ids)}
        n_dev = state.n_devices
        if self.pool_ids:
            self.ideal = np.stack([state.ideal_shard_count(state.pools[p])
                                   for p in self.pool_ids])
            self.counts = np.stack([state.pool_counts[p]
                                    for p in self.pool_ids]
                                   ).astype(np.float64)
        else:
            self.ideal = np.zeros((0, n_dev))
            self.counts = np.zeros((0, n_dev))

    def apply(self, mv: Movement) -> None:
        r = self.row[mv.pg[0]]
        self.counts[r, self.state.idx(mv.src_osd)] -= 1.0
        self.counts[r, self.state.idx(mv.dst_osd)] += 1.0

    def sweep(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One dense pass for the whole sweep: per-pool deviations
        (n_pools, n_devices), worst-source indices (n_pools,) and stable
        lowest-deviation-first destination orders (n_pools, n_devices)."""
        deviation = self.counts - self.ideal
        return (deviation, np.argmax(deviation, axis=1),
                np.argsort(deviation, axis=1, kind="stable"))


def _attempt_move(state: ClusterState, pool_id: int, cfg: MgrBalancerConfig,
                  index: _PoolShardIndex, deviation: np.ndarray,
                  src_idx: int, order: np.ndarray) -> Movement | None:
    """The §2.3.1 selection body for one pool, given its deviation row,
    worst source and destination order; None if the pool aborts."""
    if deviation[src_idx] <= cfg.deviation:
        return None                                    # pool is balanced
    src_osd = state.devices[src_idx].id

    # shards of this pool on the source, ascending (pg, slot) — the mgr
    # balancer does not consider shard size.
    shards = index.shards(pool_id, src_osd)
    for di in order:
        dst_osd = state.devices[int(di)].id
        if dst_osd == src_osd:
            continue
        if deviation[di] >= deviation[src_idx] - 1.0:
            break                                      # no count improvement possible
        for (pg, slot) in shards:
            if state.move_is_legal(pg, slot, dst_osd, headroom=cfg.headroom):
                return Movement(pg, slot, src_osd, dst_osd, state.shard_sizes[pg])
    # §2.3.1: the built-in balancer gives up on the pool instead of trying
    # the next-worst source.
    return None


def _pool_round(state: ClusterState, pool_id: int, cfg: MgrBalancerConfig,
                index: _PoolShardIndex | None = None) -> Movement | None:
    """One attempted move for one pool; None if the pool aborts.  The
    per-pool reference path (fresh deviation/argmax/argsort per call) the
    dense sweep in ``_balance`` is sequence-verified against."""
    index = index or _PoolShardIndex(state)
    ideal = index.ideal(pool_id)
    counts = state.pool_counts[pool_id].astype(np.float64)
    deviation = counts - ideal
    src_idx = int(np.argmax(deviation))
    # destinations: lowest deviation first (size-blind)
    order = np.argsort(deviation, kind="stable")
    return _attempt_move(state, pool_id, cfg, index, deviation, src_idx,
                         order)


def _balance(state: ClusterState, cfg: MgrBalancerConfig | None = None,
             record_trajectory: bool = False):
    """Generate movements until every pool is count-balanced or aborts.

    Returns (movements, trajectory) where trajectory logs cluster metrics
    after each applied move when requested. ``state`` is mutated to the
    simulated target state, as both balancers plan against their own
    projected state (§3.1).  Library-internal engine entry; the public
    API is ``repro_torch.core.planner.create_planner("mgr")``.
    """
    cfg = cfg or MgrBalancerConfig()
    movements: list[Movement] = []
    trajectory: list[dict] = []
    index = _PoolShardIndex(state)
    ledger = _DensePoolLedger(state)
    active = set(state.pools.keys())
    while active and len(movements) < cfg.max_moves:
        progressed = False
        # one vectorized pass ranks every pool's sources/destinations for
        # the whole sweep (a move only perturbs its own pool's row, so
        # rows read later in the sweep are exactly what a per-pool
        # recompute would produce)
        deviation, src, order = ledger.sweep()
        for pool_id in sorted(active):
            r = ledger.row[pool_id]
            mv = _attempt_move(state, pool_id, cfg, index, deviation[r],
                               int(src[r]), order[r])
            if mv is None:
                active.discard(pool_id)
                continue
            state.apply(mv)
            index.apply(mv)
            ledger.apply(mv)
            movements.append(mv)
            progressed = True
            if record_trajectory:
                trajectory.append({
                    "move": len(movements),
                    "variance": state.utilization_variance(),
                    "free_space": state.total_pool_free_space(),
                    "moved_bytes": mv.size,
                })
            if len(movements) >= cfg.max_moves:
                break
        if not progressed:
            break
    return movements, trajectory

