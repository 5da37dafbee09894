"""Equilibrium: the paper's size-aware shard balancer (§3.1), faithful.

Per generated move:

1. **Source selection** — devices sorted by relative utilization
   (used/capacity) in the *current simulated target state*, descending.
   The fullest device is the source candidate; if it yields no legal move
   we fall through to the next-fullest, up to the ``k`` fullest (paper
   default k=25), then terminate.
2. **Shard choice** — shards on the source are tried **largest first**.
3. **Destination assignment** — candidate destinations are scanned
   emptiest-first and a move is accepted only if
   (a) the pool's CRUSH rule remains satisfied,
   (b) both endpoints' PG-shard counts move toward (or stay within
   ``count_slack`` of) the pool's per-device ideal, and
   (c) cluster-wide utilization variance strictly decreases.
4. **Apply** — the move is applied to the simulated state, utilizations are
   recalculated, and the loop continues until no source yields a move.

Acceptance criterion (c) makes each emitted move a strict improvement, so
the sequence converges (variance is bounded below by 0 and decreases by a
positive amount each move; see tests/test_equilibrium.py property tests).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import legality
from .cluster import ClusterState, Movement, PGId
from .tail import SourceBounds
from .tail import tail_flush as _tail_flush
from .tail import tail_record as _tail_record
from .tail import tail_stats as _tail_stats
from .tail import tail_terminal as _tail_terminal


@dataclass
class EquilibriumConfig:
    k: int = 25                     # paper: try the k fullest sources
    count_slack: float = 0.0        # tolerance on ideal-count criterion
    headroom: float = 0.0           # destination capacity headroom fraction
    max_moves: int = 100_000
    min_variance_delta: float = 0.0  # require strictly better than this


@dataclass
class MoveRecord:
    movement: Movement
    variance_after: float
    free_space_after: float
    planning_seconds: float
    sources_tried: int


def _count_criterion(state: ClusterState, pg: PGId, src_idx: int, dst_idx: int,
                     ideal_cache: dict[int, np.ndarray], slack: float) -> bool:
    """Both endpoints must approach their ideal pool shard count (§3.1
    'Improving the ideal pool PG shard count for the source and
    destination OSD'), within ``slack`` shards of tolerance."""
    pool_id = pg[0]
    if pool_id not in ideal_cache:
        ideal_cache[pool_id] = state.ideal_shard_count(state.pools[pool_id])
    ideal = ideal_cache[pool_id]
    counts = state.pool_counts[pool_id]
    return bool(legality.src_count_ok(counts[src_idx], ideal[src_idx], slack)
                and legality.dst_count_ok(counts[dst_idx], ideal[dst_idx],
                                          slack))


class _IncrementalVariance:
    """O(1)-per-move tracker of utilization mean/second-moment.

    Acceptance and bookkeeping both go through the shared legality-core
    expressions ((used ± size) / cap, the two maintained moments), so the
    faithful planner's decisions are bit-identical to the vectorized
    engines *by construction*, not by parallel maintenance."""

    def __init__(self, used: np.ndarray, cap: np.ndarray):
        self.cap = cap
        self.used = used.astype(np.float64, copy=True)
        self.util = used / cap
        self.sum = float(self.util.sum())
        self.sumsq = float((self.util**2).sum())
        self.n = used.shape[0]

    def variance(self) -> float:
        return legality.variance_from_moments(self.sum, self.sumsq, self.n)

    def improves(self, src_idx: int, dst_idx: int, size: float,
                 min_variance_delta: float) -> bool:
        return bool(legality.variance_improves(
            self.used[src_idx], self.used[dst_idx], self.cap[src_idx],
            self.cap[dst_idx], self.util[src_idx], self.util[dst_idx],
            size, self.sum, self.sumsq, self.n, min_variance_delta))

    def commit(self, src_idx: int, dst_idx: int, size: float) -> None:
        self.used[src_idx] -= size
        self.used[dst_idx] += size
        for i in (src_idx, dst_idx):        # source first, like apply_row
            u_new = self.used[i] / self.cap[i]
            self.sum += u_new - self.util[i]
            self.sumsq += u_new**2 - self.util[i] ** 2
            self.util[i] = u_new


def plan_one_move(state: ClusterState, cfg: EquilibriumConfig,
                  tracker: _IncrementalVariance,
                  bounds: SourceBounds | None = None
                  ) -> tuple[Movement | None, int]:
    """Generate the next movement (or None), per §3.1.

    Returns (movement, sources_tried).  ``tried`` counts ranks in the
    full fullest-first order, so a bound-skipped source still advances
    it — the histogram is identical with and without ``bounds``.
    """
    cap = state.capacity_vector()
    used = state.used()
    util = used / cap
    src_order = legality.fullest_first(util)[: cfg.k]
    dst_order = np.argsort(util, kind="stable")
    ideal_cache: dict[int, np.ndarray] = {}

    for tried, src_idx in enumerate(src_order, start=1):
        src_idx = int(src_idx)
        if bounds is not None and bounds.skip(src_idx):
            continue
        src_osd = state.devices[src_idx].id
        # largest shard first (deterministic tie-break on pg id / slot)
        shards = sorted(state.shards_on[src_osd],
                        key=lambda s: (-state.shard_sizes[s[0]], s[0], s[1]))
        saw_candidate = False
        for (pg, slot) in shards:
            size = state.shard_sizes[pg]
            if size <= 0.0:
                continue
            for dst_i in dst_order:
                dst_i = int(dst_i)
                if dst_i == src_idx:
                    break           # destinations fuller than source are useless
                dst_osd = state.devices[dst_i].id
                if not state.move_is_legal(pg, slot, dst_osd, headroom=cfg.headroom):
                    continue
                if not _count_criterion(state, pg, src_idx, dst_i,
                                        ideal_cache, cfg.count_slack):
                    continue
                saw_candidate = True
                if not tracker.improves(src_idx, dst_i, size,
                                        cfg.min_variance_delta):
                    continue        # must strictly reduce variance
                return (Movement(pg, slot, src_osd, dst_osd, size), tried)
        if bounds is not None and not saw_candidate:
            # no pair passed every criterion except the variance test:
            # the certificate holds until a surgical event invalidates it
            largest = (state.shard_sizes[shards[0][0]] if shards else 0.0)
            bounds.prune(src_idx, max(float(largest), 0.0))
    return None, len(src_order)


def _balance(state: ClusterState, cfg: EquilibriumConfig | None = None,
             record_trajectory: bool = False, record_free_space: bool = True,
             stats_out: dict | None = None, source_bounds: bool = False):
    """Run Equilibrium to convergence on ``state`` (mutated in place).

    Returns (movements, records) — ``records`` carries per-move metrics
    (variance, free space, planning time, sources tried) used by the
    Fig 4/5/6 benchmarks; ``stats_out`` (optional) receives the
    convergence-tail instrumentation (sources_tried histogram,
    selection-vs-apply wall split, prune counters).  ``source_bounds``
    enables the no-candidate certificates (off by default here:
    this engine is the bit-identity reference, so the bounds are opt-in
    for cross-checking).  Library-internal engine entry; the public API
    is ``repro_torch.core.planner.create_planner("equilibrium_faithful")``.
    """
    cfg = cfg or EquilibriumConfig()
    tracker = _IncrementalVariance(state.used(), state.capacity_vector())
    bounds = SourceBounds() if source_bounds else None
    movements: list[Movement] = []
    records: list[MoveRecord] = []
    acc = _tail_stats(stats_out)
    while len(movements) < cfg.max_moves:
        t0 = time.perf_counter()
        if bounds is not None:
            bounds.begin_scan()
        mv, tried = plan_one_move(state, cfg, tracker, bounds)
        dt = time.perf_counter() - t0
        if mv is None:
            if bounds is not None:
                bounds.end_terminal_scan()
            _tail_terminal(acc, dt)
            break
        t1 = time.perf_counter()
        s_i, d_i = state.idx(mv.src_osd), state.idx(mv.dst_osd)
        if bounds is not None:
            pool_id = mv.pg[0]
            ideal = state.ideal_shard_count(state.pools[pool_id])
            c_old = float(state.pool_counts[pool_id][s_i])
            flip = bool(legality.count_flip_enables(
                legality.dst_count_ok(c_old, ideal[s_i], cfg.count_slack),
                legality.dst_count_ok(c_old - 1.0, ideal[s_i],
                                      cfg.count_slack)))
            util_before = float(tracker.util[s_i])
            used_before = float(tracker.used[s_i])
        tracker.commit(s_i, d_i, mv.size)
        state.apply(mv)
        if bounds is not None:
            holders = [state.idx(o) for o in state.acting[mv.pg]] + [s_i]
            counts = state.pool_counts[pool_id]
            bounds.invalidate(
                s_i, d_i, holders, util_before, float(tracker.util[s_i]),
                tracker.util, used_before,
                float(legality.capacity_limit(tracker.cap[s_i],
                                              cfg.headroom)),
                flip, lambda s: counts[s] > 0)
        _tail_record(acc, tried, dt, time.perf_counter() - t1)
        movements.append(mv)
        if record_trajectory:
            records.append(MoveRecord(
                movement=mv,
                variance_after=state.utilization_variance(),
                free_space_after=(state.total_pool_free_space()
                                  if record_free_space else float("nan")),
                planning_seconds=dt,
                sources_tried=tried,
            ))
    if bounds is not None:
        acc["bound_hits"] = bounds.bound_hits
        acc["pruned"] = bounds.pruned_count
        bounds.flush_counters()
    if stats_out is not None:
        stats_out["source_bounds"] = bool(source_bounds)
    _tail_flush(acc)
    return movements, records

