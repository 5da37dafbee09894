"""Convergence-tail instrumentation and host-side source bounds.

The convergence tail is the phase where most accepted moves come from a
source other than the fullest device (``sources_tried > 1``): every move
re-walks the legality of sources that have already proven fruitless, and
at cluster-B scale that re-walking is ~97% of full-convergence wall
time.  This module owns the two pieces every engine shares:

* the tail *accumulator* (:func:`tail_stats` / :func:`tail_record` /
  :func:`tail_terminal` / :func:`tail_flush`) — the ``sources_tried``
  histogram, the selection/apply wall split, and the prune
  counters, flushed into ``PlanResult.stats`` with one schema for all
  engines;
* the host-side :class:`SourceBounds` certificate tracker used by the
  faithful and dense-NumPy engines behind their ``source_bounds`` flag —
  the same prune predicate and the same surgical invalidation events
  (through the shared :mod:`repro_torch.core.legality` expressions) that the
  batch engine maintains device-resident in its carry, so the property
  suite can cross-check all three engines bit-for-bit.
"""

from __future__ import annotations

from . import legality
from ..obs import registry as _obs_registry


# ---------------------------------------------------------------------------
# Tail accumulator (PlanResult.stats schema)


def tail_stats(stats_out: dict | None) -> dict:
    """Mutable convergence-tail accumulator shared by all engines: a
    ``sources_tried`` histogram, the selection/apply wall-time split and
    the source-bound prune counters, written into ``stats_out``
    (PlanResult.stats) by :func:`tail_flush`."""
    return {"hist": {}, "select": 0.0, "apply": 0.0, "tail": 0.0,
            "terminal": 0.0, "bound_hits": 0, "pruned": 0,
            "out": stats_out}


def tail_record(acc: dict, tried: int, select_s: float,
                apply_s: float) -> None:
    acc["hist"][tried] = acc["hist"].get(tried, 0) + 1
    acc["select"] += select_s
    acc["apply"] += apply_s
    if tried > 1:
        acc["tail"] += select_s + apply_s


def tail_terminal(acc: dict, seconds: float) -> None:
    """Account the final fruitless scan (every source walked, no legal
    move) — by definition the most tail-like work in a convergence run,
    so it belongs in the tail share."""
    acc["select"] += seconds
    acc["tail"] += seconds
    acc["terminal"] += seconds


def tail_flush(acc: dict) -> None:
    """Flush the accumulator into ``stats_out`` (PlanResult.stats keys)
    and the global metrics registry — the single write point through
    which every engine's tail instrumentation reaches the telemetry
    spine (``obs.span(..., counters=True)`` attributes these increments
    to the enclosing plan span)."""
    hist = acc["hist"]
    tail_moves = sum(c for t, c in hist.items() if t > 1)
    reg = _obs_registry()
    reg.inc("tail.moves", sum(hist.values()))
    reg.inc("tail.tail_moves", tail_moves)
    # source-scan slots = Σ rank·count: the prune-rate denominator, so
    # trace consumers can compute bound_hits/slots from counters alone
    reg.inc("tail.scan_slots", sum(t * c for t, c in hist.items()))
    reg.inc("tail.selection_seconds", acc["select"])
    reg.inc("tail.apply_seconds", acc["apply"])
    reg.inc("tail.tail_seconds", acc["tail"])
    reg.inc("tail.terminal_seconds", acc["terminal"])
    reg.inc("tail.bound_hits", acc["bound_hits"])
    reg.set_gauge("tail.pruned_sources", acc["pruned"])
    if acc["out"] is None:
        return
    acc["out"].update(
        sources_tried_hist={str(t): hist[t] for t in sorted(hist)},
        tail_moves=tail_moves,
        tail_seconds=acc["tail"],
        terminal_scan_seconds=acc["terminal"],
        selection_seconds=acc["select"], apply_seconds=acc["apply"],
        moves_seconds=acc["select"] + acc["apply"],
        bound_hits=acc["bound_hits"],
        pruned_sources=acc["pruned"])


# ---------------------------------------------------------------------------
# Host-side source-bound certificates


class SourceBounds:
    """Per-source no-candidate certificates for the host-loop engines.

    A source is *pruned* when its scan produced no pair passing every
    criterion except the variance test ("no candidate pair") — the one
    state of affairs the variance criterion alone can never undo, which
    makes the certificate immune to the global ``util_sum`` drift that
    defeats any threshold on utilization itself.  A live certificate
    lets the scan skip the source without touching its shards.

    Certificates die only under the surgical events named in the
    legality core (mirroring the batch carry's ``apply_move``):

    * *touch* — the source was an endpoint of the applied move;
    * *holder* — the moved PG has a shard on the source (membership /
      failure-domain masks for those rows changed), including the old
      source that just lost one;
    * *crossing* — the move's source dropped past the pruned source in
      the emptiest-first destination order (:func:`legality.bound_crossed`);
    * *count flip* — the move's source shed a shard of a pool it was
      count-blocked for (:func:`legality.count_flip_enables`) and the
      pruned source still holds shards of that pool;
    * *capacity* — the move's source lost bytes while the pruned
      source's largest shard did not fit on it
      (:func:`legality.bound_capacity_binding`).
    """

    def __init__(self):
        self._pruned: dict[int, float] = {}   # src index -> largest shard
        self.bound_hits = 0                   # scans skipped by a live bound
        self._scan_hits = 0                   # ... within the current scan
        self.scans = 0                        # begin_scan calls
        self.prunes = 0                       # certificates granted
        # certificates killed, by the trigger that fired (touch / holder
        # / crossed / count_flip / capacity) — accumulated as cheap local
        # ints and flushed to the metrics registry once per plan
        # (:meth:`flush_counters`), so the per-move path never pays a
        # registry write
        self.invalidations: dict[str, int] = {}

    # -- scan-side -----------------------------------------------------

    def begin_scan(self) -> None:
        self._scan_hits = 0
        self.scans += 1

    def skip(self, src_idx: int) -> bool:
        if src_idx in self._pruned:
            self.bound_hits += 1
            self._scan_hits += 1
            return True
        return False

    def end_terminal_scan(self) -> None:
        """Drop the final fruitless scan's skips from ``bound_hits`` so
        the counter means 'scans skipped while producing moves' in every
        engine (the batch engine cannot see terminal-scan skips: its
        terminal chunk emits nothing)."""
        self.bound_hits -= self._scan_hits
        self._scan_hits = 0

    def prune(self, src_idx: int, largest_shard: float) -> None:
        if src_idx not in self._pruned:
            self.prunes += 1
        self._pruned[src_idx] = float(largest_shard)

    @property
    def pruned_count(self) -> int:
        return len(self._pruned)

    def __contains__(self, src_idx: int) -> bool:
        return src_idx in self._pruned

    # -- invalidation --------------------------------------------------

    def invalidate(self, src_idx: int, dst_idx: int, holders,
                   util_src_before: float, util_src_after: float,
                   util, used_src_before: float, cap_limit_src: float,
                   count_flip: bool, holds_pool) -> None:
        """Kill every certificate the applied move could have broken.

        ``util`` is the post-move utilization vector; ``holds_pool`` maps
        a device index to whether it still holds shards of the moved
        PG's pool.  Only the move's *source* side can enable a blocked
        pair (the destination gains bytes, shards and membership — all
        disabling), so the crossing/count/capacity triggers test the
        source endpoint only.
        """
        if not self._pruned:
            return
        inv = self.invalidations
        if self._pruned.pop(src_idx, None) is not None:
            inv["touch"] = inv.get("touch", 0) + 1
        if self._pruned.pop(dst_idx, None) is not None:
            inv["touch"] = inv.get("touch", 0) + 1
        for h in holders:
            if self._pruned.pop(int(h), None) is not None:
                inv["holder"] = inv.get("holder", 0) + 1
        for s in list(self._pruned):
            if bool(legality.bound_crossed(util_src_before, util_src_after,
                                           util[s], src_idx, s)):
                del self._pruned[s]
                inv["crossed"] = inv.get("crossed", 0) + 1
            elif count_flip and holds_pool(s):
                del self._pruned[s]
                inv["count_flip"] = inv.get("count_flip", 0) + 1
            elif bool(legality.bound_capacity_binding(
                    used_src_before, cap_limit_src, self._pruned[s])):
                del self._pruned[s]
                inv["capacity"] = inv.get("capacity", 0) + 1

    def clear(self) -> None:
        self._pruned.clear()

    # -- telemetry -----------------------------------------------------

    def flush_counters(self) -> None:
        """Flush the ledger's accumulated event counts into the global
        metrics registry and zero them — called once per plan next to the
        ``stats_out`` flush, so a ``counters=True`` span around ``plan()``
        attributes the certificate activity to that plan."""
        reg = _obs_registry()
        if self.scans:
            reg.inc("tail.scans", self.scans)
            self.scans = 0
        if self.prunes:
            reg.inc("tail.prunes", self.prunes)
            self.prunes = 0
        for trigger, n in self.invalidations.items():
            reg.inc("tail.invalidations", n, trigger=trigger)
        self.invalidations.clear()
