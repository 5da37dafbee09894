"""Flat array mirror of a :class:`ClusterState` (host-side, NumPy).

The batch engine (:mod:`repro_torch.core.equilibrium_batch`) builds its
device carry from this mirror: capacities, class/domain ids, the flat
shard table with per-shard rule geometry, per-pool ideal and actual
counts, per-device shard row sets and the two maintained utilization
moments.  All id-numbering and criterion math comes from
:mod:`repro_torch.core.legality`, so the mirror cannot drift bitwise
from the host engines.
"""

from __future__ import annotations

import numpy as np

from . import legality
from .cluster import ClusterState, Movement
from .equilibrium import EquilibriumConfig
from .legality import LegalityState


class DenseState:
    """Flat array mirror of a :class:`ClusterState`, maintained incrementally.

    Shards are rows of a flat table; PG membership and per-(pg,step) domain
    occupancy are dense matrices so legality of *all* destinations for *all*
    source shards is a handful of vectorized ops.
    """

    def __init__(self, state: ClusterState):
        self.state = state
        # freshness contract: the mirror is bit-faithful to the state at
        # exactly this mutation epoch.  ``apply_row`` callers re-stamp via
        # ``mark_synced`` after applying the movement to the state; any
        # other mutation (or a partial refresh like the batch engine's
        # delta absorption, which leaves the membership/occupancy arrays
        # untouched) makes ``require_fresh`` refuse warm reuse.
        self.epoch = state.mutation_epoch
        self.mirror_complete = True
        devs = state.devices
        n_dev = len(devs)
        self.n_dev = n_dev

        # per-device legality inputs (capacities, class ids, domain ids,
        # in-mask) come from the shared LegalityState; out devices are
        # never legal destinations (mirrors move_is_legal's out_osds
        # check, independent of the ideal-count criterion which stops
        # excluding at count_slack >= 1)
        self.legality = leg = LegalityState.from_cluster(state)
        self.cap = leg.cap
        self.used = state.used()
        self.class_id = leg.class_id
        self.dev_class = leg.dev_class
        self.dev_in = leg.dev_in
        self.levels = leg.levels
        self.dev_domain_arr = leg.dev_domain_arr
        self.n_domains = leg.n_domains
        self.dev_domain = {lvl: self.dev_domain_arr[li]
                           for li, lvl in enumerate(self.levels)}

        # pools
        pool_ids = sorted(state.pools)
        self.pool_index = {p: i for i, p in enumerate(pool_ids)}
        self.n_pools = len(pool_ids)
        self.ideal = np.stack([state.ideal_shard_count(state.pools[p])
                               for p in pool_ids])          # (n_pools, n_dev)
        self.pool_counts = np.stack([state.pool_counts[p] for p in pool_ids]
                                    ).astype(np.float64)     # (n_pools, n_dev)

        # flat shard table
        pgs = sorted(state.acting)
        self.pg_index = {pg: i for i, pg in enumerate(pgs)}
        self.pgs = pgs
        n_pg = len(pgs)
        rows = []
        for pg in pgs:
            pool = state.pools[pg[0]]
            for slot in range(pool.size):
                rows.append((pg, slot))
        self.shard_key = rows                                # row -> (pg, slot)
        self.row_of = {k: r for r, k in enumerate(rows)}
        n_sh = len(rows)
        self.sh_pg = np.array([self.pg_index[pg] for pg, _ in rows])
        self.sh_pool = np.array([self.pool_index[pg[0]] for pg, _ in rows])
        self.sh_size = np.array([state.shard_sizes[pg] for pg, _ in rows])
        self.sh_dev = np.array([state.idx(state.acting[pg][slot])
                                for pg, slot in rows])

        # per-shard rule-step attributes from the shared slot-geometry
        # walk (legality.rule_slot_steps — also the pool-create
        # absorption's source, so absorbed rows cannot drift from built
        # ones)
        lvl_id = {l: i for i, l in enumerate(self.levels)}
        geometry = {p: legality.rule_slot_steps(state.pools[p].rule)
                    for p in state.pools}
        self.sh_level = np.empty(n_sh, dtype=np.int64)
        self.sh_class = np.empty(n_sh, dtype=np.int64)       # -1 = any
        self.sh_step = np.empty(n_sh, dtype=np.int64)        # step idx in pool rule
        self.sh_slot = np.empty(n_sh, dtype=np.int64)
        self.sh_sbase = np.empty(n_sh, dtype=np.int64)       # step's first slot
        self.sh_scnt = np.empty(n_sh, dtype=np.int64)        # step's slot count
        for r, (pg, slot) in enumerate(rows):
            si, base, scnt, domain, dev_class = geometry[pg[0]][slot]
            self.sh_level[r] = lvl_id[domain]
            self.sh_class[r] = (self.class_id[dev_class]
                                if dev_class is not None else -1)
            self.sh_step[r] = si
            self.sh_slot[r] = slot
            self.sh_sbase[r] = base
            self.sh_scnt[r] = scnt

        # membership (n_pg, n_dev) and per-(pg,step,level) domain occupancy
        self.member = np.zeros((n_pg, n_dev), dtype=bool)
        max_steps = max(len(state.pools[p].rule.steps) for p in state.pools)
        self.max_steps = max_steps
        self.occ = {lvl: np.zeros((n_pg, max_steps, self.n_domains[lvl]),
                                  dtype=np.int16) for lvl in self.levels}
        for r, (pg, slot) in enumerate(rows):
            pgi = self.pg_index[pg]
            di = self.sh_dev[r]
            self.member[pgi, di] = True
            lvl = self.levels[self.sh_level[r]]
            self.occ[lvl][pgi, self.sh_step[r],
                          self.dev_domain[lvl][di]] += 1

        # Per-device domain-occupancy view: occ_dev[pg, step, d] = shards of
        # (pg, step) already in the failure domain containing device d, at
        # the step's own level.  One gather per candidate block replaces the
        # per-row Python peer-occupancy rebuild; maintained incrementally in
        # apply_row.  Each (pg, step) has exactly one failure-domain level
        # (the rule step's), so a single dense array suffices.
        self.occ_dev = np.zeros((n_pg, max_steps, n_dev), dtype=np.int16)
        pg_pool = np.array([pg[0] for pg in pgs])
        for p in pool_ids:
            idx = np.flatnonzero(pg_pool == p)
            for si, rstep in enumerate(state.pools[p].rule.steps):
                lvl = rstep.failure_domain
                self.occ_dev[idx, si] = \
                    self.occ[lvl][idx, si][:, self.dev_domain[lvl]]

        # per-device shard rows (python lists; updated incrementally)
        self.rows_on_dev: list[set[int]] = [set() for _ in range(n_dev)]
        for r in range(n_sh):
            self.rows_on_dev[self.sh_dev[r]].add(r)

        # incremental variance bookkeeping
        self.util = self.used / self.cap
        self.util_sum = float(self.util.sum())
        self.util_sumsq = float((self.util ** 2).sum())

    # -- freshness ----------------------------------------------------------

    @property
    def stale(self) -> bool:
        """True when the bound state mutated past the mirrored epoch (or
        a partial refresh left the mirror structurally incomplete)."""
        return (not self.mirror_complete
                or self.epoch != self.state.mutation_epoch)

    def mark_synced(self) -> None:
        """Re-stamp the mirror as faithful to the state's current epoch —
        legal only right after the mirror and the state absorbed the same
        mutation (``apply_row`` + ``ClusterState.apply`` of one move)."""
        self.epoch = self.state.mutation_epoch

    def require_fresh(self, state: ClusterState) -> None:
        """Refuse a warm start on a stale or foreign mirror.

        The dense engine's planning math reads the *full* mirror
        (membership, domain occupancy, per-device row sets); planning on
        arrays that missed a mutation silently emits illegal or
        non-faithful moves, so a mismatched epoch is an error, never a
        fallback.
        """
        if state is not self.state:
            raise ValueError("DenseState warm start bound to a different "
                             "ClusterState than it mirrors")
        if not self.mirror_complete:
            raise RuntimeError(
                "DenseState mirror is structurally incomplete (a partial "
                "refresh such as batch delta absorption only updates the "
                "fields the device carry needs); rebuild before warm "
                "starting the dense engine")
        if self.epoch != self.state.mutation_epoch:
            raise RuntimeError(
                f"DenseState mirror is stale (mirrored epoch {self.epoch}, "
                f"state epoch {self.state.mutation_epoch}); rebuild it or "
                "absorb the missed mutations before warm starting")

    # -- mutation -----------------------------------------------------------

    def apply_row(self, row: int, dst_idx: int) -> Movement:
        pg, slot = self.shard_key[row]
        src_idx = int(self.sh_dev[row])
        size = float(self.sh_size[row])
        pgi = self.sh_pg[row]
        lvl = self.levels[self.sh_level[row]]
        stp = self.sh_step[row]

        self.member[pgi, src_idx] = False
        self.member[pgi, dst_idx] = True
        dom = self.dev_domain[lvl]
        self.occ[lvl][pgi, stp, dom[src_idx]] -= 1
        self.occ[lvl][pgi, stp, dom[dst_idx]] += 1
        self.occ_dev[pgi, stp] += ((dom == dom[dst_idx]).astype(np.int16)
                                   - (dom == dom[src_idx]).astype(np.int16))
        self.pool_counts[self.sh_pool[row], src_idx] -= 1
        self.pool_counts[self.sh_pool[row], dst_idx] += 1
        self.rows_on_dev[src_idx].discard(row)
        self.rows_on_dev[dst_idx].add(row)
        self.sh_dev[row] = dst_idx
        self.used[src_idx] -= size
        self.used[dst_idx] += size
        for i in (src_idx, dst_idx):
            u_new = self.used[i] / self.cap[i]
            self.util_sum += u_new - self.util[i]
            self.util_sumsq += u_new ** 2 - self.util[i] ** 2
            self.util[i] = u_new

        src_osd = self.state.devices[src_idx].id
        dst_osd = self.state.devices[dst_idx].id
        return Movement(pg, slot, src_osd, dst_osd, size)

    # -- candidate evaluation -------------------------------------------------

    def source_rows(self, src_idx: int) -> np.ndarray:
        """Shard rows on a device, largest-first with the faithful planner's
        tie-break ((-size, pg, slot) — rows are built in (pg, slot) order,
        so a stable sort on -size matches)."""
        rows = np.fromiter(self.rows_on_dev[src_idx], dtype=np.int64,
                           count=len(self.rows_on_dev[src_idx]))
        rows.sort()                              # (pg, slot) order
        order = np.argsort(-self.sh_size[rows], kind="stable")
        rows = rows[order]
        return rows[self.sh_size[rows] > 0.0]

    def peer_occupancy(self, rows: np.ndarray,
                       src_idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(R, n_dev) peer occupancy per destination with each shard's own
        source domain already subtracted, plus the raw per-device domain
        occupancy.  No Python per-row work — two gathers on occ_dev /
        dev_domain_arr (levels differ per row, so both are indexed by the
        row's own level)."""
        occ = self.occ_dev[self.sh_pg[rows], self.sh_step[rows]]   # (R, n)
        lvl_rows = self.sh_level[rows]
        dom_rows = self.dev_domain_arr[lvl_rows]                   # (R, n)
        own = self.dev_domain_arr[lvl_rows, src_idx]               # (R,)
        peer = occ - (dom_rows == own[:, None]).astype(np.int16)
        return peer, occ

    def candidate_matrix(self, rows: np.ndarray, src_idx: int,
                         cfg: EquilibriumConfig) -> np.ndarray:
        """(len(rows), n_dev) pairs passing every criterion *except* the
        variance test — the PR-6 prune predicate's mask: a source whose
        candidate matrix is all-false holds a no-candidate certificate
        (the variance criterion alone can never create a legal move)."""
        n = self.n_dev
        sizes = self.sh_size[rows][:, None]                   # (R,1)

        # class match
        cls = self.sh_class[rows][:, None]                    # (R,1)
        cls_ok = legality.class_ok(cls, self.dev_class[None, :])

        # not already a member of the PG
        not_member = ~self.member[self.sh_pg[rows]]           # (R,n)

        # failure-domain free (excluding the shard's own slot): pure array
        # indexing against the incrementally-maintained occ_dev view
        peer, _ = self.peer_occupancy(rows, src_idx)
        dom_ok = peer <= 0

        # capacity fit
        cap_ok = legality.capacity_ok(
            self.used[None, :], legality.capacity_limit(self.cap[None, :],
                                                        cfg.headroom), sizes)

        # ideal-count criterion
        pool_rows = self.sh_pool[rows]
        cnt = self.pool_counts[pool_rows]                     # (R,n)
        ideal = self.ideal[pool_rows]                         # (R,n)
        src_cnt = cnt[np.arange(len(rows)), src_idx]
        src_ideal = ideal[np.arange(len(rows)), src_idx]
        src_ok = legality.src_count_ok(src_cnt, src_ideal, cfg.count_slack)
        dst_ok = legality.dst_count_ok(cnt, ideal, cfg.count_slack)

        # the faithful loop scans destinations emptiest-first and stops at
        # the source's own rank (see legality.before_source)
        u = self.util
        before_src = legality.before_source(u, u[src_idx], np.arange(n),
                                            src_idx)

        cand = (cls_ok & not_member & dom_ok & cap_ok & dst_ok
                & src_ok[:, None] & self.dev_in[None, :]
                & before_src[None, :])
        cand[:, src_idx] = False
        return cand

    def variance_mask(self, rows: np.ndarray, src_idx: int,
                      cfg: EquilibriumConfig) -> np.ndarray:
        """(len(rows), n_dev) exact variance delta < -min_variance_delta
        (strict improvement)."""
        sizes = self.sh_size[rows][:, None]                   # (R,1)
        u = self.util
        return legality.variance_improves(
            self.used[src_idx], self.used[None, :], self.cap[src_idx],
            self.cap[None, :], u[src_idx], u[None, :], sizes,
            self.util_sum, self.util_sumsq, float(self.n_dev),
            cfg.min_variance_delta)

    def valid_matrix(self, rows: np.ndarray, src_idx: int,
                     cfg: EquilibriumConfig) -> np.ndarray:
        """(len(rows), n_dev) boolean matrix of acceptable moves
        (candidate ∧ variance — boolean AND, so splitting the masks for
        the bounds path cannot change a bit)."""
        return (self.candidate_matrix(rows, src_idx, cfg)
                & self.variance_mask(rows, src_idx, cfg))

    def pick(self, rows: np.ndarray, valid: np.ndarray) -> tuple[int, int] | None:
        """First row (largest shard) with a valid destination; destination =
        min utilization (ties → lowest device index, matching np.argsort
        stable order of the faithful planner)."""
        any_valid = valid.any(axis=1)
        if not any_valid.any():
            return None
        i = int(np.argmax(any_valid))
        util = np.where(valid[i], self.util, np.inf)
        d = int(np.argmin(util))
        return int(rows[i]), d
