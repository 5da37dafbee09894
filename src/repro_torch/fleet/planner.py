"""Multi-cluster planner: one step plans every cluster of a bucket.

A storage operator runs *fleets* of Ceph clusters.  The batch engine
(:class:`~repro_torch.core.equilibrium_batch.BatchPlanner`) plans one
cluster a chunk, so a fleet pays every step's launches and every chunk's
host sync once per cluster.  :class:`FleetPlanner` pads the clusters to
shared shape buckets (:mod:`repro_torch.fleet.pack`) and runs one step
over every lane of a bucket: the chunk step of the batch engine at
``source_block=1`` without the legality cache, with a leading lane axis
on every tensor (:class:`_FleetChunk`), whose selection is **one** launch
of kernel K1 for the whole bucket
(:func:`repro_torch.kernels.ops.bind_select_rows` with ``lanes=True``).
A round issues every bucket's chunk and then fetches all of them in one
host sync.

Each lane is exact: every update is a masked write (a move with
``ok=False`` writes back the old values), a lane that is done or
inactive changes nothing, no index of one lane reaches another's data,
and the per-lane ``n_real`` / ``k_eff`` / active scalars keep the
padding out of every criterion.  So a fleet plan emits, per cluster,
exactly the move stream and tail stats of a serial :class:`BatchPlanner`
configured like a fleet lane (``source_block=1``, ``legality_cache=False``,
the same ``source_bounds``, ``chunk`` and ``row_block``), and the JAX
package's own ``FleetPlanner`` (tests/test_torch_fleet.py).

The latency knob (``slo_seconds``) bounds a fleet tick's wall time: the
deadline is checked before every bucket dispatch after the first (the
first dispatch is the progress guarantee), and an expired tick returns
each unfinished cluster's moves fetched so far, a partial but valid plan
(every fetched move is applied in the carry and replayed through
:meth:`ClusterState.apply`, which re-validates it).  Each cluster's
:class:`~repro_torch.core.planner.PlanResult` reports the cut through the
``slo_expired`` / ``plan_freshness_seconds`` / ``converged`` /
``variance_after`` stats keys.

``device=None`` runs on the CUDA card and raises without one;
``device="cpu"`` runs the same step on K1's plain version.  There is no
compilation: ``fleet.jit_recompiles`` is never incremented and each
plan's ``jit_recompiles`` stays 0.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import legality
from ..core.cluster import ClusterDelta, ClusterState
from ..core.equilibrium import EquilibriumConfig
from ..core.equilibrium_batch import (BatchPlanner, _fetch, _first_true,
                                     _shift_insert, _shift_remove)
from ..core.planner import PlanResult, _finish, register_planner
from ..core.tail import tail_flush, tail_record, tail_stats, tail_terminal
from ..device import resolve_device
from ..kernels.ops import bind_select_rows
from ..kernels.select_move import compact_parked
from .. import obs as _obs
from ..obs import registry as _obs_registry
from .pack import FleetPack, _Bucket, capacity_limits

__all__ = ["FleetPlanner"]

F64 = torch.float64
I64 = torch.int64

_UNSET = object()

#: device telemetry a lane, per chunk: tiles walked, tiles holding a
#: candidate (the walk at source_block 1 without the cache)
_TEL = 2


class _FleetChunk:
    """The batch engine's chunk step (``_Chunk`` at ``source_block=1``,
    without the legality cache) over a bucket's stacked carries: every
    tensor of ``dyn`` / ``const`` has the lanes first, ``scal`` holds one
    entry a lane of each criterion scalar, ``n_f`` (the lane's real device
    count) and ``k_eff`` (its real source-queue depth); ``k`` is the
    bucket's queue width.  Updated in place; no host sync.

    Indices into a lane's data go through (lane, index) pairs, so a
    lane's writes never meet another's, and within a lane the written
    indices are distinct wherever a move is applied (a move's endpoints
    differ; the top-k sources are distinct devices)."""

    def __init__(self, bucket: _Bucket, *, bounds: bool, rb: int):
        self.dyn, self.const, self.scal = bucket.dyn, bucket.const, \
            bucket.scal
        self.k, self.bounds, self.rb = bucket.shape.k, bounds, rb
        self.B, n = self.dyn["used"].shape
        dev = self.dyn["used"].device
        self.lane = torch.arange(self.B, device=dev)
        self.dev_iota = torch.arange(n, device=dev)
        self.pos = torch.arange(self.k, device=dev)
        self.cap_lim = capacity_limits(bucket)
        # K1 bound to the stacked carry: one launch selects for all lanes
        self.select_rows = bind_select_rows(self.cap_lim, self.dyn,
                                            self.const, self.scal, lanes=True)

    @property
    def r_cap(self) -> int:
        return self.dyn["rows_on"].shape[2]

    def sources(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per lane, the step's top-k sources: (the fullest-first
        ``order_k``, the order the step scans, the count of available
        ones).  Ranks past the lane's ``k_eff`` (padding) are parked like
        pruned sources, behind every real rank."""
        d, k_eff = self.dyn, self.scal["k_eff"]
        order_k = d["order"][:, :self.k]
        if not self.bounds:         # K1 reads the order contiguous
            return order_k, order_k.contiguous(), k_eff
        parked = (d["pruned"].gather(1, order_k)
                  | (self.pos[None, :] >= k_eff[:, None]))
        src_order, n_avail = compact_parked(order_k, parked)
        return order_k, src_order, n_avail

    def select(self, active: torch.Tensor, tel: torch.Tensor | None = None):
        """One planning step's selection on every lane; updates
        ``pruned`` (where ``active``) and the telemetry ``tel`` (where
        given) and returns (found, row, src, dst, tried, skipped), each
        (lanes,)."""
        d, k, lane, pos = self.dyn, self.k, self.lane, self.pos
        B, R = self.B, self.r_cap
        order_k, src_order, n_avail = self.sources()
        if tel is not None:
            any_row, dst, cand_src, cand_row = self.select_rows(
                src_order, n_avail, cand_row=True)
        else:
            any_row, dst, cand_src = self.select_rows(src_order, n_avail)
        any_row = any_row.view(B, k, R)

        # winner: the first available source with a legal row
        src_has = any_row.any(dim=2)                           # (B, k)
        p = torch.where(src_has, pos, k).amin(dim=1)           # k: none
        found = p < k
        jw = p.clamp(max=k - 1)
        ri = _first_true(any_row[lane, jw])
        win_dev = src_order[lane, jw]
        row = d["rows_on"][lane, win_dev, ri]
        win_dst = dst.view(B, k, R)[lane, jw, ri].to(I64)
        if self.bounds:
            # rank in the full fullest-first order; rank - p scans were
            # certificate skips
            rank = _first_true(order_k == win_dev[:, None])
            prunable = ((pos < p[:, None]) & (pos < n_avail[:, None])
                        & ~cand_src & active[:, None])
            pr, at = d["pruned"], (lane[:, None], src_order)
            pr[at] = pr[at] | prunable
        else:
            rank = jw
        if tel is not None:
            # the tiles the reference's walk visits at source_block 1:
            # each position before the winner (before the last available
            # one when nothing wins) as many row blocks as its rows, one
            # at least; the winner's up to its row's block; position 0's
            # first block when nothing is available
            rb = self.rb
            nb = R // rb
            blk = torch.arange(nb, device=pos.device)
            nrows = d["nrows"].gather(1, src_order)
            blocks = ((nrows + rb - 1) // rb).clamp(min=1)[:, :, None]
            before = ((pos[None, :, None]
                       < torch.minimum(p, n_avail)[:, None, None])
                      & (blk < blocks))
            winner = ((pos[None, :, None] == p[:, None, None])
                      & (blk <= (ri // rb)[:, None, None]))
            first = ((n_avail == 0)[:, None, None] & (pos == 0)[None, :, None]
                     & (blk == 0))
            walked = (before | winner | first) & active[:, None, None]
            cand_tile = cand_row.view(B, k, nb, rb).any(dim=3)
            tel += torch.stack([walked.sum(dim=(1, 2)),
                                (walked & cand_tile).sum(dim=(1, 2))], dim=1)
        return found, row, win_dev, win_dst, rank + 1, rank - jw

    def _reorder(self, util, src, dst) -> torch.Tensor:
        """Re-sort ``src`` and ``dst`` within each lane's maintained
        stable argsort(-util) order, both removed before either is
        re-inserted, insertion ranks counted from the (-util, index)
        key."""
        order, iota, lane = self.dyn["order"], self.dev_iota, self.lane
        s, t = src[:, None], dst[:, None]
        o = _shift_remove(order, _first_true(order == s)[:, None], -1)
        o = _shift_remove(o, _first_true(o == t)[:, None], -1)
        u_s, u_d = util[lane, src][:, None], util[lane, dst][:, None]
        before_src = ((util > u_s) | ((util == u_s) & (iota < s))) \
            & (iota != t)
        o = _shift_insert(o, before_src.sum(dim=1, keepdim=True), s)
        before_dst = (util > u_d) | ((util == u_d) & (iota < t))
        return _shift_insert(o, before_dst.sum(dim=1, keepdim=True), t)

    def apply(self, ok, row, src, dst) -> None:
        """Each lane's ``_Chunk.apply``, in place, in the same update
        order and float expressions; ``ok=False`` writes back the old
        values."""
        d, c, s, lane = self.dyn, self.const, self.scal, self.lane
        used, util = d["used"], d["util"]
        okf, oki = ok.to(F64), ok.to(I64)
        row = torch.where(ok, row, 0)
        size = c["sh_size"][lane, row]
        pgi, pool, slot = (c["sh_pg"][lane, row], c["sh_pool"][lane, row],
                           c["sh_slot"][lane, row])
        ln, lp = lane[:, None], pool[:, None]
        both = torch.stack([src, dst], dim=1)                      # (B, 2)
        if self.bounds:
            util_src_before = util[lane, src]
            used_src_before = used[lane, src]
            dok_src_before = d["dst_ok"][lane, pool, src]
        acting = d["acting"]
        acting[lane, pgi, slot] = torch.where(ok, dst, acting[lane, pgi, slot])
        pc = d["pool_counts"]
        pc[ln, lp, both] = pc[ln, lp, both] + torch.stack([-okf, okf], dim=1)
        ok2 = legality.dst_count_ok(pc[ln, lp, both], c["ideal"][ln, lp, both],
                                    s["slack"][:, None])
        dok = d["dst_ok"]
        dok[ln, lp, both] = torch.where(ok[:, None], ok2, dok[ln, lp, both])
        # sorted row lists: shift-remove from src, shift-insert into dst
        rows_on = d["rows_on"]
        src_list = rows_on[lane, src]                              # (B, R)
        removed = _shift_remove(
            src_list, _first_true(src_list == row[:, None])[:, None], -1)
        dst_list = rows_on[lane, dst]
        dsz = torch.where(dst_list >= 0,
                          c["sh_size"].gather(1, dst_list.clamp(min=0)),
                          float("-inf"))
        sz, rw = size[:, None], row[:, None]
        before = (dst_list >= 0) & ((dsz > sz)
                                    | ((dsz == sz) & (dst_list < rw)))
        inserted = _shift_insert(dst_list, before.sum(dim=1, keepdim=True),
                                 row[:, None])
        okc = ok[:, None]
        rows_on[ln, both] = torch.stack(
            [torch.where(okc, removed, src_list),
             torch.where(okc, inserted, dst_list)], dim=1)
        nrows = d["nrows"]
        nrows[ln, both] = nrows[ln, both] + torch.stack([-oki, oki], dim=1)
        used[ln, both] = used[ln, both] + torch.stack([-size * okf,
                                                       size * okf], dim=1)
        cap = c["cap"]
        for i in (src, dst):                  # source first, like apply_row
            u_new = used[lane, i] / cap[lane, i]
            u_old = util[lane, i]
            d["us"] += (u_new - u_old)[:, None]
            d["usq"] += (u_new ** 2 - u_old ** 2)[:, None]
            util[lane, i] = u_new
        new_order = self._reorder(util, src, dst)
        d["order"].copy_(torch.where(okc, new_order, d["order"]))
        if self.bounds:
            # the certificate triggers of _Chunk.apply, per lane
            iota = self.dev_iota
            holder = (acting[lane, pgi][:, None, :]
                      == iota[None, :, None]).any(dim=2)
            touch = (iota == src[:, None]) | (iota == dst[:, None]) | holder
            crossed = legality.bound_crossed(
                util_src_before[:, None], util[lane, src][:, None], util,
                src[:, None], iota)
            flip = legality.count_flip_enables(dok_src_before,
                                               dok[lane, pool, src])
            holds_pool = pc[lane, pool] > 0.0
            largest = rows_on[:, :, 0]
            maxsz = torch.where(largest >= 0,
                                c["sh_size"].gather(1, largest.clamp(min=0)),
                                0.0)
            bind = legality.bound_capacity_binding(
                used_src_before[:, None], self.cap_lim[lane, src][:, None],
                maxsz)
            inval = touch | crossed | (flip[:, None] & holds_pool) | bind
            pr = d["pruned"]
            pr.copy_(torch.where(okc, pr & ~inval, pr))

    def run(self, m: int, active0: torch.Tensor,
            telemetry: bool = False) -> torch.Tensor:
        """Up to ``m`` steps on every lane; ``active0`` (lanes,) bool says
        which lanes plan (the others change nothing).  Returns the packed
        (lanes, 5 m + 3 + n [+ 2]) int64 result the host fetches: per
        lane the (m, 5) move block (row, src, dst, sources_tried,
        bound_skips, or -1 sentinels) flattened, then done, overflow,
        max(nrows), the (n,) source-bound certificates as 0 / 1 and, with
        ``telemetry``, tiles walked and tiles holding a candidate."""
        B, lane = self.B, self.lane
        dev = lane.device
        done = ~active0
        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
        moves = torch.empty((B, m, 5), dtype=I64, device=dev)
        tel = torch.zeros((B, _TEL), dtype=I64, device=dev) if telemetry \
            else None
        nrows = self.dyn["nrows"]
        for t in range(m):
            active = ~(done | overflow)
            found, row, src, dst, tried, skipped = self.select(active, tel)
            found &= active
            # a full destination row list would drop a shard: stop the
            # lane and let the host move it to a wider bucket
            ovf = found & (nrows[lane, dst] >= self.r_cap)
            ok = found & ~ovf
            self.apply(ok, row, src, dst)
            moves[:, t] = torch.where(
                ok[:, None], torch.stack([row, src, dst, tried, skipped], 1),
                -1)
            done |= active & ~found
            overflow |= ovf
        out = [moves.view(B, -1), done.to(I64)[:, None],
               overflow.to(I64)[:, None], nrows.amax(dim=1)[:, None],
               self.dyn["pruned"].to(I64)]
        return torch.cat(out if tel is None else [*out, tel], dim=1)


@register_planner("fleet", sim_config_attr="equilibrium",
                  description="multi-cluster engine: shape-bucketed fleets "
                              "planned by one step per bucket (one K1 launch "
                              "for every lane), with per-cluster move "
                              "budgets, streaming delta absorption and an "
                              "optional latency SLO",
                  equivalence="equilibrium")
class FleetPlanner:
    """Plan N independent clusters with one lane-batched engine.

    Each cluster is a named lane: :meth:`add_cluster` binds a
    :class:`BatchPlanner` (its sync, absorption and reconcile are reused
    as they are; only the chunk step is batched).  :meth:`plan_fleet`
    runs one fleet tick over any subset of clusters with per-cluster move
    budgets; :meth:`plan` makes a fleet of one behave like
    ``equilibrium_batch`` behind the registry (binding the passed state
    to a lane), so the scenario engine drives it as it is.

    Fleet lanes run at ``source_block=1`` without the legality cache, as
    the reference's do; ``source_bounds`` stays on (certificates are
    per-lane state).
    """

    name = "fleet"

    def __init__(self, cfg: EquilibriumConfig | None = None, chunk: int = 64,
                 row_block: int = 8, source_bounds: bool = True,
                 slo_seconds: float | None = None, device=None):
        self.cfg = cfg or EquilibriumConfig()
        self.chunk = chunk
        rb = max(1, row_block)
        if rb & (rb - 1):       # bucket widths are pow2 multiples of rb
            rb = 1 << (rb - 1).bit_length()
        self.rb = rb
        self.source_bounds = source_bounds
        self.slo_seconds = slo_seconds
        self.device = resolve_device(device, "fleet")
        self._clusters: dict[object, BatchPlanner] = {}
        self._pack = FleetPack(rb)
        self._by_state: dict[int, object] = {}      # id(state) -> key
        # lanes whose stacked carry ran ahead of their planner's: the crop
        # waits until something reads the planner's carry (an absorb or
        # rebuild, a bucket move, a detach)
        self._needs_crop: set = set()

    # -- fleet membership -----------------------------------------------------

    def add_cluster(self, key, state: ClusterState,
                    cfg: EquilibriumConfig | None = None,
                    row_capacity: int | None = None) -> BatchPlanner:
        """Bind one cluster as fleet lane ``key`` (stable across ticks);
        returns its engine.  ``row_capacity`` pins the carry's initial row
        axis: a common capacity puts clusters of different row counts in
        one bucket (one step, no mid-run move to a wider bucket).

        While the cluster is in the fleet, plan through the fleet: between
        ticks the stacked lane, not the engine's own carry, is the
        authoritative state (:meth:`remove_cluster` hands it back)."""
        if key in self._clusters:
            raise ValueError(f"cluster {key!r} already in the fleet")
        bp = BatchPlanner(state, cfg or self.cfg, chunk=self.chunk,
                          source_block=1, row_block=self.rb,
                          legality_cache=False,
                          source_bounds=self.source_bounds,
                          row_capacity=row_capacity, device=self.device)
        self._clusters[key] = bp
        self._by_state[id(state)] = key
        return bp

    def remove_cluster(self, key) -> None:
        bp = self._clusters.pop(key)
        self._by_state.pop(id(bp.state), None)
        if key in self._needs_crop:
            # hand the engine back with its carry current
            self._pack.crop_lane(key, bp)
            self._needs_crop.discard(key)
        self._pack.remove(key)

    @property
    def clusters(self) -> tuple:
        return tuple(self._clusters)

    # -- Planner protocol (the fleet of one) ----------------------------------

    def plan(self, state: ClusterState, *, budget: int | None = None,
             record_trajectory: bool = False,
             record_free_space: bool = True) -> PlanResult:
        key = self._by_state.get(id(state))
        if key is None:
            n = len(self._clusters)
            key = f"cluster{n}"
            while key in self._clusters:
                n += 1
                key = f"cluster{n}"
            self.add_cluster(key, state)
        results = self.plan_fleet({key: budget},
                                  record_trajectory=record_trajectory,
                                  record_free_space=record_free_space)
        return results[key]

    def observe(self, delta: ClusterDelta) -> bool:
        """Single-lane protocol hook.  Deltas of bound states arrive
        through their subscriptions; a multi-cluster fleet needs the lane
        named (:meth:`observe_cluster`, :meth:`FleetService.ingest`):
        broadcasting a delta over unrelated epoch streams would poison
        them."""
        if len(self._clusters) == 1:
            (bp,) = self._clusters.values()
            return bp.observe(delta)
        return True

    def observe_cluster(self, key, delta: ClusterDelta) -> bool:
        """Route one streamed delta to lane ``key``; True iff that
        cluster's warm carry can absorb it (False: it rebuilds at the next
        tick)."""
        return self._clusters[key].observe(delta)

    def reset(self) -> None:
        for bp in self._clusters.values():
            bp.reset()
        self._pack = FleetPack(self.rb)
        self._needs_crop.clear()

    # -- the fleet tick -------------------------------------------------------

    def _sync(self, keys, reg) -> tuple[dict, dict, dict]:
        """Each cluster's delta absorption or (re)build, one after
        another on the host: (registry rebuilds and host syncs, seconds,
        end time) per cluster."""
        stats, secs, at = {}, {}, {}
        for key in keys:
            bp = self._clusters[key]
            if key in self._needs_crop and (bp.stale or bp._pending
                                            or bp._invalid):
                # the sync absorbs into or rebuilds from the planner's
                # carry: refresh it from the lane first
                self._pack.crop_lane(key, bp)
                self._needs_crop.discard(key)
            snap = reg.snapshot()
            t0 = time.perf_counter()
            bp.sync()
            secs[key] = time.perf_counter() - t0
            at[key] = time.perf_counter()
            d = reg.deltas_since(snap)
            stats[key] = (int(d.get("batch.rebuilds", 0)),
                          int(d.get("batch.host_syncs", 0)))
            bp._terminal_seconds = 0.0
        return stats, secs, at

    def _step_of(self, bucket: _Bucket) -> _FleetChunk:
        if bucket.step is None:
            bucket.step = _FleetChunk(bucket, bounds=self.source_bounds,
                                      rb=self.rb)
        return bucket.step

    def plan_fleet(self, budgets: dict | None = None, *,
                   slo_seconds=_UNSET, record_trajectory: bool = False,
                   record_free_space: bool = True) -> dict:
        """One fleet tick: sync every requested cluster, pack, plan all
        of them through bucket rounds, reconcile each, and return ``{key:
        PlanResult}``.

        ``budgets`` maps lane key to move budget (None: that cluster's
        ``cfg.max_moves``); ``budgets=None`` plans every cluster at its
        default.  Clusters not named do not plan this tick and their
        carries are untouched.  ``slo_seconds`` overrides the instance
        default for this tick (None: unbounded)."""
        slo = self.slo_seconds if slo_seconds is _UNSET else slo_seconds
        if budgets is None:
            budgets = {k: None for k in self._clusters}
        unknown = [k for k in budgets if k not in self._clusters]
        if unknown:
            raise KeyError(f"unknown fleet clusters: {unknown!r}")
        keys = [k for k in self._clusters if k in budgets]
        reg = _obs_registry()
        results: dict = {}
        t_tick = time.perf_counter()
        deadline = None if slo is None else t_tick + float(slo)
        with _obs.span("fleet.tick", cat="fleet", counters=True,
                       clusters=len(keys)) as sp:
            sync_stats, sync_dt, sync_at = self._sync(keys, reg)

            # --- budgets, stash replay, packing
            budget_of: dict = {}
            raw: dict = {}
            lane_secs = {k: 0.0 for k in keys}
            packed: set = set()
            for key in keys:
                bp = self._clusters[key]
                b = budgets.get(key)
                budget_of[key] = bp.cfg.max_moves if b is None else b
                raw[key] = []
                if bp._step is None or budget_of[key] <= 0:
                    continue
                take = min(len(bp._stash), budget_of[key])
                if take:
                    raw[key].extend(bp._stash[:take])
                    del bp._stash[:take]
                    reg.inc("batch.stash_replayed", take)
                if key in self._needs_crop and key not in self._pack.tokens:
                    # the lane moved buckets: packing would read the
                    # planner's stale carry; refresh it first
                    self._pack.crop_lane(key, bp)
                    self._needs_crop.discard(key)
                self._pack.ensure(key, bp)
                packed.add(key)

            # --- the rounds
            live = {key for key in packed
                    if len(raw[key]) < budget_of[key]
                    and not self._clusters[key]._done}
            telemetry = _obs.enabled()
            expired = False
            first_dispatch = True
            rounds = chunks = 0
            participations = {k: 0 for k in keys}
            groups = None       # rebuilt when lanes move buckets
            while live and not expired:
                rounds += 1
                if groups is None:
                    groups = [(shape, bucket,
                               [(key, i)
                                for key, i in bucket.lanes().items()
                                if key in packed
                                and self._pack.where.get(key) == (shape, i)])
                              for shape, bucket in self._pack.buckets.items()]
                # the round's lane masks and steps first: a mask's upload
                # waits for the stream, which is empty between rounds
                ready = []
                for shape, bucket, members in groups:
                    active = [(key, i) for key, i in members if key in live]
                    if not active:
                        continue
                    mask = np.zeros(len(bucket), bool)
                    for _key, i in active:
                        mask[i] = True
                    ready.append((shape, bucket, active,
                                  bucket.dispatch_mask(mask),
                                  self._step_of(bucket)))
                # every bucket's chunk goes out before the round's one host
                # sync, so the device runs the buckets back to back; the
                # buckets hold disjoint lanes, so the order changes nothing
                pending = []
                for shape, bucket, active, mask, step in ready:
                    if (not first_dispatch and deadline is not None
                            and time.perf_counter() > deadline):
                        # cut before more work; what is in flight below is
                        # still fetched (it is applied in the carries)
                        expired = True
                        break
                    first_dispatch = False
                    t0 = time.perf_counter()
                    out = step.run(self.chunk, mask, telemetry)
                    pending.append((shape, bucket, active, out, t0))
                if not pending:
                    continue
                reg.inc("fleet.rounds")
                if len(pending) > 1:
                    reg.inc("fleet.rounds.overlapped")
                # one blocking transfer for the whole round
                fetched = _fetch(torch.cat([p[3].reshape(-1)
                                            for p in pending]))
                reg.inc("fleet.round_syncs")
                at = 0
                for shape, bucket, active, out, t0 in pending:
                    packed_np = fetched[at:at + out.numel()].reshape(
                        out.shape)
                    at += out.numel()
                    dt = time.perf_counter() - t0
                    chunks += 1
                    reg.inc("fleet.chunks")
                    m, n = self.chunk, shape.n_dev
                    lane_dt = dt / len(active)
                    if telemetry:
                        rows = [i for _k, i in active]
                        tel = packed_np[rows, 5 * m + 3 + n:]
                        reg.inc("batch.tiles_walked", int(tel[:, 0].sum()))
                        reg.inc("batch.cand_tiles", int(tel[:, 1].sum()))
                    for key, i in active:
                        bp = self._clusters[key]
                        lane_np = packed_np[i]
                        participations[key] += 1
                        lane_secs[key] += lane_dt
                        em = lane_np[:5 * m].reshape(m, 5)
                        em = em[em[:, 0] >= 0]
                        lane_done = bool(lane_np[5 * m])
                        lane_ovf = bool(lane_np[5 * m + 1])
                        nmax = int(lane_np[5 * m + 2])
                        # the certificates as the serial engine holds them
                        # after a fetch (what an absorption may keep)
                        mask_np = lane_np[5 * m + 3:5 * m + 3
                                          + bucket.dims[i].n_dev] != 0
                        bp._pruned_mask = mask_np
                        bp._pruned = int(mask_np.sum())
                        per_s = lane_dt / max(len(em), 1)
                        raw[key].extend((*mv, per_s)
                                        for mv in map(tuple, em.tolist()))
                        if len(em) == 0 and lane_done and not lane_ovf:
                            bp._terminal_seconds += lane_dt
                        if len(raw[key]) >= budget_of[key]:
                            over = len(raw[key]) - budget_of[key]
                            if over:
                                # the overshoot is applied in the carry:
                                # held for the next tick, as the serial
                                # engine holds it
                                reg.inc("batch.stash_moves", over)
                                _obs.point("batch.stash", cat="batch",
                                           moves=over)
                                bp._stash = (raw[key][budget_of[key]:]
                                             + bp._stash)
                                del raw[key][budget_of[key]:]
                            if lane_done:
                                bp._done = True
                            live.discard(key)
                        elif lane_done:
                            bp._done = True
                            live.discard(key)
                        if key in live and (lane_ovf or
                                            nmax + self.chunk > shape.r_cap):
                            # only this lane moves to the next row
                            # capacity; every other lane stays as it is
                            reg.inc("fleet.rebuckets")
                            _obs.point("fleet.rebucket", cat="fleet",
                                       cluster=str(key), r_cap=shape.r_cap)
                            self._pack.rebucket(key)
                            groups = None

            slo_cut = set(live) if expired else set()

            # planned-on lanes ran ahead of their planners' carries; the
            # crop waits until something reads those (see _needs_crop)
            for key in keys:
                if key in packed and participations[key] > 0:
                    self._needs_crop.add(key)

            # --- per-cluster reconcile and stats
            total_moves = 0
            for key in keys:
                bp = self._clusters[key]
                with _obs.span("planner.plan", cat="planner", counters=True,
                               planner=self.name, cluster=str(key)) as psp:
                    t0 = time.perf_counter()
                    movements, records = bp._reconcile(
                        raw[key], record_trajectory, record_free_space)
                    stats: dict = {}
                    acc = tail_stats(stats)
                    for _row, _src, _dst, tried, skipped, secs in raw[key]:
                        tail_record(acc, tried, secs, 0.0)
                        acc["bound_hits"] += int(skipped)
                    tail_terminal(acc, bp._terminal_seconds)
                    if self.source_bounds and key in packed:
                        # the count at the lane's last fetch, or the one
                        # its last build or absorption left
                        acc["pruned"] = bp._pruned
                    tail_flush(acc)
                    rebuilds, sync_syncs = sync_stats[key]
                    now = time.perf_counter()
                    stats.update({
                        "planning_seconds": (sync_dt[key] + lane_secs[key]
                                             + (now - t0)),
                        "budget": budgets.get(key),
                        "engine": "fleet",
                        "warm": True,
                        "rebuilds": rebuilds,
                        "absorbed_deltas": bp._absorbed_deltas,
                        # the sync's transfers and one a round the lane
                        # took part in; nothing is compiled
                        "host_syncs": sync_syncs + participations[key],
                        "jit_recompiles": 0,
                        "stash_moves": len(bp._stash),
                        "legality_cache": False,
                        "source_bounds": self.source_bounds,
                        "fleet_clusters": len(keys),
                        "slo_deadline_seconds": (None if slo is None
                                                 else float(slo)),
                        "slo_expired": key in slo_cut,
                        "plan_freshness_seconds": now - sync_at[key],
                        "converged": bool(bp._done or bp._step is None),
                        "variance_after":
                            float(bp.state.utilization_variance()),
                    })
                    result = PlanResult(movements, records, self.name,
                                        stats=stats)
                    results[key] = _finish(result, psp)
                total_moves += len(movements)
                _obs.point("fleet.plan", cat="fleet", cluster=str(key),
                           moves=len(movements),
                           wall=results[key].stats["planning_seconds"],
                           freshness=results[key].stats[
                               "plan_freshness_seconds"],
                           slo_expired=key in slo_cut,
                           converged=results[key].stats["converged"])

            reg.inc("fleet.ticks")
            reg.inc("fleet.planned_moves", total_moves)
            if slo is not None:
                reg.inc("fleet.slo_misses" if expired else "fleet.slo_hits")
            reg.set_gauge("fleet.clusters", len(self._clusters))
            sp.set(rounds=rounds, chunks=chunks, moves=total_moves,
                   slo_expired=bool(expired),
                   wall=time.perf_counter() - t_tick)
        return results
