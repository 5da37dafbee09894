"""Device-resident batched Equilibrium planner, in PyTorch.

The port of :mod:`repro.core.equilibrium_batch`'s cold path.  All
planning state lives in tensors on one device (an H100 by default, the
CPU when the caller asks for it), and the host syncs **once per chunk**
of up to ``chunk`` moves:

* **The carry** is the reference's compact ground truth, updated in
  place: the ``(n_pg, max_pool_size)`` acting table, per-pool shard
  counts and the destination-count criterion, the per-device shard
  row-sets as a padded ``(n_dev, r_cap)`` table in faithful candidate
  order (size descending, row ascending), the maintained stable
  fullest-first device order, the two utilization moments, and the
  source-bound certificates (``pruned``).
* **One step evaluates the whole candidate tensor.**  The reference step
  walks (source, row-block) tiles in a ``lax.while_loop`` until the
  faithful winner is decided; torch has no data-dependent loop without a
  host sync.  This step evaluates every criterion on the full
  ``(k, r_cap, n_dev)`` tensor of the compacted top-k sources at once —
  the reference's ``source_block=k``, ``row_block ≥ r_cap`` tile, which
  its own tests pin as move-for-move identical — and reduces it with one
  launch of kernel K1 (:func:`repro_torch.kernels.ops.masked_select`).
  At the reference default ``source_block=1`` the walk's outcome is a
  closed form, derived here with masked reductions and no loop:

  - the winner is the first compacted position ``p < n_avail`` whose
    source has a row with a legal destination; its row is the first such
    row in faithful order, its destination K1's ``dst``;
  - ``sources_tried = rank + 1`` with ``rank`` the winner's position in
    the uncompacted order, and ``bound_skips = rank - p``;
  - the newly pruned sources are the positions ``q < p`` (every
    ``q < n_avail`` when nothing wins) whose candidate mask — every
    criterion but the variance test — is empty on every row.

  So moves, ``sources_tried``, ``bound_hits`` and ``pruned_sources`` are
  the reference's exactly, and the step has no data-dependent loop (a
  later fleet port can add a leading lane axis to every tensor).
* **Moves apply as masked updates**: ``torch.where(ok, new, old)`` and
  indexed writes, in place on the carry, so a step that finds nothing
  (or runs after convergence) changes no value.
* **No host sync inside a chunk.**  Every index is a 1-element tensor
  (indexing with a 0-dim integer tensor calls ``.item()``), no boolean
  mask indexing, no ``nonzero``; the host fetches one packed int64
  vector per chunk — the ``(chunk, 5)`` move block, ``done``,
  ``overflow``, ``max(nrows)`` and the pruned count — counted on
  ``batch.host_syncs``.
* **float64 everywhere** on the criteria, with the legality core's
  expressions in the reference's operand order; the utilization moments
  come from the host mirror and are only ever updated by the reference
  expressions, never re-summed on the device.

Indices that the reference leaves to JAX's clamped gathers and dropped
scatters are clamped or masked explicitly here: torch wraps a negative
index and a positive out-of-range one is a device-side assert.

Not in this slice: delta absorption (:meth:`BatchPlanner.observe`
returns False, so any external mutation rebuilds at the next plan), the
legality cache, device telemetry and pipelined dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import legality
from .cluster import ClusterDelta, ClusterState, Movement
from .dense import DenseState
from .equilibrium import EquilibriumConfig, MoveRecord
from .tail import tail_flush, tail_record, tail_stats, tail_terminal
from .. import obs as _obs
from ..kernels.ops import masked_select
from ..device import resolve_device
from ..kernels.select_move import compact_parked
from ..obs import registry as _obs_registry

F64 = torch.float64
I64 = torch.int64


def host_sync_count() -> int:
    """Total device→host transfers made by this engine — a monotonic
    read of the ``batch.host_syncs`` registry counter."""
    return int(_obs_registry().get("batch.host_syncs"))


def dense_rebuild_count() -> int:
    """Total from-scratch dense-state builds (``batch.rebuilds``)."""
    return int(_obs_registry().get("batch.rebuilds"))


def _fetch(t: torch.Tensor) -> np.ndarray:
    """The only device→host transfer point in this module: one call per
    planning chunk (plus one per re-pad), never per move or source."""
    _obs_registry().inc("batch.host_syncs")
    return t.cpu().numpy()


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Lowest index along the last dim where ``mask`` holds, 0 where it
    never does (``jnp.argmax`` of a bool array, with the tie order
    written out instead of left to ``torch.argmax``)."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    first = torch.where(mask, iota, n).amin(dim=-1)
    return torch.where(first == n, 0, first)


def _shift_remove(arr: torch.Tensor, pos: torch.Tensor, pad: int
                  ) -> torch.Tensor:
    """Drop ``arr[pos]``, shift the tail left, pad the freed last slot."""
    n = arr.shape[0]
    idx = torch.arange(n, device=arr.device)
    out = torch.where(idx >= pos, torch.roll(arr, -1), arr)
    # not ``out[n - 1] = pad``: writing a host scalar into a CUDA tensor
    # is a host-to-device copy that synchronises
    return torch.where(idx == n - 1, pad, out)


def _shift_insert(arr: torch.Tensor, pos: torch.Tensor,
                  value: torch.Tensor) -> torch.Tensor:
    """Insert ``value`` at ``pos``, shifting the tail right (last drops)."""
    n = arr.shape[0]
    idx = torch.arange(n, device=arr.device)
    return torch.where(idx < pos, arr,
                       torch.where(idx == pos, value, torch.roll(arr, 1)))


# ---------------------------------------------------------------------------
# The chunk: select + apply up to `m` moves on the device, in place


class _Chunk:
    """One cluster's device carry plus the step that advances it.

    ``dyn`` (mutated in place): used, util (n,) f64; us, usq (1,) f64 —
    the maintained moments; acting (n_pg, S); pool_counts (P, n) f64;
    dst_ok (P, n) bool; rows_on (n, r_cap) with -1 padding; nrows,
    order (n,); pruned (n,) bool.  ``const``: cap, dev_class, dev_in,
    dev_domain (L, n), the per-shard tables sh_* and ideal (P, n).
    Integer tensors are int64 throughout (torch's index type).
    """

    def __init__(self, dyn: dict, const: dict, scal: dict, *, k: int,
                 bounds: bool):
        self.dyn, self.const, self.scal = dyn, const, scal
        self.k, self.bounds = k, bounds
        dev = const["cap"].device
        n = const["cap"].shape[0]
        self.dev_iota = torch.arange(n, device=dev)
        self.pos = torch.arange(k, device=dev)
        self.cap_lim = legality.capacity_limit(const["cap"],
                                               scal["headroom"])

    @property
    def r_cap(self) -> int:
        return self.dyn["rows_on"].shape[1]

    # -- selection -----------------------------------------------------------

    def select(self, active: torch.Tensor):
        """One §3.1 planning step's selection over the full candidate
        tensor; updates ``pruned`` (where ``active``) and returns
        (found, row, src, dst, tried, skipped), each (1,)."""
        d, c, s = self.dyn, self.const, self.scal
        k, r_cap = self.k, self.r_cap
        used, util = d["used"], d["util"]
        iota, pos = self.dev_iota, self.pos
        order_k = d["order"][:k]            # maintained argsort(-util, stable)
        if self.bounds:
            # unpruned sources first (fullest-first order preserved),
            # pruned ones parked at the back and excluded by n_avail
            src_order, n_avail = compact_parked(order_k, d["pruned"][order_k])
        else:
            src_order, n_avail = order_k, torch.full((), k, device=pos.device)
        avail = pos < n_avail                                  # (k,)
        rows_k = d["rows_on"][src_order]                       # (k, R)
        real = rows_k >= 0
        r = rows_k.clamp(min=0)             # -1 padding gathers row 0, masked
        pg, lvl, slot = c["sh_pg"][r], c["sh_level"][r], c["sh_slot"][r]
        sbase, scnt = c["sh_sbase"][r], c["sh_scnt"][r]
        pool = c["sh_pool"][r]
        size = torch.where(real, c["sh_size"][r], 0.0)         # (k, R) f64

        # static legality: class match ∧ ¬member ∧ failure-domain free,
        # from the acting table, all S slots of each row's PG at once
        # (the reference loops over the slots; one (k, R, S, n) compare
        # per test is the same OR with a few launches instead of ~12 per
        # slot).  Padded slots are -1: never a member, never a peer.
        acting_t = d["acting"][pg]                             # (k, R, S)
        j = torch.arange(acting_t.shape[2], device=iota.device)
        lo, n_in = sbase[..., None], scnt[..., None]
        in_step = (lo <= j) & (lo + n_in > j) & (slot[..., None] != j)
        peer = torch.where(in_step, c["dev_domain"][lvl[..., None],
                                                    acting_t.clamp(min=0)],
                           -1)                 # domain ids are >= 0
        member = (acting_t[..., None] == iota).any(dim=2)      # (k, R, n)
        clash = (c["dev_domain"][lvl][:, :, None, :]
                 == peer[..., None]).any(dim=2)
        static = legality.class_ok(c["sh_class"][r][..., None],
                                   c["dev_class"]) & ~(member | clash)

        # candidate mask: every criterion except the variance test
        src_c = src_order[:, None]                             # (k, 1)
        src_cc = src_order[:, None, None]                      # (k, 1, 1)
        cap_ok = legality.capacity_ok(used, self.cap_lim, size[..., None])
        crit = d["dst_ok"][pool]                               # (k, R, n)
        src_ok = legality.src_count_ok(d["pool_counts"][pool, src_c],
                                       c["ideal"][pool, src_c], s["slack"])
        u_s = util[src_order][:, None, None]
        before_src = legality.before_source(util, u_s, iota, src_cc)
        cand = (static & cap_ok & crit & (real & src_ok)[..., None]
                & (iota != src_cc) & c["dev_in"] & before_src)

        # exact variance acceptance (float64, reference operand order)
        var_ok = legality.variance_improves(
            used[src_order][:, None, None], used,
            c["cap"][src_order][:, None, None], c["cap"], u_s, util,
            size[..., None], d["us"], d["usq"], s["n_f"], s["min_dvar"])
        any_row, dst = masked_select((cand & var_ok).view(k * r_cap, -1),
                                     util)                      # K1
        any_row = any_row.view(k, r_cap) & avail[:, None]
        dst = dst.view(k, r_cap)

        # winner: the first available source with a legal row
        src_has = any_row.any(dim=1)                           # (k,)
        p = torch.where(src_has, pos, k).amin()                # k: none
        found = (p < k).view(1)
        jw = p.clamp(max=k - 1).view(1)
        hit = any_row.index_select(0, jw)[0]                   # (R,)
        ri = _first_true(hit).view(1)
        row = rows_k.index_select(0, jw)[0].index_select(0, ri)
        win_dst = dst.index_select(0, jw)[0].index_select(0, ri).to(I64)
        win_dev = src_order.index_select(0, jw)
        if self.bounds:
            # rank in the *full* fullest-first order: sources_tried stays
            # the faithful histogram; rank − p scans were certificate skips
            rank = _first_true(order_k == win_dev).view(1)
            # certificates: scanned, fruitless sources with no candidate
            # pair on any row — the verdict the variance test cannot undo
            no_cand = ~cand.flatten(1).any(dim=1)              # (k,)
            prunable = (pos < p) & avail & no_cand & active
            pr = d["pruned"]
            pr[src_order] = pr[src_order] | prunable    # src_order: distinct
        else:
            rank = jw
        return found, row, win_dev, win_dst, rank + 1, rank - jw

    # -- apply ---------------------------------------------------------------

    def _reorder(self, util, src, dst) -> torch.Tensor:
        """Re-sort ``src`` and ``dst`` within the maintained stable
        argsort(-util) order after their utilizations changed: both are
        removed before either is re-inserted, insertion ranks counted
        from the (-util, index) key."""
        order, iota = self.dyn["order"], self.dev_iota
        o = _shift_remove(order, _first_true(order == src), -1)
        o = _shift_remove(o, _first_true(o == dst), -1)
        u_s, u_d = util[src], util[dst]
        before_src = ((util > u_s) | ((util == u_s) & (iota < src))) \
            & (iota != dst)
        o = _shift_insert(o, before_src.sum(), src)
        before_dst = (util > u_d) | ((util == u_d) & (iota < dst))
        return _shift_insert(o, before_dst.sum(), dst)

    def apply(self, ok, row, src, dst) -> None:
        """In-place mirror of ``DenseState.apply_row`` (same update order,
        bit-identical float accumulation).  ``ok=False`` makes every
        update write back the old value."""
        d, c, s = self.dyn, self.const, self.scal
        used, util = d["used"], d["util"]
        okf = ok.to(F64)
        oki = ok.to(I64)
        row = torch.where(ok, row, 0)
        size = c["sh_size"][row]
        pgi, pool, slot = c["sh_pg"][row], c["sh_pool"][row], c["sh_slot"][row]
        both = torch.cat([src, dst])
        if self.bounds:
            # pre-update snapshots for the source-side certificate triggers
            util_src_before = util[src]
            used_src_before = used[src]
            dok_src_before = d["dst_ok"][pool, src]
        acting = d["acting"]
        acting[pgi, slot] = torch.where(ok, dst, acting[pgi, slot])
        pc = d["pool_counts"]
        pc[pool, both] = pc[pool, both] + torch.cat([-okf, okf])
        # the destination-count criterion changed only where counts did
        ok2 = legality.dst_count_ok(pc[pool, both], c["ideal"][pool, both],
                                    s["slack"])
        dok = d["dst_ok"]
        dok[pool, both] = torch.where(ok, ok2, dok[pool, both])
        # sorted row lists: shift-remove from src, shift-insert into dst
        rows_on = d["rows_on"]
        src_list = rows_on[src][0]
        removed = _shift_remove(src_list, _first_true(src_list == row), -1)
        dst_list = rows_on[dst][0]
        dsz = torch.where(dst_list >= 0, c["sh_size"][dst_list.clamp(min=0)],
                          float("-inf"))
        before = (dst_list >= 0) & ((dsz > size)
                                    | ((dsz == size) & (dst_list < row)))
        inserted = _shift_insert(dst_list, before.sum(), row)
        rows_on[both] = torch.stack([torch.where(ok, removed, src_list),
                                     torch.where(ok, inserted, dst_list)])
        nrows = d["nrows"]
        nrows[both] = nrows[both] + torch.cat([-oki, oki])
        used[both] = used[both] + torch.cat([-size * okf, size * okf])
        cap = c["cap"]
        for i in (src, dst):                  # source first, like apply_row
            u_new = used[i] / cap[i]          # no-op when ok=False: the
            d["us"] += u_new - util[i]        # recomputed ratio is bit-
            d["usq"] += u_new ** 2 - util[i] ** 2   # identical, deltas 0.0
            util[i] = u_new
        new_order = self._reorder(util, src, dst)
        d["order"].copy_(torch.where(ok, new_order, d["order"]))
        if self.bounds:
            # surgical certificate invalidation: touch (endpoints), holder
            # (post-move acting set of the moved PG), emptiest-order
            # crossing, count flip, capacity binding
            iota = self.dev_iota
            holder = (acting[pgi][0][None, :] == iota[:, None]).any(dim=1)
            touch = (iota == src) | (iota == dst) | holder
            crossed = legality.bound_crossed(util_src_before, util[src],
                                             util, src, iota)
            flip = legality.count_flip_enables(dok_src_before,
                                               dok[pool, src])
            holds_pool = pc[pool][0] > 0.0
            largest = rows_on[:, 0]
            maxsz = torch.where(largest >= 0,
                                c["sh_size"][largest.clamp(min=0)], 0.0)
            bind = legality.bound_capacity_binding(
                used_src_before, self.cap_lim[src], maxsz)
            inval = touch | crossed | (flip & holds_pool) | bind
            pr = d["pruned"]
            pr.copy_(torch.where(ok, pr & ~inval, pr))

    # -- chunk ---------------------------------------------------------------

    def run(self, m: int) -> torch.Tensor:
        """Up to ``m`` steps; returns the packed int64 result the host
        fetches: the (m, 5) move block (row, src, dst, sources_tried,
        bound_skips, or -1 sentinels) flattened, then done, overflow,
        max(nrows) and the pruned-source count."""
        dev = self.dev_iota.device
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        overflow = torch.zeros(1, dtype=torch.bool, device=dev)
        moves = torch.empty((m, 5), dtype=I64, device=dev)
        nrows = self.dyn["nrows"]
        for t in range(m):
            active = ~(done | overflow)
            found, row, src, dst, tried, skipped = self.select(active)
            found &= active
            # a full destination row list would drop a shard: stop and let
            # the host re-pad (never hit when r_cap >= max rows + chunk)
            ovf = found & (nrows[dst] >= self.r_cap)
            ok = found & ~ovf
            self.apply(ok, row, src, dst)
            moves[t] = torch.where(ok, torch.cat([row, src, dst, tried,
                                                  skipped]), -1)
            done |= active & ~found
            overflow |= ovf
        return torch.cat([moves.flatten(), done.to(I64), overflow.to(I64),
                          nrows.max().view(1),
                          self.dyn["pruned"].sum().view(1)])


# ---------------------------------------------------------------------------
# Host driver


def _pack_rows(rows_on_dev, sh_size: np.ndarray, r_cap: int) -> np.ndarray:
    """Pad per-device row sets to (n_dev, r_cap), each in the faithful
    candidate order: size descending, row (= (pg, slot)) ascending."""
    rows = np.full((len(rows_on_dev), r_cap), -1, np.int64)
    for d, s in enumerate(rows_on_dev):
        order = sorted(s, key=lambda r: (-sh_size[r], r))
        rows[d, :len(order)] = order
    return rows


class BatchPlanner:
    """Handle on the device-resident engine bound to one ClusterState.

    The carry stays alive between :meth:`plan` calls while the bound
    state is unchanged (``state.mutation_epoch`` equals the epoch the
    carry was synced at), so moves planned past one call's budget — the
    overshoot stash, already applied in the carry — are emitted first by
    the next call, and the emitted stream is the cold-start sequence.
    Any other mutation of the state rebuilds the carry at the next plan.
    """

    #: per-device row tables are padded in multiples of this many rows
    ROW_ALIGN = 8

    def __init__(self, state: ClusterState,
                 cfg: EquilibriumConfig | None = None, chunk: int = 64,
                 row_capacity: int | None = None,
                 source_bounds: bool = True,
                 device=None):
        self.state = state
        self.cfg = cfg or EquilibriumConfig()
        self.chunk = chunk
        self.row_capacity = row_capacity
        self.source_bounds = source_bounds
        self.device = resolve_device(device, "equilibrium_batch")
        self._dense = None
        self._step: _Chunk | None = None
        self._epoch = -1                # state.mutation_epoch at last sync
        self._done = False
        self._pruned = 0                # pruned count at the last fetch
        self._terminal_seconds = 0.0
        # moves the device already planned+applied in the carry but the
        # host has not yet emitted: (row, src, dst, tried, skipped, secs)
        self._stash: list[tuple[int, int, int, int, int, float]] = []

    # -- dense-state lifecycle ----------------------------------------------

    def _round_cap(self, n: int) -> int:
        a = self.ROW_ALIGN
        return max(a, -(-int(n) // a) * a)

    def _build(self) -> None:
        """Full rebuild of the device carry from ``self.state``."""
        _obs_registry().inc("batch.rebuilds")
        _obs.point("batch.rebuild", cat="batch",
                   n_devices=self.state.n_devices)
        state, cfg = self.state, self.cfg
        self._stash = []
        self._done = False
        self._pruned = 0
        self._dense = None
        self._step = None
        self._epoch = state.mutation_epoch
        if not state.acting or not state.pools or state.n_devices < 2:
            return
        dense = DenseState(state)
        if not dense.shard_key:
            return
        self._dense = dense
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        # compact acting table (n_pg, max pool size), padded with -1
        n_slots = max(p.size for p in state.pools.values())
        acting_np = np.full((len(dense.pgs), n_slots), -1, np.int64)
        for pg, pgi in dense.pg_index.items():
            osds = state.acting[pg]
            acting_np[pgi, :len(osds)] = [state.idx(o) for o in osds]
        const = {
            "cap": t(dense.cap, F64), "dev_class": t(dense.dev_class, I64),
            "dev_in": t(dense.dev_in, torch.bool),
            "dev_domain": t(dense.dev_domain_arr, I64),
            "sh_size": t(dense.sh_size.astype(np.float64), F64),
            "sh_pg": t(dense.sh_pg, I64), "sh_pool": t(dense.sh_pool, I64),
            "sh_class": t(dense.sh_class, I64),
            "sh_level": t(dense.sh_level, I64),
            "sh_slot": t(dense.sh_slot, I64),
            "sh_sbase": t(dense.sh_sbase, I64),
            "sh_scnt": t(dense.sh_scnt, I64),
            "ideal": t(dense.ideal, F64),
        }
        nrows_np = np.array([len(s) for s in dense.rows_on_dev], np.int64)
        r_cap = self._round_cap(
            max(self.row_capacity, int(nrows_np.max()))
            if self.row_capacity is not None
            else int(nrows_np.max()) + self.chunk)
        dyn = {
            "used": t(dense.used, F64), "util": t(dense.util, F64),
            # the moments come from the host mirror, as float64 scalars
            "us": t([dense.util_sum], F64), "usq": t([dense.util_sumsq], F64),
            "acting": t(acting_np, I64),
            "pool_counts": t(dense.pool_counts, F64),
            "dst_ok": t(legality.dst_count_ok(dense.pool_counts, dense.ideal,
                                              cfg.count_slack), torch.bool),
            "rows_on": t(_pack_rows(dense.rows_on_dev, dense.sh_size, r_cap),
                         I64),
            "nrows": t(nrows_np, I64),
            "order": t(legality.fullest_first(dense.util), I64),
            "pruned": torch.zeros(dense.n_dev, dtype=torch.bool, device=dev),
        }
        # every scalar is a tensor on the carry's device: a CUDA division
        # by a host scalar would multiply by its reciprocal instead
        scal = {"slack": t(cfg.count_slack, F64),
                "headroom": t(cfg.headroom, F64),
                "min_dvar": t(cfg.min_variance_delta, F64),
                "n_f": t(float(dense.n_dev), F64)}
        self._step = _Chunk(dyn, const, scal,
                            k=min(cfg.k, max(state.n_devices, 1)),
                            bounds=self.source_bounds)

    @property
    def stale(self) -> bool:
        return self._epoch != self.state.mutation_epoch

    def observe(self, delta: ClusterDelta) -> bool:
        """Delta absorption is not ported yet: every delta invalidates
        the carry, and the next :meth:`plan` rebuilds it (the reference's
        own conservative fallback, so sequences stay correct)."""
        return False

    def reset(self) -> None:
        """Drop all warm state; the next :meth:`plan` cold-starts."""
        self._epoch = -1
        self._step = None
        self._dense = None
        self._stash = []
        self._done = False
        self._pruned = 0

    def sync(self) -> None:
        """Cold-build on first use or after any external mutation."""
        if self._epoch < 0 or self.stale:
            self._build()

    # -- planning ------------------------------------------------------------

    def _flush_stats(self, raw_moves, stats_out: dict, snap: dict) -> None:
        """Convergence-tail instrumentation (one schema with the host
        engines via ``tail_flush``; selection and apply are fused on the
        device, so the whole chunk-amortized move time is selection) plus
        this engine's registry-counter deltas."""
        acc = tail_stats(stats_out)
        for _row, _src, _dst, tried, skipped, secs in raw_moves:
            tail_record(acc, tried, secs, 0.0)
            acc["bound_hits"] += int(skipped)
        tail_terminal(acc, self._terminal_seconds)
        if self.source_bounds and self._step is not None:
            acc["pruned"] = self._pruned
        tail_flush(acc)
        self._engine_stats(snap, stats_out)

    def _engine_stats(self, snap: dict, stats_out: dict) -> None:
        # no legality cache and no pipelined dispatch in this engine yet
        stats_out["legality_cache"] = False
        stats_out["source_bounds"] = self.source_bounds
        stats_out["pipeline"] = False
        self._registry_stats(snap, stats_out)

    def _reconcile(self, raw_moves, record_trajectory: bool,
                   record_free_space: bool
                   ) -> tuple[list[Movement], list[MoveRecord]]:
        """Replay the emitted move log through :meth:`ClusterState.apply`
        (which re-validates every source assignment), then mark the
        carry synced to the resulting epoch."""
        dense, state = self._dense, self.state
        movements: list[Movement] = []
        records: list[MoveRecord] = []
        for row, src, dst, tried, _skipped, secs in raw_moves:
            pg, slot = dense.shard_key[row]
            mv = Movement(pg, slot, state.devices[src].id,
                          state.devices[dst].id,
                          float(dense.sh_size[row]))
            state.apply(mv)
            movements.append(mv)
            if record_trajectory:
                records.append(MoveRecord(
                    movement=mv,
                    variance_after=state.utilization_variance(),
                    free_space_after=(state.total_pool_free_space()
                                      if record_free_space
                                      else float("nan")),
                    planning_seconds=secs,
                    sources_tried=tried,
                ))
        self._epoch = state.mutation_epoch
        return movements, records

    def _registry_stats(self, snap: dict, stats_out: dict) -> None:
        """Deltas of this engine's registry counters since plan entry."""
        d = _obs_registry().deltas_since(snap)
        stats_out["rebuilds"] = int(d.get("batch.rebuilds", 0))
        stats_out["host_syncs"] = int(d.get("batch.host_syncs", 0))
        stats_out["jit_recompiles"] = 0
        stats_out["stash_moves"] = int(d.get("batch.stash_moves", 0))
        stats_out["cache_hits"] = 0
        stats_out["cache_misses"] = 0
        stats_out["absorbed_deltas"] = 0

    def _repad(self) -> None:
        """Widen the per-device row table to max rows + chunk (one sync).
        The source bounds say nothing about row geometry and survive."""
        reg = _obs_registry()
        reg.inc("batch.repads")
        _obs.point("batch.repad", cat="batch", r_cap=self._step.r_cap)
        dyn = self._step.dyn
        packed = _fetch(torch.cat([dyn["nrows"][:, None], dyn["rows_on"]],
                                  dim=1))
        nrows_np, rows_np = packed[:, 0], packed[:, 1:]
        r_cap = self._round_cap(int(nrows_np.max()) + self.chunk)
        rows = np.full((rows_np.shape[0], r_cap), -1, np.int64)
        for i, nd in enumerate(nrows_np.tolist()):
            rows[i, :nd] = rows_np[i, :nd]
        dyn["rows_on"] = torch.as_tensor(rows, device=self.device)

    def _chunk_loop(self, budget: int
                    ) -> list[tuple[int, int, int, int, int, float]]:
        """Run chunks until ``budget`` raw moves are on hand (stashing any
        overshoot), the device reports convergence, or a re-pad is
        needed.  ``self._terminal_seconds`` collects the wall time of
        chunks that emit no moves (the terminal fruitless scan)."""
        self._terminal_seconds = 0.0
        raw: list[tuple[int, int, int, int, int, float]] = []
        take = min(len(self._stash), budget)
        raw.extend(self._stash[:take])
        del self._stash[:take]
        reg = _obs_registry()
        if take:
            reg.inc("batch.stash_replayed", take)
        m = self.chunk
        while len(raw) < budget and not self._done:
            reg.inc("batch.chunks")
            with _obs.span("batch.chunk", cat="batch") as sp:
                t0 = time.perf_counter()
                out = self._step.run(m)
                t1 = time.perf_counter()
                packed = _fetch(out)
                dt = time.perf_counter() - t0
                moves_np = packed[:5 * m].reshape(m, 5)
                done, overflow = bool(packed[5 * m]), bool(packed[5 * m + 1])
                nmax = int(packed[5 * m + 2])
                self._pruned = int(packed[5 * m + 3])
                emitted = moves_np[moves_np[:, 0] >= 0]
                sp.set(emitted=len(emitted), done=done, overflow=overflow,
                       dispatch_s=round(t1 - t0, 6),
                       sync_s=round(time.perf_counter() - t1, 6))
            if len(emitted) == 0 and done and not overflow:
                self._terminal_seconds += dt
            per_s = dt / max(len(emitted), 1)
            raw.extend((*mv, per_s) for mv in map(tuple, emitted.tolist()))
            if len(raw) >= budget:
                # device ran past the budget: the overshoot is already
                # applied in the carry — hold it for the next call
                over = len(raw) - budget
                if over:
                    reg.inc("batch.stash_moves", over)
                    _obs.point("batch.stash", cat="batch", moves=over)
                self._stash = raw[budget:] + self._stash
                del raw[budget:]
                self._done = done
                break
            if done:
                self._done = True
                break
            if overflow or nmax + self.chunk > self._step.r_cap:
                self._repad()
        return raw

    def plan(self, max_moves: int | None = None,
             record_trajectory: bool = False,
             record_free_space: bool = True,
             stats_out: dict | None = None):
        """Plan up to ``max_moves`` (default ``cfg.max_moves``) further
        moves, applying them to the bound state; returns (movements,
        records) exactly like :func:`repro_torch.core.equilibrium._balance`.
        """
        budget = self.cfg.max_moves if max_moves is None else max_moves
        snap = (_obs_registry().snapshot() if stats_out is not None
                else None)
        self.sync()
        if self._step is None or budget <= 0:
            if stats_out is not None:
                tail_flush(tail_stats(stats_out))
                self._engine_stats(snap, stats_out)
            return [], []
        raw_moves = self._chunk_loop(budget)
        if stats_out is not None:
            self._flush_stats(raw_moves, stats_out, snap)
        return self._reconcile(raw_moves, record_trajectory,
                               record_free_space)
