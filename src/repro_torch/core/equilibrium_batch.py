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
  walks (source block, row block) tiles of ``source_block`` (kb) sources
  and ``row_block`` (rb) rows in a ``lax.while_loop`` until the faithful
  winner is decided; torch has no data-dependent loop without a host
  sync.  This step evaluates every criterion on the full
  ``(k_pad, r_cap, n_dev)`` candidate space of the compacted top-k
  sources at once — the reference's ``source_block=k``, ``row_block ≥
  r_cap`` tile, which its own tests pin as move-for-move identical — and
  reduces it per row, all in one launch of kernel K1
  (:func:`repro_torch.kernels.ops.bind_select_rows`), which never writes
  the mask to device memory.  ``k_pad`` rounds k up to a multiple of kb:
  as the reference's ``jnp.pad`` does, positions ``k..k_pad-1`` take
  device 0 and its rows, are never available, and are evaluated, counted
  and cached like any position.  The walk's outcome at any kb is a closed
  form of K1's outputs, with masked reductions and no loop
  (:meth:`_Chunk.frontier`, :meth:`_Chunk.certified`,
  :meth:`_Chunk.walked`):

  - the winner is the first compacted position ``p < n_avail`` whose
    source has a row with a legal destination; its row is the first such
    row in faithful order, its destination K1's ``dst``; it sits in block
    ``p // kb`` — the walk's order never changes the winner;
  - ``sources_tried = rank + 1`` with ``rank`` the winner's position in
    the uncompacted order, and ``bound_skips = rank - p``;
  - each block before the winner's (every block up to the one holding
    position ``n_avail - 1`` when nothing wins, block 0 when nothing is
    available) walks as many row blocks as its longest slot, at least
    one, a slot past ``n_avail`` counting as empty; the winner's block
    walks up to the row block where the winner has found its row and
    every fuller slot of the block has run out of rows;
  - the newly pruned sources are the available positions the walk
    resolved whose candidate mask — every criterion but the variance
    test — is empty on every row: every one in a block walked whole, and
    in the winner's block every other position whose rows all lay in the
    tiles walked, after the winner too.

  So moves, ``sources_tried``, ``bound_hits`` and ``pruned_sources`` are
  the reference's exactly at every kb, and the step has no
  data-dependent loop: :mod:`repro_torch.fleet` runs its kb-1 form with
  a leading lane axis on every tensor.  At kb 1 a tile is one position's
  row block and the same closed form takes fewer operations.
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

* **Warm start and delta absorption.**  :class:`BatchPlanner` keeps the
  carry between plans and subscribes to the bound state's delta stream;
  an external mutation (pool growth, device add, device out or back in,
  a foreign movement, a pool create) is absorbed into a freshly built
  carry at the next plan, not rebuilt from a new mirror.  Every refreshed
  tensor comes from the same host expressions :meth:`BatchPlanner._build`
  uses (one constructor, ``_new_step``), so an absorbed carry equals a
  fresh build's bitwise, apart from the row table's padding width and
  source-bound certificates kept across a foreign movement.

* **The opt-ins** follow the reference's tiles, so each counter they
  feed is the reference's.  ``legality_cache`` keeps, per compacted
  position (``k_pad`` of them), every row's candidate mask (every
  criterion but the variance test) tagged with its device and per-row-
  block clean bits.  A tile is a hit only where every one of its kb
  slots is tagged with its source and clean in that row block; K1's
  cached instantiation reads a hit tile's masks and evaluates the rest;
  each walked miss tile's masks move into the cache and its slots are
  tagged, a slot whose tag changed losing its other clean blocks.  Each
  move repairs the cache (dirty bits for the endpoints' slots, padding
  slots included, and the moved PG's blocks, and the endpoints' columns
  recomputed).  Device telemetry (tiles walked, tiles where any slot
  holds a candidate, cache hits and misses, all per tile) is issued only
  while a tracer is installed and rides the chunk's one fetch.
  ``pipeline`` issues chunk *i+1* before the host turns chunk *i* into
  moves, under the reference's gate.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from . import legality
from .cluster import (ClusterDelta, ClusterState, DeviceAddDelta,
                      DeviceOutDelta, Movement, MovementDelta,
                      PoolCreateDelta, PoolGrowthDelta)
from .dense import DenseState
from .equilibrium import EquilibriumConfig, MoveRecord
from .legality import LegalityState
from .tail import tail_flush, tail_record, tail_stats, tail_terminal
from .. import obs as _obs
from ..kernels.ops import bind_select_rows
from ..device import resolve_device
from ..kernels.ref import candidate_masks
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
    """Along the last dim: drop the entry at ``pos``, shift the tail left,
    pad the freed last slot.  ``pos`` broadcasts against ``arr`` (a 0-d
    position, or one a lane with a trailing axis of 1 for the fleet's
    stacked carries)."""
    n = arr.shape[-1]
    idx = torch.arange(n, device=arr.device)
    out = torch.where(idx >= pos, torch.roll(arr, -1, dims=-1), arr)
    # not ``out[n - 1] = pad``: writing a host scalar into a CUDA tensor
    # is a host-to-device copy that synchronises
    return torch.where(idx == n - 1, pad, out)


def _shift_insert(arr: torch.Tensor, pos: torch.Tensor,
                  value: torch.Tensor) -> torch.Tensor:
    """Along the last dim: insert ``value`` at ``pos``, shifting the tail
    right (last drops); ``pos`` and ``value`` broadcast against ``arr``
    as :func:`_shift_remove`'s ``pos``."""
    idx = torch.arange(arr.shape[-1], device=arr.device)
    return torch.where(idx < pos, arr,
                       torch.where(idx == pos, value,
                                   torch.roll(arr, 1, dims=-1)))


# ---------------------------------------------------------------------------
# The chunk: select + apply up to `m` moves on the device, in place


class _Chunk:
    """One cluster's device carry plus the step that advances it.

    ``dyn`` (mutated in place): used, util (n,) f64; us, usq (1,) f64 —
    the maintained moments; acting (n_pg, S); pool_counts (P, n) f64;
    dst_ok (P, n) bool; rows_on (n, r_cap) with -1 padding; nrows,
    order (n,); pruned (n,) bool; with the legality cache, c_dev
    (k_pad,) — the device each source position's entry was evaluated
    for, -1 none — c_ok (k_pad, r_cap, n) bool — the entries' candidate
    masks — and c_clean (k_pad, r_cap / rb) bool — the blocks of rows
    whose mask is current.  ``kb`` sources make a block of the walk;
    ``k_pad`` is k rounded up to a multiple of kb.
    ``const``: cap, dev_class, dev_in, dev_domain (L, n), the per-shard
    tables sh_* and ideal (P, n).  Integer tensors are int64 throughout
    (torch's index type).
    """

    def __init__(self, dyn: dict, const: dict, scal: dict, *, k: int,
                 bounds: bool, kb: int = 1, rb: int = 8,
                 cache: bool = False):
        self.dyn, self.const, self.scal = dyn, const, scal
        self.k, self.bounds, self.rb, self.cache = k, bounds, rb, cache
        # kb sources a block; the last block is padded to kb with device
        # 0, as the reference's jnp.pad does
        self.kb = kb
        self.n_sb = -(-k // kb)
        self.k_pad = self.n_sb * kb
        dev = const["cap"].device
        n = const["cap"].shape[0]
        #: the devices the fetched certificate vector covers
        self.n_dev = n
        self.dev_iota = torch.arange(n, device=dev)
        self.pos = torch.arange(self.k_pad, device=dev)
        self.pad = torch.zeros(self.k_pad - k, dtype=I64, device=dev)
        self.sb_iota = torch.arange(self.n_sb, device=dev)
        self.pos_sb = self.pos // kb            # each position's block
        self.cap_lim = legality.capacity_limit(const["cap"],
                                               scal["headroom"])
        self._bind_kernel()
        if cache:
            self.fresh_cache()

    def _bind_kernel(self) -> None:
        """K1 bound to this carry (checked once; a re-pad rebinds it)."""
        self.select_rows = bind_select_rows(self.cap_lim, self.dyn,
                                            self.const, self.scal)

    @property
    def r_cap(self) -> int:
        return self.dyn["rows_on"].shape[1]

    def _nrows_of(self, src_order) -> torch.Tensor:
        """The (k_pad,) row counts of the step's sources."""
        return self.dyn["nrows"][src_order]

    def fresh_cache(self) -> None:
        """An empty legality cache for the current r_cap: no entry tagged,
        nothing clean, so the first walk of every tile evaluates it.
        ``c_new`` is where K1 writes the rows it evaluates; only the
        blocks the walk reached move into ``c_ok``, so a position the walk
        did not reach keeps its entry for the device it was tagged with."""
        k, r_cap, dev = self.k_pad, self.r_cap, self.dev_iota.device
        n = self.dev_iota.shape[0]
        self.dyn["c_dev"] = torch.full((k,), -1, dtype=I64, device=dev)
        self.dyn["c_ok"] = torch.zeros((k, r_cap, n), dtype=torch.bool,
                                       device=dev)
        self.dyn["c_clean"] = torch.zeros((k, r_cap // self.rb),
                                          dtype=torch.bool, device=dev)
        self.c_new = torch.zeros_like(self.dyn["c_ok"])

    # -- selection -----------------------------------------------------------

    def sources(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step's top-k sources: (the fullest-first ``order_k``, the
        ``k_pad`` positions the step scans, the 0-dim count of available
        ones).  Under source bounds the unpruned sources come first
        (fullest-first order preserved) and the pruned ones are parked at
        the back; positions ``k..k_pad-1`` pad the last source block with
        device 0 and are never available."""
        order_k = self.dyn["order"][:self.k]  # maintained argsort(-util)
        if self.bounds:
            src_order, n_avail = compact_parked(order_k,
                                                self.dyn["pruned"][order_k])
        else:
            src_order = order_k
            n_avail = torch.full((), self.k, device=self.pos.device)
        if self.k_pad > self.k:
            src_order = torch.cat([src_order, self.pad])
        return order_k, src_order, n_avail

    def hits(self, src_order) -> tuple:
        """The legality cache as this step reads it: (the (k_pad,) tags
        that match ``src_order``, the (k_pad, r_cap / rb) blocks K1 reads
        from the cache, the (n_sb, r_cap / rb) tiles that hit).  A tile
        hits only where every one of its kb slots does; on a miss K1
        evaluates all of them."""
        tag = self.dyn["c_dev"] == src_order
        hit_pos = hit_tile = tag[:, None] & self.dyn["c_clean"]
        if self.kb > 1:
            hit_tile = hit_pos.view(self.n_sb, self.kb, -1).all(dim=1)
            hit_pos = hit_tile.repeat_interleave(self.kb, dim=0)
        return tag, hit_pos, hit_tile

    def frontier(self, p, ri, n_avail, src_order) -> tuple:
        """Where the reference's walk stops at kb > 1, from the winner's
        position ``p`` (k: none) and its first legal row ``ri``: (the
        (k_pad,) row blocks each position spans, at least one and one for
        a position past ``n_avail``; the count of source blocks walked
        whole — every block before the winner's, else every block up to
        the one holding position ``n_avail - 1``, block 0 alone when
        nothing is available; the winner's block; the last row block the
        winner's block walks, where its first fuller slots have resolved
        and the winner has found its row)."""
        rb, kb, pos = self.rb, self.kb, self.pos
        nrows = torch.where(pos < n_avail, self._nrows_of(src_order), 0)
        blocks = ((nrows + rb - 1) // rb).clamp(min=1)
        sb_w = p // kb
        n_full = torch.where(p < self.k, sb_w,
                             (n_avail.clamp(min=1) - 1) // kb + 1)
        fuller = (self.pos_sb == sb_w) & (pos < p)
        c_dec = torch.maximum(ri // rb,
                              torch.where(fuller, blocks - 1, 0).amax())
        return blocks, n_full, sb_w, c_dec

    def certified(self, p, n_avail, cand_src, geo=None) -> torch.Tensor:
        """(k_pad,) bool: the positions the walk resolved empty with no
        candidate pair on any row.  At kb 1, every available position
        before the winner; at kb > 1 (``geo``: :meth:`frontier`'s result),
        every available position of a block walked whole, and in the
        winner's block every other one whose rows all lay in the tiles
        walked, after the winner too."""
        pos = self.pos
        if self.kb == 1:
            return (pos < p) & (pos < n_avail) & ~cand_src
        blocks, n_full, sb_w, c_dec = geo
        sb = self.pos_sb
        part = ((sb == sb_w) & (p < self.k) & (pos != p)
                & (blocks <= c_dec + 1))
        return ((sb < n_full) | part) & (pos < n_avail) & ~cand_src

    def walked(self, p, ri, n_avail, src_order, active, geo=None
               ) -> torch.Tensor:
        """(n_sb, r_cap / rb) bool: the (source block, row block) tiles
        the reference's walk visits in this step, from the step's results:
        the winner's position ``p`` (k: none) and its first legal row
        ``ri``.  A block before the winner's (every block up to the last
        available position's when nothing wins) walks as many row blocks
        as its longest slot, at least one; the winner's block walks up to
        :meth:`frontier`'s last row block; with no source available only
        tile (0, 0) is walked; an inactive step walks nothing.  ``geo``:
        :meth:`frontier`'s result (kb > 1).  At kb 1 a tile is one
        position's row block, and the same outcome takes fewer
        operations."""
        rb = self.rb
        blk = torch.arange(self.r_cap // rb, device=self.pos.device)[None, :]
        if self.kb == 1:
            pos = self.pos[:, None]
            nrows = self._nrows_of(src_order)
            blocks = ((nrows + rb - 1) // rb).clamp(min=1)[:, None]
            before = (pos < torch.minimum(p, n_avail)) & (blk < blocks)
            winner = (pos == p) & (blk <= ri // rb)
            first = (n_avail == 0) & (pos == 0) & (blk == 0)
            return (before | winner | first) & active
        blocks, n_full, sb_w, c_dec = geo
        sb = self.sb_iota[:, None]
        longest = blocks.view(self.n_sb, self.kb).amax(dim=1)[:, None]
        whole = (sb < n_full) & (blk < longest)
        part = (sb == sb_w) & (p < self.k) & (blk <= c_dec)
        return (whole | part) & active

    def select(self, active: torch.Tensor, tel: torch.Tensor | None = None):
        """One §3.1 planning step's selection over the full candidate
        tensor; updates ``pruned`` (where ``active``), the legality cache
        and the telemetry ``tel`` (where given) and returns (found, row,
        src, dst, tried, skipped), each (1,)."""
        d, c, s = self.dyn, self.const, self.scal
        k, kb, r_cap = self.k, self.kb, self.r_cap
        pos = self.pos
        order_k, src_order, n_avail = self.sources()
        # every criterion and the reduction in one K1 launch; ``any_row``
        # is already False for parked and padding positions
        if self.cache:
            tag, hit_pos, hit_tile = self.hits(src_order)
            any_row, dst, cand_src, cand_row = self.select_rows(
                src_order, n_avail, cache_ok=d["c_ok"], hit_blk=hit_pos,
                rb=self.rb, cache_out=self.c_new, cand_row=True)
        elif tel is not None:
            any_row, dst, cand_src, cand_row = self.select_rows(
                src_order, n_avail, cand_row=True)
        else:
            any_row, dst, cand_src = self.select_rows(src_order, n_avail)
        any_row = any_row.view(self.k_pad, r_cap)
        dst = dst.view(self.k_pad, r_cap)
        rows_k = d["rows_on"][src_order]                  # (k_pad, R)

        # winner: the first available source with a legal row
        src_has = any_row.any(dim=1)                           # (k_pad,)
        p = torch.where(src_has, pos, k).amin()                # k: none
        found = (p < k).view(1)
        jw = p.clamp(max=k - 1).view(1)
        hit = any_row.index_select(0, jw)[0]                   # (R,)
        ri = _first_true(hit).view(1)
        row = rows_k.index_select(0, jw)[0].index_select(0, ri)
        win_dst = dst.index_select(0, jw)[0].index_select(0, ri).to(I64)
        win_dev = src_order.index_select(0, jw)
        geo = None
        if kb > 1 and (self.bounds or self.cache or tel is not None):
            geo = self.frontier(p, ri, n_avail, src_order)
        if self.bounds:
            # rank in the *full* fullest-first order: sources_tried stays
            # the faithful histogram; rank − p scans were certificate skips
            rank = _first_true(order_k == win_dev).view(1)
            # certificates: scanned, fruitless sources with no candidate
            # pair on any row — the verdict the variance test cannot undo
            prunable = self.certified(p, n_avail, cand_src, geo) & active
            # the first k positions are distinct devices; the padding
            # repeats device 0 and is never certified
            srcs, prunable = src_order[:k], prunable[:k]
            pr = d["pruned"]
            pr[srcs] = pr[srcs] | prunable
        else:
            rank = jw
        if self.cache or tel is not None:
            walked = self.walked(p, ri, n_avail, src_order, active, geo)
            if tel is not None:
                nb = r_cap // self.rb
                cand_tile = cand_row.view(self.k_pad, nb, self.rb).any(dim=2)
                if kb > 1:                  # any slot of the tile
                    cand_tile = cand_tile.view(self.n_sb, kb, nb).any(dim=1)
                counts = [walked.sum(), (walked & cand_tile).sum()]
                if self.cache:
                    counts += [(walked & hit_tile).sum(),
                               (walked & ~hit_tile).sum()]
                tel[:len(counts)] += torch.stack(counts)
            if self.cache:
                if kb > 1:
                    walked = walked.repeat_interleave(kb, dim=0)
                self._walk_cache(walked, tag, hit_pos, src_order)
        return found, row, win_dev, win_dst, rank + 1, rank - jw

    def _walk_cache(self, walked, tag, hit_blk, src_order) -> None:
        """The cache after the reference's walk, per position: each block
        walked on a miss of its tile takes the mask K1 just evaluated; a
        position whose source block was walked is tagged with its source
        (padding with device 0), and its clean blocks are those it kept
        under the same tag and the ones walked."""
        d, k, rb = self.dyn, self.k_pad, self.rb
        c_ok, c_clean, c_dev = d["c_ok"], d["c_clean"], d["c_dev"]
        shape = (k, -1, rb, c_ok.shape[2])
        take = (walked & ~hit_blk)[:, :, None, None]
        c_ok.view(shape).copy_(torch.where(take, self.c_new.view(shape),
                                           c_ok.view(shape)))
        slot = walked.any(dim=1)
        c_clean.copy_(torch.where(slot[:, None],
                                  (tag[:, None] & c_clean) | walked, c_clean))
        c_dev.copy_(torch.where(slot, src_order, c_dev))

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
        if self.cache:
            self._repair_cache(ok, pgi, src, dst, both)

    def _repair_cache(self, ok, pgi, src, dst, both) -> None:
        """Keep every clean cache block equal to a fresh evaluation after
        a move (the reference's ``apply_move`` cache repair).  A move
        changes a candidate mask's inputs only at its two endpoints and in
        the moved PG's acting set: the blocks of entries tagged with an
        endpoint (their row lists shifted) and the blocks holding a row of
        the moved PG go dirty, and the endpoints' two columns of every
        entry are evaluated again."""
        d, c = self.dyn, self.const
        k, rb = self.k_pad, self.rb
        c_dev, c_ok, c_clean = d["c_dev"], d["c_ok"], d["c_clean"]
        tags = c_dev.clamp(min=0)
        rows_c = d["rows_on"][tags]                          # (k_pad, R)
        has_pg = (rows_c >= 0) & (c["sh_pg"][rows_c.clamp(min=0)] == pgi)
        dirty = (((c_dev == src) | (c_dev == dst))[:, None]
                 | has_pg.view(k, -1, rb).any(dim=2))
        c_clean.copy_(torch.where(ok, c_clean & ~dirty, c_clean))
        cols = candidate_masks(tags, rows_c, self.cap_lim, d, c, self.scal,
                               devs=both)["cand"]            # (k_pad, R, 2)
        c_ok[:, :, both] = torch.where(ok, cols, c_ok[:, :, both])

    # -- chunk ---------------------------------------------------------------

    def run(self, m: int, telemetry: bool = False) -> torch.Tensor:
        """Up to ``m`` steps; returns the packed int64 result the host
        fetches: the (m, 5) move block (row, src, dst, sources_tried,
        bound_skips, or -1 sentinels) flattened, then done, overflow,
        max(nrows), the (n,) source-bound certificates as 0 / 1 (the host
        keeps them for an absorption that may carry them over) and, with
        ``telemetry``, the chunk's (4,) device telemetry: tiles walked,
        tiles holding a candidate, cache hits, cache misses."""
        dev = self.dev_iota.device
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        overflow = torch.zeros(1, dtype=torch.bool, device=dev)
        moves = torch.empty((m, 5), dtype=I64, device=dev)
        tel = torch.zeros(4, dtype=I64, device=dev) if telemetry else None
        nrows = self.dyn["nrows"]
        for t in range(m):
            active = ~(done | overflow)
            found, row, src, dst, tried, skipped = self.select(active, tel)
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
        out = [moves.flatten(), done.to(I64), overflow.to(I64),
               nrows.max().view(1), self.dyn["pruned"].to(I64)]
        return torch.cat(out if tel is None else [*out, tel])


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
    """Warm-startable handle on the device-resident engine bound to one
    ClusterState.

    The carry stays alive between :meth:`plan` calls.  Moves planned past
    one call's budget — the overshoot stash, already applied in the carry
    — are emitted first by the next call, so the emitted stream is the
    cold-start sequence.  Staleness is the epoch compare
    (``state.mutation_epoch`` against the epoch the carry was synced at);
    what changed comes from the bound state's delta stream, to which the
    planner subscribes weakly (:meth:`ClusterState.subscribe`):

    * **Every known delta type is absorbed** at the next plan (``_absorb``)
      into a new carry: pool growth and device out / back in refresh sizes,
      utilizations, ideals and the in-mask on the host; a device add
      extends the device axis with empty rows; a foreign movement and a
      pool create re-read the assignment from the state (appending the new
      pool's PGs and shard rows).  A held overshoot stash is discarded:
      its moves exist only in the carry, never in the state, so re-reading
      the assignment undoes them.  Each tensor is recomputed by the
      expressions :meth:`_build` uses, so the continuation is the
      cold-start sequence.
    * **A full rebuild remains** for an unknown delta type, an unstamped or
      conflicting delta, a backlog past :attr:`PENDING_CAP`, and a change
      that would renumber the carry's dense ids (a device class or pool id
      sorting before an existing one).
    """

    #: pending-delta backlog above which the stream is dropped: rebuild
    PENDING_CAP = 8192

    def __init__(self, state: ClusterState,
                 cfg: EquilibriumConfig | None = None, chunk: int = 64,
                 source_block: int = 1, row_block: int = 8,
                 row_capacity: int | None = None,
                 legality_cache: bool = False,
                 source_bounds: bool = True,
                 pipeline: bool = True,
                 device=None):
        self.state = state
        self.cfg = cfg or EquilibriumConfig()
        self.chunk = chunk
        # sources a block of the walk: clamped to k here, and again
        # wherever k is recomputed (a build, a device add), so it only
        # ever shrinks
        self._kb = min(max(1, source_block), self._k())
        self.row_capacity = row_capacity
        self.legality_cache = legality_cache
        self.source_bounds = source_bounds
        # pipelined dispatch: chunk i+1 is issued before the host turns
        # chunk i into moves, under _chunk_loop's gate
        self.pipeline = pipeline
        # rows a block: the row table's alignment and the legality cache's
        # and the telemetry's tile height
        self._rb = max(1, row_block)
        self.device = resolve_device(device, "equilibrium_batch")
        self._dense = None
        self._step: _Chunk | None = None
        self._epoch = -1                # state.mutation_epoch at last sync
        self._done = False
        self._pruned = 0                # pruned count at the last fetch
        # the carry's certificates as the host last saw them (valid while
        # no stash is held), and (used, pool counts) of the state at the
        # synced epoch when any certificate was held: what a foreign
        # movement's absorption compares against, with no fetch
        self._pruned_mask: np.ndarray | None = None
        self._synced_bounds: tuple[np.ndarray, np.ndarray] | None = None
        self._terminal_seconds = 0.0
        # moves the device already planned+applied in the carry but the
        # host has not yet emitted: (row, src, dst, tried, skipped, secs)
        self._stash: list[tuple[int, int, int, int, int, float]] = []
        # deltas observed since the last sync, keyed by epoch; _invalid is
        # set when the stream is unusable (overflow, unstamped, conflict)
        self._pending: dict[int, ClusterDelta] = {}
        self._invalid = False
        self._absorbed_deltas = 0       # lifetime count (stats, tests)
        # subscribe weakly: the state must not keep a dead planner alive
        ref = weakref.ref(self)

        def _deliver(delta, _ref=ref):
            planner = _ref()
            if planner is None:
                return False            # prunes this subscription
            planner._record_delta(delta)
            return True

        state.subscribe(_deliver)

    # -- dense-state lifecycle ----------------------------------------------

    def _k(self) -> int:
        """The step's source count for the bound state's device axis."""
        return min(self.cfg.k, max(self.state.n_devices, 1))

    def _round_cap(self, n: int) -> int:
        rb = self._rb
        return max(rb, -(-int(n) // rb) * rb)

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _acting(self, dense: DenseState) -> torch.Tensor:
        """The compact acting table (n_pg, max pool size), -1 padded, read
        from the state."""
        state = self.state
        n_slots = max(p.size for p in state.pools.values())
        acting_np = np.full((len(dense.pgs), n_slots), -1, np.int64)
        for pg, pgi in dense.pg_index.items():
            osds = state.acting[pg]
            acting_np[pgi, :len(osds)] = [state.idx(o) for o in osds]
        return self._tensor(acting_np, I64)

    def _device_const(self, dense: DenseState) -> dict:
        t = self._tensor
        return {"cap": t(dense.cap, F64), "dev_class": t(dense.dev_class, I64),
                "dev_in": t(dense.dev_in, torch.bool),
                "dev_domain": t(dense.dev_domain_arr, I64)}

    def _shard_const(self, dense: DenseState) -> dict:
        t = self._tensor
        return {"sh_size": t(dense.sh_size.astype(np.float64), F64),
                "sh_pg": t(dense.sh_pg, I64), "sh_pool": t(dense.sh_pool, I64),
                "sh_class": t(dense.sh_class, I64),
                "sh_level": t(dense.sh_level, I64),
                "sh_slot": t(dense.sh_slot, I64),
                "sh_sbase": t(dense.sh_sbase, I64),
                "sh_scnt": t(dense.sh_scnt, I64)}

    def _new_step(self, const: dict, dense: DenseState, *,
                  acting: torch.Tensor, rows: np.ndarray, nrows: np.ndarray,
                  pruned: np.ndarray) -> _Chunk:
        """A new carry from host arrays: the one constructor a build and
        an absorption share (fresh ``dyn``, ``const`` and ``scal`` dicts;
        ``_Chunk`` derives k, the device iota and the capacity limit from
        the device axis, and binds K1 to these dicts)."""
        t, cfg = self._tensor, self.cfg
        util, ideal, counts = dense.util, dense.ideal, dense.pool_counts
        n_dev = util.shape[0]
        const = {**const, "ideal": t(ideal, F64)}
        dyn = {
            "used": t(dense.used, F64), "util": t(util, F64),
            # the moments are host float64 sums of the mirror (never
            # re-summed on the device), as DenseState computes them
            "us": t([float(util.sum())], F64),
            "usq": t([float((util ** 2).sum())], F64),
            "acting": acting,
            "pool_counts": t(counts, F64),
            "dst_ok": t(legality.dst_count_ok(counts, ideal, cfg.count_slack),
                        torch.bool),
            "rows_on": t(rows, I64), "nrows": t(nrows, I64),
            "order": t(legality.fullest_first(util), I64),
            "pruned": t(pruned, torch.bool),
        }
        # every scalar is a tensor on the carry's device: a CUDA division
        # by a host scalar would multiply by its reciprocal instead
        scal = {"slack": t(cfg.count_slack, F64),
                "headroom": t(cfg.headroom, F64),
                "min_dvar": t(cfg.min_variance_delta, F64),
                "n_f": t(float(n_dev), F64)}     # the variance divisor
        self._pruned_mask = pruned.copy()    # the CPU carry shares memory
        self._pruned = int(pruned.sum())
        return self._chunk(dyn, const, scal, k=min(cfg.k, max(n_dev, 1)))

    def _chunk(self, dyn: dict, const: dict, scal: dict, k: int) -> _Chunk:
        """The step over a new carry (the sharded engine partitions it
        first)."""
        return _Chunk(dyn, const, scal, k=k, bounds=self.source_bounds,
                      kb=self._kb, rb=self._rb, cache=self.legality_cache)

    def _build(self) -> None:
        """Full rebuild of the device carry from ``self.state``."""
        _obs_registry().inc("batch.rebuilds")
        _obs.point("batch.rebuild", cat="batch",
                   n_devices=self.state.n_devices,
                   pending=len(self._pending), invalid=self._invalid)
        state = self.state
        self._stash = []
        self._done = False
        self._pruned = 0
        self._pruned_mask = None
        self._synced_bounds = None
        self._pending.clear()
        self._invalid = False
        self._dense = None
        self._step = None
        self._epoch = state.mutation_epoch
        self._kb = min(self._kb, self._k())
        if not state.acting or not state.pools or state.n_devices < 2:
            return
        dense = DenseState(state)
        if not dense.shard_key:
            return
        self._dense = dense
        nrows_np = np.array([len(s) for s in dense.rows_on_dev], np.int64)
        r_cap = self._round_cap(
            max(self.row_capacity, int(nrows_np.max()))
            if self.row_capacity is not None
            else int(nrows_np.max()) + self.chunk)
        self._step = self._new_step(
            {**self._device_const(dense), **self._shard_const(dense)}, dense,
            acting=self._acting(dense),
            rows=_pack_rows(dense.rows_on_dev, dense.sh_size, r_cap),
            nrows=nrows_np, pruned=np.zeros(dense.n_dev, bool))

    @property
    def stale(self) -> bool:
        return self._epoch != self.state.mutation_epoch

    # -- the delta stream ----------------------------------------------------

    def _record_delta(self, delta: ClusterDelta) -> None:
        if len(self._pending) >= self.PENDING_CAP:
            self._invalid = True
            self._pending.clear()
            return
        existing = self._pending.get(delta.epoch)
        if existing is None:
            self._pending[delta.epoch] = delta
        elif existing != delta:
            # two different claims about one epoch: the stream cannot be
            # trusted — rebuild rather than absorb the wrong one
            self._invalid = True

    def _drop_synced_pending(self) -> None:
        """Forget deltas at or below the synced epoch (the carry already
        reflects them — typically the planner's own replayed moves)."""
        self._pending = {e: d for e, d in self._pending.items()
                         if e > self._epoch}

    def _pending_run(self) -> list[ClusterDelta] | None:
        """The contiguous delta run covering (synced epoch, state epoch],
        or None if any mutation went unobserved."""
        run = []
        for epoch in range(self._epoch + 1, self.state.mutation_epoch + 1):
            delta = self._pending.get(epoch)
            if delta is None:
                return None
            run.append(delta)
        return run

    def _class_ids_stable(self) -> bool:
        """Device classes are dense sorted ids in the carry; a new class
        that sorts before an existing one would renumber ``sh_class``."""
        new_id, _ = legality.device_class_ids(self.state.devices)
        return all(new_id.get(c) == i
                   for c, i in self._dense.class_id.items())

    def _absorbable(self, run: list[ClusterDelta] | None) -> bool:
        """Whether a pending run can be absorbed: the stream is whole and
        trusted, a carry exists, and no delta renumbers the carry's dense
        ids (a device class sorting before an existing one, a pool id at
        or below the mirrored maximum, a pool whose rule names a class the
        carry has no id for) or is of an unknown type."""
        if run is None or self._invalid or self._step is None:
            return False
        dense = self._dense
        max_pool = max(dense.pool_index, default=-1)
        for delta in run:
            if isinstance(delta, (PoolGrowthDelta, DeviceOutDelta,
                                  MovementDelta)):
                continue
            if isinstance(delta, DeviceAddDelta):
                if not self._class_ids_stable():
                    return False
                continue
            if isinstance(delta, PoolCreateDelta):
                pool = self.state.pools.get(delta.pool_id)
                if pool is None or delta.pool_id <= max_pool:
                    return False
                if not all(s.device_class is None
                           or s.device_class in dense.class_id
                           for s in pool.rule.steps):
                    return False
                max_pool = delta.pool_id
                continue
            return False        # unknown delta type: rebuild
        return True

    def observe(self, delta: ClusterDelta) -> bool:
        """Record one cluster delta; True iff the planner can stay warm.

        Deltas of the bound state arrive through the subscription, so a
        caller needs this only for deltas made elsewhere (it deduplicates
        by epoch).  False means the next :meth:`plan` rebuilds the carry;
        True means it absorbs the pending deltas into it."""
        if getattr(delta, "epoch", -1) < 0:
            self._invalid = True        # unstamped: cannot be ordered
        else:
            self._record_delta(delta)
        if self._epoch < 0 or not self.stale:
            return True                 # nothing warm to invalidate (yet)
        return self._absorbable(self._pending_run())

    def reset(self) -> None:
        """Drop all warm state; the next :meth:`plan` cold-starts."""
        self._epoch = -1
        self._step = None
        self._dense = None
        self._stash = []
        self._done = False
        self._pruned = 0
        self._pruned_mask = None
        self._synced_bounds = None
        self._pending.clear()
        self._invalid = False

    # -- absorption ----------------------------------------------------------

    def _extend_pools(self, created: list[int]) -> None:
        """Append created pools' PGs and shard rows to the host mirror's
        tables in the (sorted pg, slot) order a cold build walks, with the
        per-slot rule geometry of the same walk
        (``legality.rule_slot_steps``); ``_absorbable`` has checked that
        the new pool ids sort after every mirrored one."""
        state, dense = self.state, self._dense
        lvl_id = {l: i for i, l in enumerate(dense.levels)}
        for pid in sorted(created):
            pool = state.pools[pid]
            dense.pool_index[pid] = len(dense.pool_index)
            dense.n_pools = len(dense.pool_index)
            geometry = legality.rule_slot_steps(pool.rule)
            new = {"sh_pg": [], "sh_pool": [], "sh_level": [],
                   "sh_class": [], "sh_step": [], "sh_slot": [],
                   "sh_sbase": [], "sh_scnt": []}
            for pg in sorted(state.pgs_of_pool[pid]):
                dense.pg_index[pg] = len(dense.pg_index)
                dense.pgs.append(pg)
                for slot in range(pool.size):
                    dense.row_of[(pg, slot)] = len(dense.shard_key)
                    dense.shard_key.append((pg, slot))
                    si, base, scnt, domain, dev_class = geometry[slot]
                    new["sh_pg"].append(dense.pg_index[pg])
                    new["sh_pool"].append(dense.pool_index[pid])
                    new["sh_level"].append(lvl_id[domain])
                    new["sh_class"].append(dense.class_id[dev_class]
                                           if dev_class is not None else -1)
                    new["sh_step"].append(si)
                    new["sh_slot"].append(slot)
                    new["sh_sbase"].append(base)
                    new["sh_scnt"].append(scnt)
            for attr, vals in new.items():
                setattr(dense, attr, np.concatenate(
                    [getattr(dense, attr), vals]).astype(np.int64))

    def _kept_certificates(self, run, dense: DenseState, rows: np.ndarray
                           ) -> np.ndarray:
        """The certificates that survive a pure foreign-movement run: clear
        each move's endpoints and every current holder of its PG, then run
        the legality core's triggers that ``_Chunk.apply`` runs, as one net
        sweep of the synced carry's values against the mutated state's
        (the criteria are memoryless, so the net compare is exact for the
        devices the run did not touch)."""
        state, cfg = self.state, self.cfg
        n_dev = dense.n_dev
        held = self._pruned_mask
        if held is None or not held.any() or self._synced_bounds is None:
            return np.zeros(n_dev, bool)
        pruned = held.copy()
        for d in run:
            mv = d.movement
            pruned[state.idx(mv.src_osd)] = pruned[state.idx(mv.dst_osd)] = \
                False
            for o in state.acting[mv.pg]:
                pruned[state.idx(o)] = False
        if not pruned.any():
            return pruned
        used_old, counts_old = self._synced_bounds
        cap, used, util = dense.cap, dense.used, dense.util
        util_old = used_old / cap
        dst_ok = legality.dst_count_ok(dense.pool_counts, dense.ideal,
                                       cfg.count_slack)
        dst_ok_old = legality.dst_count_ok(counts_old, dense.ideal,
                                           cfg.count_slack)
        iota = np.arange(n_dev)
        kill = legality.bound_crossed(
            util_old[:, None], util[:, None], util[None, :],
            iota[:, None], iota[None, :]).any(axis=0)
        flips = dst_ok & ~dst_ok_old
        kill |= (flips.any(axis=1)[:, None]
                 & (dense.pool_counts > 0.0)).any(axis=0)
        largest = rows[:, 0]
        maxsz = np.where(largest >= 0,
                         dense.sh_size[np.maximum(largest, 0)], 0.0)
        lim = legality.capacity_limit(cap, cfg.headroom)
        dropped = used < used_old
        kill |= (dropped[:, None]
                 & legality.bound_capacity_binding(
                     used_old[:, None], lim[:, None],
                     maxsz[None, :])).any(axis=0)
        return pruned & ~kill

    def _absorb(self) -> bool:
        """Absorb the pending delta run into a new carry; False (and no
        change) where it is not absorbable.

        Structural path (a pool create, a held stash or a movement): the
        row lists, the acting table and the shard sizes are re-read from
        the state; the row table widens only where its rows plus a chunk
        no longer fit.  Otherwise (growth, device adds, out flips): the
        device's acting table and shard geometry stay, and the row table
        comes back in one counted fetch, padded for adds and re-sorted for
        growth.  Both end in :meth:`_new_step`, the constructor
        :meth:`_build` uses."""
        run = self._pending_run()
        if not self._absorbable(run):
            return False
        state, dense = self.state, self._dense
        old = self._step
        added = [d.device for d in run if isinstance(d, DeviceAddDelta)]
        created = [d.pool_id for d in run if isinstance(d, PoolCreateDelta)]
        grew = any(isinstance(d, PoolGrowthDelta) for d in run)
        outs = any(isinstance(d, DeviceOutDelta) for d in run)
        structural = (bool(created) or bool(self._stash)
                      or any(isinstance(d, MovementDelta) for d in run))
        # certificates survive only a pure foreign-movement run with no
        # discarded stash: un-applying stashed moves would leave them
        # claiming facts about a state that never existed, and every other
        # delta type changes their inputs (sizes, ideals, the device axis)
        keep_bounds = (self.source_bounds and not self._stash and bool(run)
                       and all(isinstance(d, MovementDelta) for d in run))
        self._stash = []

        if created:
            self._extend_pools(created)
        const = dict(old.const)         # _new_step refreshes "ideal"
        if added or outs:
            # appending devices keeps every existing id (_class_ids_stable;
            # domain ids are first-seen); out flips land in dev_in
            dense.legality = leg = LegalityState.from_cluster(state)
            dense.class_id = leg.class_id
            dense.dev_class = leg.dev_class
            dense.dev_domain_arr = leg.dev_domain_arr
            dense.n_domains = leg.n_domains
            dense.dev_in = leg.dev_in
            dense.cap = leg.cap
            const.update(self._device_const(dense))
        n_dev = dense.n_dev = state.n_devices
        if added:
            self._kb = min(self._kb, self._k())
        # the host views a cold build reads, from the mutated state
        dense.used = state.used()
        dense.util = dense.used / dense.cap
        pool_ids = sorted(state.pools)
        dense.ideal = np.stack([state.ideal_shard_count(state.pools[p])
                                for p in pool_ids])
        dense.pool_counts = np.stack([state.pool_counts[p] for p in pool_ids]
                                     ).astype(np.float64)
        dense.sh_size = np.array([state.shard_sizes[pg]
                                  for pg, _ in dense.shard_key])

        if structural:
            rows_on_dev: list[list[int]] = [[] for _ in range(n_dev)]
            for osd, shards in state.shards_on.items():
                d = state.idx(osd)
                for key in shards:
                    rows_on_dev[d].append(dense.row_of[key])
            nrows = np.array([len(r) for r in rows_on_dev], np.int64)
            r_cap = old.r_cap
            if int(nrows.max(initial=0)) + self.chunk > r_cap:
                r_cap = self._round_cap(int(nrows.max()) + self.chunk)
            rows = _pack_rows(rows_on_dev, dense.sh_size, r_cap)
            acting = self._acting(dense)
            const.update(self._shard_const(dense))
        else:
            acting = old.dyn["acting"]
            packed = _fetch(torch.cat([old.dyn["nrows"][:, None],
                                       old.dyn["rows_on"]], dim=1))
            nrows, rows = packed[:, 0].copy(), packed[:, 1:].copy()
            if added:
                rows = np.concatenate(
                    [rows, np.full((len(added), rows.shape[1]), -1,
                                   np.int64)])
                nrows = np.concatenate([nrows, np.zeros(len(added),
                                                        np.int64)])
            if grew:
                sh_size = dense.sh_size
                for d in range(n_dev):
                    nd = int(nrows[d])
                    rows[d, :nd] = sorted(rows[d, :nd].tolist(),
                                          key=lambda r: (-sh_size[r], r))
                const["sh_size"] = self._tensor(
                    sh_size.astype(np.float64), F64)

        held = self._pruned if keep_bounds else 0
        pruned = (self._kept_certificates(run, dense, rows) if keep_bounds
                  else np.zeros(n_dev, bool))
        # a partial refresh: only the fields the carry and _reconcile read
        # are current; membership, occupancy and row sets are not, so the
        # mirror refuses a warm start (DenseState.require_fresh)
        dense.mirror_complete = False
        self._step = self._new_step(const, dense, acting=acting, rows=rows,
                                    nrows=nrows, pruned=pruned)
        self._done = False
        self._absorbed_deltas += len(run)
        reg = _obs_registry()
        reg.inc("absorb.runs")
        for d in run:
            reg.inc("absorb.deltas", type=type(d).__name__)
        _obs.point("batch.absorb", cat="batch", deltas=len(run),
                   structural=bool(structural), kept_bounds=bool(keep_bounds),
                   certificates_held=held, certificates_kept=int(pruned.sum()))
        self._epoch = state.mutation_epoch
        self._drop_synced_pending()
        self._snapshot_bounds()
        return True

    def _snapshot_bounds(self) -> None:
        """Keep the synced state's used bytes and pool counts while the
        carry holds a certificate (what ``_kept_certificates`` compares
        against); nothing otherwise."""
        mask = self._pruned_mask
        if self._stash or mask is None or not mask.any():
            self._synced_bounds = None
            return
        state = self.state
        self._synced_bounds = (
            state.used(),
            np.stack([state.pool_counts[p] for p in sorted(state.pools)]
                     ).astype(np.float64))

    def sync(self) -> None:
        """Bring the carry up to date with the bound state: a cold build on
        first use, else an absorption of the pending deltas, else (where
        they cannot be absorbed) a full rebuild."""
        if self._epoch < 0:
            self._build()
        elif self.stale and not self._absorb():
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
        stats_out["legality_cache"] = self.legality_cache
        stats_out["source_bounds"] = self.source_bounds
        stats_out["pipeline"] = self.pipeline
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
        self._drop_synced_pending()     # the planner's own replayed moves
        # synced to the state: a backlog concern (the replay of a large
        # plan passing PENDING_CAP) is moot, staleness is the epoch compare
        self._invalid = False
        self._snapshot_bounds()
        return movements, records

    def _registry_stats(self, snap: dict, stats_out: dict) -> None:
        """Deltas of this engine's registry counters since plan entry;
        ``absorbed_deltas`` is the planner's lifetime count."""
        d = _obs_registry().deltas_since(snap)
        stats_out["rebuilds"] = int(d.get("batch.rebuilds", 0))
        stats_out["host_syncs"] = int(d.get("batch.host_syncs", 0))
        stats_out["jit_recompiles"] = 0
        stats_out["stash_moves"] = int(d.get("batch.stash_moves", 0))
        stats_out["cache_hits"] = int(d.get("batch.cache_hits", 0))
        stats_out["cache_misses"] = int(d.get("batch.cache_misses", 0))
        stats_out["absorbed_deltas"] = self._absorbed_deltas

    def _repad(self) -> None:
        """Widen the per-device row table to max rows + chunk (one sync).
        The source bounds say nothing about row geometry and survive; the
        legality cache is shaped by r_cap and starts empty."""
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
        if self.legality_cache:
            self._step.fresh_cache()

    def _record_chunk_tel(self, reg, tel: np.ndarray) -> None:
        """Fold one chunk's fetched device telemetry into the registry."""
        reg.inc("batch.tiles_walked", int(tel[0]))
        reg.inc("batch.cand_tiles", int(tel[1]))
        if self.legality_cache:
            reg.inc("batch.cache_hits", int(tel[2]))
            reg.inc("batch.cache_misses", int(tel[3]))

    def _chunk_loop(self, budget: int
                    ) -> list[tuple[int, int, int, int, int, float]]:
        """Run chunks until ``budget`` raw moves are on hand (stashing any
        overshoot), the device reports convergence, or a re-pad is
        needed.  ``self._terminal_seconds`` collects the wall time of
        chunks that emit no moves (the terminal fruitless scan).

        With ``pipeline`` on, chunk *i+1* is issued as soon as chunk
        *i*'s fetched scalars prove that a full chunk is needed (not done,
        no overflow, the budget and the row capacity both leave room): it
        is the chunk the next iteration would issue, so the sequence is
        unchanged.  A chunk's seconds are its issue and its fetch,
        wherever the issue ran.  Telemetry rides each chunk while a tracer
        is installed."""
        self._terminal_seconds = 0.0
        raw: list[tuple[int, int, int, int, int, float]] = []
        take = min(len(self._stash), budget)
        raw.extend(self._stash[:take])
        del self._stash[:take]
        reg = _obs_registry()
        if take:
            reg.inc("batch.stash_replayed", take)
        m = self.chunk
        n = self._step.n_dev
        telemetry = _obs.enabled()
        pending = None          # (packed result, dispatch seconds) of i+1
        while len(raw) < budget and not self._done:
            reg.inc("batch.chunks")
            with _obs.span("batch.chunk", cat="batch") as sp:
                t0 = time.perf_counter()
                if pending is None:
                    out = self._step.run(m, telemetry)
                    dispatch_s = time.perf_counter() - t0
                    overlapped = False
                else:
                    out, dispatch_s = pending
                    pending = None
                    overlapped = True
                t1 = time.perf_counter()
                packed = _fetch(out)
                dt = time.perf_counter() - t0
                sync_s = time.perf_counter() - t1
                if overlapped:
                    # its issue ran inside the previous chunk, after that
                    # chunk's time was taken: count it here, once
                    dt += dispatch_s
                moves_np = packed[:5 * m].reshape(m, 5)
                done, overflow = bool(packed[5 * m]), bool(packed[5 * m + 1])
                nmax = int(packed[5 * m + 2])
                self._pruned_mask = packed[5 * m + 3:5 * m + 3 + n] != 0
                self._pruned = int(self._pruned_mask.sum())
                emitted = moves_np[moves_np[:, 0] >= 0]
                if (self.pipeline and not done and not overflow
                        and len(raw) + len(emitted) < budget
                        and nmax + m <= self._step.r_cap):
                    # no break and no re-pad below: the next iteration
                    # runs a full chunk, so issue it now
                    td = time.perf_counter()
                    pending = (self._step.run(m, telemetry),
                               time.perf_counter() - td)
                    reg.inc("batch.chunks_overlapped")
                if telemetry:
                    self._record_chunk_tel(reg, packed[5 * m + 3 + n:])
                if self.legality_cache:
                    # each applied move repaired the cache in place
                    reg.inc("batch.cache_repairs", len(emitted))
                sp.set(emitted=len(emitted), done=done, overflow=overflow,
                       overlapped=overlapped,
                       dispatch_s=round(dispatch_s, 6),
                       sync_s=round(sync_s, 6))
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
            if overflow or nmax + m > self._step.r_cap:
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
