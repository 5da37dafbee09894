"""Sharded batch engine: the batch engine's step over a device axis
partitioned across the ranks of a ``torch.distributed`` process group.

The port of :mod:`repro.core.shard`.  The batch engine's working set is
dominated by the destination axis: the ``(n_pools, n_dev)``
destination-count criterion, the ``(n_dev, r_cap)`` row tables, the
per-source certificate vector and every destination slice of the
selection scale with the device count, the axis that grows 10k–100k-OSD
clusters past one card's memory.  This module splits that axis into
contiguous ascending blocks, one per rank, and runs the *same* chunk step
on each rank (:class:`_ShardChunk` is :class:`~repro_torch.core
.equilibrium_batch._Chunk` with the cross-rank reductions spliced in):

* **sharded**: the device axis of the row tables ``rows_on`` / ``nrows``,
  the ``dst_ok`` / ``pool_counts`` / ``ideal`` columns and the
  ``pruned`` certificates; the *row axis* of the eight per-row registry
  arrays (``sh_size`` … ``sh_scnt``), block-sharded by global row id;
  and the *pg axis* of the acting table — everything in the carry that
  scales with cluster size;
* **replicated**: the O(n_dev) bookkeeping vectors (``used``, ``util``,
  ``order`` and the device registry ``cap``, ``dev_class``, ``dev_in``,
  ``dev_domain``) and the two moments — every rank updates them with the
  same expressions from the same inputs, so they stay equal.

Ranks combine in three ways, and the combine math lives in the legality
core (:mod:`repro_torch.core.legality`, "Cross-shard reductions"):

1. owner gathers — a block-sharded value at a global index (a device's
   rows and certificate, a row's registry record, a PG's acting set, a
   source's count criterion) is rebuilt with a one-owner sum
   (``shard_gather_contrib`` / ``shard_gather_finish``), float64 values
   travelling as their int64 bit patterns so that the sum is exact for
   every value; one ``all_reduce`` carries every gather of a stage;
2. the certificate predicate — a source's any-candidate bit is the summed
   OR of the ranks' bits (``shard_any``), so a source is pruned only when
   no rank holds a candidate for it;
3. the winner rule — each rank selects over its own destination block in
   one launch of K1's window form (:func:`repro_torch.kernels.ops
   .bind_select_rows_window`), the ranks' ``(any, util at dst, global
   dst)`` per (position, row) are ``all_gather``-ed and folded in
   ascending rank order with ``shard_winner_better``, which reproduces the
   serial emptiest-first winner bit for bit (ties fall to the lower
   global index: blocks are contiguous and ascending).

After the fold every rank holds the serial step's K1 outputs, so the
serial closed form of the walk (``frontier``, ``certified``, ``walked``)
runs unchanged on replicated values at any ``source_block``.  A step
makes four collectives to select (three gathers, the fold) and two to
apply a move, two more with source bounds (the head rows' sizes for the
capacity trigger); the chunk ends with three (``max(nrows)``, the
certificates, the telemetry), and the host fetches one packed vector a
chunk, as the serial engine does.

The device axis is padded to a multiple of the rank count with the fleet
pack's neutral device (capacity 1, util 0, out, classless, its own
failure domain, no rows): pads sort behind every real device in the
maintained fullest-first order, are never candidates and contribute
nothing to any reduction, so the padded sequence is the natural-width
one.  The carry is gathered back to its natural sizes around an
absorption (:meth:`ShardedBatchPlanner._absorb`) and partitioned again
after it.

Every rank runs the whole host side (the cluster state, the delta
stream, absorption, the stash, reconcile) on its own copy of the state,
so every rank emits the same moves.  With no process group and one
shard every collective is the identity (the reference's mesh of one).
:func:`spawn_ranks` starts a group of processes on one host: gloo on the
CPU, NCCL on CUDA, one rank per card (rank ``r`` on ``cuda:r``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from . import legality
from .cluster import ClusterState
from .equilibrium import EquilibriumConfig
from .equilibrium_batch import (F64, I64, BatchPlanner, _Chunk, _fetch,
                                _first_true, _shift_insert, _shift_remove)
from .planner import BatchEquilibriumPlanner, register_planner
from .. import obs as _obs
from ..device import resolve_device
from ..kernels.ops import bind_select_rows_window
from ..kernels.ref import SH_FIELDS, pack_records
from ..kernels.select_move import compact_parked
from ..obs import registry as _obs_registry

__all__ = ["ShardedBatchPlanner", "chunk_memory_stats", "partition_carry",
           "spawn_ranks"]

#: the carry's tensors by the axis the ranks split: the device axis
#: (leading for the row tables and certificates, trailing for the (P, n)
#: criterion columns), the registry's row axis, the acting table's pg
#: axis; every other tensor is replicated (the reference's ``_DYN_SPECS``
#: and ``_CONST_SPECS``)
_DEVICE_LEADING = ("rows_on", "nrows", "pruned")
_DEVICE_TRAILING = ("pool_counts", "dst_ok", "ideal")
_ROW_AXIS = SH_FIELDS
_PG_AXIS = ("acting",)


class _Comm:
    """The collectives of the engine's process group: sums and maxima in
    place, and gathers stacked on a leading rank axis.  Every payload is
    an integer tensor (float64 values as their bit patterns, bools as
    0 / 1).  Without a process group there is one rank and every
    collective is the identity."""

    def __init__(self, n_shards: int | None):
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        if n_shards is None:
            n_shards = world
        n_shards = int(n_shards)
        if n_shards > 1 and not grouped:
            raise ValueError(f"n_shards={n_shards} needs an initialized "
                             f"torch.distributed process group (see "
                             f"spawn_ranks); none is")
        if n_shards != world:
            raise ValueError(f"n_shards={n_shards} but the process group "
                             f"has {world} ranks")
        self.grouped = grouped
        self.size = world
        self.rank = dist.get_rank() if grouped else 0

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.grouped:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if self.grouped:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(ranks, *t.shape): every rank's ``t``, in rank order."""
        if not self.grouped:
            return t[None]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return torch.stack(out)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An int64 payload of ``t``: float64 as its bit pattern, integers
    and bools as int64."""
    return t.view(I64) if t.dtype == F64 else t.to(I64)


class _ShardChunk(_Chunk):
    """One rank's block of the carry plus the step that advances it: the
    serial :class:`~repro_torch.core.equilibrium_batch._Chunk`'s step, its
    selection one launch of K1's window form over the rank's destination
    block and the ranks' winners folded, its apply the serial one with
    owner-local writes and owner gathers (the reference's ``apply_move``).

    ``dyn`` / ``const`` have ``_Chunk``'s keys; the tensors named by the
    module's axis tuples hold this rank's block (the device axis's
    ``n_local`` devices from ``base`` on, the registry's ``rows_local``
    rows from ``rbase``, the acting table's ``pg_local`` PGs from
    ``pgbase``), the rest the whole padded width.  ``n_real`` is the
    natural device count (the certificates the host fetches), ``rows_real``
    and ``pgs_real`` the natural registry and acting heights."""

    def __init__(self, dyn: dict, const: dict, scal: dict, *, k: int,
                 bounds: bool, kb: int, rb: int, comm: _Comm, n_real: int,
                 rows_real: int, pgs_real: int):
        self.comm = comm
        self.n_local = dyn["rows_on"].shape[0]
        self.base = comm.rank * self.n_local
        self.rows_local = const["sh_size"].shape[0]
        self.rbase = comm.rank * self.rows_local
        self.pg_local = dyn["acting"].shape[0]
        self.pgbase = comm.rank * self.pg_local
        self.n_real, self.rows_real, self.pgs_real = (n_real, rows_real,
                                                      pgs_real)
        super().__init__(dyn, const, scal, k=k, bounds=bounds, kb=kb, rb=rb)
        self.n_dev = n_real
        dev = self.dev_iota.device
        self.giota = self.base + torch.arange(self.n_local, device=dev)
        self.every_pos = torch.full((), self.k_pad, device=dev)
        # the registry block as packed records, gathered a step at a time
        self.rec_local = pack_records(const)

    def _bind_kernel(self) -> None:
        self.select_rows = bind_select_rows_window(
            self.cap_lim, self.dyn, self.const, self.scal, self.base)

    def _nrows_of(self, src_order) -> torch.Tensor:
        # the step's sources' row counts, gathered by select
        return self._nrows_k

    # -- cross-rank gathers ---------------------------------------------------

    def _owned(self, idx, blk_base, width) -> tuple:
        owns = legality.shard_owns(idx, blk_base, width)
        return owns, torch.where(owns, idx - blk_base, 0)

    def _pick(self, arrays, idx, blk_base, width) -> tuple:
        """This rank's part of an owner gather: (the values of
        ``arrays`` — this rank's blocks of one axis, ``width`` long from
        ``blk_base`` — at global indices ``idx``, as int64 (*idx.shape,
        columns), the arrays' columns side by side; where this rank owns
        each index)."""
        owns, safe = self._owned(idx, blk_base, width)
        return torch.cat([_bits(a[safe]).reshape(*idx.shape, -1)
                          for a in arrays], dim=-1), owns

    def _gather(self, *parts) -> list[torch.Tensor]:
        """Owner gathers, all in one sum: each part is (values (..., c)
        int64, owns (...)) as :meth:`_pick` gives it, and comes back as
        the owners' values."""
        contribs = [legality.shard_gather_contrib(v, o.to(I64)[..., None])
                    for v, o in parts]
        flat = torch.cat([c.reshape(-1) for c in contribs])
        summed = legality.shard_gather_finish(self.comm.sum(flat))
        return [part.view(c.shape) for part, c in zip(
            summed.split([c.numel() for c in contribs]), contribs)]

    def _sizes(self, rows: torch.Tensor) -> torch.Tensor:
        """The registry's bytes of global rows ``rows`` (-1: 0.0)."""
        (bits,) = self._gather(self._pick([self.rec_local[:, -1]],
                                          rows.clamp(min=0), self.rbase,
                                          self.rows_local))
        return torch.where(rows >= 0, bits[..., 0].view(F64), 0.0)

    # -- selection ------------------------------------------------------------

    def select(self, active: torch.Tensor, tel: torch.Tensor | None = None):
        """The serial step's selection: gathers the step's sources' rows,
        records, acting sets and count criterion from their owners once,
        launches K1's window form once, folds the ranks' winners and runs
        the serial closed form.  Updates this rank's certificates (where
        ``active``) and the telemetry ``tel`` (where given: tiles walked,
        tiles holding a candidate on any rank, on this rank, this rank's
        winners) and returns (found, row, src, dst, tried, skipped, the
        winner's packed record, its PG's acting set), each (1,) but the
        last two."""
        d, c, s = self.dyn, self.const, self.scal
        k, kb, R, k_pad = self.k, self.kb, self.r_cap, self.k_pad
        pos = self.pos
        order_k = d["order"][:k]            # maintained argsort(-util)
        at = torch.cat([order_k, self.pad])  # padding: device 0's rows
        (g,) = self._gather(self._pick([d["pruned"], d["nrows"],
                                        d["rows_on"]], at, self.base,
                                       self.n_local))        # (k_pad, R+2)
        if self.bounds:
            # the compaction's permutation of the gathered positions:
            # order_k[perm] is compact_parked(order_k, pruned[order_k])
            perm, n_avail = compact_parked(pos[:k], g[:k, 0] != 0)
            src_order = torch.cat([order_k[perm], self.pad])
            g = g[torch.cat([perm, pos[k:]])]
        else:
            src_order = at
            n_avail = torch.full((), k, device=pos.device)
        self._nrows_k = g[:, 1]
        rows_k = g[:, 2:].contiguous()                       # (k_pad, R)
        (rec,) = self._gather(self._pick([self.rec_local],
                                         rows_k.clamp(min=0), self.rbase,
                                         self.rows_local))   # (k_pad, R, 8)
        pool = rec[..., SH_FIELDS.index("sh_pool")]
        # the rows' PGs' acting sets and each source's count criterion at
        # the row's pool, each from its owner
        owns_s, ls = self._owned(src_order[:, None], self.base, self.n_local)
        src_ok = legality.src_count_ok(d["pool_counts"][pool, ls],
                                       c["ideal"][pool, ls], s["slack"])
        acting, ok_s = self._gather(
            self._pick([d["acting"]], rec[..., SH_FIELDS.index("sh_pg")],
                       self.pgbase, self.pg_local),
            (_bits(src_ok)[..., None], owns_s.expand(k_pad, R)))
        act_k = acting.contiguous()                          # (k_pad, R, S)
        src_ok = ok_s[..., 0] != 0

        # this rank's window: one K1 launch, every position available;
        # the fold below masks the parked ones, as the reference masks its
        # shards' folded winners
        telemetry = tel is not None
        out = self.select_rows(src_order, self.every_pos, rows_k, rec, act_k,
                               src_ok, cand_row=telemetry)
        any_l, dst_l, cand_l = out[:3]
        dst_l = dst_l.to(I64)
        kR = k_pad * R
        payload = [any_l.to(I64), d["util"][dst_l].view(I64), dst_l,
                   cand_l.to(I64)]
        if telemetry:
            payload.append(out[3].view(-1).to(I64))
        gathered = self.comm.gather(torch.cat(payload))     # (ranks, ...)
        ga = gathered[:, :kR] != 0
        gu = gathered[:, kR:2 * kR].view(F64)
        gd = gathered[:, 2 * kR:3 * kR]
        # the ranks' winners folded in ascending rank order
        any_row, usel, dst = ga[0], gu[0], gd[0]
        for r in range(1, self.comm.size):
            better = legality.shard_winner_better(ga[r], gu[r], gd[r],
                                                  any_row, usel, dst)
            usel = torch.where(better, gu[r], usel)
            dst = torch.where(better, gd[r], dst)
            any_row = any_row | ga[r]
        cand_src = legality.shard_any(
            gathered[:, 3 * kR:3 * kR + k_pad].sum(dim=0))
        any_row = any_row.view(k_pad, R) & (pos < n_avail)[:, None]
        dst = dst.view(k_pad, R)

        # the serial closed form, on replicated values
        src_has = any_row.any(dim=1)                         # (k_pad,)
        p = torch.where(src_has, pos, k).amin()              # k: none
        found = (p < k).view(1)
        jw = p.clamp(max=k - 1).view(1)
        ri = _first_true(any_row.index_select(0, jw)[0]).view(1)
        row = rows_k.index_select(0, jw)[0].index_select(0, ri)
        win_dst = dst.index_select(0, jw)[0].index_select(0, ri)
        win_dev = src_order.index_select(0, jw)
        at_w = jw * R + ri
        win_rec = rec.view(kR, -1).index_select(0, at_w)[0]
        win_act = act_k.view(kR, -1).index_select(0, at_w)[0]
        geo = None
        if kb > 1 and (self.bounds or telemetry):
            geo = self.frontier(p, ri, n_avail, src_order)
        if self.bounds:
            rank = _first_true(order_k == win_dev).view(1)
            prunable = self.certified(p, n_avail, cand_src, geo) & active
            # owner-local: this rank's devices among the first k sources
            # (the padding repeats device 0 and is never certified)
            hit = ((self.giota[:, None] == src_order[None, :k])
                   & prunable[None, :k]).any(dim=1)
            d["pruned"] |= hit
        else:
            rank = jw
        if telemetry:
            walked = self.walked(p, ri, n_avail, src_order, active, geo)
            nb = R // self.rb

            def tiles(rows):                 # any slot, any row of a tile
                t = rows.view(k_pad, nb, self.rb).any(dim=2)
                return t.view(self.n_sb, kb, nb).any(dim=1) if kb > 1 else t

            rows_g = (gathered[:, 3 * kR + k_pad:] != 0).any(dim=0)
            owns_w = legality.shard_owns(win_dst, self.base, self.n_local)
            tel += torch.stack([
                walked.sum(), (walked & tiles(rows_g.view(k_pad, R))).sum(),
                (walked & tiles(out[3])).sum(),
                (found & active & owns_w).sum()])
        return (found, row, win_dev, win_dst, rank + 1, rank - jw, win_rec,
                win_act)

    # -- apply ----------------------------------------------------------------

    def apply(self, ok, row, src, dst, rec, act, ends) -> None:
        """The serial ``_Chunk.apply`` over this rank's block: the moved
        row's record ``rec`` and its PG's acting set ``act`` as selection
        gathered them, ``ends`` (2, R + 4) the endpoints' row counts,
        rows, ``dst_ok``, count and ideal at the row's pool
        (:meth:`_endpoints`); every write to a sharded tensor is its
        owner's, every replicated value is updated by the serial
        expressions."""
        d, c, s = self.dyn, self.const, self.scal
        used, util = d["used"], d["util"]
        R = self.r_cap
        okf = ok.to(F64)
        oki = ok.to(I64)
        pool = rec[SH_FIELDS.index("sh_pool")].view(1)
        pgi = rec[SH_FIELDS.index("sh_pg")].view(1)
        slot = rec[SH_FIELDS.index("sh_slot")].view(1)
        size = rec[-1:].view(F64)
        both = torch.cat([src, dst])
        at_src, at_dst = self.giota == src, self.giota == dst
        src_list, dst_list = ends[0, 1:R + 1], ends[1, 1:R + 1]
        dok_before = ends[:, R + 1] != 0
        counts, ideal = ends[:, R + 2].view(F64), ends[:, R + 3].view(F64)
        if self.bounds:
            util_src_before = util[src]
            used_src_before = used[src]
        owns_pg, lpg = self._owned(pgi, self.pgbase, self.pg_local)
        acting = d["acting"]
        acting[lpg, slot] = torch.where(ok & owns_pg, dst, acting[lpg, slot])
        # the destination-count criterion changed only where counts did
        c2 = counts + torch.cat([-okf, okf])
        dok_after = torch.where(ok, legality.dst_count_ok(c2, ideal,
                                                          s["slack"]),
                                dok_before)
        pc, dok = d["pool_counts"], d["dst_ok"]
        pc[pool] = torch.where(at_src, c2[0],
                               torch.where(at_dst, c2[1], pc[pool]))
        dok[pool] = torch.where(at_src, dok_after[0],
                                torch.where(at_dst, dok_after[1], dok[pool]))
        # sorted row lists: shift-remove from src, shift-insert into dst
        removed = _shift_remove(src_list, _first_true(src_list == row), -1)
        dsz = torch.where(dst_list >= 0, self._sizes(dst_list),
                          float("-inf"))
        before = (dst_list >= 0) & ((dsz > size)
                                    | ((dsz == size) & (dst_list < row)))
        inserted = _shift_insert(dst_list, before.sum(), row)
        rows_on = d["rows_on"]
        for end, new in ((src, removed), (dst, inserted)):
            owns, li = self._owned(end, self.base, self.n_local)
            rows_on[li] = torch.where(ok & owns, new, rows_on[li])
        nrows = d["nrows"]
        nrows.copy_(torch.where(at_src, nrows - oki,
                                torch.where(at_dst, nrows + oki, nrows)))
        used[both] = used[both] + torch.cat([-size * okf, size * okf])
        cap = c["cap"]
        for i in (src, dst):                  # source first, like apply_row
            u_new = used[i] / cap[i]
            d["us"] += u_new - util[i]
            d["usq"] += u_new ** 2 - util[i] ** 2
            util[i] = u_new
        new_order = self._reorder(util, src, dst)
        d["order"].copy_(torch.where(ok, new_order, d["order"]))
        if self.bounds:
            # the serial triggers over this rank's block of the
            # certificates
            iota = self.giota
            act_after = torch.where(
                (torch.arange(act.shape[0], device=act.device) == slot) & ok,
                dst, act)
            holder = (act_after[None, :] == iota[:, None]).any(dim=1)
            touch = at_src | at_dst | holder
            crossed = legality.bound_crossed(
                util_src_before, util[src],
                util[self.base:self.base + self.n_local], src, iota)
            flip = legality.count_flip_enables(dok_before[0], dok_after[0])
            holds_pool = pc[pool][0] > 0.0
            # the head rows' sizes of this rank's block: the registry rows
            # live on any rank, so every rank's heads are gathered and
            # resolved together
            heads = self.comm.gather(rows_on[:, 0].contiguous()).view(-1)
            sizes = self._sizes(heads)[self.base:self.base + self.n_local]
            maxsz = torch.where(rows_on[:, 0] >= 0, sizes, 0.0)
            bind = legality.bound_capacity_binding(
                used_src_before, self.cap_lim[src], maxsz)
            inval = touch | crossed | (flip & holds_pool) | bind
            pr = d["pruned"]
            pr.copy_(torch.where(ok, pr & ~inval, pr))

    def _endpoints(self, src, dst, pool) -> torch.Tensor:
        """(2, R + 4) int64 for (src, dst) from their owners: the row
        count, the rows, ``dst_ok``, the pool count and the ideal at
        ``pool`` (the last two as float64 bit patterns)."""
        d = self.dyn
        p = pool.view(1)
        (ends,) = self._gather(self._pick(
            [d["nrows"], d["rows_on"], d["dst_ok"][p][0],
             d["pool_counts"][p][0], self.const["ideal"][p][0]],
            torch.cat([src, dst]), self.base, self.n_local))
        return ends

    # -- chunk ----------------------------------------------------------------

    def run(self, m: int, telemetry: bool = False) -> torch.Tensor:
        """Up to ``m`` steps; returns the serial ``_Chunk.run``'s packed
        result with ``max(nrows)`` over every rank, the natural width's
        certificates gathered from every rank and, with ``telemetry``,
        every rank's (4,) telemetry (tiles walked, tiles holding a
        candidate on any rank, on this rank, this rank's winners), in rank
        order."""
        dev = self.dev_iota.device
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        overflow = torch.zeros(1, dtype=torch.bool, device=dev)
        moves = torch.empty((m, 5), dtype=I64, device=dev)
        tel = torch.zeros(4, dtype=I64, device=dev) if telemetry else None
        pool_col = SH_FIELDS.index("sh_pool")
        for t in range(m):
            active = ~(done | overflow)
            found, row, src, dst, tried, skipped, rec, act = self.select(
                active, tel)
            found &= active
            ends = self._endpoints(src, dst, rec[pool_col])
            # a full destination row list would drop a shard: stop and let
            # the host re-pad (never hit when r_cap >= max rows + chunk)
            ovf = found & (ends[1, :1] >= self.r_cap)
            ok = found & ~ovf
            self.apply(ok, row, src, dst, rec, act, ends)
            moves[t] = torch.where(ok, torch.cat([row, src, dst, tried,
                                                  skipped]), -1)
            done |= active & ~found
            overflow |= ovf
        nmax = self.comm.max(self.dyn["nrows"].max().view(1))
        pruned = self.comm.gather(self.dyn["pruned"].to(I64)).view(-1)
        out = [moves.flatten(), done.to(I64), overflow.to(I64), nmax,
               pruned[:self.n_real]]
        if telemetry:
            out.append(self.comm.gather(tel).view(-1))
        return torch.cat(out)

    # -- the natural-width carry ----------------------------------------------

    def gathered(self) -> SimpleNamespace:
        """The carry an absorption reads (``BatchPlanner._absorb``), back at
        its natural sizes from every rank's block: ``const`` but ``ideal``
        (which the new carry recomputes), ``dyn``'s ``acting``, ``nrows``
        and ``rows_on``, and ``r_cap``.  Collective: every rank calls it."""
        n, rows, pgs = self.n_real, self.rows_real, self.pgs_real

        def whole(t):                   # leading-axis blocks, rank order
            return self.comm.gather(_bits(t)).flatten(0, 1)

        const = {key: self.const[key][..., :n] for key in (
            "cap", "dev_class", "dev_in", "dev_domain")}
        records = whole(self.rec_local)[:rows]
        for i, key in enumerate(SH_FIELDS):
            const[key] = records[:, i].contiguous()
        const["sh_size"] = const["sh_size"].view(F64)
        dyn = {"acting": whole(self.dyn["acting"])[:pgs],
               "nrows": whole(self.dyn["nrows"])[:n],
               "rows_on": whole(self.dyn["rows_on"])[:n]}
        return SimpleNamespace(dyn=dyn, const=const, r_cap=self.r_cap)


# ---------------------------------------------------------------------------
# Host driver


def _pad_to(t: torch.Tensor, width: int, dim: int, value) -> torch.Tensor:
    """``t`` widened to ``width`` along ``dim`` with ``value``."""
    extra = width - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                    device=t.device)], dim=dim)


def partition_carry(dyn: dict, const: dict, n_shards: int, rank: int,
                    width: int) -> tuple[dict, dict, tuple[int, int, int]]:
    """Rank ``rank``'s part of a natural-width carry (``_Chunk``'s ``dyn``
    and ``const``) split ``n_shards`` ways: the device axis padded to
    ``width`` (a multiple of ``n_shards``), the registry's rows and the
    acting table's PGs to multiples of ``n_shards``, the tensors the
    module's axis tuples name cut to the rank's block, the rest whole.
    The device pads are the fleet pack's neutral device: capacity 1,
    nothing stored, out of service, classless (-2 matches no shard
    class), its own failure domain, no rows, last in the fullest-first
    order; registry and acting pads are never referenced (every row and
    PG id in the carry is real).  Returns the new dicts and the natural
    (devices, registry rows, PGs)."""
    ns = n_shards
    n, rows, pgs = (const["cap"].shape[0], const["sh_size"].shape[0],
                    dyn["acting"].shape[0])
    rows_w, pgs_w = -(-rows // ns) * ns, -(-pgs // ns) * ns
    #: each padded tensor's pad value and its device axis
    pads = {"used": (0.0, 0), "util": (0.0, 0), "rows_on": (-1, 0),
            "nrows": (0, 0), "pruned": (False, 0), "cap": (1.0, 0),
            "dev_class": (-2, 0), "dev_in": (False, 0),
            "pool_counts": (0.0, -1), "dst_ok": (False, -1),
            "dev_domain": (-2, -1), "ideal": (0.0, -1)}
    dyn, const = dict(dyn), dict(const)
    for part in (dyn, const):
        for key, (value, dim) in pads.items():
            if key in part:
                part[key] = _pad_to(part[key], width, dim, value)
    dyn["order"] = torch.cat([dyn["order"], torch.arange(
        n, width, dtype=I64, device=dyn["order"].device)])

    def block(t, full, dim):
        size = full // ns
        return t.narrow(dim, rank * size, size).contiguous()

    for key in _DEVICE_LEADING:
        dyn[key] = block(dyn[key], width, 0)
    for key in _DEVICE_TRAILING:
        part = const if key == "ideal" else dyn
        part[key] = block(part[key], width, -1)
    for key in _ROW_AXIS:
        const[key] = block(_pad_to(const[key], rows_w, 0, 0), rows_w, 0)
    for key in _PG_AXIS:
        dyn[key] = block(_pad_to(dyn[key], pgs_w, 0, -1), pgs_w, 0)
    return dyn, const, (n, rows, pgs)


class ShardedBatchPlanner(BatchPlanner):
    """:class:`~repro_torch.core.equilibrium_batch.BatchPlanner` with the
    chunk step over a device axis split across the ranks of the
    ``torch.distributed`` process group.

    The host side — staleness, delta absorption, the stash, re-pads,
    reconcile — is inherited, and every rank runs it on its own copy of
    the cluster; only the carry's layout and the step differ.  The carry
    lives padded (the device axis rounded up to a multiple of
    ``n_shards`` with the neutral pad device) and partitioned; an
    absorption gathers it back to its natural sizes first.

    ``n_shards`` is the process group's world size (an explicit value
    that differs raises); with no process group, one shard and no
    collective at all.  ``pad_devices`` overrides the padded width (tests
    use it for uneven padding at one shard); it must be a multiple of
    ``n_shards``.  ``legality_cache`` is refused, as the reference
    refuses it.  ``device=None`` is the card (rank ``r`` on ``cuda:r``
    when there are several ranks); ``device="cpu"`` runs the kernels'
    plain versions.  Collectives: gloo on the CPU, NCCL on CUDA."""

    def __init__(self, state: ClusterState,
                 cfg: EquilibriumConfig | None = None, *,
                 n_shards: int | None = None,
                 pad_devices: int | None = None, device=None, **kwargs):
        if kwargs.get("legality_cache"):
            raise ValueError("the sharded engine does not support the "
                             "cross-move legality cache; plan unsharded "
                             "or drop legality_cache")
        self.comm = _Comm(n_shards)
        self.n_shards = ns = self.comm.size
        if pad_devices is not None and pad_devices % ns:
            raise ValueError(f"pad_devices={pad_devices} is not a "
                             f"multiple of n_shards={ns}")
        self._pad_override = pad_devices
        dev = resolve_device(device, "equilibrium_batch_sharded")
        if dev.type == "cuda" and dev.index is None and ns > 1:
            dev = torch.device("cuda", self.comm.rank)
        super().__init__(state, cfg, device=dev, **kwargs)

    def _pad_width(self, n: int) -> int:
        w = -(-n // self.n_shards) * self.n_shards
        if self._pad_override is not None:
            if self._pad_override < w:
                raise ValueError(f"pad_devices={self._pad_override} < "
                                 f"required width {w}")
            w = self._pad_override
        return w

    def _chunk(self, dyn: dict, const: dict, scal: dict, k: int
               ) -> _ShardChunk:
        """This rank's blocks of the natural-width carry, padded to
        :meth:`_pad_width`."""
        dyn, const, sizes = partition_carry(
            dyn, const, self.n_shards, self.comm.rank,
            self._pad_width(const["cap"].shape[0]))
        n, rows, pgs = sizes
        return _ShardChunk(dyn, const, scal, k=k, bounds=self.source_bounds,
                           kb=self._kb, rb=self._rb, comm=self.comm,
                           n_real=n, rows_real=rows, pgs_real=pgs)

    def _absorb(self) -> bool:
        """Gather the carry back to its natural sizes (where the pending
        run is absorbable), then the inherited absorption, which ends in a
        new partitioned carry (:meth:`_chunk`)."""
        if self._absorbable(self._pending_run()):
            self._step = self._step.gathered()
        return super()._absorb()

    def _repad(self) -> None:
        """Widen this rank's row table to the maximum rows of any rank +
        chunk (one sync)."""
        reg = _obs_registry()
        reg.inc("batch.repads")
        _obs.point("batch.repad", cat="batch", r_cap=self._step.r_cap)
        dyn = self._step.dyn
        nmax = self.comm.max(dyn["nrows"].max().view(1))
        packed = _fetch(torch.cat([nmax, dyn["nrows"],
                                   dyn["rows_on"].flatten()]))
        r_cap = self._round_cap(int(packed[0]) + self.chunk)
        n_local = dyn["nrows"].shape[0]
        nrows_np = packed[1:1 + n_local]
        rows_np = packed[1 + n_local:].reshape(n_local, -1)
        rows = np.full((n_local, r_cap), -1, np.int64)
        for i, nd in enumerate(nrows_np.tolist()):
            rows[i, :nd] = rows_np[i, :nd]
        dyn["rows_on"] = torch.as_tensor(rows, device=self.device)

    def _record_chunk_tel(self, reg, tel: np.ndarray) -> None:
        """Fold every rank's fetched telemetry into the registry: the
        tiles walked and the tiles holding a candidate anywhere once (every
        rank walks in lockstep), and each rank's tiles walked, tiles with a
        candidate in its block and winners in its block by ``shard``."""
        tel = np.asarray(tel).reshape(-1, 4)
        reg.inc("batch.tiles_walked", int(tel[0, 0]))
        reg.inc("batch.cand_tiles", int(tel[0, 1]))
        for s in range(tel.shape[0]):
            reg.inc("batch.shard.tiles_walked", int(tel[s, 0]), shard=s)
            reg.inc("batch.shard.cand_tiles", int(tel[s, 2]), shard=s)
            reg.inc("batch.shard.wins", int(tel[s, 3]), shard=s)

    def _engine_stats(self, snap: dict, stats_out: dict) -> None:
        super()._engine_stats(snap, stats_out)
        stats_out["shards"] = self.n_shards


def chunk_memory_stats(bp: BatchPlanner) -> dict:
    """Memory of the planner's carry on this rank, the PyTorch
    counterpart of the reference's ``chunk_memory_stats``: these are not
    XLA's ``memory_analysis`` figures.  ``argument_bytes`` is the bytes
    of the rank's carry (every tensor of the chunk's ``dyn``, ``const``
    and ``scal``); on CUDA, ``peak_bytes`` is
    ``torch.cuda.max_memory_allocated`` over one chunk run on the carry,
    which is then put back as it was.  Syncs the planner (building the
    carry if needed); returns {} for a degenerate cluster with nothing to
    plan.  Collective for a sharded planner: every rank calls it."""
    bp.sync()
    step = bp._step
    if step is None:
        return {}
    tensors = [*step.dyn.values(), *step.const.values(), *step.scal.values()]
    stats = {"argument_bytes": sum(t.numel() * t.element_size()
                                   for t in tensors)}
    if step.cap_lim.is_cuda:
        dev = step.cap_lim.device
        saved = {key: t.cpu() for key, t in step.dyn.items()}
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step.run(bp.chunk)
        torch.cuda.synchronize(dev)
        stats["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        for key, t in saved.items():
            step.dyn[key].copy_(t)
    return stats


def _rank_main(rank: int, world: int, backend: str, tmp: str,
               timeout: float, fn, args) -> None:
    """One rank of :func:`spawn_ranks`: join the group, run ``fn``, leave
    its result in ``tmp``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    out = Path(tmp) / f"rank{rank}.pkl"
    part = out.with_suffix(".part")
    part.write_bytes(pickle.dumps(result))
    os.replace(part, out)


def spawn_ranks(fn, world: int, backend: str = "gloo", args: tuple = (),
                timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes joined in one
    ``torch.distributed`` process group (``backend``: gloo on the CPU,
    NCCL on CUDA with rank ``r`` on ``cuda:r``), its store a file under a
    temporary directory, and return each rank's result in rank order.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  A
    collective or the group's start that waits ``timeout`` seconds fails
    its rank.  Raises if any rank fails; every process has ended when it
    returns."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        mp.spawn(_rank_main, args=(world, backend, tmp, timeout, fn, args),
                 nprocs=world, join=True)
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                for r in range(world)]


@register_planner("equilibrium_batch_sharded", sim_config_attr="equilibrium",
                  description="batch engine with the chunk step over a "
                              "device axis split across the ranks of the "
                              "torch.distributed process group (K1's window "
                              "form on each rank; bit-identical to "
                              "equilibrium_batch)",
                  equivalence="equilibrium")
class ShardedBatchEquilibriumPlanner(BatchEquilibriumPlanner):
    """Protocol adapter over :class:`ShardedBatchPlanner` — the sharded
    twin of the ``equilibrium_batch`` registry entry (the same protocol
    surface, inherited from its adapter; only the bound engine differs).
    With no process group this is the engine on one shard; with a group
    of N ranks (:func:`spawn_ranks`), each rank plans its block of the
    device axis."""

    name = "equilibrium_batch_sharded"
    engine = "batch-sharded"

    def __init__(self, cfg: EquilibriumConfig | None = None, chunk: int = 64,
                 source_block: int = 1, row_block: int = 8,
                 row_capacity: int | None = None, warm: bool = True,
                 source_bounds: bool = True, pipeline: bool = True,
                 n_shards: int | None = None,
                 pad_devices: int | None = None, device=None):
        super().__init__(cfg, chunk=chunk, source_block=source_block,
                         row_block=row_block, row_capacity=row_capacity,
                         warm=warm, source_bounds=source_bounds,
                         pipeline=pipeline, device=device)
        del self._engine_kwargs["legality_cache"]
        self._engine_kwargs.update(n_shards=n_shards,
                                   pad_devices=pad_devices)

    def _bind(self, state: ClusterState) -> ShardedBatchPlanner:
        if self._impl is None or self._impl.state is not state:
            self._impl = ShardedBatchPlanner(state, self.cfg,
                                             **self._engine_kwargs)
        return self._impl
