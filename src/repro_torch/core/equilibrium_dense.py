"""The dense planner lanes of the port: the counterpart of the JAX
package's ``src/repro/core/equilibrium_jax.py``.

Two lanes plan over the flat host mirror :class:`~repro_torch.core.dense
.DenseState` and emit the faithful §3.1 planner's move stream, move for
move:

* ``engine="numpy"`` — one balancing step is dense masked NumPy work over
  a ``(shards_on_source, devices)`` grid (``DenseState.valid_matrix`` and
  ``pick``), with the host-side source-bound certificates of
  :mod:`.tail` behind ``source_bounds``.  Registered as ``equilibrium``,
  the planner every consumer of the port calls.
* ``engine="jax-legacy"`` — the reference's first-generation per-source
  lane, kept as the measured baseline: per source the host packs the
  source's rows (:func:`_pick_legacy`), uploads them once, and
  :func:`select_legacy` forms the ``(P, n_dev)`` validity mask in float64
  with the legality core's expressions and reduces it per row with one
  launch of K1's standalone reduction (``kernels/ops.py::masked_select``:
  the CUDA kernel on the card, its plain version only on tensors the
  caller put on the CPU); one fetch a source returns the winner.  The
  engine tag keeps the reference's name, so stats compare across
  packages.  Registered as ``equilibrium_jax_legacy``; it runs on the
  CUDA card unless the caller passes ``device="cpu"``.

The reference needed ``enable_x64`` for the legacy lane: a float32
criterion flips near-threshold count and variance tests.  Every float
tensor the lane builds is float64, and the variance divisor is a float64
tensor on the lane's device (PyTorch's CUDA division by a host scalar
multiplies by its reciprocal).

The ``"batch"`` engine string belongs to ``equilibrium_batch``
(:mod:`.equilibrium_batch`) and is not routed through here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import legality
from .cluster import ClusterState, Movement
from .dense import DenseState
from .equilibrium import EquilibriumConfig, MoveRecord
from .equilibrium_batch import _first_true
from .tail import (SourceBounds, tail_flush, tail_record, tail_stats,
                   tail_terminal)
from ..device import resolve_device
from ..kernels import ops
from ..obs import registry as _obs_registry

ENGINES = ("numpy", "jax-legacy")


def host_sync_count() -> int:
    """Total device→host fetches of the legacy lane, one per evaluated
    source — a monotonic read of the ``dense.host_syncs`` counter."""
    return int(_obs_registry().get("dense.host_syncs"))


def _fetch(t: torch.Tensor) -> list:
    """The legacy lane's one device→host transfer a source."""
    _obs_registry().inc("dense.host_syncs")
    return t.tolist()


def upload(arrays: dict[str, np.ndarray], device: torch.device
           ) -> dict[str, torch.Tensor]:
    """The named host arrays on ``device`` in one copy: packed into one
    fresh byte buffer (each array at an 8-byte offset), copied once, and
    viewed back with its own dtype and shape.  The tensors never share
    memory with the arrays (on the CPU they share the fresh buffer)."""
    offs, total = [], 0
    for a in arrays.values():
        offs.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = np.empty(total, dtype=np.uint8)
    for off, a in zip(offs, arrays.values()):
        buf[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1) \
            .view(np.uint8)
    flat = torch.from_numpy(buf).to(device)
    return {name: flat[off:off + a.nbytes].view(_torch_dtype(a.dtype))
            .view(a.shape)
            for (name, a), off in zip(arrays.items(), offs)}


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def select_legacy(sizes, cls, member, peer, cnt, ideal, src_cnt, src_ideal,
                  used, cap, util, moments, dev_class, src_idx: int,
                  count_slack: float, headroom: float,
                  min_variance_delta: float):
    """One source's (P, n_dev) legality and criteria evaluation and its
    selection, on tensors (the counterpart of the reference's
    ``_jax_select``).

    Rows are the source's shard rows, largest first, padded to P with
    ``sizes`` -1 (never valid).  ``member`` already excludes out devices
    and destinations at or after the source in the emptiest-first order;
    ``peer`` has each shard's own source domain subtracted (the
    reference's ``own_dom_eq``, all False, is dropped); ``moments`` holds
    ``util_sum``, ``util_sumsq`` and ``n_dev`` as float64, so the variance
    divisor is a tensor on the lane's device.

    Returns 0-dim tensors ``(found, i, d)``: some row has a legal
    destination, the first such row (largest shard), and its emptiest
    legal destination (ties to the lowest index) from one K1 launch.
    """
    sizes_c = sizes[:, None]
    cls_ok = legality.class_ok(cls[:, None], dev_class[None, :])
    dom_ok = peer <= 0
    cap_ok = legality.capacity_ok(
        used[None, :], legality.capacity_limit(cap[None, :], headroom),
        sizes_c)
    src_ok = legality.src_count_ok(src_cnt, src_ideal, count_slack)
    dst_ok = legality.dst_count_ok(cnt, ideal, count_slack)
    util_sum, util_sumsq, n_f = moments[0], moments[1], moments[2]
    var_ok = legality.variance_improves(
        used[src_idx], used[None, :], cap[src_idx], cap[None, :],
        util[src_idx], util[None, :], sizes_c, util_sum, util_sumsq, n_f,
        min_variance_delta)
    valid = (cls_ok & ~member & dom_ok & cap_ok & dst_ok & var_ok
             & src_ok[:, None] & (sizes_c > 0))
    valid[:, src_idx] = False
    any_row, dst = ops.masked_select(valid, util)
    i = _first_true(any_row)
    return any_row.any(), i, dst.gather(0, i.view(1))[0]


def _pick_legacy(dense: DenseState, rows: np.ndarray, src_idx: int,
                 cfg: EquilibriumConfig, pad_rows: int,
                 device: torch.device) -> tuple[int, int] | None:
    """Pack one source's rows on the host exactly as the reference's
    ``_pick_jax`` does, upload them once, select with
    :func:`select_legacy` and fetch ``(found, i, d)`` once."""
    n = dense.n_dev
    R = len(rows)
    P = pad_rows * max(1, -(-R // pad_rows))      # round up to pad multiple

    def padded(a, fill=0):
        out = np.full((P,) + a.shape[1:], fill, dtype=a.dtype)
        out[:R] = a
        return out

    # out devices and destinations at/after the source's utilization rank
    # are folded into the membership mask (each excludes a destination)
    before_src = legality.before_source(dense.util, dense.util[src_idx],
                                        np.arange(n), src_idx)
    pool_rows = dense.sh_pool[rows]
    t = upload({
        "sizes": padded(dense.sh_size[rows].astype(np.float64), -1.0),
        "cls": padded(dense.sh_class[rows], 0),
        "member": padded(dense.member[dense.sh_pg[rows]]
                         | ~dense.dev_in[None, :] | ~before_src[None, :],
                         True),
        "peer": padded(dense.peer_occupancy(rows, src_idx)[0]),
        "cnt": padded(dense.pool_counts[pool_rows]),
        "ideal": padded(dense.ideal[pool_rows]),
        "src_cnt": padded(dense.pool_counts[pool_rows, src_idx]),
        "src_ideal": padded(dense.ideal[pool_rows, src_idx]),
        "used": dense.used, "cap": dense.cap, "util": dense.util,
        "moments": np.array([dense.util_sum, dense.util_sumsq, float(n)],
                            dtype=np.float64),
        "dev_class": dense.dev_class}, device)
    found, i, d = select_legacy(**t, src_idx=src_idx,
                                count_slack=cfg.count_slack,
                                headroom=cfg.headroom,
                                min_variance_delta=cfg.min_variance_delta)
    found, i, d = _fetch(torch.stack([found.long(), i, d.long()]))
    if not found or i >= R:
        return None
    return int(rows[i]), int(d)


def _balance_fast(state: ClusterState, cfg: EquilibriumConfig | None = None,
                  record_trajectory: bool = False, pad_rows: int = 256,
                  record_free_space: bool = True, engine: str = "numpy",
                  stats_out: dict | None = None, source_bounds: bool = False,
                  dense: DenseState | None = None, device=None):
    """The dense lanes' planning loop (the reference's ``_balance_fast``
    without its ``use_jax`` switch and its ``"batch"`` route): the faithful
    planner's move stream, applied to ``state``.

    ``engine`` is ``"numpy"`` or ``"jax-legacy"`` (see the module
    docstring); ``device`` is the legacy lane's (None: the CUDA card, or
    raise).  ``dense`` warm-starts from a mirror kept from an earlier
    call, which must be fresh (``DenseState.require_fresh``).  Returns
    ``(movements, records)``.
    """
    cfg = cfg or EquilibriumConfig()
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: "
                         "expected 'numpy' or 'jax-legacy'")
    legacy = engine == "jax-legacy"
    if source_bounds and legacy:
        raise ValueError("source_bounds is not supported by the jax-legacy "
                         "engine: its kernel does not expose the candidate "
                         "mask the prune predicate needs")
    if legacy:
        device = resolve_device(device, "the jax-legacy engine")
        syncs0 = host_sync_count()
    # warm start (``dense`` kept from a prior call): accepted only when
    # the mirror provably matches the state — a stale mirror raises
    # instead of silently planning on arrays that missed a mutation
    if dense is None:
        dense = DenseState(state)
    else:
        dense.require_fresh(state)
    bounds = SourceBounds() if source_bounds else None
    movements: list[Movement] = []
    records: list[MoveRecord] = []
    acc = tail_stats(stats_out)

    while len(movements) < cfg.max_moves:
        t0 = time.perf_counter()
        src_order = legality.fullest_first(dense.util)[: cfg.k]
        picked = None
        tried = 0
        if bounds is not None:
            bounds.begin_scan()
        for src_idx in src_order:
            tried += 1
            src_idx = int(src_idx)
            if bounds is not None and bounds.skip(src_idx):
                continue
            rows = dense.source_rows(src_idx)
            if rows.size == 0:
                if bounds is not None:
                    bounds.prune(src_idx, 0.0)   # no pairs at all
                continue
            if legacy:
                picked = _pick_legacy(dense, rows, src_idx, cfg, pad_rows,
                                      device)
            elif bounds is not None:
                cand = dense.candidate_matrix(rows, src_idx, cfg)
                if not cand.any():
                    # no candidate pair: certificate (rows[0] = largest)
                    bounds.prune(src_idx, float(dense.sh_size[rows[0]]))
                    continue
                picked = dense.pick(rows,
                                    cand & dense.variance_mask(rows, src_idx,
                                                               cfg))
            else:
                picked = dense.pick(rows,
                                    dense.valid_matrix(rows, src_idx, cfg))
            if picked is not None:
                break
        dt = time.perf_counter() - t0
        if picked is None:
            if bounds is not None:
                bounds.end_terminal_scan()
            tail_terminal(acc, dt)
            break
        row, dst_idx = picked
        t1 = time.perf_counter()
        if bounds is not None:
            pool_i = int(dense.sh_pool[row])
            s_pre = int(dense.sh_dev[row])
            pgi = int(dense.sh_pg[row])
            c_old = float(dense.pool_counts[pool_i, s_pre])
            i_src = float(dense.ideal[pool_i, s_pre])
            flip = bool(legality.count_flip_enables(
                legality.dst_count_ok(c_old, i_src, cfg.count_slack),
                legality.dst_count_ok(c_old - 1.0, i_src, cfg.count_slack)))
            util_before = float(dense.util[s_pre])
            used_before = float(dense.used[s_pre])
        mv = dense.apply_row(row, dst_idx)
        state.apply(mv)
        dense.mark_synced()      # mirror and state absorbed the same move
        if bounds is not None:
            holders = np.flatnonzero(dense.member[pgi]).tolist() + [s_pre]
            counts = dense.pool_counts[pool_i]
            bounds.invalidate(
                s_pre, dst_idx, holders, util_before,
                float(dense.util[s_pre]), dense.util, used_before,
                float(legality.capacity_limit(dense.cap[s_pre],
                                              cfg.headroom)),
                flip, lambda s: counts[s] > 0)
        tail_record(acc, tried, dt, time.perf_counter() - t1)
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
        if legacy:
            stats_out["host_syncs"] = host_sync_count() - syncs0
    tail_flush(acc)
    return movements, records
