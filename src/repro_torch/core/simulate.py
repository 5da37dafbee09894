"""Movement simulation + evaluation harness (paper §3.2).

Both balancers emit movement instructions against a *copy* of the cluster
state; this module replays those instructions on a fresh copy to measure
what the paper's Table 1 and Figures 4–6 report:

* gained pool free space (sum over user-data pools of max-avail delta),
* total moved bytes,
* utilization variance trajectory (cluster-wide and per device class),
* per-pool free-space trajectories.

It also provides the **movement throttle** (:class:`MovementThrottle`):
in a real cluster an upmap lands in the osdmap instantly but the data
lands over time, gated by ``osd_max_backfills`` and per-device recovery
bandwidth.  The throttle tracks that gap — the *target* map (what the
balancers plan against) versus *physical* occupancy (what utilization
metrics should measure) — and is the transport model of the scenario
engine (:mod:`repro_torch.sim.engine`).  :func:`simulate_throttled`
replays one precomputed move list under it.

The port of :mod:`repro.core.simulate`, with the same arithmetic in the
same order, except in one case where the reference never finishes.  After
an upmap is re-targeted back to the device that still holds the shard
(A→B, then B→A while A→B is in flight), the superseding transfer's holder
*is* its destination.  The reference's :meth:`MovementThrottle.tick`
charges that device's budget twice, first for the destination and then
for the holder; once the transfer wants the whole per-tick budget the
second charge gets 0 bytes, and the transfer moves 0 bytes on every tick
from then on.  Here such a transfer (``src_holds`` and ``holder ==
mv.dst_osd``) has nothing to copy: it completes in the tick it is in
flight, takes no bandwidth from any device, and books its size as
completed bytes and its progress so far as completed progress, so both
conservation invariants hold.  Every other transfer moves exactly as the
reference's does.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .cluster import ClusterState, GiB, Movement


@dataclass
class SimulationResult:
    moves_applied: int
    moved_bytes: float
    free_before: float
    free_after: float
    variance_before: float
    variance_after: float
    variance_by_class_before: dict[str, float]
    variance_by_class_after: dict[str, float]
    pool_free_before: dict[int, float]
    pool_free_after: dict[int, float]
    # per-move trajectories (index 0 = initial state)
    variance_trajectory: np.ndarray = field(default=None)
    free_trajectory: np.ndarray = field(default=None)
    moved_bytes_trajectory: np.ndarray = field(default=None)

    @property
    def gained_free_space(self) -> float:
        return self.free_after - self.free_before


def device_classes(state: ClusterState) -> list[str]:
    return sorted({d.device_class for d in state.devices})


def simulate(initial: ClusterState, movements: list[Movement],
             record_trajectory: bool = True,
             trajectory_stride: int = 1) -> SimulationResult:
    """Replay ``movements`` on a copy of ``initial`` and measure effects."""
    state = initial.copy()
    classes = device_classes(state)
    free_before = state.total_pool_free_space()
    var_before = state.utilization_variance()
    var_class_before = {c: state.utilization_variance(c) for c in classes}
    pool_free_before = {pid: state.pool_free_space(pid) for pid in state.pools}

    var_traj = [var_before]
    free_traj = [free_before]
    moved_traj = [0.0]
    moved = 0.0
    for i, mv in enumerate(movements):
        state.apply(mv)
        moved += mv.size
        if record_trajectory and (i % trajectory_stride == 0 or i == len(movements) - 1):
            var_traj.append(state.utilization_variance())
            free_traj.append(state.total_pool_free_space())
            moved_traj.append(moved)

    state.check_valid()
    return SimulationResult(
        moves_applied=len(movements),
        moved_bytes=moved,
        free_before=free_before,
        free_after=state.total_pool_free_space(),
        variance_before=var_before,
        variance_after=state.utilization_variance(),
        variance_by_class_before=var_class_before,
        variance_by_class_after={c: state.utilization_variance(c) for c in classes},
        pool_free_before=pool_free_before,
        pool_free_after={pid: state.pool_free_space(pid) for pid in state.pools},
        variance_trajectory=np.array(var_traj) if record_trajectory else None,
        free_trajectory=np.array(free_traj) if record_trajectory else None,
        moved_bytes_trajectory=np.array(moved_traj) if record_trajectory else None,
    )


# ---------------------------------------------------------------------------
# Movement throttle: target map vs physical occupancy


@dataclass
class ThrottleConfig:
    """Backfill limits, mirroring Ceph's recovery knobs.

    ``max_concurrent`` caps cluster-wide in-flight backfills
    (osd_max_backfills aggregated); ``device_bytes_per_tick`` is each
    device's recovery bandwidth per simulation tick, shared by every
    transfer reading from or writing to it.
    """

    max_concurrent: int = 8
    device_bytes_per_tick: float = 512 * GiB


@dataclass
class _Transfer:
    mv: Movement
    remaining: float
    # False once the source's copy is gone (failure recovery: the data is
    # re-read from surviving peers, so the source consumes no bandwidth
    # and holds no physical bytes).
    src_holds: bool = True
    # Physical holder of the shard's bytes.  Usually mv.src_osd, but when
    # an upmap is re-targeted mid-backfill (shard moved A→B, then B→C
    # while A→B was still transferring) the superseding transfer keeps
    # reading from the *original* holder A — the intermediate destination
    # never completed and holds nothing.
    holder: int = -1

    def __post_init__(self):
        if self.holder < 0:
            self.holder = self.mv.src_osd


class MovementThrottle:
    """FIFO backfill queue: admits up to ``max_concurrent`` transfers,
    progresses each by the per-device bandwidth it can claim, and accounts
    for the target-vs-physical occupancy gap."""

    def __init__(self, cfg: ThrottleConfig | None = None):
        self.cfg = cfg or ThrottleConfig()
        self.pending: deque[_Transfer] = deque()
        self.in_flight: list[_Transfer] = []
        self.transferred_bytes = 0.0
        self.completed_moves = 0
        self.cancelled_moves = 0
        # byte ledger (conservation oracle): every enqueued byte ends up
        # completed, cancelled or still live; every transferred byte ends
        # up as completed progress, discarded progress or live progress
        self.enqueued_bytes = 0.0
        self.completed_bytes = 0.0
        self.completed_progress_bytes = 0.0
        self.cancelled_bytes = 0.0
        self.discarded_bytes = 0.0

    # -- queue management ---------------------------------------------------

    def enqueue(self, movements: list[Movement], src_holds: bool = True) -> None:
        for mv in movements:
            holder, holds = mv.src_osd, src_holds
            old = self._find_shard(mv.pg, mv.slot)
            if old is not None:
                # upmap re-targeted mid-backfill: the superseded transfer's
                # destination never completed, so the new one re-reads the
                # full shard from the original physical holder and the
                # partially transferred bytes are discarded
                self._remove(old)
                self.cancelled_moves += 1
                holder, holds = old.holder, old.src_holds
            self.pending.append(_Transfer(mv, float(mv.size), holds, holder))
            self.enqueued_bytes += float(mv.size)

    def _find_shard(self, pg, slot) -> _Transfer | None:
        for t in self.in_flight:
            if t.mv.pg == pg and t.mv.slot == slot:
                return t
        for t in self.pending:
            if t.mv.pg == pg and t.mv.slot == slot:
                return t
        return None

    def _remove(self, tr: _Transfer) -> None:
        if tr in self.in_flight:
            self.in_flight.remove(tr)
        else:
            self.pending.remove(tr)
        self.cancelled_bytes += float(tr.mv.size)
        self.discarded_bytes += float(tr.mv.size) - tr.remaining

    def cancel_to(self, osd_id: int) -> int:
        """Drop transfers destined for a device that just died; the shard's
        new recovery move supersedes them.  Partially transferred bytes
        stay counted (they were moved, then lost)."""
        n0 = len(self.pending) + len(self.in_flight)
        for t in list(self.pending) + self.in_flight:
            if t.mv.dst_osd == osd_id:
                self.cancelled_bytes += float(t.mv.size)
                self.discarded_bytes += float(t.mv.size) - t.remaining
        self.pending = deque(t for t in self.pending
                             if t.mv.dst_osd != osd_id)
        self.in_flight = [t for t in self.in_flight if t.mv.dst_osd != osd_id]
        dropped = n0 - len(self.pending) - len(self.in_flight)
        self.cancelled_moves += dropped
        return dropped

    def source_lost(self, osd_id: int) -> None:
        """The holding device's data is gone (failure): in-progress reads
        fall back to surviving peers."""
        for t in self.pending:
            if t.holder == osd_id:
                t.src_holds = False
        for t in self.in_flight:
            if t.holder == osd_id:
                t.src_holds = False

    @property
    def backlog_moves(self) -> int:
        return len(self.pending) + len(self.in_flight)

    @property
    def backlog_bytes(self) -> float:
        return (sum(t.remaining for t in self.pending)
                + sum(t.remaining for t in self.in_flight))

    # -- simulation ---------------------------------------------------------

    def tick(self) -> float:
        """Advance one tick; returns bytes transferred this tick."""
        while (self.pending
               and len(self.in_flight) < self.cfg.max_concurrent):
            self.in_flight.append(self.pending.popleft())
        budget: dict[int, float] = {}
        bw = self.cfg.device_bytes_per_tick

        def take(osd: int, want: float) -> float:
            left = budget.setdefault(osd, bw)
            got = min(left, want)
            budget[osd] = left - got
            return got

        moved = 0.0
        still: list[_Transfer] = []
        for t in self.in_flight:
            if t.src_holds and t.holder == t.mv.dst_osd:
                # re-targeted back to its holder: the bytes are already
                # there (the reference charges the one device twice here
                # and can move 0 bytes forever)
                self._complete(t)
                continue
            want = min(t.remaining, budget.get(t.mv.dst_osd, bw))
            if t.src_holds:
                want = min(want, budget.get(t.holder, bw))
            if want > 0.0:
                got = take(t.mv.dst_osd, want)
                if t.src_holds:
                    got = take(t.holder, got)
                t.remaining -= got
                moved += got
            if t.remaining <= 1e-6:
                self._complete(t)
            else:
                still.append(t)
        self.in_flight = still
        self.transferred_bytes += moved
        return moved

    def _complete(self, t: _Transfer) -> None:
        self.completed_moves += 1
        self.completed_bytes += float(t.mv.size)
        self.completed_progress_bytes += float(t.mv.size) - t.remaining

    # -- accounting ---------------------------------------------------------

    def check_conservation(self, rel: float = 1e-9) -> dict:
        """Assert the two byte-conservation invariants and return the
        ledger.

        * **queue**: every enqueued byte is completed, cancelled
          (superseded mid-backfill or dropped by :meth:`cancel_to`) or
          still live in the queue;
        * **flow**: every byte :meth:`tick` reported as transferred is
          completed progress, discarded progress of a cancelled transfer,
          or live progress of an in-flight one.

        Exact up to float summation order, hence the relative tolerance.
        """
        live = list(self.pending) + self.in_flight
        live_size = sum(float(t.mv.size) for t in live)
        live_progress = sum(float(t.mv.size) - t.remaining for t in live)
        ledger = {
            "enqueued_bytes": self.enqueued_bytes,
            "completed_bytes": self.completed_bytes,
            "cancelled_bytes": self.cancelled_bytes,
            "live_bytes": live_size,
            "transferred_bytes": self.transferred_bytes,
            "completed_progress_bytes": self.completed_progress_bytes,
            "discarded_bytes": self.discarded_bytes,
            "live_progress_bytes": live_progress,
        }
        queue_rhs = self.completed_bytes + self.cancelled_bytes + live_size
        scale = max(abs(self.enqueued_bytes), abs(queue_rhs), 1.0)
        assert abs(self.enqueued_bytes - queue_rhs) <= rel * scale, \
            f"throttle queue conservation violated: {ledger}"
        flow_rhs = (self.completed_progress_bytes + self.discarded_bytes
                    + live_progress)
        scale = max(abs(self.transferred_bytes), abs(flow_rhs), 1.0)
        assert abs(self.transferred_bytes - flow_rhs) <= rel * scale, \
            f"throttle flow conservation violated: {ledger}"
        return ledger

    def physical_used(self, state: ClusterState) -> np.ndarray:
        """Per-device *physical* bytes: the state's target occupancy plus
        corrections for data not yet transferred (source still holds its
        copy; destination only holds what has arrived)."""
        used = state.used()
        for t in list(self.pending) + self.in_flight:
            if t.src_holds and t.holder in state.dev_by_id:
                used[state.idx(t.holder)] += t.mv.size
            used[state.idx(t.mv.dst_osd)] -= t.remaining
        return used


@dataclass
class ThrottledReplayResult:
    ticks: int
    moved_bytes: float
    variance_target: float
    # per-tick physical series (index 0 = before any transfer lands)
    variance_trajectory: np.ndarray
    transferred_trajectory: np.ndarray
    in_flight_trajectory: np.ndarray


def simulate_throttled(initial: ClusterState, movements: list[Movement],
                       throttle: ThrottleConfig | None = None,
                       max_ticks: int = 100_000) -> ThrottledReplayResult:
    """Replay a move list the way a cluster executes it: every upmap lands
    in the target map at tick 0, the data drains through the throttle.
    Physical utilization variance converges to the target variance only
    once the backlog empties — the gap is the movement cost over time."""
    state = initial.copy()
    q = MovementThrottle(throttle)
    for mv in movements:
        state.apply(mv)
    q.enqueue(movements)
    cap = state.capacity_vector()
    var_traj = [float(np.var(q.physical_used(state) / cap))]
    moved_traj = [0.0]
    inflight_traj = [0]
    ticks = 0
    while q.backlog_moves and ticks < max_ticks:
        q.tick()
        ticks += 1
        var_traj.append(float(np.var(q.physical_used(state) / cap)))
        moved_traj.append(q.transferred_bytes)
        inflight_traj.append(len(q.in_flight))
    return ThrottledReplayResult(
        ticks=ticks,
        moved_bytes=q.transferred_bytes,
        variance_target=state.utilization_variance(),
        variance_trajectory=np.array(var_traj),
        transferred_trajectory=np.array(moved_traj),
        in_flight_trajectory=np.array(inflight_traj),
    )


def compare_balancers(initial: ClusterState, mgr_movements: list[Movement],
                      eq_movements: list[Movement]) -> dict:
    """Table-1 style comparison row for one cluster."""
    mgr = simulate(initial, mgr_movements, record_trajectory=False)
    eq = simulate(initial, eq_movements, record_trajectory=False)
    return {
        "default_gained_free_space": mgr.gained_free_space,
        "ours_gained_free_space": eq.gained_free_space,
        "default_moved_bytes": mgr.moved_bytes,
        "ours_moved_bytes": eq.moved_bytes,
        "default_moves": mgr.moves_applied,
        "ours_moves": eq.moves_applied,
        "default_variance_after": mgr.variance_after,
        "ours_variance_after": eq.variance_after,
        "variance_before": mgr.variance_before,
    }
