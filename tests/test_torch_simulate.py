"""The port's replay harness and movement throttle
(``repro_torch.core.simulate``) against the JAX package's
(``repro.core.simulate``), compared exactly (``==`` on floats).

The cases of ``tests/test_simulate.py`` and the throttle cases of
``tests/test_sim_engine.py`` run through both packages on the same
cluster and moves.  The throttle's random op mixes run both packages in
lockstep, their ledgers equal after every op, until a transfer appears
whose holder is its destination while its source still holds the data:
the one case where the port does not follow the reference (the
reference can move 0 bytes a tick forever there).  From then on the port
alone must drain within a stated tick cap with its ledger balanced."""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro.core import EquilibriumConfig as RefEquilibriumConfig
from repro.core import GiB as RefGiB
from repro.core import Movement as RefMovement
from repro.core import MovementThrottle as RefThrottle
from repro.core import ThrottleConfig as RefThrottleConfig
from repro.core import TiB as RefTiB
from repro.core import compare_balancers as ref_compare_balancers
from repro.core import create_planner as ref_create_planner
from repro.core import simulate as ref_simulate
from repro.core import simulate_throttled as ref_simulate_throttled
from repro.core import small_test_cluster as ref_small_test_cluster
from repro_torch.core import (EquilibriumConfig, GiB, Movement,
                              MovementThrottle, ThrottleConfig, TiB,
                              compare_balancers, create_planner, simulate,
                              simulate_throttled, small_test_cluster)

assert GiB == RefGiB and TiB == RefTiB

#: ticks a transfer can stay at the head of the in-flight list: sizes
#: of the random mixes are at most 3 GiB, bandwidths at least 0.5 GiB a
#: tick, and the head transfer always gets the full bandwidth of its
#: devices
HEAD_TICKS = 6


def _tuples(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd, m.size) for m in moves]


def _plans(cfg_kw=None):
    """The same small cluster from both packages and its faithful plan
    from each (equal move for move)."""
    cfg_kw = cfg_kw or {}
    ref = ref_small_test_cluster()
    ref_moves = ref_create_planner(
        "equilibrium_faithful", cfg=RefEquilibriumConfig(**cfg_kw)).plan(
        ref.copy()).moves
    port = small_test_cluster()
    port_moves = create_planner(
        "equilibrium_faithful", cfg=EquilibriumConfig(**cfg_kw)).plan(
        port.copy()).moves
    assert _tuples(ref_moves) == _tuples(port_moves)
    assert len(port_moves) >= min(4, cfg_kw.get("max_moves", 4))
    return ref, ref_moves, port, port_moves


def _same_result(ref, port):
    for name in ("moves_applied", "moved_bytes", "free_before", "free_after",
                 "variance_before", "variance_after",
                 "variance_by_class_before", "variance_by_class_after",
                 "pool_free_before", "pool_free_after", "gained_free_space"):
        assert getattr(ref, name) == getattr(port, name), name
    for name in ("variance_trajectory", "free_trajectory",
                 "moved_bytes_trajectory"):
        a, b = getattr(ref, name), getattr(port, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.tolist() == b.tolist(), name


# ---------------------------------------------------------------------------
# the replay harness (tests/test_simulate.py's cases)


@pytest.mark.parametrize("stride", [1, 3])
def test_simulate_trajectory_matches_reference(stride):
    ref, ref_moves, port, port_moves = _plans()
    want = ref_simulate(ref, ref_moves, record_trajectory=True,
                        trajectory_stride=stride)
    got = simulate(port, port_moves, record_trajectory=True,
                   trajectory_stride=stride)
    _same_result(want, got)
    sampled = {i for i in range(len(port_moves)) if i % stride == 0}
    sampled.add(len(port_moves) - 1)
    assert len(got.variance_trajectory) == 1 + len(sampled)
    assert got.variance_trajectory[-1] == got.variance_after
    assert got.moved_bytes_trajectory[-1] == got.moved_bytes


def test_simulate_without_trajectory_matches_reference():
    ref, ref_moves, port, port_moves = _plans()
    want = ref_simulate(ref, ref_moves, record_trajectory=False)
    got = simulate(port, port_moves, record_trajectory=False)
    _same_result(want, got)
    assert got.variance_trajectory is None
    assert got.moves_applied == len(port_moves)


def test_gained_free_space_and_its_inverse_match_reference():
    """Balancing gains free space; replaying the inverse moves on the
    balanced state gives it back, in both packages alike."""
    ref, ref_moves, port, port_moves = _plans()
    want = ref_simulate(ref, ref_moves, record_trajectory=False)
    got = simulate(port, port_moves, record_trajectory=False)
    assert got.gained_free_space == want.gained_free_space > 0
    ref_bal, port_bal = ref.copy(), port.copy()
    for mv in ref_moves:
        ref_bal.apply(mv)
    for mv in port_moves:
        port_bal.apply(mv)
    ref_inv = [RefMovement(m.pg, m.slot, m.dst_osd, m.src_osd, m.size)
               for m in reversed(ref_moves)]
    port_inv = [Movement(m.pg, m.slot, m.dst_osd, m.src_osd, m.size)
                for m in reversed(port_moves)]
    back_ref = ref_simulate(ref_bal, ref_inv, record_trajectory=False)
    back = simulate(port_bal, port_inv, record_trajectory=False)
    _same_result(back_ref, back)
    assert back.gained_free_space < 0
    assert back.gained_free_space == pytest.approx(-got.gained_free_space,
                                                   rel=1e-9)


@pytest.mark.parametrize("max_concurrent,bw_tib", [(3, 2.0), (4, 1.0)])
def test_simulate_throttled_matches_reference(max_concurrent, bw_tib):
    """The throttled replay equals the reference's tick for tick and ends
    at the unthrottled endpoint."""
    ref, ref_moves, port, port_moves = _plans()
    want = ref_simulate_throttled(ref, ref_moves, RefThrottleConfig(
        max_concurrent=max_concurrent, device_bytes_per_tick=bw_tib * TiB))
    got = simulate_throttled(port, port_moves, ThrottleConfig(
        max_concurrent=max_concurrent, device_bytes_per_tick=bw_tib * TiB))
    assert (got.ticks, got.moved_bytes, got.variance_target) \
        == (want.ticks, want.moved_bytes, want.variance_target)
    for name in ("variance_trajectory", "transferred_trajectory",
                 "in_flight_trajectory"):
        assert getattr(got, name).tolist() == getattr(want, name).tolist()
    plain = simulate(port, port_moves, record_trajectory=False)
    assert got.moved_bytes == pytest.approx(plain.moved_bytes)
    assert got.variance_target == plain.variance_after
    assert got.variance_trajectory[-1] == pytest.approx(plain.variance_after,
                                                        rel=1e-9)
    assert got.variance_trajectory[0] == pytest.approx(plain.variance_before,
                                                       rel=1e-9)
    assert got.ticks == len(got.variance_trajectory) - 1
    assert got.in_flight_trajectory.max() <= max_concurrent


def test_compare_balancers_matches_reference():
    """The Table-1 row from both packages on the same mgr and
    Equilibrium plans."""
    ref, ref_eq, port, port_eq = _plans()
    ref_mgr = ref_create_planner("mgr").plan(ref.copy()).moves
    port_mgr = create_planner("mgr").plan(port.copy()).moves
    assert _tuples(ref_mgr) == _tuples(port_mgr)
    assert compare_balancers(port, port_mgr, port_eq) \
        == ref_compare_balancers(ref, ref_mgr, ref_eq)


# ---------------------------------------------------------------------------
# the throttle alone (tests/test_sim_engine.py's throttle cases)


def _both_throttles(max_concurrent, bw):
    return (RefThrottle(RefThrottleConfig(max_concurrent=max_concurrent,
                                          device_bytes_per_tick=bw)),
            MovementThrottle(ThrottleConfig(max_concurrent=max_concurrent,
                                            device_bytes_per_tick=bw)))


def _queue(q) -> list:
    return [(t.mv.pg, t.mv.slot, t.mv.src_osd, t.mv.dst_osd, t.mv.size,
             t.remaining, t.src_holds, t.holder)
            for t in list(q.pending) + q.in_flight]


#: the throttle's counters: its byte ledger and its move counts
COUNTERS = ("enqueued_bytes", "completed_bytes", "completed_progress_bytes",
            "cancelled_bytes", "discarded_bytes", "transferred_bytes",
            "completed_moves", "cancelled_moves")


def _same_throttle(ref_q, q, ledger: bool = True) -> dict | None:
    """Both throttles hold the same queue and counters; with ``ledger``,
    both ledgers balance and are equal (the cases whose bandwidth is a
    thousandth of a byte balance in neither package: the reference's
    tests do not check them)."""
    assert _queue(q) == _queue(ref_q)
    assert len(q.in_flight) == len(ref_q.in_flight)
    assert [getattr(q, c) for c in COUNTERS] \
        == [getattr(ref_q, c) for c in COUNTERS]
    if not ledger:
        return None
    got = q.check_conservation()
    assert got == ref_q.check_conservation()
    return got


def test_throttle_bandwidth_paces_transfer_like_reference():
    ref, _, _, port_moves = _plans({"max_moves": 1})
    mv = port_moves[0]
    ref_q, q = _both_throttles(4, mv.size / 4)
    ref_q.enqueue([RefMovement(mv.pg, mv.slot, mv.src_osd, mv.dst_osd,
                               mv.size)])
    q.enqueue([mv])
    ticks = 0
    while q.backlog_moves:
        assert q.tick() == ref_q.tick()
        ticks += 1
        _same_throttle(ref_q, q)
    assert ticks == 4 and q.completed_moves == 1
    assert q.transferred_bytes == pytest.approx(mv.size)


def test_throttle_concurrency_cap_like_reference():
    ref, ref_moves, _, port_moves = _plans({"max_moves": 6})
    ref_q, q = _both_throttles(2, 1e-3)
    ref_q.enqueue(ref_moves)
    q.enqueue(port_moves)
    assert q.tick() == ref_q.tick()
    _same_throttle(ref_q, q, ledger=False)
    assert len(q.in_flight) == 2 and q.backlog_moves == len(port_moves)


def test_throttle_cancel_and_source_lost_like_reference():
    ref, ref_moves, _, port_moves = _plans({"max_moves": 4})
    ref_q, q = _both_throttles(2, 1e-3)
    ref_q.enqueue(ref_moves)
    q.enqueue(port_moves)
    dst = port_moves[0].dst_osd
    assert q.cancel_to(dst) == ref_q.cancel_to(dst) \
        == sum(1 for m in port_moves if m.dst_osd == dst)
    q.source_lost(port_moves[-1].src_osd)
    ref_q.source_lost(port_moves[-1].src_osd)
    _same_throttle(ref_q, q, ledger=False)
    for t in list(q.pending) + q.in_flight:
        if t.mv.src_osd == port_moves[-1].src_osd:
            assert not t.src_holds


def test_retarget_mid_backfill_ledger_matches_reference():
    """Shard moved 1→2, re-targeted 2→3 while the first transfer was a
    third done: the same ledger as the reference's after every step."""
    ref_q, q = _both_throttles(2, 1.0 * GiB)
    for qq, mv_cls in ((ref_q, RefMovement), (q, Movement)):
        qq.enqueue([mv_cls((0, 0), 0, 1, 2, 3.0 * GiB)])
        qq.tick()
        qq.enqueue([mv_cls((0, 0), 0, 2, 3, 3.0 * GiB)])
    ledger = _same_throttle(ref_q, q)
    assert ledger["cancelled_bytes"] == 3.0 * GiB
    assert ledger["discarded_bytes"] == 1.0 * GiB
    (live,) = list(q.pending) + q.in_flight
    assert live.holder == 1 and live.remaining == 3.0 * GiB
    while q.backlog_moves:
        assert q.tick() == ref_q.tick()
        _same_throttle(ref_q, q)
    assert q.completed_progress_bytes == 3.0 * GiB
    assert q.transferred_bytes == 4.0 * GiB


# ---------------------------------------------------------------------------
# random op mixes: lockstep with the reference up to the livelock's case


def _ops(seed, n_ops):
    """The op sequence of ``tests/test_simulate.py``'s
    ``_check_throttle_conservation`` (the same draws in the same order):
    ``(max_concurrent, bandwidth, [op, ...])``, an op being ``("enqueue",
    [(pg, slot, src, dst, size), ...], src_holds)``, ``("tick",)``,
    ``("cancel", osd)`` or ``("lost", osd)``."""
    rng = np.random.default_rng((seed, 0x7407))
    max_concurrent = int(rng.integers(1, 5))
    bw = float(rng.uniform(0.5, 4.0)) * GiB
    shards = [((0, i), s) for i in range(6) for s in range(2)]

    def rand_move():
        pg, slot = shards[int(rng.integers(len(shards)))]
        src, dst = (int(x) for x in rng.choice(10, size=2, replace=False))
        return (pg, slot, src, dst, float(rng.uniform(0.1, 3.0)) * GiB)

    ops = []
    for _ in range(n_ops):
        op = int(rng.integers(5))
        if op <= 1:
            moves = [rand_move() for _ in range(int(rng.integers(1, 4)))]
            ops.append(("enqueue", moves, bool(rng.integers(2))))
        elif op == 2:
            ops.append(("tick",))
        elif op == 3:
            ops.append(("cancel", int(rng.integers(10))))
        else:
            ops.append(("lost", int(rng.integers(10))))
    return max_concurrent, bw, ops


def _apply(q, mv_cls, op):
    if op[0] == "enqueue":
        q.enqueue([mv_cls(*m) for m in op[1]], src_holds=op[2])
    elif op[0] == "tick":
        q.tick()
    elif op[0] == "cancel":
        q.cancel_to(op[1])
    else:
        q.source_lost(op[1])


def _holds_own_destination(q) -> bool:
    return any(t.src_holds and t.holder == t.mv.dst_osd
               for t in list(q.pending) + q.in_flight)


def _drain(q) -> int:
    """Tick the port's throttle empty, its ledger checked each tick; fail
    (never hang) past ``HEAD_TICKS`` ticks a transfer."""
    cap = HEAD_TICKS * q.backlog_moves
    ticks = 0
    while q.backlog_moves:
        assert ticks < cap, (f"throttle did not drain in {cap} ticks: "
                             f"{_queue(q)}")
        q.tick()
        ticks += 1
        q.check_conservation()
    ledger = q.check_conservation()
    assert ledger["enqueued_bytes"] == pytest.approx(
        ledger["completed_bytes"] + ledger["cancelled_bytes"])
    assert q.transferred_bytes == pytest.approx(
        q.completed_progress_bytes + q.discarded_bytes)
    return ticks


def _lockstep(seed, n_ops) -> bool:
    """Both throttles through the same ops, ledgers and queues equal after
    every op until a transfer holds its own destination; then the port
    alone, and its drain.  Returns whether that case appeared."""
    max_concurrent, bw, ops = _ops(seed, n_ops)
    ref_q, q = _both_throttles(max_concurrent, bw)
    reached = False
    for op in ops:
        _apply(q, Movement, op)
        if not reached:
            _apply(ref_q, RefMovement, op)
            _same_throttle(ref_q, q)
            reached = _holds_own_destination(q)
        q.check_conservation()
    if not reached:
        while q.backlog_moves and not reached:
            assert q.tick() == ref_q.tick()
            _same_throttle(ref_q, q)
            reached = _holds_own_destination(q)
    _drain(q)
    return reached


SPINE = [(0, 10), (1, 25), (2, 40), (3, 60), (7, 80), (13, 120)]
MORE = [(seed, 120) for seed in range(100, 150)]


@pytest.mark.parametrize("seed,n_ops", SPINE + MORE)
def test_throttle_random_mix_lockstep_with_reference(seed, n_ops):
    _lockstep(seed, n_ops)


def test_random_mixes_reach_the_livelock_case():
    """The lockstep cases do reach the case where the port departs from
    the reference, so the drain after it is exercised."""
    assert sum(_holds_case(seed, n) for seed, n in SPINE + MORE) >= 3


def _holds_case(seed, n_ops) -> bool:
    max_concurrent, bw, ops = _ops(seed, n_ops)
    q = MovementThrottle(ThrottleConfig(max_concurrent=max_concurrent,
                                        device_bytes_per_tick=bw))
    for op in ops:
        _apply(q, Movement, op)
        if _holds_own_destination(q):
            return True
    return False


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), n_ops=st.integers(1, 120))
def test_throttle_conservation_property(seed, n_ops):
    """The reference's property on the port, with a tick cap per example
    that fails rather than hangs."""
    max_concurrent, bw, ops = _ops(seed, n_ops)
    q = MovementThrottle(ThrottleConfig(max_concurrent=max_concurrent,
                                        device_bytes_per_tick=bw))
    for op in ops:
        _apply(q, Movement, op)
        q.check_conservation()
    _drain(q)


# ---------------------------------------------------------------------------
# the livelock itself


def _round_trip(state_cls_moves):
    """A real shard of the small cluster, a legal second home for it, and
    the A→B and B→A moves of its size."""
    state, mv_cls = state_cls_moves
    pg = state.pgs_of_pool[0][0]
    a = state.acting[pg][0]
    b = next(d.id for d in state.devices
             if d.id != a and state.move_is_legal(pg, 0, d.id))
    size = state.shard_sizes[pg]
    return mv_cls(pg, 0, a, b, size), mv_cls(pg, 0, b, a, size)


def test_retarget_back_to_holder_drains_in_one_tick():
    """A→B of three ticks' bandwidth, one tick, then B→A: the reference
    moves 0 bytes a tick with its backlog unchanged; the port completes
    the transfer in one tick with no bandwidth, its ledger balanced and
    its physical bytes those of the target map."""
    ref_state, port_state = ref_small_test_cluster(), small_test_cluster()
    ref_there, ref_back = _round_trip((ref_state, RefMovement))
    there, back = _round_trip((port_state, Movement))
    assert _tuples([there, back]) == _tuples([ref_there, ref_back])
    bw = there.size / 3
    ref_q, q = _both_throttles(4, bw)
    for qq, st_, mvs in ((ref_q, ref_state, (ref_there, ref_back)),
                         (q, port_state, (there, back))):
        st_.apply(mvs[0])
        qq.enqueue([mvs[0]])
        qq.tick()
        st_.apply(mvs[1])
        qq.enqueue([mvs[1]])
    _same_throttle(ref_q, q)
    (live,) = q.in_flight + list(q.pending)
    assert live.src_holds and live.holder == live.mv.dst_osd
    assert live.remaining == there.size >= bw

    before = ref_q.check_conservation()
    for _ in range(3):
        assert ref_q.tick() == 0.0
        assert ref_q.backlog_moves == 1
        assert _queue(ref_q)[0][5] == there.size
    assert ref_q.check_conservation()["transferred_bytes"] \
        == before["transferred_bytes"]

    assert q.physical_used(port_state).tolist() \
        == port_state.used().tolist()
    assert q.tick() == 0.0
    assert q.backlog_moves == 0 and q.completed_moves == 1
    ledger = q.check_conservation()
    assert ledger["completed_bytes"] == there.size
    assert ledger["cancelled_bytes"] == there.size
    assert ledger["transferred_bytes"] == bw
    assert ledger["discarded_bytes"] == there.size - (there.size - bw)
    assert ledger["completed_progress_bytes"] == 0.0
    assert q.physical_used(port_state).tolist() == port_state.used().tolist()


def test_retarget_back_takes_no_bandwidth_from_others():
    """The repaired transfer charges no device: a transfer beside it that
    shares the device moves exactly as it would alone."""
    bw = 1.0 * GiB
    ref_q, q = _both_throttles(4, bw)
    alone = MovementThrottle(ThrottleConfig(max_concurrent=4,
                                            device_bytes_per_tick=bw))
    alone.enqueue([Movement((0, 1), 0, 1, 5, 2.0 * GiB)])
    for qq, mv_cls in ((ref_q, RefMovement), (q, Movement)):
        qq.enqueue([mv_cls((0, 0), 0, 1, 2, 3.0 * GiB)])
        qq.tick()
        qq.enqueue([mv_cls((0, 0), 0, 2, 1, 3.0 * GiB),
                    mv_cls((0, 1), 0, 1, 5, 2.0 * GiB)])
    _same_throttle(ref_q, q)
    # the reference charges device 1 twice for the first transfer, which
    # leaves the second nothing
    assert ref_q.tick() == 0.0
    assert q.tick() == alone.tick() == bw
    assert _queue(q) == _queue(alone)
    q.check_conservation()
