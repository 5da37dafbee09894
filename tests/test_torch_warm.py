"""Warm start and delta absorption of the port's batch engine
(``BatchPlanner``, ``device="cpu"``: the engine the card runs, with K1's
plain version).

Each case plans a little, mutates the cluster (pool growth, device add,
device out and back in, a foreign movement, a pool create, and mixes of
them), and holds the warm continuation, move for move, to two plans of
the mutated state: the port's own cold ``BatchPlanner`` on an exact copy
(``ClusterState.from_plain``, which keeps the per-device bytes as they
are) and the JAX package's host ``equilibrium_faithful`` on a reference
``ClusterState`` built from the same seed and mutated in lockstep.  The
absorbed carry is held bitwise to a fresh build's, apart from the row
table's padding width and certificates kept across a foreign movement.
The delta stream's edges (unstamped, conflicting, overflowing, duplicate
deltas, a collected planner) and a property over seeded interleavings
close the file."""

import gc
import types
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.core import Device as RefDevice
from repro.core import Movement as RefMovement
from repro.core import PlacementRule as RefRule
from repro.core import Pool as RefPool
from repro.core import clustergen as ref_gen
from repro.core.crush import build_cluster as ref_build
from repro.core.crush import place_pg as ref_place
from repro.core.planner import create_planner as ref_create
from repro_torch import obs
from repro_torch.core import (ClusterDelta, ClusterState, Device, Movement,
                              PlacementRule, Pool, PoolGrowthDelta, TiB,
                              build_cluster, place_pg)
from repro_torch.core import clustergen as port_gen
from repro_torch.core.equilibrium import EquilibriumConfig
from repro_torch.core.equilibrium_batch import (BatchPlanner,
                                                dense_rebuild_count)
from repro_torch.core.planner import create_planner

#: the classes, rules and placement of each package, so that one mutation
#: function changes a port state and a reference state alike
PORT = types.SimpleNamespace(Device=Device, Movement=Movement,
                             Rule=PlacementRule, Pool=Pool, place=place_pg,
                             build=build_cluster)
REF = types.SimpleNamespace(Device=RefDevice, Movement=RefMovement,
                            Rule=RefRule, Pool=RefPool, place=ref_place,
                            build=ref_build)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tup(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves]


def trace(moves, records):
    return (tup(moves), [r.variance_after for r in records],
            [r.sources_tried for r in records])


def exact_copy(state: ClusterState) -> ClusterState:
    """A copy with the same per-device bytes (``copy()`` re-sums them,
    which can differ in the last bit after moves and growth)."""
    return ClusterState.from_plain(state.to_plain())


def absorb_points(records):
    return [r["args"] for r in records if r.get("name") == "batch.absorb"]


# ---------------------------------------------------------------------------
# mutations, each applied to a port and a reference state alike


def foreign_move(port, ref):
    """A foreign balancer's move: the host faithful planner's first move
    of a copy of the port state, applied to both states."""
    mv = create_planner("equilibrium_faithful",
                        cfg=EquilibriumConfig(max_moves=1)).plan(
        exact_copy(port)).moves[0]
    for state, m in ((port, PORT), (ref, REF)):
        state.apply(m.Movement(mv.pg, mv.slot, mv.src_osd, mv.dst_osd,
                               mv.size))


def legal_move(port, ref):
    """A move no Equilibrium plan would make: the emptiest device's first
    shard, in (pg, slot) order, to the first device that takes it."""
    order = np.argsort(port.utilization(), kind="stable")
    for i in order.tolist():
        osd = port.devices[i].id
        for pg, slot in sorted(port.shards_on[osd]):
            for d in port.devices:
                if port.move_is_legal(pg, slot, d.id):
                    for state, m in ((port, PORT), (ref, REF)):
                        state.apply(m.Movement(pg, slot, osd, d.id,
                                               state.shard_sizes[pg]))
                    return
    raise AssertionError("no legal move")


def _both(fn):
    def mutate(port, ref):
        fn(port, PORT)
        fn(ref, REF)
    return mutate


def _add(dev_id, cap, cls, host):
    return _both(lambda s, m: s.add_device(
        m.Device(id=dev_id, capacity=cap * TiB, device_class=cls,
                 host=host)))


def _create_pool(rule_of, pgs, seed, name="fresh", ec_k=0, tib=0.4):
    def fn(s, m):
        pid = 1 + max(s.pools)
        pool = m.Pool(pid, name, pgs, rule_of(m), ec_k=ec_k,
                      stored_bytes=tib * TiB)
        acting = {(pid, i): m.place(s.devices, pool, i, seed=seed)
                  for i in range(pgs)}
        sizes = {(pid, i): pool.nominal_shard_size for i in range(pgs)}
        s.add_pool(pool, acting, sizes)
    return _both(fn)


def _drain(s, m):
    """One out-delta, then a burst of re-placement moves: each of the
    device's shards, in (pg, slot) order, to the first legal device."""
    out = s.devices[2].id
    s.mark_out(out)
    for pg, slot in sorted(s.shards_on[out]):
        for dst in s.devices:
            if s.move_is_legal(pg, slot, dst.id):
                s.apply(m.Movement(pg, slot, out, dst.id, s.shard_sizes[pg]))
                break


def _mixed(s, m):
    s.grow_pool(1, 1.0 * TiB)
    s.add_device(m.Device(id=503, capacity=6 * TiB, device_class="hdd",
                          host="hy"))
    s.grow_pool(0, 0.5 * TiB)


def _out_and_in(s, m):
    s.mark_out(s.devices[1].id)
    s.mark_out(s.devices[1].id, out=False)


@dataclass(frozen=True)
class WeirdDelta(ClusterDelta):
    """A delta type the absorber does not know."""


def _unknown(port, ref):
    port.mutation_epoch += 1
    port._notify(WeirdDelta(port.mutation_epoch))


#: name -> (mutation, whether it absorbs); the rebuild cases are the
#: conservative fallback
MUTATIONS = {
    "growth": (_both(lambda s, m: s.grow_pool(0, 2.0 * TiB)), True),
    "device-add": (_add(500, 8, "hdd", "hx"), True),
    "trailing-class": (_add(501, 4, "zzz-new", "hz"), True),
    "renumbering-class": (_add(502, 4, "aaa-first", "ha"), False),
    "mixed-growth-and-adds": (_both(_mixed), True),
    "device-out": (_both(lambda s, m: s.mark_out(s.devices[1].id)), True),
    "foreign-movement": (foreign_move, True),
    "pool-create": (_create_pool(
        lambda m: m.Rule.replicated(2, "host", "hdd"), 8, 3), True),
    "device-back-in": (_both(_out_and_in), True),
    "drain-like-mix": (_both(_drain), True),
    "wider-rule-pool-create": (_create_pool(
        lambda m: m.Rule.erasure(3, 2, "host", "hdd"), 12, 9, "wide-ec",
        ec_k=3, tib=2.0), True),
    "unknown-delta": (_unknown, False),
}


def warm_vs_cold(mutate, *, chunk=5, first_budget=5,
                 cluster="small_test_cluster", states=None):
    """Plan ``first_budget`` moves warm (and the same with the reference's
    faithful planner), mutate both states, then hold the warm
    continuation to the port's cold plan of an exact copy and to the
    reference's faithful plan.  Returns (the planner, the warm result,
    its rebuilds, the absorb trace points, the deltas the port state
    emitted, what ``observe`` said of them)."""
    port, ref = states or (getattr(port_gen, cluster)(),
                           getattr(ref_gen, cluster)())
    planner = create_planner("equilibrium_batch", chunk=chunk, device="cpu")
    faithful = ref_create("equilibrium_faithful")
    first = planner.plan(port, budget=first_budget)
    assert tup(first.moves) == tup(faithful.plan(ref,
                                                 budget=first_budget).moves)
    seen: list = []
    port.subscribe(seen.append)
    mutate(port, ref)
    port.unsubscribe(seen.append)
    assert seen
    absorbs = planner.observe(seen[0])
    assert all(planner.observe(d) is absorbs for d in seen)
    cold = BatchPlanner(exact_copy(port), chunk=chunk, device="cpu").plan(
        record_trajectory=True)
    want = faithful.plan(ref, record_trajectory=True)
    before = dense_rebuild_count()
    with obs.tracing() as t:
        warm = planner.plan(port, record_trajectory=True)
    rebuilds = dense_rebuild_count() - before
    assert warm.stats["rebuilds"] == rebuilds
    assert tup(warm.moves) == tup(cold[0])
    assert trace(warm.moves, warm.records) == trace(want.moves, want.records)
    port.check_valid()
    return planner, warm, rebuilds, absorb_points(t.records), seen, absorbs


# ---------------------------------------------------------------------------
# warm continuation against the cold start and the reference


@pytest.mark.parametrize("chunk,first_budget", [(5, 5), (8, 3)],
                         ids=["no-stash", "stash"])
@pytest.mark.parametrize("name", list(MUTATIONS))
def test_warm_continuation_matches_cold_and_reference(name, chunk,
                                                      first_budget):
    """``observe`` says warm exactly for the absorbable deltas; they
    absorb with no rebuild, the rest rebuild once; the continuation is
    the cold start's and the reference's either way."""
    mutate, absorbable = MUTATIONS[name]
    _, warm, rebuilds, points, seen, absorbs = warm_vs_cold(
        mutate, chunk=chunk, first_budget=first_budget)
    assert absorbs is absorbable
    assert rebuilds == (0 if absorbable else 1)
    assert len(points) == (1 if absorbable else 0)
    if absorbable:
        assert points[0]["deltas"] == len(seen)
        assert warm.stats["absorbed_deltas"] == len(seen)


def test_renumbering_pool_id_falls_back_to_rebuild():
    """A pool id sorting before an existing one would renumber the
    carry's pool, PG and shard rows: one rebuild, the same moves."""
    def states():
        out = []
        for m in (PORT, REF):
            devs = (port_gen if m is PORT else ref_gen).small_test_cluster(
            ).devices
            rule = m.Rule.replicated(3, "host", "hdd")
            out.append(m.build(devs, [
                m.Pool(0, "a", 32, rule, stored_bytes=120 * TiB),
                m.Pool(5, "b", 16, rule, stored_bytes=60 * TiB)], seed=1))
        return tuple(out)

    def mutate(s, m):
        rule = m.Rule.replicated(3, "host", "hdd")
        pool = m.Pool(3, "mid", 8, rule, stored_bytes=5 * TiB)
        acting = {(3, i): m.place(s.devices, pool, i, seed=1)
                  for i in range(8)}
        s.add_pool(pool, acting,
                   {(3, i): pool.nominal_shard_size for i in range(8)})

    _, _, rebuilds, points, _, absorbs = warm_vs_cold(_both(mutate),
                                                      states=states())
    assert rebuilds == 1 and points == [] and absorbs is False


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_warm_budget_split_across_deltas_is_one_build(cluster):
    """Growth, an add and a drain between budget-split plans: one build
    for the whole lifecycle, every plan's moves the reference's."""
    port, ref = getattr(port_gen, cluster)(), getattr(ref_gen, cluster)()
    planner = create_planner("equilibrium_batch", chunk=4, device="cpu")
    faithful = ref_create("equilibrium_faithful")
    before = dense_rebuild_count()
    steps = [None, _both(lambda s, m: s.grow_pool(0, 1.5 * TiB)),
             _add(700, 6, "hdd", "hq"), legal_move, None]
    for mutate in steps:
        if mutate is not None:
            mutate(port, ref)
        for budget in (3, 7):
            got = planner.plan(port, budget=budget)
            assert tup(got.moves) == tup(faithful.plan(ref,
                                                       budget=budget).moves)
    rest = planner.plan(port)
    assert tup(rest.moves) == tup(faithful.plan(ref).moves)
    assert dense_rebuild_count() - before == 1


# ---------------------------------------------------------------------------
# the reference's warm-start checks, on the port


def test_warm_start_no_rebuild_and_bit_identical():
    want = ref_create("equilibrium_faithful").plan(
        ref_gen.small_test_cluster())
    planner = BatchPlanner(port_gen.small_test_cluster(), device="cpu")
    before = dense_rebuild_count()
    seq = []
    for budget in (3, 5, 10_000):
        seq += planner.plan(max_moves=budget)[0]
    assert tup(seq) == tup(want.moves)
    assert dense_rebuild_count() - before == 1


def test_warm_start_small_chunks_stash_across_budgets():
    want = ref_create("equilibrium_faithful").plan(
        ref_gen.small_test_cluster())
    planner = BatchPlanner(port_gen.small_test_cluster(), chunk=4,
                           device="cpu")
    before = dense_rebuild_count()
    seq = []
    while True:
        moves, _ = planner.plan(max_moves=3)
        if not moves:
            break
        seq += moves
    assert tup(seq) == tup(want.moves)
    assert dense_rebuild_count() - before == 1


def test_warm_start_converged_tick_is_noop():
    state = port_gen.small_test_cluster()
    planner = BatchPlanner(state, device="cpu")
    before = dense_rebuild_count()
    assert planner.plan()[0]
    assert planner.plan() == ([], [])
    assert dense_rebuild_count() - before == 1
    assert BatchPlanner(exact_copy(state), device="cpu").plan() == ([], [])


def test_warm_start_absorbs_growth_into_overshoot_stash():
    """Growth while a stash is held (budget 5 < chunk 64) absorbs: the
    stash, planned before the growth and never applied to the state, is
    dropped and the carry re-read from the state."""
    port, ref = port_gen.small_test_cluster(), ref_gen.small_test_cluster()
    planner = BatchPlanner(port, device="cpu")
    faithful = ref_create("equilibrium_faithful")
    assert tup(planner.plan(max_moves=5)[0]) == tup(
        faithful.plan(ref, budget=5).moves)
    assert planner._stash, "premise: budget < chunk leaves a stash"
    port.grow_pool(0, 2.0 * TiB)
    ref.grow_pool(0, 2.0 * TiB)
    cold = BatchPlanner(exact_copy(port), device="cpu").plan()[0]
    before = dense_rebuild_count()
    with obs.tracing() as t:
        warm = planner.plan()[0]
    assert tup(warm) == tup(cold) == tup(faithful.plan(ref).moves)
    assert dense_rebuild_count() - before == 0
    assert absorb_points(t.records)[0]["structural"] is True


def test_absorb_counters_per_delta_type():
    reg = obs.registry()
    before = reg.snapshot()
    state = port_gen.small_test_cluster()
    planner = create_planner("equilibrium_batch", device="cpu")
    planner.plan(state)
    state.grow_pool(0, 1.0 * TiB)
    assert planner.observe(PoolGrowthDelta(state.mutation_epoch, 0,
                                           1.0 * TiB))
    state.add_device(Device(id=900, capacity=8 * TiB, device_class="hdd",
                            host="hn"))
    planner.plan(state)                  # absorption happens in plan()
    d = reg.deltas_since(before)
    assert d.get("absorb.runs") == 1
    assert d.get("absorb.deltas{type=PoolGrowthDelta}") == 1
    assert d.get("absorb.deltas{type=DeviceAddDelta}") == 1
    assert d.get("batch.rebuilds") == 1


def test_dense_mirror_refuses_a_warm_start_after_absorption():
    """Absorption refreshes only the mirror fields the carry needs, so
    the mirror refuses to stand for the state."""
    state = port_gen.cluster_a()
    bp = BatchPlanner(state, device="cpu")
    bp.plan(max_moves=5)
    pid = sorted(state.pools)[0]
    state.grow_pool(pid, state.pools[pid].stored_bytes * 1.2)
    bp.plan(max_moves=5)
    assert bp._dense is not None and not bp._dense.mirror_complete
    with pytest.raises(RuntimeError, match="incomplete"):
        bp._dense.require_fresh(state)


# ---------------------------------------------------------------------------
# the absorbed carry against a fresh build


def _same_carry(absorbed, fresh, *, kept: bool) -> None:
    for part in ("dyn", "const", "scal"):
        a, b = getattr(absorbed, part), getattr(fresh, part)
        assert a.keys() == b.keys(), part
        for key in a:
            x, y = a[key], b[key]
            assert x.dtype == y.dtype, (part, key)
            if key == "rows_on":
                assert x.shape[0] == y.shape[0]
                assert x.shape[1] >= y.shape[1]
                for i, n in enumerate(fresh.dyn["nrows"].tolist()):
                    assert torch.equal(x[i, :n], y[i, :n]), i
                    assert bool((x[i, n:] == -1).all())
            elif key == "pruned" and kept:
                continue
            else:
                assert x.shape == y.shape, (part, key)
                assert torch.equal(x, y), (part, key)
    assert absorbed.k == fresh.k
    assert torch.equal(absorbed.cap_lim, fresh.cap_lim)


@pytest.mark.parametrize("first_budget", [5, 3], ids=["synced", "stash"])
@pytest.mark.parametrize("name", [n for n, (_, a) in MUTATIONS.items() if a])
def test_absorbed_carry_equals_a_fresh_build(name, first_budget):
    """After each absorbable delta the new carry's tensors equal those
    of a build from the same state, bit for bit (``scal["n_f"]``, the
    variance divisor, among them)."""
    mutate, _ = MUTATIONS[name]
    port, ref = port_gen.small_test_cluster(), ref_gen.small_test_cluster()
    planner = BatchPlanner(port, chunk=5, device="cpu")
    planner.plan(max_moves=first_budget)
    mutate(port, ref)
    before = dense_rebuild_count()
    with obs.tracing() as t:
        planner.sync()
    assert dense_rebuild_count() == before
    (point,) = absorb_points(t.records)
    fresh = BatchPlanner(port, chunk=5, device="cpu")
    fresh.sync()
    _same_carry(planner._step, fresh._step, kept=point["kept_bounds"])
    assert float(planner._step.scal["n_f"]) == port.n_devices
    if not point["kept_bounds"]:
        assert not bool(planner._step.dyn["pruned"].any())


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_certificates_survive_a_foreign_move(cluster):
    """Certificates held at convergence survive a foreign move in part
    (the endpoints, the PG's holders and the devices a trigger fires on
    lose theirs), and the continuation is still the cold start's and the
    reference's."""
    port, ref = getattr(port_gen, cluster)(), getattr(ref_gen, cluster)()
    planner = create_planner("equilibrium_batch", device="cpu")
    faithful = ref_create("equilibrium_faithful")
    assert tup(planner.plan(port).moves) == tup(faithful.plan(ref).moves)
    held = planner._impl._pruned
    assert held > 0, "premise: certificates at convergence"
    legal_move(port, ref)
    cold = BatchPlanner(exact_copy(port), device="cpu").plan()[0]
    with obs.tracing() as t:
        warm = planner.plan(port)
    (point,) = absorb_points(t.records)
    assert point["kept_bounds"] and point["certificates_held"] == held
    assert 0 < point["certificates_kept"] < held
    assert warm.stats["rebuilds"] == 0
    assert tup(warm.moves) == tup(cold) == tup(faithful.plan(ref).moves)


def test_non_structural_absorb_fetches_once():
    """Growth with no stash: one fetch of the row table, then the
    chunks (host syncs = chunks + re-pads + 1)."""
    state = port_gen.small_test_cluster()
    planner = create_planner("equilibrium_batch", chunk=5, device="cpu")
    planner.plan(state, budget=5)
    state.grow_pool(0, 2.0 * TiB)
    reg = obs.registry()
    snap = reg.snapshot()
    with obs.tracing() as t:
        res = planner.plan(state)
    d = reg.deltas_since(snap)
    (point,) = absorb_points(t.records)
    assert point["structural"] is False
    assert res.stats["host_syncs"] == (d.get("batch.chunks", 0)
                                       + d.get("batch.repads", 0) + 1)


# ---------------------------------------------------------------------------
# the delta stream's edges


def _warm_planner():
    state = port_gen.small_test_cluster()
    planner = BatchPlanner(state, chunk=5, device="cpu")
    planner.plan(max_moves=5)
    return state, planner


def test_unstamped_delta_rebuilds_once():
    state, planner = _warm_planner()
    state.grow_pool(0, 1.0 * TiB)
    assert planner.observe(PoolGrowthDelta(-1, 0, 1.0 * TiB)) is False
    before = dense_rebuild_count()
    planner.plan()
    assert dense_rebuild_count() - before == 1
    assert not planner._invalid and planner._pending == {}


def test_conflicting_delta_rebuilds_once():
    state, planner = _warm_planner()
    state.grow_pool(0, 1.0 * TiB)
    epoch = state.mutation_epoch
    assert planner.observe(PoolGrowthDelta(epoch, 0, 1.0 * TiB)) is True
    assert planner.observe(PoolGrowthDelta(epoch, 0, 2.0 * TiB)) is False
    assert planner._invalid
    before = dense_rebuild_count()
    planner.plan()
    assert dense_rebuild_count() - before == 1


def test_duplicate_delta_is_deduplicated():
    state, planner = _warm_planner()
    state.grow_pool(0, 1.0 * TiB)
    delta = PoolGrowthDelta(state.mutation_epoch, 0, 1.0 * TiB)
    for _ in range(3):
        assert planner.observe(delta) is True
    assert len(planner._pending) == 1 and not planner._invalid
    before = dense_rebuild_count()
    planner.plan()
    assert dense_rebuild_count() == before


def test_pending_cap_overflow_rebuilds_once(monkeypatch):
    state, planner = _warm_planner()
    monkeypatch.setattr(BatchPlanner, "PENDING_CAP", 3)
    for _ in range(4):
        state.grow_pool(0, 0.25 * TiB)
    assert planner._invalid and planner._pending_run() is None
    cold = BatchPlanner(exact_copy(state), chunk=5, device="cpu").plan()[0]
    before = dense_rebuild_count()
    assert tup(planner.plan()[0]) == tup(cold)
    assert dense_rebuild_count() - before == 1
    # the rebuild clears the stream: the next delta absorbs again
    state.grow_pool(0, 0.25 * TiB)
    before = dense_rebuild_count()
    planner.plan()
    assert dense_rebuild_count() == before


def test_missed_epoch_rebuilds_once():
    state, planner = _warm_planner()
    state.grow_pool(0, 1.0 * TiB)
    planner._pending.clear()             # a delta that never arrived
    assert planner.observe(PoolGrowthDelta(state.mutation_epoch + 5, 0,
                                           1.0)) is False
    before = dense_rebuild_count()
    planner.plan()
    assert dense_rebuild_count() - before == 1


def test_collected_planner_leaves_no_live_subscription():
    state = port_gen.small_test_cluster()
    planner = BatchPlanner(state, device="cpu")
    planner.plan(max_moves=3)
    assert len(state._subscribers) == 1
    del planner
    gc.collect()
    state.grow_pool(0, 1.0 * TiB)        # the dead callback prunes itself
    assert state._subscribers == []


# ---------------------------------------------------------------------------
# property: seeded interleavings of deltas and budgets


_OPS = st.one_of(
    st.tuples(st.just("plan"), st.integers(1, 12)),
    st.tuples(st.just("grow"), st.integers(0, 1), st.floats(0.1, 3.0)),
    st.tuples(st.just("add"), st.sampled_from([3.0, 8.0]),
              st.booleans()),
    st.tuples(st.just("out"), st.integers(0, 13)),
    st.tuples(st.just("move")),
    st.tuples(st.just("pool"), st.integers(0, 5)),
)


def _apply_op(op, port, ref, serial):
    kind = op[0]
    if kind == "grow":
        pid = sorted(port.pools)[op[1]]
        for s in (port, ref):
            s.grow_pool(pid, op[2] * TiB)
    elif kind == "add":
        cls = "zzz-new" if op[2] else port.devices[0].device_class
        _add(2000 + serial, op[1], cls, f"hp{serial}")(port, ref)
    elif kind == "out":
        osd = port.devices[op[1]].id
        out = osd not in port.out_osds
        for s in (port, ref):
            s.mark_out(osd, out)
    elif kind == "move":
        legal_move(port, ref)
    elif kind == "pool":
        cls = port.devices[0].device_class
        _create_pool(lambda m: m.Rule.replicated(2, "host", cls), 6,
                     op[1])(port, ref)


@settings(max_examples=20, deadline=None, database=None)
@given(cluster=st.sampled_from(["small_test_cluster", "cluster_a"]),
       chunk=st.sampled_from([4, 16]),
       ops=st.lists(_OPS, min_size=1, max_size=4))
def test_interleaved_deltas_and_budgets_stay_faithful(cluster, chunk, ops):
    port, ref = getattr(port_gen, cluster)(), getattr(ref_gen, cluster)()
    planner = create_planner("equilibrium_batch", chunk=chunk, device="cpu")
    faithful = ref_create("equilibrium_faithful")
    first = planner.plan(port, budget=4)
    assert tup(first.moves) == tup(faithful.plan(ref, budget=4).moves)
    rebuilds = first.stats["rebuilds"]
    for serial, op in enumerate(ops):
        if op[0] == "plan":
            got = planner.plan(port, budget=op[1])
            rebuilds += got.stats["rebuilds"]
            assert tup(got.moves) == tup(faithful.plan(ref,
                                                       budget=op[1]).moves)
        else:
            _apply_op(op, port, ref, serial)
    cold = BatchPlanner(exact_copy(port), chunk=chunk, device="cpu").plan(
        max_moves=16)
    rest = planner.plan(port, budget=16)
    assert tup(rest.moves) == tup(cold[0]) == tup(
        faithful.plan(ref, budget=16).moves)
    assert rebuilds + rest.stats["rebuilds"] == 1
    port.check_valid()
