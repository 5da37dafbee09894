"""The port's fleet planner (``repro_torch.fleet``, ``device="cpu"``: the
step the card runs, with K1's lane form in its plain version).

A fleet tick over N clusters must give, per cluster, exactly the move
stream and convergence-tail stats of N serial ``BatchPlanner`` runs
configured like a fleet lane (source_block 1, no legality cache, source
bounds on, the same chunk and row_block): under streaming growth, device
out / in and foreign-movement deltas, across shape buckets, under a
mid-stream SLO cut (which may only re-chunk the stream), with a lane
moved to a wider bucket (which must leave every other lane bitwise as it
was), and through the service and the load generator.  Each of the
reference's ``tests/test_fleet.py`` functions has its counterpart here.

The JAX package's own ``FleetPlanner`` is the second arbiter: it runs in
a subprocess (``tests/_ref_fleet.py``, under the bindings it needs), and
each case's moves, certificate counters and ``fleet.*`` / ``batch.*``
registry deltas must equal the port's.  ``host_syncs`` is not compared:
the reference fetches the pruned count apart from the round, which the
port packs into the round's one fetch."""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _ref_fleet
from _hypothesis_compat import given, settings, strategies as st
from repro_torch import obs
from repro_torch.core import GiB, Movement
from repro_torch.core import cluster as port_cluster
from repro_torch.core import clustergen
from repro_torch.core.cluster import PoolGrowthDelta
from repro_torch.core.clustergen import sim_cluster
from repro_torch.core.equilibrium_batch import dense_rebuild_count
from repro_torch.core.planner import create_planner
from repro_torch.fleet import (BucketShape, CarryDims, FleetLoadGen,
                               FleetPlanner, FleetService)
from repro_torch.kernels.ref import lane_view, select_rows_lanes_ref, \
    select_rows_ref

REPO = pathlib.Path(__file__).resolve().parent.parent
CH, RB = 8, 8          # small chunk/row-block: padding boundaries get hit
TiB = 1024 * GiB
STAT_KEYS = _ref_fleet.STAT_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_tuples(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves]


def _twin_pair(n_hdd: int, seed: int):
    """Two independently built, identical cluster states."""
    def mk():
        return sim_cluster(seed=seed, n_hdd=n_hdd, n_ssd=0, fill=0.6)
    return mk(), mk()


def _fleet(**kw) -> FleetPlanner:
    return FleetPlanner(chunk=CH, row_block=RB, device="cpu", **kw)


def _serial_planner():
    """The serial comparator, configured exactly like a fleet lane."""
    return create_planner("equilibrium_batch", chunk=CH, row_block=RB,
                          source_block=1, legality_cache=False,
                          source_bounds=True, device="cpu")


def _mutate(t: int, key_idx: int, state) -> None:
    _ref_fleet.mutate(t, key_idx, state, Movement)


def _run_fleet_vs_serial(specs, ticks, budget, *, deltas=True,
                         slo_cut_tick=None, drain=8):
    """Drive twin fleets, one FleetPlanner against N serial BatchPlanners
    on identically built states, and hold each cluster's move stream
    equal (per tick when no SLO cut is in play; as concatenated streams
    otherwise, since a cut only re-chunks the sequence)."""
    fp = _fleet()
    fleet_states, serial_states, serial = {}, {}, {}
    for j, (n_hdd, seed) in enumerate(specs):
        key = f"c{j}"
        fleet_states[key], serial_states[key] = _twin_pair(n_hdd, seed)
        fp.add_cluster(key, fleet_states[key])
        serial[key] = _serial_planner()
    keys = list(fleet_states)
    stream_f = {k: [] for k in keys}
    stream_s = {k: [] for k in keys}

    def one_round(budgets, slo):
        res_s = {k: serial[k].plan(serial_states[k], budget=budgets[k])
                 for k in keys}
        res_f = fp.plan_fleet(budgets, slo_seconds=slo)
        for k in keys:
            stream_f[k] += as_tuples(res_f[k].moves)
            stream_s[k] += as_tuples(res_s[k].moves)
        return res_f, res_s

    for t in range(ticks):
        if deltas:
            for j, k in enumerate(keys):
                _mutate(t, j, fleet_states[k])
                _mutate(t, j, serial_states[k])
        cut = slo_cut_tick is not None and t == slo_cut_tick
        res_f, res_s = one_round({k: budget for k in keys},
                                 0.0 if cut else None)
        if slo_cut_tick is None:
            for k in keys:
                assert as_tuples(res_f[k].moves) == as_tuples(res_s[k].moves)
                for sk in STAT_KEYS:
                    assert res_f[k].stats[sk] == res_s[k].stats[sk], (k, sk)
    for _ in range(drain):          # run both sides to convergence
        one_round({k: budget for k in keys}, None)
    for k in keys:
        assert stream_f[k] == stream_s[k], k
        assert fleet_states[k].utilization_variance() \
            == serial_states[k].utilization_variance()
        fleet_states[k].check_valid()
    return fp, fleet_states


# ---------------------------------------------------------------------------
# the fleet equals N serial planners, bit for bit


def test_fleet_of_one_matches_serial():
    _run_fleet_vs_serial([(9, 0)], ticks=2, budget=CH, deltas=False)


def test_fleet_three_heterogeneous_under_delta_stream():
    """Three clusters of two sizes (one shape bucket) under interleaved
    growth / device-out / foreign-movement deltas."""
    _run_fleet_vs_serial([(9, 0), (12, 1), (9, 2)], ticks=3, budget=CH)


def test_fleet_multi_bucket():
    """Clusters in different shape buckets plan in one tick (one step a
    bucket)."""
    _run_fleet_vs_serial([(9, 3), (18, 4)], ticks=2, budget=CH,
                         deltas=False)


def test_fleet_rounds_coscheduled():
    """A round issues every bucket before its one host sync: with two
    buckets the overlapped-round counter ticks, and the blocking fetches
    stay one a round."""
    reg = obs.registry()
    snap = reg.snapshot()
    _run_fleet_vs_serial([(9, 3), (18, 4)], ticks=2, budget=CH,
                         deltas=False)
    d = reg.deltas_since(snap)
    rounds = int(d.get("fleet.rounds", 0))
    assert rounds >= 1
    assert int(d.get("fleet.round_syncs", 0)) == rounds
    assert int(d.get("fleet.rounds.overlapped", 0)) >= 1


def test_fleet_slo_cutoff_stream_identical():
    """An SLO cut mid-stream (deadline 0 on tick 1) may shrink that tick's
    plans, but the concatenated streams stay the serial ones."""
    _run_fleet_vs_serial([(9, 0), (12, 1), (9, 2)], ticks=3, budget=CH,
                         slo_cut_tick=1, drain=12)


@pytest.mark.parametrize("seed_base,sizes,cut", [
    (0, [9, 12, 9], 1),
    (7, [12, 9, 9, 12], 0),
])
def test_fleet_matches_serial_cases(seed_base, sizes, cut):
    specs = [(n, seed_base + i) for i, n in enumerate(sizes)]
    _run_fleet_vs_serial(specs, ticks=3, budget=CH,
                         slo_cut_tick=1 if cut else None, drain=12)


@settings(max_examples=3, deadline=None)
@given(st.integers(min_value=0, max_value=10_000),
       st.lists(st.sampled_from([9, 12]), min_size=3, max_size=4),
       st.integers(min_value=0, max_value=1))
def test_fleet_matches_serial_property(seed_base, sizes, cut):
    """N >= 3 random small clusters, random sizes and seeds, delta
    streams, optionally a mid-stream SLO cut."""
    specs = [(n, seed_base + i) for i, n in enumerate(sizes)]
    _run_fleet_vs_serial(specs, ticks=3, budget=CH,
                         slo_cut_tick=1 if cut else None, drain=12)


def test_fleet_empty_device_sorts_before_padding():
    """A real device with no shards (utilization 0.0, as the pad devices)
    sorts before the padding by index, takes moves as the serial planner
    gives them, and the lane's crop holds exactly the real devices."""
    fp, serial = _fleet(), _serial_planner()
    a = _ref_fleet.build(clustergen, port_cluster, 9, 5, 1)
    b = _ref_fleet.build(clustergen, port_cluster, 9, 5, 1)
    bp = fp.add_cluster("e", a)
    empty = a.idx(a.devices[-1].id)
    got, want = [], []
    for _ in range(12):
        r = fp.plan_fleet({"e": CH})["e"]
        s = serial.plan(b, budget=CH)
        got += as_tuples(r.moves)
        want += as_tuples(s.moves)
        assert {k: r.stats[k] for k in STAT_KEYS} \
            == {k: s.stats[k] for k in STAT_KEYS}
    assert got == want and any(m[3] == a.devices[empty].id for m in got)
    shape, lane = fp._pack.where["e"]
    assert shape.n_dev == 16 and a.n_devices == 10
    fp.remove_cluster("e")      # crops the lane back into its planner
    order = bp._step.dyn["order"]
    assert sorted(order.tolist()) == list(range(10))


def test_certificates_survive_the_crop_into_a_foreign_movement():
    """A converged lane holds certificates; a foreign movement is absorbed
    with the certificates the serial planner keeps (its ``_pruned_mask``
    after the last fetch, which the crop must leave), and the next plans
    and their counters stay the serial ones."""
    fp, serial = _fleet(), _serial_planner()
    a, b = _twin_pair(9, 0)
    bp = fp.add_cluster("c", a)
    for _ in range(12):
        r = fp.plan_fleet({"c": CH})["c"]
        serial.plan(b, budget=CH)
    assert r.stats["converged"] and r.stats["pruned_sources"] > 0
    assert bp._pruned_mask.sum() == r.stats["pruned_sources"]
    np.testing.assert_array_equal(bp._pruned_mask,
                                  serial._impl._pruned_mask)
    _mutate(2, 0, a)           # kind 2: a foreign movement
    _mutate(2, 0, b)
    r = fp.plan_fleet({"c": CH})["c"]
    s = serial.plan(b, budget=CH)
    assert as_tuples(r.moves) == as_tuples(s.moves)
    assert {k: r.stats[k] for k in STAT_KEYS} \
        == {k: s.stats[k] for k in STAT_KEYS}
    assert r.stats["pruned_sources"] > 0


# ---------------------------------------------------------------------------
# the JAX package's FleetPlanner, in a subprocess


@pytest.fixture(scope="module")
def reference_fleet():
    """Every case of ``_ref_fleet.CASES`` through the reference's fleet,
    in one process of its own (the binding on ``jax.experimental`` it
    needs outlives a test)."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_ref_fleet.py"),
         *_ref_fleet.CASES], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("case", list(_ref_fleet.CASES))
def test_fleet_matches_reference_fleet(reference_fleet, case):
    """Moves and certificate counters of every tick, the states'
    variances, and the ``fleet.*`` / ``batch.*`` counters (rounds,
    chunks, re-buckets, overlapped rounds, ticks, planned moves, tiles
    walked and candidate tiles) equal the reference fleet's.  Every case
    pads devices in each lane; ``rebucket`` moves a lane to a wider
    bucket mid-tick, ``empty_device`` has a real device at utilization
    0.0."""
    got = json.loads(json.dumps(_ref_fleet.drive(
        case, clustergen, port_cluster, obs,
        functools.partial(FleetPlanner, device="cpu"))))
    want = reference_fleet[case]
    assert got["plans"] == want["plans"]
    assert got["counters"] == want["counters"]
    assert got["variance"] == want["variance"]
    assert got["counters"]["fleet.planned_moves"] > 0
    if case == "rebucket":
        assert got["counters"]["fleet.rebuckets"] >= 1
    if case in ("multi_bucket", "rebucket"):
        assert got["counters"]["fleet.rounds.overlapped"] >= 1


# ---------------------------------------------------------------------------
# SLO-bounded plans are valid partial plans


def test_slo_partial_plan_is_legal():
    """A deadline-0 tick returns partial plans whose every move is legal
    when replayed, in order, on an untouched twin state."""
    fp = _fleet(slo_seconds=0.0)
    a, b = _twin_pair(9, 5)
    fp.add_cluster("c", a)
    res = fp.plan_fleet({"c": 64})
    assert res["c"].stats["slo_expired"]
    # progress guarantee: the first dispatch of a tick always runs
    assert len(res["c"].moves) > 0
    for mv in res["c"].moves:
        assert b.move_is_legal(mv.pg, mv.slot, mv.dst_osd)
        b.apply(mv)
    b.check_valid()
    total = len(res["c"].moves)
    for _ in range(10):
        more = fp.plan_fleet({"c": 64}, slo_seconds=None)
        total += len(more["c"].moves)
        if more["c"].stats["converged"]:
            break
    assert more["c"].stats["converged"]
    assert total >= 64 or more["c"].stats["converged"]


# ---------------------------------------------------------------------------
# a lane moved to a wider bucket leaves the others bitwise untouched


def _fetch_all(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


def test_rebucket_leaves_other_lanes_bitwise_untouched():
    """Moving one lane to the next row bucket leaves every other lane,
    its certificates (``pruned``) included, bitwise as it was; the moved
    lane is the serial re-pad: the row axis padded with -1, everything
    else carried over."""
    fp = _fleet()
    states = {}
    for j, seed in enumerate([0, 1, 2]):
        states[f"c{j}"], _ = _twin_pair(9, seed)
        fp.add_cluster(f"c{j}", states[f"c{j}"])
    for _ in range(6):                       # until certificates are held
        fp.plan_fleet({k: CH for k in states})
    pack = fp._pack
    shape0, lane0 = pack.where["c0"]
    bucket = pack.buckets[shape0]
    others = {k: i for k, (s, i) in pack.where.items()
              if k != "c0" and s == shape0}
    assert others, "test expects a shared bucket"
    before = {k: _fetch_all(bucket.slice_dyn(i)) for k, i in others.items()}
    assert any(bool(d["pruned"].any()) for d in before.values())
    old_lane0 = _fetch_all(bucket.slice_dyn(lane0))
    assert not torch.equal(old_lane0["used"],
                           before[next(iter(others))]["used"])

    new_shape, new_lane = pack.rebucket("c0")
    assert new_shape.r_cap == shape0.next_r_cap().r_cap

    for k, i in others.items():
        assert pack.where[k] == (shape0, i)
        after = pack.buckets[shape0].slice_dyn(i)
        for name, t in before[k].items():
            assert t.dtype == after[name].dtype
            assert torch.equal(t, after[name]), (k, name)
    moved = pack.buckets[new_shape].slice_dyn(new_lane)
    rows_b, rows_a = old_lane0["rows_on"], moved["rows_on"]
    assert torch.equal(rows_a[:, :rows_b.shape[1]], rows_b)
    assert bool((rows_a[:, rows_b.shape[1]:] == -1).all())
    for name, t in old_lane0.items():
        if name != "rows_on":
            assert torch.equal(moved[name], t), name


def test_bucket_shape_geometry():
    dims = CarryDims(n_dev=9, r_cap=48, n_sh=672, n_pg=224, n_slots=3,
                     n_pools=3, n_levels=2, k=9)
    shape = BucketShape.for_dims(dims, rb=8)
    assert shape.n_dev == 16 and shape.fits(dims)
    assert shape.r_cap >= 48 and shape.r_cap % 8 == 0
    assert shape.next_r_cap().r_cap == 2 * shape.r_cap
    bigger = CarryDims(n_dev=12, r_cap=shape.r_cap * 2, n_sh=672, n_pg=224,
                       n_slots=3, n_pools=3, n_levels=2, k=12)
    grown = shape.grown_to(bigger, rb=8)
    assert grown.fits(dims) and grown.fits(bigger)
    assert grown.r_cap == shape.r_cap * 2     # escalations are sticky


# ---------------------------------------------------------------------------
# K1's lane form


def test_lane_form_of_k1_equals_each_lanes_own_selection():
    """The lane form of K1's plain version on a bucket of three distinct
    lanes (one with padded devices, one whose ``k_eff`` is below the
    bucket's k) equals ``select_rows_ref`` on each lane's natural carry,
    bitwise: no lane reads another's data, and the padding reaches no
    output of a real position."""
    fp = _fleet()
    specs = [(9, 0), (12, 1), (16, 2)]
    states = {}
    for j, (n, seed) in enumerate(specs):
        states[f"c{j}"], _ = _twin_pair(n, seed)
        fp.add_cluster(f"c{j}", states[f"c{j}"])
    fp.plan_fleet({k: CH for k in states})
    bucket = next(iter(fp._pack.buckets.values()))
    assert len(bucket) == 3 and bucket.shape.n_dev == 16
    step = fp._step_of(bucket)
    order_k, src_order, n_avail = step.sources()
    got = select_rows_lanes_ref(src_order, n_avail, step.cap_lim, step.dyn,
                                step.const, step.scal, cand_row=True)
    k_effs = bucket.scal["k_eff"].tolist()
    assert min(k_effs) < bucket.shape.k == 16 and k_effs.count(16) == 1
    for key, i in bucket.lanes().items():
        bp = fp._clusters[key]
        fp._pack.crop_lane(key, bp)         # the lane's natural carry
        natural = bp._step
        n, k = natural.dyn["used"].shape[0], natural.k
        assert n < 16 or k == 16
        # the lane's own step: its k sources, its rows
        src, avail = src_order[i, :k], n_avail[i]
        want = select_rows_ref(src, avail, natural.cap_lim, natural.dyn,
                               natural.const, natural.scal, cand_row=True)
        R = natural.r_cap
        any_g, dst_g, cand_g, row_g = (t[i] for t in got)
        assert torch.equal(any_g.view(-1, R)[:k], want[0].view(k, R))
        assert torch.equal(dst_g.view(-1, R)[:k], want[1].view(k, R))
        assert torch.equal(cand_g[:k], want[2])
        assert torch.equal(row_g[:k], want[3])
        # positions past k_eff are parked: no legal row
        assert not bool(any_g.view(-1, R)[k:].any())
        # and lane i of the bucket is its own view, not another lane's
        one = select_rows_ref(src_order[i], n_avail[i], step.cap_lim[i],
                              lane_view(step.dyn, i),
                              lane_view(step.const, i),
                              lane_view(step.scal, i), cand_row=True)
        assert all(torch.equal(g[i], w) for g, w in zip(got, one))


# ---------------------------------------------------------------------------
# service and registry surface


def test_fleet_planner_is_registered():
    p = create_planner("fleet", chunk=CH, row_block=RB, device="cpu")
    assert isinstance(p, FleetPlanner)
    a, b = _twin_pair(9, 6)
    res = p.plan(a, budget=CH)               # protocol single-cluster path
    ref = _serial_planner().plan(b, budget=CH)
    assert as_tuples(res.moves) == as_tuples(ref.moves)
    assert res.stats["fleet_clusters"] == 1
    assert res.stats["jit_recompiles"] == 0


def test_fleet_planner_default_device_is_the_card():
    """``device=None`` is the CUDA card: without one the planner raises
    rather than carry on on the CPU."""
    if torch.cuda.is_available():
        assert FleetPlanner().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetPlanner()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_planner("fleet")


def test_fleet_service_tick_and_ingest():
    svc = FleetService(chunk=CH, row_block=RB, device="cpu")
    a, b = _twin_pair(9, 7)
    a2, b2 = _twin_pair(12, 8)
    svc.attach("x", a)
    svc.attach("y", a2)
    tick = svc.tick({"x": CH, "y": CH})
    assert set(tick.results) == {"x", "y"}
    assert tick.total_moves == sum(len(r.moves)
                                   for r in tick.results.values())
    assert len(tick) == 2 and tick.wall_seconds > 0
    sx, sy = _serial_planner(), _serial_planner()
    sx.plan(b, budget=CH)
    sy.plan(b2, budget=CH)
    for st_ in (a, b):
        st_.grow_pool(0, 512 * GiB)
    tick2 = svc.tick({"x": CH, "y": CH})
    assert as_tuples(tick2.results["x"].moves) == \
        as_tuples(sx.plan(b, budget=CH).moves)
    assert as_tuples(tick2.results["y"].moves) == \
        as_tuples(sy.plan(b2, budget=CH).moves)
    svc.detach("y")
    assert set(svc.tick({"x": CH}).results) == {"x"}


def test_fleet_service_detach_midstream_and_reattach():
    """attach, a delta stream and ticks (absorb-only: one rebuild, at the
    first pack), detach mid-stream while deltas still arrive, re-attach:
    exactly one rebuild for the new pack, and every plan equal to a
    serial twin fed the same mutations."""
    svc = FleetService(chunk=CH, row_block=RB, device="cpu")
    a, b = _twin_pair(9, 31)
    serial = _serial_planner()

    before = dense_rebuild_count()
    svc.attach("lane", a)
    svc.tick({"lane": CH})
    serial.plan(b, budget=CH)
    assert dense_rebuild_count() - before >= 1

    after_pack = dense_rebuild_count()
    for t in range(2):
        _mutate(t, 0, a)
        _mutate(t, 0, b)
        tick = svc.tick({"lane": CH})
        assert as_tuples(tick.results["lane"].moves) == \
            as_tuples(serial.plan(b, budget=CH).moves)
    assert dense_rebuild_count() == after_pack

    svc.detach("lane")
    assert set(svc.tick({}).results) == set()
    _mutate(2, 0, a)
    _mutate(2, 0, b)

    before_reattach = dense_rebuild_count()
    svc.attach("lane", a)
    tick = svc.tick({"lane": CH})
    assert dense_rebuild_count() - before_reattach == 1
    fresh = _serial_planner()
    b2 = b.copy()
    assert as_tuples(tick.results["lane"].moves) == \
        as_tuples(fresh.plan(b2, budget=CH).moves)

    steady = dense_rebuild_count()
    _mutate(3, 0, a)
    _mutate(3, 0, b2)
    tick = svc.tick({"lane": CH})
    assert as_tuples(tick.results["lane"].moves) == \
        as_tuples(fresh.plan(b2, budget=CH).moves)
    assert dense_rebuild_count() == steady


def test_fleet_service_ingest_routes_out_of_band_deltas():
    """``ingest`` hands a lane a delta that did not come through the
    attached state's own subscription: an absorbable one returns True and
    the next tick reflects it."""
    svc = FleetService(chunk=CH, row_block=RB, device="cpu")
    a, b = _twin_pair(9, 33)
    svc.attach("m", a)
    svc.tick({"m": CH})
    serial = _serial_planner()
    serial.plan(b, budget=CH)
    a.grow_pool(0, 256 * GiB)
    b.grow_pool(0, 256 * GiB)
    delta = PoolGrowthDelta(a.mutation_epoch, 0, 256 * GiB)
    assert svc.ingest("m", delta) is True      # deduped by epoch, absorbs
    tick = svc.tick({"m": CH})
    assert as_tuples(tick.results["m"].moves) == \
        as_tuples(serial.plan(b, budget=CH).moves)


def test_fleet_pack_lane_reuse():
    """Freed lanes are reused in place; ``ensure`` is a no-op while a
    cluster's carry is unchanged."""
    fp = _fleet()
    for j in range(3):
        s, _ = _twin_pair(9, 20 + j)
        fp.add_cluster(f"c{j}", s)
    fp.plan_fleet({f"c{j}": CH for j in range(3)})
    shape, lane1 = fp._pack.where["c1"]
    assert fp._pack.ensure("c0", fp._clusters["c0"]) is False
    fp.remove_cluster("c1")
    assert "c1" not in fp._pack.where
    s, _ = _twin_pair(9, 99)
    fp.add_cluster("c9", s)
    fp.plan_fleet({"c9": CH})
    assert fp._pack.where["c9"] == (shape, lane1)    # freed slot reused


def test_fleet_loadgen_absorb_only_rebuilds_once():
    """steady-growth emits only absorbable deltas: each cluster's whole
    lifecycle costs exactly one dense rebuild (the initial pack)."""
    lg = FleetLoadGen(["steady-growth", "steady-growth"], seeds=[0, 1],
                      quick=True, device="cpu")
    metrics = lg.run()
    assert set(metrics) == {"steady-growth-0", "steady-growth-1"}
    summary = lg.summary()
    assert summary["clusters"] == 2
    assert summary["fleet_ticks"] > 0
    for key, acc in summary["per_cluster"].items():
        assert acc["rebuilds"] == 1, key
        assert acc["plans"] > 0 and acc["moves"] >= 0
    assert summary["slo_hit_rate"] == 1.0    # no SLO configured
