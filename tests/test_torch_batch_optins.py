"""The batch engine's opt-ins — the legality cache, device telemetry and
pipelined dispatch — held to the JAX package's own batch engine.

``repro.core.equilibrium_batch.BatchPlanner`` runs here on JAX's CPU
backend with three of its module attributes bound (the ``reference``
fixture, through ``monkeypatch``, so every other test of the worker sees
the module as it was; ``tests/_ref_batch_counters.py`` says why).  Both
engines plan the same seed-built clusters, mutated in lockstep between
calls, each under its own package's tracer, and every plan call must
give the same moves, ``sources_tried`` histogram, ``bound_hits``,
``pruned_sources`` and registry deltas of the tiles walked, the tiles
holding a candidate, the cache's hits, misses and repairs, the pipelined
chunks, re-pads, stash moves and rebuilds.  The port runs with
``device="cpu"``: K1's plain version, with the cache it reads and
writes.  The literal rows come from the reference engine's runs.

Then: K1's plain version with a cache in each state against the
uncached call, telemetry that cannot move a plan, and the fuzzer's
oracles over the batch lane with the cache on."""

import importlib.util
import json
import pathlib

import pytest
import torch

import repro.core.equilibrium_batch as ref_batch
from _ref_batch_counters import (CLUSTER_B_CONFIG, COUNTERS, FIXTURE,
                                 counted_plan, record, reference_attrs)
from _lockstep import ROW, WARM, grow, lockstep, quiet_move, totals
from _select_rows_carries import (CARRIES, cache_states, carry, carry_id,
                                  cluster_state, engine_cache)
from repro import obs as ref_obs
from repro.core import Movement as RefMovement
from repro.core import clustergen as ref_gen
from repro.core.equilibrium import EquilibriumConfig as RefConfig
from repro_torch import obs
from repro_torch.core import Movement
from repro_torch.core import clustergen as port_gen
from repro_torch.core.equilibrium import EquilibriumConfig
from repro_torch.core.equilibrium_batch import BatchPlanner
from repro_torch.core.planner import create_planner
from repro_torch.fuzz import OracleFailure
from repro_torch.fuzz.harness import run_lane, run_lifecycle
from repro_torch.kernels.ref import select_rows_masks, select_rows_ref
from repro_torch.sim import generate_timeline

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference(monkeypatch):
    """The JAX package's batch engine, runnable for one test."""
    for mod, name, value in reference_attrs():
        monkeypatch.setattr(mod, name, value, raising=False)
    return ref_batch


# ---------------------------------------------------------------------------
# lockstep: the port against the reference, plan call by plan call


@pytest.mark.parametrize("bounds", [True, False], ids=["bounds", "nobounds"])
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "nopipe"])
@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_option_matrix_matches_reference(reference, cluster, cache,
                                         pipeline, bounds):
    """Cache x pipeline x source bounds at chunk 8, row_block 8: a plan to
    convergence, equal to the reference in moves and every counter; the
    pipelined runs overlap every chunk but the last, the others none."""
    rec, = lockstep(cluster, [None], chunk=8, row_block=8,
                    legality_cache=cache, pipeline=pipeline,
                    source_bounds=bounds)
    t = totals([rec])
    assert t["tiles_walked"] > 0 and t["cand_tiles"] > 0
    assert (t["cache_hits"] + t["cache_misses"] == t["tiles_walked"]) is cache
    assert t["cache_repairs"] == (t["moves"] if cache else 0)
    assert (t["chunks_overlapped"] > 0) is pipeline


#: the reference engine's counts (moves, then ROW), cache on
TABLE = {
    "cluster_a-64": ("cluster_a", dict(chunk=64), [None], None,
                     (44, 348, 137, 82, 266, 44, 0, 0)),
    "cluster_a-16-repad": ("cluster_a", dict(chunk=16, row_capacity=1),
                           [None], None, (44, 348, 137, 82, 266, 44, 1, 1)),
    "cluster_a-8-six-plans": ("cluster_a", dict(chunk=8), [10] * 6,
                              {3: grow(1e12)},
                              (44, 369, 144, 81, 288, 46, 2, 0)),
    "small-8-six-plans": ("small_test_cluster", dict(chunk=8), [10] * 6,
                          {3: grow(1e12)}, (25, 159, 63, 19, 140, 25, 1, 0)),
    "small-64": ("small_test_cluster", dict(chunk=64), [None], None,
                 (25, 113, 49, 19, 94, 25, 0, 0)),
    "sim_cluster-16": ("sim_cluster", dict(chunk=16), [None], None,
                       (56, 287, 149, 31, 256, 56, 3, 0)),
}


@pytest.mark.parametrize("name", list(TABLE))
def test_reference_table_rows(reference, name):
    """The literal rows of the reference's counts with the cache on: each
    plan call equal to the reference engine's, the sums the rows'."""
    cluster, kw, budgets, between, row = TABLE[name]
    got = totals(lockstep(cluster, budgets, between, legality_cache=True,
                          **kw))
    assert tuple(got.values()) == row


def test_cluster_a_without_bounds_row(reference):
    """``source_bounds=False`` walks every source: the reference's 396
    tiles, 137 with a candidate, 164 hits and 232 misses."""
    got = totals(lockstep("cluster_a", [None], legality_cache=True,
                          source_bounds=False))
    assert (got["moves"], got["tiles_walked"], got["cand_tiles"],
            got["cache_hits"], got["cache_misses"]) == (44, 396, 137, 164,
                                                        232)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
def test_cluster_d_hybrid_rule_counts(cache):
    """cluster_d (the paper's 1 x ssd + 2 x hdd rule) to convergence at
    the defaults: the reference engine's 333 moves, 1,219 bound hits, 16
    pruned sources, 5,607 tiles walked of which 2,046 held a candidate,
    and with the cache 2,398 hits and 3,209 misses."""
    port = BatchPlanner(cluster_state("cluster_d"), legality_cache=cache,
                        device="cpu")
    rec = counted_plan(port, obs)
    t = totals([rec])
    assert (t["moves"], rec["bound_hits"], rec["pruned_sources"],
            t["tiles_walked"], t["cand_tiles"]) == (333, 1219, 16, 5607,
                                                    2046)
    assert (t["cache_hits"], t["cache_misses"], t["cache_repairs"]) == (
        (2398, 3209, 333) if cache else (0, 0, 0))
    assert t["chunks_overlapped"] == 5 and t["repads"] == 0


@pytest.mark.parametrize("rb", [1, 32])
def test_row_block_matches_reference(reference, rb):
    """Other tile heights: the row table's alignment, the cache's blocks
    and the telemetry's tiles all follow ``row_block``."""
    lockstep("cluster_a", [None], chunk=8, row_block=rb, legality_cache=True)


def test_every_top_source_parked(reference):
    """n_avail 0: cluster_d at k 1 converges with its fullest source
    certified; a foreign move that leaves the certificate standing is
    absorbed with it, so the next step has no available source and walks
    tile (0, 0) alone, in both engines."""
    port_state, ref_state = cluster_state("cluster_d"), ref_gen.cluster_d()
    port = BatchPlanner(port_state, EquilibriumConfig(k=1),
                        legality_cache=True, device="cpu")
    ref = ref_batch.BatchPlanner(ref_state, RefConfig(k=1),
                                 legality_cache=True)
    first = counted_plan(port, obs)
    assert first == counted_plan(ref, ref_obs)
    pg, slot, src, dst, size = quiet_move(
        port_state, port._step.dyn["order"][:1].tolist())
    port_state.apply(Movement(pg, slot, src, dst, size))
    ref_state.apply(RefMovement(pg, slot, src, dst, size))
    port.sync()
    assert bool(port._step.dyn["pruned"][port._step.dyn["order"][0]])
    again = counted_plan(port, obs)
    assert again == counted_plan(ref, ref_obs)
    assert again["moves"] == [] and again["batch.tiles_walked"] == 1
    assert again["batch.cache_misses"] == 1


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_warm_sequence_drops_the_cache_where_the_reference_does(reference,
                                                                cluster):
    """Plans of 10 with pool growth, a device out and back in, a device
    add, a foreign move and a pool create between them, chunk 8 (a stash
    held across each): every absorption starts an empty cache, as the
    reference's does, and the counters of every call stay equal."""
    recs = lockstep(cluster, [10] * 8, WARM, chunk=8, legality_cache=True)
    assert sum(r["batch.rebuilds"] for r in recs) == 1


# ---------------------------------------------------------------------------
# K1's plain version with a cache


def _same_as_uncached(args, cache, want_out=None):
    """The cached call against the uncached one: ``any``, ``dst`` and
    ``cand_src`` bitwise, ``cand_row`` OR-ing to ``cand_src`` and False
    on padding rows, the hit rows of ``cache_out`` untouched and its
    other rows ``want_out``'s."""
    plain = select_rows_ref(*args)
    out = cache["cache_ok"].clone()
    got = select_rows_ref(*args, **cache, cache_out=out, cand_row=True)
    for g, w in zip(got[:3], plain):
        assert torch.equal(g, w)
    cand_row = got[3]
    assert torch.equal(cand_row.any(dim=1), got[2])
    rows_k = args[3]["rows_on"][args[0]]
    assert not cand_row[rows_k < 0].any()
    hit_rows = cache["hit_blk"].repeat_interleave(cache["rb"], 1)
    assert torch.equal(out[hit_rows], cache["cache_ok"][hit_rows])
    if want_out is not None:
        assert torch.equal(out[~hit_rows], want_out[~hit_rows])
    return got


@pytest.mark.parametrize("case", CARRIES, ids=[carry_id(c) for c in CARRIES])
def test_plain_select_rows_reads_its_cache(case):
    """On each test carry and each cache state the cached call gives the
    uncached call's ``any``, ``dst`` and ``cand_src`` bitwise, a
    ``cand_row`` whose per-source OR is ``cand_src``, and writes the
    fresh masks of exactly its miss rows."""
    args = carry(*case)
    for _name, cache, want in cache_states(args):
        _same_as_uncached(args, cache, want)


@pytest.mark.parametrize("case", CARRIES[::3],
                         ids=[carry_id(c) for c in CARRIES[::3]])
def test_candidate_masks_columns_equal_the_full_evaluation(case):
    """The cache repair's two-column evaluation (``devs``) gives the full
    evaluation's columns bitwise, for the step's sources and for rows
    read under other tags, at the step's endpoints and at the first and
    last device."""
    from repro_torch.kernels.ref import candidate_masks
    args = carry(*case)
    src_order, _, cap_lim, dyn, const, scal = args
    n = dyn["util"].shape[0]
    tags = src_order.roll(1)
    for src in (src_order, tags):
        rows = dyn["rows_on"][src]
        full = candidate_masks(src, rows, cap_lim, dyn, const, scal)
        for pair in ((src_order[0], src_order[-1]), (0, n - 1)):
            devs = torch.as_tensor(pair, dtype=torch.int64).view(2)
            cols = candidate_masks(src, rows, cap_lim, dyn, const, scal,
                                   devs=devs)
            assert torch.equal(cols["cand"], full["cand"][..., devs])
            assert torch.equal(cols["pre"], full["pre"][..., devs])
            assert torch.equal(cols["live"], full["live"])


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_plain_select_rows_reads_the_engines_cache(cluster):
    """The engine's own cache after planning steps with it (tags kept
    and changed, blocks dirtied by repairs, clean blocks repaired in
    place): every clean block holds the fresh evaluation, and the cached
    selection is the uncached one."""
    args, cache = engine_cache(cluster, 40, legal_hit=False)
    fresh = select_rows_masks(*args)["cand"]
    hit_rows = cache["hit_blk"].repeat_interleave(cache["rb"], 1)
    assert torch.equal(cache["cache_ok"][hit_rows], fresh[hit_rows])
    _same_as_uncached(args, cache, fresh)


def test_plain_select_rows_reads_a_corrupted_clean_block():
    """A legal pair read from a clean block of the engine's cache (cluster
    A, its 32nd step): clearing its byte in the cache removes it from the
    selection, so the cached call reads the cache."""
    args, cache = engine_cache("cluster_a", 60, legal_hit=True)
    plain = select_rows_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(
        select_rows_ref(*args, **cache), plain))
    k, R = cache["hit_blk"].shape[0], args[3]["rows_on"].shape[1]
    hit_rows = cache["hit_blk"].repeat_interleave(cache["rb"], 1)
    q, r = (int(i) for i in (plain[0].view(k, R) & hit_rows).nonzero()[0])
    bad = dict(cache, cache_ok=cache["cache_ok"].clone())
    bad["cache_ok"][q, r, int(plain[1].view(k, R)[q, r])] = False
    got = select_rows_ref(*args, **bad)
    assert not all(torch.equal(g, w) for g, w in zip(got, plain))


# ---------------------------------------------------------------------------
# telemetry cannot move a plan


def _op_count():
    path = REPO / "tools" / "step_op_count.py"
    spec = importlib.util.spec_from_file_location("step_op_count", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
def test_telemetry_cannot_move_a_plan(cache):
    """With and without a tracer the same moves and stats; telemetry
    counters only under the tracer."""
    plain = create_planner("equilibrium_batch", chunk=8, legality_cache=cache,
                           device="cpu").plan(port_gen.cluster_a(),
                                              record_trajectory=True)
    with obs.tracing():
        traced = create_planner("equilibrium_batch", chunk=8,
                                legality_cache=cache, device="cpu").plan(
            port_gen.cluster_a(), record_trajectory=True)
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in plain.moves] == \
        [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in traced.moves]
    assert [r.sources_tried for r in plain.records] == \
        [r.sources_tried for r in traced.records]
    assert plain.stats["cache_hits"] == 0
    assert (traced.stats["cache_hits"] > 0) is cache
    assert plain.stats["legality_cache"] is cache
    assert plain.stats["pipeline"] is True


def test_untraced_step_issues_the_operations_it_did_before_the_opt_ins():
    """With no tracer and the cache off a step issues 278 PyTorch
    operations on cluster A (``tools/step_op_count.py``), as before the
    opt-ins; under a tracer the telemetry adds its own."""
    mod = _op_count()
    assert mod.count("cluster_a", 8)["run_ops_per_step"] == 278.0
    with obs.tracing():
        planner = BatchPlanner(port_gen.cluster_a(), device="cpu")
        planner.sync()
        counter = mod.OpCount()
        with counter:
            planner._step.run(8, telemetry=True)
    assert counter.n / 8 > 278.0 + 1


# ---------------------------------------------------------------------------
# the fuzzer's oracles over the batch lane with each option on


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "nopipe"])
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_lane_with_the_cache_passes_every_oracle(seed, pipeline):
    """Quick timelines through ``equilibrium_batch`` with the cache on,
    under a tracer: legality, variance, conservation and rebuild oracles
    in the lane, and agreement with the faithful and dense lanes in moves
    and metrics JSON."""
    tl = generate_timeline(seed, "quick")
    state, events, cfg = tl.build("equilibrium_batch")
    with obs.tracing():
        snap = obs.registry().snapshot()
        lane = run_lifecycle(state, events, cfg, "equilibrium_batch",
                             device="cpu", planner_kwargs=dict(
                                 legality_cache=True, pipeline=pipeline))
        d = obs.registry().deltas_since(snap)
    for engine in ("equilibrium_faithful", "equilibrium"):
        other = run_lane(tl, engine)
        if (lane.moves, lane.metrics_json) != (other.moves,
                                                other.metrics_json):
            raise OracleFailure("agreement", f"equilibrium_batch with the "
                                f"cache vs {engine}, seed {seed}")
    assert d.get("batch.cache_repairs", 0) >= lane.planned_moves
    assert d.get("batch.tiles_walked", 0) > 0


# ---------------------------------------------------------------------------
# the recorder of the cluster-B fixture


def test_recorder_gives_the_reference_rows(reference):
    """``tests/_ref_batch_counters.py``'s recorder on cluster A with the
    fixture's config gives the reference's row (so it cannot drift), and
    the committed cluster-B fixture holds the reference's 839 moves,
    1,040 bound hits and 6 pruned sources with the cache on and off."""
    rec = record(ref_gen.cluster_a(), legality_cache=True,
                 **CLUSTER_B_CONFIG)
    assert (rec["moves"], *(rec[f"batch.{key}"] for key in ROW)) == (
        44, 348, 137, 82, 266, 44, 0, 0)
    assert set(rec) == {"moves", "sources_tried_hist", "bound_hits",
                        "pruned_sources", *COUNTERS}
    fixture = json.loads(FIXTURE.read_text())
    assert fixture["config"] == CLUSTER_B_CONFIG
    for cache in (True, False):
        run = fixture["runs"][f"legality_cache={cache}"]
        assert (run["moves"], run["bound_hits"], run["pruned_sources"]) == (
            839, 1040, 6)
        assert (run["batch.cache_repairs"] > 0) is cache
