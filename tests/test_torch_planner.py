"""The port's planners against the JAX package's: ``equilibrium_batch``
(``device="cpu"``, the same engine the card runs, with K1's plain
version) and the port's host ``equilibrium_faithful`` emit the reference
faithful planner's move sequence move for move, with equal
``variance_after``, ``sources_tried`` and certificate counters, across
paper clusters, config variants, chunk lengths, source bounds on and off
and the row-capacity boundary; one host sync per chunk; the stats key set
is the reference schema.

The reference's own ``equilibrium_batch`` lane may run its dense-NumPy
fallback where its JAX import fails, so the reference lanes held here are
``equilibrium_faithful`` and ``equilibrium`` (dense NumPy), which the
reference's invariant makes bit-identical to its batch lane."""

import pytest
import torch

from _ref_batch_counters import reference_attrs
from repro.core import clustergen as ref_gen
from repro.core.equilibrium import EquilibriumConfig as RefConfig
from repro.core.planner import create_planner as ref_create
from repro.obs.schema import STATS_SCHEMA as REF_SCHEMA
from repro_torch import obs
from repro_torch.core import clustergen as port_gen
from repro_torch.core.cluster import ClusterState, Device, TiB
from repro_torch.core.dense import DenseState
from repro_torch.core.equilibrium import EquilibriumConfig
from repro_torch.core.equilibrium_batch import (BatchPlanner, _first_true,
                                                _shift_insert, _shift_remove,
                                                dense_rebuild_count,
                                                host_sync_count)
from repro_torch.core.planner import (available_planners, create_planner,
                                      planners_in_class)
from repro_torch.obs.schema import STATS_SCHEMA, validate_stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_tuples(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves]


def trace(result):
    return (as_tuples(result.moves),
            [r.variance_after for r in result.records],
            [r.sources_tried for r in result.records])


def ref_plan(cluster, planner="equilibrium_faithful", budget=None, **cfg):
    state = getattr(ref_gen, cluster)()
    return ref_create(planner, cfg=RefConfig(**cfg)).plan(
        state, budget=budget, record_trajectory=True)


def ref_bounds(cluster, budget=None, **cfg):
    state = getattr(ref_gen, cluster)()
    return ref_create("equilibrium_faithful", cfg=RefConfig(**cfg),
                      source_bounds=True).plan(state, budget=budget)


def port_batch(cluster, budget=None, *, chunk=64, source_bounds=True,
               row_capacity=None, **cfg):
    state = getattr(port_gen, cluster)()
    res = create_planner("equilibrium_batch", cfg=EquilibriumConfig(**cfg),
                         chunk=chunk, source_bounds=source_bounds,
                         row_capacity=row_capacity, device="cpu").plan(
        state, budget=budget, record_trajectory=True)
    state.check_valid()
    return res


# (cluster, move budget): full convergence where it is cheap on the CPU
CLUSTERS = [("small_test_cluster", None), ("cluster_a", None),
            ("cluster_c", 60), ("cluster_f", 60)]


@pytest.mark.parametrize("source_bounds", [True, False])
@pytest.mark.parametrize("cluster,budget", CLUSTERS)
def test_batch_matches_reference_faithful(cluster, budget, source_bounds):
    ref = ref_plan(cluster, budget=budget)
    got = port_batch(cluster, budget, source_bounds=source_bounds)
    assert len(got.moves) > 0
    assert trace(got) == trace(ref)
    assert got.stats["sources_tried_hist"] == ref.stats["sources_tried_hist"]
    if source_bounds:
        rb = ref_bounds(cluster, budget=budget)
        assert got.stats["bound_hits"] == rb.stats["bound_hits"]
        assert got.stats["pruned_sources"] == rb.stats["pruned_sources"]
    else:
        assert got.stats["bound_hits"] == 0
        assert got.stats["pruned_sources"] == 0


@pytest.mark.parametrize("source_bounds", [True, False])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_port_faithful_matches_reference(cluster, source_bounds):
    ref = ref_plan(cluster)
    state = getattr(port_gen, cluster)()
    got = create_planner("equilibrium_faithful",
                         source_bounds=source_bounds).plan(
        state, record_trajectory=True)
    assert trace(got) == trace(ref)
    if source_bounds:
        rb = ref_bounds(cluster)
        assert got.stats["bound_hits"] == rb.stats["bound_hits"]
        assert got.stats["pruned_sources"] == rb.stats["pruned_sources"]


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_batch_matches_reference_dense_numpy(cluster):
    ref = ref_plan(cluster, planner="equilibrium")
    assert trace(port_batch(cluster)) == trace(ref)


@pytest.mark.slow
def test_batch_matches_reference_hybrid_rule():
    """Cluster D's hybrid 1×ssd+2×hdd rule (multi-step slot geometry),
    against the reference dense-NumPy engine, as the reference's own
    batch test does."""
    ref = ref_plan("cluster_d", planner="equilibrium", max_moves=120)
    got = port_batch("cluster_d", max_moves=120)
    assert len(got.moves) == 120
    assert trace(got) == trace(ref)


@pytest.mark.parametrize("kwargs", [
    dict(count_slack=1.0, k=5),
    dict(headroom=0.1),
    dict(min_variance_delta=1e-12),
    dict(k=100),                    # k > n_devices
])
def test_batch_matches_reference_config_variants(kwargs):
    ref = ref_plan("small_test_cluster", **kwargs)
    got = port_batch("small_test_cluster", **kwargs)
    assert trace(got) == trace(ref)


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunk_length_never_changes_the_sequence(chunk):
    ref = ref_plan("small_test_cluster")
    snap = obs.registry().snapshot()
    before = host_sync_count()
    got = port_batch("small_test_cluster", chunk=chunk)
    assert trace(got) == trace(ref)
    chunks = int(obs.registry().deltas_since(snap).get("batch.chunks", 0))
    # one sync per chunk: every chunk but the last is full, the last one
    # holds the fruitless terminal step
    assert chunks == len(got.moves) // chunk + 1
    assert host_sync_count() - before == chunks == got.stats["host_syncs"]


def test_row_capacity_at_exact_boundary_repads():
    """row_capacity == max rows/device (rounded up to the 8-row
    alignment, so less than a chunk of slack): the first chunk leaves too
    little room and forces the mid-run re-pad; the sequence must not
    change."""
    ref = ref_plan("small_test_cluster")
    mx = max(len(s) for s in
             DenseState(port_gen.small_test_cluster()).rows_on_dev)
    snap = obs.registry().snapshot()
    got = port_batch("small_test_cluster", chunk=8, row_capacity=mx)
    assert trace(got) == trace(ref)
    d = obs.registry().deltas_since(snap)
    assert d.get("batch.repads", 0) >= 1
    assert got.stats["host_syncs"] == d["batch.chunks"] + d["batch.repads"]


def test_row_capacity_clamped_below_occupancy():
    ref = ref_plan("small_test_cluster")
    got = port_batch("small_test_cluster", chunk=3, row_capacity=1)
    assert trace(got) == trace(ref)


def test_warm_budget_split_emits_the_cold_sequence():
    """Moves planned past a budget are stashed in the carry and emitted
    first by the next call, with a single dense build."""
    cold = ref_plan("small_test_cluster")
    state = port_gen.small_test_cluster()
    planner = BatchPlanner(state, EquilibriumConfig(), chunk=8,
                           device="cpu")
    before = dense_rebuild_count()
    seq = []
    for budget in (3, 5, 10_000):
        moves, _ = planner.plan(max_moves=budget)
        seq += moves
    assert as_tuples(seq) == as_tuples(cold.moves)
    assert dense_rebuild_count() - before == 1
    assert planner.plan(max_moves=10) == ([], [])    # converged: a no-op


def test_external_mutation_rebuilds_and_stays_faithful():
    """The unstamped-delta fallback: ``observe(None)`` cannot be ordered
    in the delta stream, so it poisons the stream and observe() says the
    carry is lost; the next plan rebuilds from the mutated state."""
    ref = ref_gen.small_test_cluster()
    ref_p = ref_create("equilibrium_faithful")
    state = port_gen.small_test_cluster()
    planner = create_planner("equilibrium_batch", device="cpu")
    first = planner.plan(state, budget=5)
    assert as_tuples(first.moves) == as_tuples(ref_p.plan(ref, budget=5).moves)
    before = dense_rebuild_count()
    state.grow_pool(0, 2 * TiB)
    ref.grow_pool(0, 2 * TiB)
    assert planner._impl.observe(None) is False
    rest = planner.plan(state)
    assert dense_rebuild_count() - before == 1
    assert as_tuples(rest.moves) == as_tuples(ref_p.plan(ref).moves)


def test_degenerate_clusters_plan_nothing():
    devs = [Device(id=0, capacity=8 * TiB, device_class="hdd", host="h0")]
    res = create_planner("equilibrium_batch", device="cpu").plan(
        ClusterState(devs, [], {}, {}))
    assert res.moves == [] and validate_stats(res.stats) == []


def test_legality_cache_and_source_block_are_accepted(monkeypatch):
    """The front door takes the engine's opt-ins and reports them, and
    plans at source_block 0 and 2 with the reference batch planner's
    moves, histogram and certificate counters (its engine runs here with
    ``tests/_ref_batch_counters.py``'s bindings)."""
    res = create_planner("equilibrium_batch", device="cpu",
                         legality_cache=True, pipeline=False,
                         row_block=4).plan(port_gen.small_test_cluster(),
                                           budget=4)
    assert res.stats["legality_cache"] is True
    assert res.stats["pipeline"] is False
    assert len(res.moves) == 4 and validate_stats(res.stats) == []
    for mod, name, value in reference_attrs():
        monkeypatch.setattr(mod, name, value, raising=False)
    keys = ("sources_tried_hist", "bound_hits", "pruned_sources",
            "legality_cache", "source_bounds", "pipeline")
    for kb in (0, 2):
        want = ref_create("equilibrium_batch", source_block=kb).plan(
            ref_gen.small_test_cluster())
        got = create_planner("equilibrium_batch", device="cpu",
                             source_block=kb).plan(
            port_gen.small_test_cluster())
        assert as_tuples(got.moves) == as_tuples(want.moves)
        assert {k: got.stats[k] for k in keys} == \
            {k: want.stats[k] for k in keys}
        assert validate_stats(got.stats) == []


def test_mgr_matches_reference():
    ref = ref_create("mgr").plan(ref_gen.cluster_a(), record_trajectory=True)
    got = create_planner("mgr").plan(port_gen.cluster_a(),
                                     record_trajectory=True)
    assert as_tuples(got.moves) == as_tuples(ref.moves)
    assert [r.variance_after for r in got.records] \
        == [r.variance_after for r in ref.records]


def test_registry_and_stats_schema():
    assert STATS_SCHEMA.keys() == REF_SCHEMA.keys()
    assert available_planners() == ("equilibrium", "equilibrium_batch",
                                     "equilibrium_batch_sharded",
                                     "equilibrium_faithful",
                                     "equilibrium_jax_legacy", "fleet", "mgr",
                                     "none")
    assert planners_in_class("equilibrium") == (
        "equilibrium", "equilibrium_batch", "equilibrium_batch_sharded",
        "equilibrium_faithful", "equilibrium_jax_legacy", "fleet")
    for name in available_planners():
        kw = {"device": "cpu"} if name in ("equilibrium_batch",
                                           "equilibrium_batch_sharded",
                                           "equilibrium_jax_legacy",
                                           "fleet") else {}
        res = create_planner(name, **kw).plan(port_gen.small_test_cluster(),
                                              budget=4)
        assert res.stats.keys() == REF_SCHEMA.keys(), name
        assert validate_stats(res.stats) == [], name
    res = create_planner("equilibrium_batch", device="cpu").plan(
        port_gen.small_test_cluster(), budget=4)
    assert res.stats["engine"] == "batch" and res.stats["pipeline"] is True
    assert res.stats["source_bounds"] is True
    # absorbed_deltas is the planner's lifetime count, not a per-plan delta
    state = port_gen.small_test_cluster()
    planner = create_planner("equilibrium_batch", chunk=4, device="cpu")
    assert planner.plan(state, budget=4).stats["absorbed_deltas"] == 0
    state.grow_pool(0, 1 * TiB)
    state.grow_pool(1, 1 * TiB)
    assert planner.plan(state, budget=4).stats["absorbed_deltas"] == 2
    state.mark_out(state.devices[0].id)
    res = planner.plan(state, budget=4)
    assert res.stats["absorbed_deltas"] == 3 and res.stats["rebuilds"] == 0
    assert planner.plan(state, budget=4).stats["absorbed_deltas"] == 3
    assert validate_stats(res.stats) == []


def test_planning_state_stays_float64():
    """No criterion input is downcast (torch factories default to
    float32)."""
    planner = BatchPlanner(port_gen.small_test_cluster(), device="cpu")
    planner.sync()
    step = planner._step
    for name in ("used", "util", "us", "usq", "pool_counts"):
        assert step.dyn[name].dtype == torch.float64, name
    for name in ("cap", "sh_size", "ideal"):
        assert step.const[name].dtype == torch.float64, name
    for name in ("slack", "headroom", "min_dvar", "n_f"):
        assert step.scal[name].dtype == torch.float64, name
    dense = DenseState(port_gen.small_test_cluster())
    assert step.dyn["us"].item() == dense.util_sum
    assert step.dyn["usq"].item() == dense.util_sumsq


def test_masked_helpers_match_jax_semantics():
    """``_first_true`` is ``jnp.argmax`` of a bool array (0 where no entry
    holds); the shift helpers keep the padded row lists sorted."""
    m = torch.tensor([[False, True, True], [False, False, False],
                      [True, False, True]])
    assert _first_true(m).tolist() == [1, 0, 0]
    arr = torch.tensor([7, 5, 3, -1])
    assert _shift_remove(arr, torch.tensor(1), -1).tolist() == [7, 3, -1, -1]
    assert _shift_insert(arr, torch.tensor(1), torch.tensor([6])).tolist() \
        == [7, 6, 5, 3]


def test_traced_plan_passes_the_trace_schema(tmp_path):
    """Tracing reads only: a traced plan emits the same moves, and the
    port's trace passes the port's ``validate_trace``."""
    from repro_torch.obs import read_trace, tracing, validate_trace
    path = tmp_path / "plan.jsonl"
    with tracing(str(path)):
        got = port_batch("small_test_cluster", chunk=8)
    assert trace(got) == trace(ref_plan("small_test_cluster"))
    records = read_trace(str(path))
    assert validate_trace(records) == []
    names = {r.get("name") for r in records}
    assert {"planner.plan", "batch.chunk", "batch.rebuild"} <= names


def _erasure_cluster(cluster, crush, gen):
    """A small EC 4+2 + replicated hdd/ssd cluster, built the same way in
    either package: the slot geometry of cluster B's EC pools at a size
    the CPU converges quickly."""
    TiB, rule = cluster.TiB, cluster.PlacementRule
    devs = gen._make_devices([(24, 24 * 8 * TiB, "hdd"),
                              (6, 6 * 2 * TiB, "ssd")], osds_per_host=2,
                             seed=9)
    pools = [cluster.Pool(0, "ec", 64, rule.erasure(4, 2, "host", "hdd"),
                          ec_k=4, stored_bytes=40 * TiB),
             cluster.Pool(1, "rbd", 32, rule.replicated(3, "host", "hdd"),
                          stored_bytes=8 * TiB),
             cluster.Pool(2, "meta", 16, rule.replicated(2, "host", "ssd"),
                          stored_bytes=1 * TiB, is_user_data=False)]
    return crush.build_cluster(devs, pools, seed=9)


def test_batch_matches_reference_erasure_coded():
    from repro.core import cluster as rc, crush as rcr
    from repro_torch.core import cluster as pc, crush as pcr
    ref = ref_create("equilibrium_faithful").plan(
        _erasure_cluster(rc, rcr, ref_gen), record_trajectory=True)
    state = _erasure_cluster(pc, pcr, port_gen)
    got = create_planner("equilibrium_batch", device="cpu").plan(
        state, record_trajectory=True)
    assert len(got.moves) > 20
    assert trace(got) == trace(ref)
    state.check_valid()


def test_out_device_never_a_destination_even_with_count_slack():
    """count_slack >= 1 disables the ideal-count exclusion of empty
    devices, so the out mask alone keeps an out device from receiving."""
    ref_state = ref_gen.small_test_cluster()
    ref_state.mark_out(ref_state.devices[1].id)
    ref = ref_create("equilibrium_faithful",
                     cfg=RefConfig(count_slack=1.0)).plan(
        ref_state, record_trajectory=True)
    state = port_gen.small_test_cluster()
    out = state.devices[1].id
    state.mark_out(out)
    got = create_planner("equilibrium_batch", device="cpu",
                         cfg=EquilibriumConfig(count_slack=1.0)).plan(
        state, record_trajectory=True)
    assert trace(got) == trace(ref)
    assert all(m.dst_osd != out for m in got.moves)
