"""The port's dense lanes against the JAX package's: ``equilibrium`` (the
dense-NumPy lane) and ``equilibrium_jax_legacy`` (the per-source lane
through K1's standalone reduction, ``device="cpu"``: the lane the card
runs, with the reduction's plain version) emit the reference's
``equilibrium``, ``equilibrium_jax_legacy`` and ``equilibrium_faithful``
move streams move for move, with equal ``sources_tried`` and
``variance_after``, across paper clusters, a hybrid rule and config
variants; the dense lane's source-bound counters equal the reference's.

Beside them: the warm ``dense=`` start against a cold one, and refusal of
a stale, foreign or batch-absorbed mirror; the legacy lane's refusal of
source bounds and its default device; the first legal row winning over a
later row that ties; the fuzzer's slack regression cluster
(``tests/regressions/legacy-slack-divergence.json``: its cluster and
config, its two device adds between plans of 8) on both lanes against the
faithful planner; every float tensor the legacy lane uploads is float64,
and a float32 downcast of them diverges from the faithful planner on
cluster A."""

import numpy as np
import pytest
import torch

from repro.core import Device as RefDevice
from repro.core import clustergen as ref_gen
from repro.core.equilibrium import EquilibriumConfig as RefConfig
from repro.core.planner import create_planner as ref_create
from repro.sim.generate import fuzz_cluster
from repro_torch.core import ClusterState, Device, TiB
from repro_torch.core import clustergen as port_gen
from repro_torch.core import equilibrium_dense
from repro_torch.core.dense import DenseState
from repro_torch.core.equilibrium import EquilibriumConfig
from repro_torch.core.equilibrium_batch import BatchPlanner
from repro_torch.core.equilibrium_dense import (_balance_fast, select_legacy,
                                                upload)
from repro_torch.core.planner import create_planner
from repro_torch.kernels import ops
from test_torch_cluster import ref_to_plain

REF_LANES = ("equilibrium", "equilibrium_jax_legacy", "equilibrium_faithful")
#: the port's dense lanes, with the arguments that keep them on the CPU
PORT_LANES = {"equilibrium": {},
              "equilibrium_jax_legacy": {"device": "cpu"}}
ENGINES = ("numpy", "jax-legacy")


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


def trace(result):
    return (as_tuples(result.moves),
            [r.sources_tried for r in result.records],
            [r.variance_after for r in result.records])


def exact_copy(state: ClusterState) -> ClusterState:
    return ClusterState.from_plain(state.to_plain())


def port_plan(lane, state, budget=None, **kw):
    cfg = kw.pop("cfg", None) or EquilibriumConfig()
    res = create_planner(lane, cfg=cfg, **PORT_LANES[lane], **kw).plan(
        state, budget=budget, record_trajectory=True)
    state.check_valid()
    return res


CONFIGS = [{}, dict(count_slack=1.0, k=5), dict(headroom=0.1),
           dict(min_variance_delta=1e-12), dict(k=100),
           dict(count_slack=1.39, min_variance_delta=1e-5)]


@pytest.mark.parametrize("kwargs", CONFIGS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_lanes_match_reference(cluster, kwargs):
    refs = {lane: ref_create(lane, cfg=RefConfig(**kwargs)).plan(
        getattr(ref_gen, cluster)(), record_trajectory=True)
        for lane in REF_LANES}
    want = trace(refs["equilibrium_faithful"])
    assert len(want[0]) > 0
    for lane in REF_LANES:
        assert trace(refs[lane]) == want, lane
    for lane in PORT_LANES:
        got = port_plan(lane, getattr(port_gen, cluster)(),
                        cfg=EquilibriumConfig(**kwargs))
        assert trace(got) == want, lane
        assert got.stats["sources_tried_hist"] \
            == refs["equilibrium"].stats["sources_tried_hist"], lane
        assert got.stats["engine"] == refs[lane].stats["engine"], lane


def test_lanes_match_reference_hybrid_rule():
    """Cluster D's hybrid 1×ssd+2×hdd rule (multi-step slot geometry),
    120 moves; the port's states are the reference's, carried across."""
    base = ref_gen.cluster_d()
    cfg = dict(max_moves=120)
    refs = {lane: ref_create(lane, cfg=RefConfig(**cfg)).plan(
        base.copy(), record_trajectory=True) for lane in REF_LANES}
    want = trace(refs["equilibrium_faithful"])
    assert len(want[0]) == 120
    assert all(trace(r) == want for r in refs.values())
    port = ClusterState.from_plain(ref_to_plain(base))
    for lane in PORT_LANES:
        got = port_plan(lane, exact_copy(port),
                        cfg=EquilibriumConfig(**cfg))
        assert trace(got) == want, lane


@pytest.mark.parametrize("kwargs", CONFIGS[:4] + CONFIGS[5:],
                         ids=lambda kw: ",".join(
                             f"{k}={v}" for k, v in kw.items())
                         or "default")
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_dense_source_bounds_match_reference(cluster, kwargs):
    ref = ref_create("equilibrium", cfg=RefConfig(**kwargs),
                     source_bounds=True).plan(getattr(ref_gen, cluster)(),
                                              record_trajectory=True)
    got = port_plan("equilibrium", getattr(port_gen, cluster)(),
                    cfg=EquilibriumConfig(**kwargs), source_bounds=True)
    assert trace(got) == trace(ref)
    for key in ("bound_hits", "pruned_sources", "sources_tried_hist",
                "source_bounds"):
        assert got.stats[key] == ref.stats[key], key
    assert got.stats["source_bounds"] is True


# ---------------------------------------------------------------------------
# warm start: the DenseState freshness contract


@pytest.mark.parametrize("engine", ENGINES)
def test_dense_warm_start_matches_cold(engine):
    """A fresh mirror handed back in is a pure warm start: the continued
    plan is identical to a cold plan of the mutated state, and to the
    reference's."""
    from repro.core.equilibrium_jax import _balance_fast as ref_balance
    cfg = EquilibriumConfig(max_moves=10)
    ref_state = ref_gen.cluster_a()
    cold_state, warm_state = port_gen.cluster_a(), port_gen.cluster_a()
    dense = DenseState(warm_state)
    for _ in range(2):
        want, _ = ref_balance(ref_state, RefConfig(max_moves=10))
        a, _ = _balance_fast(cold_state, cfg, engine=engine, device="cpu")
        b, _ = _balance_fast(warm_state, cfg, engine=engine, device="cpu",
                             dense=dense)
        assert as_tuples(a) == as_tuples(b) == as_tuples(want)
        assert len(b) == 10
        # the mirror tracked every applied move: it is still fresh
        assert not dense.stale


@pytest.mark.parametrize("engine", ENGINES)
def test_dense_warm_start_refuses_stale_mirror(engine):
    state = port_gen.cluster_a()
    dense = DenseState(state)
    pid = sorted(state.pools)[0]
    state.grow_pool(pid, state.pools[pid].stored_bytes * 1.2)
    assert dense.stale
    with pytest.raises(RuntimeError, match="stale"):
        _balance_fast(state, EquilibriumConfig(max_moves=5), engine=engine,
                      device="cpu", dense=dense)


@pytest.mark.parametrize("engine", ENGINES)
def test_dense_warm_start_refuses_foreign_state(engine):
    dense = DenseState(port_gen.cluster_a())
    with pytest.raises(ValueError, match="different ClusterState"):
        _balance_fast(port_gen.cluster_a(), EquilibriumConfig(max_moves=5),
                      engine=engine, device="cpu", dense=dense)


@pytest.mark.parametrize("engine", ENGINES)
def test_dense_refuses_batch_absorbed_mirror(engine):
    """The batch engine's delta absorption refreshes only the fields the
    device carry needs; the dense lanes refuse that partial mirror even
    though the planner considers itself synced."""
    state = port_gen.cluster_a()
    bp = BatchPlanner(state, EquilibriumConfig(), device="cpu")
    bp.plan(max_moves=5)
    pid = sorted(state.pools)[0]
    state.grow_pool(pid, state.pools[pid].stored_bytes * 1.2)
    bp.plan(max_moves=5)                 # absorbs the growth delta
    assert bp._dense is not None and not bp._dense.mirror_complete
    with pytest.raises(RuntimeError, match="incomplete"):
        _balance_fast(state, EquilibriumConfig(max_moves=5), engine=engine,
                      device="cpu", dense=bp._dense)


# ---------------------------------------------------------------------------
# the legacy lane's edges


def test_legacy_refuses_source_bounds():
    with pytest.raises(ValueError, match="source_bounds"):
        _balance_fast(port_gen.small_test_cluster(), engine="jax-legacy",
                      device="cpu", source_bounds=True)
    with pytest.raises(ValueError, match="source_bounds"):
        create_planner("equilibrium_jax_legacy", device="cpu",
                       source_bounds=True).plan(port_gen.small_test_cluster())


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        _balance_fast(port_gen.small_test_cluster(), engine="batch")


def test_legacy_default_device_is_cuda():
    """``device=None`` means the card; without one the legacy lane raises
    rather than running on the CPU.  The dense-NumPy lane is host code
    and takes no device."""
    if torch.cuda.is_available():
        assert create_planner("equilibrium_jax_legacy").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        create_planner("equilibrium_jax_legacy")
    with pytest.raises(RuntimeError, match="CUDA"):
        _balance_fast(port_gen.small_test_cluster(), engine="jax-legacy")
    assert create_planner("equilibrium", device="cpu").plan(
        port_gen.small_test_cluster()).moves


def test_legacy_reduces_once_and_fetches_once_a_source(monkeypatch):
    """One reduction call and one fetch per evaluated source; the stats'
    ``host_syncs`` counts the fetches."""
    calls = []
    real = ops.masked_select

    def spy(valid, util):
        calls.append((tuple(valid.shape), valid.dtype, util.dtype))
        return real(valid, util)

    monkeypatch.setattr(ops, "masked_select", spy)
    res = port_plan("equilibrium_jax_legacy", port_gen.cluster_a())
    assert len(res.moves) == 44
    assert len(calls) == res.stats["host_syncs"] > len(res.moves)
    n = port_gen.cluster_a().n_devices
    assert {c for c in calls} == {((256, n), torch.bool, torch.float64)}


def _select_inputs(n_rows=4, n_dev=6):
    """select_legacy's inputs for ``n_rows`` rows on ``n_dev`` devices
    with every criterion passing (source device 0, the fullest)."""
    f64 = torch.float64
    used = torch.tensor([9.0] + [1.0] * (n_dev - 1), dtype=f64)
    cap = torch.full((n_dev,), 10.0, dtype=f64)
    util = used / cap
    return dict(
        sizes=torch.full((n_rows,), 1.0, dtype=f64),
        cls=torch.zeros(n_rows, dtype=torch.int64),
        member=torch.zeros(n_rows, n_dev, dtype=torch.bool),
        peer=torch.zeros(n_rows, n_dev, dtype=torch.int16),
        cnt=torch.zeros(n_rows, n_dev, dtype=f64),
        ideal=torch.ones(n_rows, n_dev, dtype=f64),
        src_cnt=torch.full((n_rows,), 2.0, dtype=f64),
        src_ideal=torch.ones(n_rows, dtype=f64),
        used=used, cap=cap, util=util,
        moments=torch.tensor([float(util.sum()), float((util ** 2).sum()),
                              float(n_dev)], dtype=f64),
        dev_class=torch.zeros(n_dev, dtype=torch.int64), src_idx=0,
        count_slack=0.0, headroom=0.0, min_variance_delta=0.0)


def test_select_legacy_first_legal_row_wins_a_tie():
    """Row 0 has no legal destination; rows 1 and 3 both have legal ones
    (the same, a tie): the winner is row 1, its destination the emptiest
    legal device with ties to the lowest index."""
    t = _select_inputs()
    t["member"][0] = True                 # row 0: every destination taken
    t["member"][2] = True                 # row 2 too
    t["member"][1, 1] = True              # row 1: device 1 taken
    t["member"][3, 1] = True              # row 3: the same
    found, i, d = select_legacy(**t)
    assert (bool(found), int(i), int(d)) == (True, 1, 2)
    # without a legal row: found is False, i and d are 0
    t["member"][:] = True
    found, i, d = select_legacy(**t)
    assert (bool(found), int(i), int(d)) == (False, 0, 0)


def test_select_legacy_excludes_padding_and_the_source_column():
    t = _select_inputs()
    t["sizes"][:2] = -1.0                 # padded rows
    t["used"][1] = 0.5                    # device 1 the emptiest
    t["util"] = t["used"] / t["cap"]
    t["moments"] = torch.tensor([float(t["util"].sum()),
                                 float((t["util"] ** 2).sum()), 6.0],
                                dtype=torch.float64)
    found, i, d = select_legacy(**t)
    assert (bool(found), int(i), int(d)) == (True, 2, 1)


def test_upload_round_trips_and_copies():
    """One packed copy gives back each array's dtype, shape and values,
    and never shares memory with the host arrays."""
    rng = np.random.default_rng(0)
    arrays = {"f": rng.random((3, 5)), "b": rng.random((7,)) < 0.5,
              "i16": rng.integers(-4, 4, (2, 3)).astype(np.int16),
              "i64": rng.integers(0, 9, (5,)), "s": np.array([1.5])}
    got = upload(arrays, torch.device("cpu"))
    for name, a in arrays.items():
        assert got[name].numpy().dtype == a.dtype, name
        assert np.array_equal(got[name].numpy(), a), name
    arrays["f"][0, 0] = -1.0
    assert float(got["f"][0, 0]) != -1.0


def test_legacy_uploads_only_float64(monkeypatch):
    """Every float tensor the legacy lane puts on its device is float64
    (the reference needed enable_x64 for this lane)."""
    seen = []

    def spy(arrays, device):
        out = upload(arrays, device)
        seen.append({k: v.dtype for k, v in out.items()})
        return out

    monkeypatch.setattr(equilibrium_dense, "upload", spy)
    port_plan("equilibrium_jax_legacy", port_gen.small_test_cluster(),
              cfg=EquilibriumConfig(count_slack=1.39,
                                    min_variance_delta=1e-5))
    assert seen
    floats = {d for s in seen for d in s.values() if d.is_floating_point}
    assert floats == {torch.float64}
    assert {k for k, d in seen[0].items() if d.is_floating_point} == {
        "sizes", "cnt", "ideal", "src_cnt", "src_ideal", "used", "cap",
        "util", "moments"}


def test_float32_downcast_diverges(monkeypatch):
    """A mutant of the legacy lane that takes every uploaded float tensor
    as float32 diverges from the faithful planner on cluster A (default
    config): the float64 rule is load-bearing there, not decorative."""
    want = ref_create("equilibrium_faithful").plan(ref_gen.cluster_a())

    def float32(arrays, device):
        return {k: v.float() if v.dtype == torch.float64 else v
                for k, v in upload(arrays, device).items()}

    assert as_tuples(port_plan("equilibrium_jax_legacy",
                               port_gen.cluster_a()).moves) \
        == as_tuples(want.moves)
    monkeypatch.setattr(equilibrium_dense, "upload", float32)
    got = port_plan("equilibrium_jax_legacy", port_gen.cluster_a())
    assert as_tuples(got.moves) != as_tuples(want.moves)


# ---------------------------------------------------------------------------
# the lifecycle fuzzer's slack regression: its cluster and config


def _exp_device(cls, ids, ordinal, device_cls):
    """A device as the simulator's ``DeviceAdd`` builds it
    (``src/repro/sim/engine.py:183-190``)."""
    return device_cls(id=1 + max(ids), capacity=12 * TiB,
                      device_class=cls, host=f"{cls}-exp{ordinal:03d}",
                      rack="rack0")


def test_regression_cluster_lanes_match_faithful():
    """``legacy-slack-divergence.json``: fuzz cluster seed 44 (10 HDD, 4
    SSD, fill 0.3218) at count_slack 1.39, min_variance_delta 1e-5; plans
    of 8 with an HDD and then an SSD device added between them.  Both port
    lanes equal the reference's faithful planner at every plan (lane
    agreement on the regression's knife edge, not the timeline's
    replay)."""
    ref = fuzz_cluster(seed=44, n_hdd=10, n_ssd=4, fill=0.3218)
    states = {lane: ClusterState.from_plain(ref_to_plain(ref))
              for lane in PORT_LANES}
    kw = dict(count_slack=1.39, min_variance_delta=1e-5)
    adds = {2: "hdd", 3: "ssd"}
    total = 0
    for tick in range(4):
        if tick in adds:
            ordinal = tick - 2
            ref.add_device(_exp_device(adds[tick],
                                       [d.id for d in ref.devices], ordinal,
                                       RefDevice))
            for s in states.values():
                s.add_device(_exp_device(adds[tick],
                                         [d.id for d in s.devices], ordinal,
                                         Device))
        want = ref_create("equilibrium_faithful", cfg=RefConfig(**kw)).plan(
            ref, budget=8, record_trajectory=True)
        for lane, s in states.items():
            got = port_plan(lane, s, budget=8, cfg=EquilibriumConfig(**kw))
            assert trace(got) == trace(want), (lane, tick)
            assert s.used().tolist() == ref.used().tolist()
        total += len(want.moves)
    assert total > 8
