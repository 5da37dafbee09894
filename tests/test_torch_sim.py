"""The port's lifecycle simulator (``repro_torch.sim``) against the JAX
package's (``repro.sim``), compared exactly: the engine's event cases of
``tests/test_sim_engine.py``, the six scenarios, the timeline generator
and the fuzz corpus's timelines give the same metrics JSON
(``json.dumps(..., sort_keys=True)``) and the same cluster state.

The batch and legacy lanes run here with ``device="cpu"`` (their
kernels' plain versions); without it they run on the CUDA card, and raise
where there is none."""

import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

import repro.sim as ref_sim
from repro.core import ThrottleConfig as RefThrottleConfig
from repro.core import TiB
from repro.core import small_test_cluster as ref_small_test_cluster
from repro.core.cluster import PlacementRule as RefPlacementRule
from repro_torch import sim
from repro_torch.core import (ClusterState, Movement, MovementThrottle,
                              PlacementRule, ThrottleConfig,
                              small_test_cluster)
from test_torch_cluster import assert_same_state, ref_to_plain

REGRESSIONS = sorted((pathlib.Path(__file__).parent / "regressions")
                     .glob("*.json"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops (the batch and legacy lanes' plain versions) on one thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dump(metrics) -> str:
    return json.dumps(metrics.to_dict(), sort_keys=True)


def _same_json(a: dict, b: dict) -> None:
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ---------------------------------------------------------------------------
# the engine (tests/test_sim_engine.py's event cases)


def _run_both(events_fn, ticks, balancer="none", seed=0):
    """One timeline through both engines on the same small cluster:
    (reference engine, port engine) after their runs, metrics JSON and
    final state equal."""
    engines = []
    for pkg, state, cfg_cls in (
            (ref_sim, ref_small_test_cluster(), RefThrottleConfig),
            (sim, small_test_cluster(), ThrottleConfig)):
        cfg = pkg.SimConfig(ticks=ticks, balancer=balancer, seed=seed,
                            throttle=cfg_cls(max_concurrent=8,
                                             device_bytes_per_tick=TiB))
        eng = pkg.ScenarioEngine(state, events_fn(pkg, state), cfg)
        eng.run()
        engines.append(eng)
    ref, port = engines
    assert _dump(port.metrics) == _dump(ref.metrics)
    assert_same_state(ref.state, port.state)
    port.state.check_valid()
    return ref, port


def test_engine_device_fail_matches_reference():
    def events(pkg, state):
        return [pkg.DeviceFail(1, osd_id=state.devices[0].id)]
    _, port = _run_both(events, 3)
    osd = port.state.devices[0].id
    assert osd in port.state.out_osds and not port.state.shards_on[osd]
    assert port.metrics.degraded[-1] == 0
    assert any("DeviceFail" in d for _, d in port.metrics.event_log)


def test_engine_host_add_matches_reference():
    def events(pkg, state):
        return [pkg.HostAdd(0, n_osds=2, capacity_each=8 * TiB,
                            device_class="hdd")]
    _, port = _run_both(events, 2)
    state = port.state
    new_devs = state.devices[-2:]
    assert len({d.host for d in new_devs}) == 1
    for pid in (0, 1):
        ideal = state.ideal_shard_count(state.pools[pid])
        for d in new_devs:
            assert int(state.pool_counts[pid][state.idx(d.id)]) \
                == int(round(ideal[state.idx(d.id)]))


def test_engine_pool_create_and_growth_match_reference():
    def events(pkg, state):
        rule = (RefPlacementRule if pkg is ref_sim else PlacementRule)
        return [pkg.PoolCreate(0, name="fresh", pg_count=8,
                               rule=rule.replicated(2, "host", "hdd"),
                               stored_bytes=0.2 * TiB),
                pkg.PoolGrowth(1, pool_id=3, bytes_per_tick=0.1 * TiB,
                               duration=2)]
    _, port = _run_both(events, 4)
    assert port.state.pools[3].name == "fresh"
    assert port.state.pools[3].stored_bytes == pytest.approx(0.4 * TiB)


def test_engine_device_out_matches_reference():
    def events(pkg, state):
        return [pkg.DeviceOut(0, osd_id=state.devices[2].id)]
    _, port = _run_both(events, 2)
    osd = port.state.devices[2].id
    assert osd in port.state.out_osds and not port.state.shards_on[osd]


def test_engine_device_add_matches_reference():
    def events(pkg, state):
        return [pkg.DeviceAdd(0, capacity=8 * TiB, device_class="hdd")]
    _, port = _run_both(events, 2)
    assert port.state.n_devices == small_test_cluster().n_devices + 1


def test_engine_rebalance_none_matches_reference():
    def events(pkg, state):
        return [pkg.RebalanceTick(t) for t in range(3)]
    _, port = _run_both(events, 3)
    assert port.metrics.planned_moves[-1] == 0
    assert port.metrics.transferred_bytes[-1] == 0.0


@pytest.mark.parametrize("balancer", ["equilibrium", "mgr"])
def test_engine_rebalance_budget_matches_reference(balancer):
    def events(pkg, state):
        return [pkg.RebalanceTick(0, max_moves=2)]
    _, port = _run_both(events, 1, balancer=balancer)
    assert 0 < port.metrics.planned_moves[-1] <= 2


def test_engine_every_event_with_the_batch_lane_matches_reference():
    """Every event type in one timeline, planned each tick by the port's
    warm batch engine (plain K1 on the CPU) against the reference's
    faithful planner: the same metrics, one cold build and no rebuild."""
    from repro_torch import obs

    def timeline(pkg, state):
        rule = (RefPlacementRule if pkg is ref_sim else PlacementRule)
        return [pkg.RebalanceTick(t) for t in range(8)] + [
            pkg.PoolGrowth(0, pool_id=0, bytes_per_tick=0.5 * TiB,
                           duration=8, every=2),
            pkg.DeviceOut(1, osd_id=state.devices[2].id),
            pkg.HostAdd(2, n_osds=2, capacity_each=8 * TiB,
                        device_class="hdd"),
            pkg.DeviceFail(3, osd_id=state.devices[5].id),
            pkg.PoolCreate(4, name="fresh", pg_count=8,
                           rule=rule.replicated(2, "host", "hdd"),
                           stored_bytes=0.2 * TiB),
            pkg.ForeignMovement(5, count=3),
            pkg.DeviceAdd(6, capacity=2 * TiB, device_class="ssd")]

    ref_state = ref_small_test_cluster()
    ref = ref_sim.ScenarioEngine(
        ref_state, timeline(ref_sim, ref_state),
        ref_sim.SimConfig(ticks=8, balancer="equilibrium_faithful",
                          moves_per_tick=6))
    ref.run()
    state = small_test_cluster()
    reg = obs.registry()
    snap = reg.snapshot()
    port = sim.ScenarioEngine(
        state, timeline(sim, state),
        sim.SimConfig(ticks=8, balancer="equilibrium_batch",
                      moves_per_tick=6), device="cpu")
    port.run()
    assert _dump(port.metrics) == _dump(ref.metrics)
    assert_same_state(ref.state, port.state)
    d = reg.deltas_since(snap)
    assert d.get("batch.rebuilds", 0) == 1
    assert d.get("absorb.runs", 0) >= 6


def test_engine_unknown_balancer_rejected():
    with pytest.raises(ValueError):
        sim.ScenarioEngine(small_test_cluster(), [],
                           sim.SimConfig(balancer="nope"))


def test_throttle_retargeted_transfer_matches_reference():
    """A shard re-moved while its first transfer is in flight re-reads
    from the original holder; the physical bytes equal the reference's at
    every step, and the target map's once drained."""
    from repro.core import Movement as RefMovement
    from repro.core import MovementThrottle as RefThrottle
    states, queues = [], []
    for st_, q_cls, cfg_cls, mv_cls in (
            (ref_small_test_cluster(), RefThrottle, RefThrottleConfig,
             RefMovement),
            (small_test_cluster(), MovementThrottle, ThrottleConfig,
             Movement)):
        pg = st_.pgs_of_pool[0][0]
        a = st_.acting[pg][0]
        size = st_.shard_sizes[pg]
        b = next(d.id for d in st_.devices
                 if d.id != a and st_.move_is_legal(pg, 0, d.id))
        st_.apply(mv_cls(pg, 0, a, b, size))
        c = next(d.id for d in st_.devices
                 if d.id != a and st_.move_is_legal(pg, 0, d.id))
        q = q_cls(cfg_cls(max_concurrent=4, device_bytes_per_tick=size / 4))
        q.enqueue([mv_cls(pg, 0, a, b, size)])
        q.tick()
        st_.apply(mv_cls(pg, 0, b, c, size))
        q.enqueue([mv_cls(pg, 0, b, c, size)])
        assert q.backlog_moves == 1 and q.cancelled_moves == 1
        states.append(st_)
        queues.append(q)
    (ref_st, st_), (ref_q, q) = states, queues
    assert q.physical_used(st_).tolist() \
        == ref_q.physical_used(ref_st).tolist()
    while q.backlog_moves:
        assert q.tick() == ref_q.tick()
        assert q.physical_used(st_).tolist() \
            == ref_q.physical_used(ref_st).tolist()
    assert ref_q.backlog_moves == 0
    np.testing.assert_allclose(q.physical_used(st_), st_.used(), rtol=1e-12)


# ---------------------------------------------------------------------------
# the six scenarios


def _scenario_pair(name, balancer, quick, device=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_sim.run_scenario(name, balancer, seed=0, quick=quick)
    kw = {} if device is None else {"device": device}
    got = sim.run_scenario(name, balancer, seed=0, quick=quick, **kw)
    _same_json(got, want)
    return got


def test_registry_matches_reference():
    assert sorted(sim.SCENARIOS) == sorted(ref_sim.SCENARIOS)
    assert len(sim.SCENARIOS) == 6
    for name, s in sim.SCENARIOS.items():
        assert s.description == ref_sim.SCENARIOS[name].description


@pytest.mark.parametrize("balancer", ["equilibrium_batch", "equilibrium",
                                      "mgr", "none"])
@pytest.mark.parametrize("name", sorted(ref_sim.SCENARIOS))
def test_scenario_quick_matches_reference(name, balancer):
    device = "cpu" if balancer == "equilibrium_batch" else None
    got = _scenario_pair(name, balancer, True, device)
    assert len(got["metrics"]["ticks"]) == got["ticks"]


@pytest.mark.parametrize("balancer", ["equilibrium", "mgr"])
@pytest.mark.parametrize("name", sorted(ref_sim.SCENARIOS))
def test_scenario_full_length_matches_reference(name, balancer):
    _scenario_pair(name, balancer, False)


@pytest.mark.parametrize("name", ["near-full-emergency",
                                  "cascading-failures"])
def test_scenario_full_length_batch_lane_matches_reference(name):
    _scenario_pair(name, "equilibrium_batch", False, "cpu")


def test_run_scenario_batch_lane_has_no_quiet_cpu_run():
    """With no ``device`` the batch lane is the card's: it raises where
    there is none rather than running on the CPU."""
    state, events, cfg = sim.SCENARIOS["steady-growth"].build(0, True)
    cfg.balancer = "equilibrium_batch"
    if torch.cuda.is_available():
        eng = sim.ScenarioEngine(state, events, cfg)
        assert eng._planner.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.run_scenario("steady-growth", "equilibrium_batch", quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.ScenarioEngine(state, events, cfg)


# ---------------------------------------------------------------------------
# the generator


@pytest.mark.parametrize("profile", sorted(ref_sim.PROFILES))
def test_generate_timeline_matches_reference(profile):
    for seed in range(50):
        got = sim.generate_timeline(seed, profile).to_dict()
        want = ref_sim.generate_timeline(seed, profile).to_dict()
        _same_json(got, want)
        again = sim.timeline_from_dict(json.loads(json.dumps(got)))
        assert again.to_dict() == got


@pytest.mark.parametrize("seed", [0, 1, 7, 44])
def test_fuzz_cluster_matches_reference(seed):
    kw = sim.generate_timeline(seed).cluster
    ref = ref_sim.fuzz_cluster(**kw)
    port = sim.fuzz_cluster(**kw)
    assert_same_state(ref, port)
    again = ClusterState.from_plain(ref_to_plain(ref)).to_plain()
    plain = port.to_plain()
    assert again.keys() == plain.keys()
    assert again["used"].tolist() == plain["used"].tolist()
    assert {k: v for k, v in again.items() if k != "used"} \
        == {k: v for k, v in plain.items() if k != "used"}


# ---------------------------------------------------------------------------
# the fuzz corpus's timelines through the port's engine


@pytest.mark.parametrize("lane", ["equilibrium", "equilibrium_jax_legacy",
                                  "equilibrium_batch"])
@pytest.mark.parametrize("path", REGRESSIONS, ids=lambda p: p.stem)
def test_regression_timeline_matches_faithful_reference(path, lane):
    """Each ``tests/regressions/*.json`` timeline through the port's
    engine with each Equilibrium lane gives the metrics JSON of the
    reference's ``equilibrium_faithful`` run."""
    d = json.loads(path.read_text())
    ref_state, ref_events, ref_cfg = ref_sim.timeline_from_dict(d).build(
        "equilibrium_faithful")
    ref = ref_sim.ScenarioEngine(ref_state, ref_events, ref_cfg)
    ref.run()
    state, events, cfg = sim.timeline_from_dict(d).build(lane)
    device = None if lane == "equilibrium" else "cpu"
    port = sim.ScenarioEngine(state, events, cfg, device=device)
    port.run()
    assert _dump(port.metrics) == _dump(ref.metrics)
    assert_same_state(ref.state, port.state)
