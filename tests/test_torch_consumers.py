"""The port's planner consumers against the JAX package's: fault tolerance
(``ft``: failure detection, recovery, elastic rescale, stragglers),
checkpoint-shard placement, the data pipeline's shard assignment and
token loader, MoE expert placement and the paged KV pool.  Each planning
consumer calls ``create_planner("equilibrium")`` (the dense lanes' host
lane), so on the same inputs, made from a seed with NumPy, each must give
the reference's moves, placements, host maps and bytes exactly.  The
second half runs the checks of ``tests/test_ft_substrate.py`` that need
no JAX on the port."""

import dataclasses

import numpy as np
import pytest

import repro.checkpoint.placement as ref_ckpt
import repro.data.pipeline as ref_data
import repro.ft as ref_ft
import repro.ft.elastic as ref_elastic
import repro.serve.paged_kv as ref_kv
import repro.sharding.expert_placement as ref_experts
from repro.core import Device as RefDevice
from repro.core import PlacementRule as RefRule
from repro.core import Pool as RefPool
from repro.core import build_cluster as ref_build
from repro_torch import checkpoint as port_ckpt
from repro_torch import data as port_data
from repro_torch import ft as port_ft
from repro_torch.core import Device, PlacementRule, Pool, TiB, build_cluster
from repro_torch.ft import elastic as port_elastic
from repro_torch.serve import paged_kv as port_kv
from repro_torch.sharding import expert_placement as port_experts

PORT = dict(Device=Device, Rule=PlacementRule, Pool=Pool,
            build=build_cluster)
REF = dict(Device=RefDevice, Rule=RefRule, Pool=RefPool, build=ref_build)


def make_state(pkg, n_hosts=8, osds_per_host=2, seed=0, fill=0.5):
    """``tests/test_ft_substrate.py::make_state`` in either package."""
    devs = []
    rng = np.random.default_rng(seed)
    for h in range(n_hosts):
        for j in range(osds_per_host):
            cap = float(rng.choice([6, 10])) * TiB
            devs.append(pkg["Device"](id=len(devs), capacity=cap,
                                      device_class="hdd", host=f"host{h}"))
    total = sum(d.capacity for d in devs)
    pool = pkg["Pool"](0, "p", 48, pkg["Rule"].replicated(3, "host"),
                       stored_bytes=fill * total / 3)
    return pkg["build"](devs, [pool], seed=seed)


def moves(ms):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd, m.size) for m in ms]


def same_state(ref, port):
    assert list(ref.acting.items()) == list(port.acting.items())
    assert ref.used().tolist() == port.used().tolist()


# ---------------------------------------------------------------------------
# against the reference


@pytest.mark.parametrize("rebalance", [True, False])
@pytest.mark.parametrize("seed,failed", [(0, 3), (0, "fullest"), (5, 11)])
def test_plan_recovery_matches_reference(seed, failed, rebalance):
    ref, port = make_state(REF, seed=seed), make_state(PORT, seed=seed)
    same_state(ref, port)
    if failed == "fullest":
        failed = int(np.argmax(ref.utilization()))
    a = ref_ft.plan_recovery(ref, failed, rebalance=rebalance)
    b = port_ft.plan_recovery(port, failed, rebalance=rebalance)
    assert moves(b.re_replications) == moves(a.re_replications)
    assert moves(b.rebalance) == moves(a.rebalance)
    assert b.unrecoverable == a.unrecoverable
    assert (b.recovery_bytes, b.rebalance_bytes) \
        == (a.recovery_bytes, a.rebalance_bytes)
    assert len(b.re_replications) > 0 and (len(b.rebalance) > 0) == rebalance
    same_state(ref, port)


def _joiners(pkg, n=4, cap=8):
    return [pkg["Device"](id=100 + i, capacity=cap * TiB, device_class="hdd",
                          host=f"newhost{i // 2}") for i in range(n)]


@pytest.mark.parametrize("case", ["up", "down", "both"])
def test_plan_rescale_matches_reference(case):
    ref, port = make_state(REF, seed=2), make_state(PORT, seed=2)
    kw_ref, kw_port = {}, {}
    if case in ("up", "both"):
        kw_ref["add_devices"] = _joiners(REF)
        kw_port["add_devices"] = _joiners(PORT)
    if case in ("down", "both"):
        kw_ref["remove_osds"] = kw_port["remove_osds"] = [0, 5]
    naive_a = ref_elastic.naive_rescale_bytes(ref.copy(), **kw_ref)
    naive_b = port_elastic.naive_rescale_bytes(port.copy(), **kw_port)
    assert naive_b == naive_a
    a = ref_ft.plan_rescale(ref, **kw_ref)
    b = port_ft.plan_rescale(port, **kw_port)
    assert moves(b.movements) == moves(a.movements)
    assert len(b.movements) > 0
    assert (b.moved_bytes, b.total_bytes, b.variance_before,
            b.variance_after) == (a.moved_bytes, a.total_bytes,
                                  a.variance_before, a.variance_after)


def test_failure_detector_matches_reference():
    rng = np.random.default_rng(7)
    members = {f"w{i}" for i in range(12)}
    a = ref_ft.FailureDetector(members=set(members), timeout=3.0)
    b = port_ft.FailureDetector(members=set(members), timeout=3.0)
    for step in range(200):
        now = step * 0.5
        m = f"w{int(rng.integers(0, 12))}"
        op = rng.random()
        if op < 0.7:
            a.heartbeat(m, now)
            b.heartbeat(m, now)
        elif op < 0.8:
            a.admit(m, now)
            b.admit(m, now)
        else:
            assert b.sweep(now) == a.sweep(now)
        assert b.alive == a.alive
        assert b.declared_failed == a.declared_failed
        assert b.last_seen == a.last_seen


@pytest.mark.parametrize("quantile,frac", [(0.5, 0.15), (0.95, 0.15),
                                           (0.8, 0.4)])
def test_stragglers_match_reference(quantile, frac):
    rng = np.random.default_rng(3)
    items = rng.integers(50, 150, size=300).astype(float)
    host_of = rng.integers(0, 8, size=300)
    speed = rng.uniform(0.2, 1.0, size=8)
    eta = rng.random(40) * 10
    a = ref_ft.StragglerMitigator(8, quantile, frac)
    b = port_ft.StragglerMitigator(8, quantile, frac)
    assert b.plan_backups(eta) == a.plan_backups(eta)
    assert b.plan_backups(np.array([])) == a.plan_backups(np.array([]))
    for mit_a, mit_b in ((None, None), (a, b)):
        assert port_ft.simulate_epoch(items, host_of, speed, mit_b) \
            == ref_ft.simulate_epoch(items, host_of, speed, mit_a)


def _hosts(pkg_mod, n, racks, seed):
    rng = np.random.default_rng(seed)
    return [pkg_mod.StorageHost(f"h{i}",
                                capacity=float(rng.integers(1, 4)) * 2**30,
                                rack=f"r{i % racks}") for i in range(n)]


@pytest.mark.parametrize("racks,replicas", [(3, 2), (1, 2), (4, 3)])
def test_plan_placement_matches_reference(racks, replicas):
    rng = np.random.default_rng(racks)
    shards = {f"leaf{i:03d}": float(rng.integers(1, 64)) * 2**20
              for i in range(80)}
    for balance in (False, True):
        a = ref_ckpt.plan_placement(shards, _hosts(ref_ckpt, 9, racks, 1),
                                    replicas, seed=4, balance=balance)
        b = port_ckpt.plan_placement(shards, _hosts(port_ckpt, 9, racks, 1),
                                     replicas, seed=4, balance=balance)
        assert b.assignment() == a.assignment()
        assert b.utilization().tolist() == a.utilization().tolist()
    assert moves(port_ckpt.placement.rebalance(b)) \
        == moves(ref_ckpt.rebalance(a))


def test_assign_shards_matches_reference():
    rng = np.random.default_rng(1)
    shards = [(i, int(rng.integers(1 << 18, 1 << 22)), 0) for i in range(96)]
    caps = [4e9, 4e9, 8e9, 8e9, 6e9]
    a = ref_data.assign_shards([ref_data.DataShard(*s) for s in shards],
                               caps, seed=2)
    b = port_data.assign_shards([port_data.DataShard(*s) for s in shards],
                                caps, seed=2)
    assert b.host_of == a.host_of
    assert b.movements_bytes == a.movements_bytes > 0
    assert b.utilization.tolist() == a.utilization.tolist()
    assert [b.shards_of(h) for h in range(5)] \
        == [a.shards_of(h) for h in range(5)]


def _loader(mod, order, batch=6):
    shards = [mod.DataShard(i, 2048 + 512 * i, seed=9) for i in range(4)]
    src = mod.SyntheticTokenSource(shards, vocab_size=321, seq_len=24)
    return mod.TokenLoader(src, order, global_batch=batch)


def test_token_loader_matches_reference():
    """The same batches in the same order, and the same resume from a
    ``state_dict`` taken mid-epoch."""
    order = [2, 0, 3, 1]
    a, b = _loader(ref_data, order), _loader(port_data, order)
    assert len(b) == len(a)
    ita, itb = iter(a), iter(b)
    for _ in range(5):
        ba, bb = next(ita), next(itb)
        for key in ("tokens", "labels"):
            assert bb[key].dtype == ba[key].dtype
            assert np.array_equal(bb[key], ba[key])
    a.close()
    b.close()
    assert b.state_dict() == a.state_dict()
    ra, rb = _loader(ref_data, [0, 1, 2, 3]), _loader(port_data, [0, 1, 2, 3])
    ra.load_state_dict(a.state_dict())
    rb.load_state_dict(b.state_dict())
    assert rb.shard_order == order and rb.cursor == 30
    na, nb = next(iter(ra)), next(iter(rb))
    ra.close()
    rb.close()
    assert np.array_equal(nb["tokens"], na["tokens"])


def test_expert_placement_matches_reference():
    spec_kw = dict(n_chips=16, chips_per_host=4, hbm_budget_bytes=4e9,
                   replicas=2, load_alpha=1.5)
    a = ref_experts.plan(3, 24, 5e7, ref_experts.ExpertClusterSpec(**spec_kw),
                         seed=1)
    b = port_experts.plan(3, 24, 5e7,
                          port_experts.ExpertClusterSpec(**spec_kw), seed=1)
    assert np.array_equal(b.assignment(), a.assignment())
    loads = np.random.default_rng(5).gamma(0.7, size=(3, 24))
    ref_experts.apply_loads(a, loads, 5e7)
    port_experts.apply_loads(b, loads, 5e7)
    assert b.chip_utilization().tolist() == a.chip_utilization().tolist()
    mv_a, mv_b = ref_experts.rebalance(a), port_experts.rebalance(b)
    assert moves(mv_b) == moves(mv_a) and len(mv_b) > 0
    assert port_experts.migration_bytes(mv_b) \
        == ref_experts.migration_bytes(mv_a)
    assert np.array_equal(b.assignment(), a.assignment())
    assert b.chip_utilization().tolist() == a.chip_utilization().tolist()


def test_paged_kv_matches_reference():
    """Admission, growth, release and two rebalances on the same stream
    of requests."""
    kw = dict(n_chips=6, page_tokens=16, pages_per_chip=512)
    a = ref_kv.PagedKVPool(ref_kv.PagedKVSpec(**kw))
    b = port_kv.PagedKVPool(port_kv.PagedKVSpec(**kw))
    rng = np.random.default_rng(4)
    for step in range(120):
        op = rng.random()
        if op < 0.5:
            n = int(rng.integers(16, 1500))
            assert b.admit(n) == a.admit(n)
        elif op < 0.8 and a.seq_chip:
            sid = sorted(a.seq_chip)[int(rng.integers(len(a.seq_chip)))]
            n = int(rng.integers(1, 300))
            assert b.extend(sid, n) == a.extend(sid, n)
        elif a.seq_chip:
            sid = sorted(a.seq_chip)[int(rng.integers(len(a.seq_chip)))]
            a.release(sid)
            b.release(sid)
        if step in (60, 119):
            for sid in list(a.seq_chip)[:6]:      # skew onto chip 0
                a.seq_chip[sid] = b.seq_chip[sid] = 0
            plan_a, plan_b = a.rebalance(), b.rebalance()
            assert plan_b == plan_a and plan_b
            assert b.migration_bytes(plan_b) == a.migration_bytes(plan_a)
        assert b.seq_chip == a.seq_chip and b.seq_len == a.seq_len
    assert b.utilization().tolist() == a.utilization().tolist()


def test_packages_export_the_reference_names():
    import repro.checkpoint
    import repro.data
    assert port_ft.__all__ == ref_ft.__all__
    assert port_data.__all__ == repro.data.__all__
    assert port_ckpt.__all__ == repro.checkpoint.__all__
    for cls in (port_ckpt.StorageHost, port_data.DataShard,
                port_kv.PagedKVSpec, port_experts.ExpertClusterSpec):
        assert dataclasses.is_dataclass(cls)


# ---------------------------------------------------------------------------
# tests/test_ft_substrate.py's checks that need no JAX, on the port


def test_failure_detector_declares_and_readmits():
    fd = port_ft.FailureDetector(members={"a", "b", "c"}, timeout=5.0)
    for m in ("a", "b", "c"):
        fd.heartbeat(m, now=0.0)
    fd.heartbeat("a", 4.0)
    fd.heartbeat("b", 4.0)
    assert fd.sweep(now=7.0) == {"c"}
    assert fd.alive == {"a", "b"}
    fd.heartbeat("c", 8.0)                 # stale heartbeat is ignored
    assert "c" in fd.declared_failed
    fd.admit("c", 9.0)
    assert fd.alive == {"a", "b", "c"}


def test_recovery_restores_redundancy():
    state = make_state(PORT)
    failed = 3
    n_lost = len(state.shards_on[failed])
    assert n_lost > 0
    plan = port_ft.plan_recovery(state, failed)
    assert not plan.unrecoverable
    assert len(plan.re_replications) == n_lost
    assert not state.shards_on[failed], "dead device must end empty"
    state.check_valid()
    for mv in plan.re_replications:
        assert mv.dst_osd != failed


def test_recovery_prefers_empty_devices():
    state = make_state(PORT)
    util_before = state.utilization()
    failed = int(np.argmax(util_before))   # kill the fullest
    plan = port_ft.plan_recovery(state, failed, rebalance=False)
    dsts = [state.idx(mv.dst_osd) for mv in plan.re_replications]
    med = np.median(util_before)
    assert np.mean([util_before[d] <= med for d in dsts]) >= 0.5


def test_scale_up_moves_less_than_naive():
    state = make_state(PORT)
    new = _joiners(PORT)
    naive = port_elastic.naive_rescale_bytes(state.copy(), add_devices=new)
    plan = port_ft.plan_rescale(state, add_devices=new)
    assert plan.moved_bytes < naive
    assert plan.variance_after < plan.variance_before
    assert 0 < plan.moved_fraction < 1


def test_scale_down_evacuates():
    state = make_state(PORT)
    victim = state.devices[0].id
    plan = port_ft.plan_rescale(state, remove_osds=[victim])
    assert [m for m in plan.movements if m.src_osd == victim]


def test_straggler_mitigation_speeds_up_epoch():
    rng = np.random.default_rng(0)
    items = rng.integers(50, 150, size=200).astype(float)
    host_of = rng.integers(0, 8, size=200)
    speed = np.array([1.0] * 7 + [0.25])   # one slow host
    plain = port_ft.simulate_epoch(items, host_of, speed, None)
    mit = port_ft.simulate_epoch(
        items, host_of, speed,
        port_ft.StragglerMitigator(n_hosts=8, backup_quantile=0.5))
    assert mit["epoch_seconds"] < plain["epoch_seconds"]
    assert mit["speedup"] > 1.5


def test_shard_assignment_balances_loaders():
    rng = np.random.default_rng(1)
    shards = [port_data.DataShard(i, int(rng.integers(1 << 18, 1 << 22)),
                                  seed=0) for i in range(64)]
    asg = port_data.assign_shards(shards, [4e9, 4e9, 8e9, 8e9])
    assert set(asg.host_of.values()) <= {0, 1, 2, 3}
    assert asg.utilization.std() < 0.1, "loaders should fill evenly"


def test_token_loader_deterministic_and_resumable():
    shards = [port_data.DataShard(i, 4096, seed=3) for i in range(4)]
    src = port_data.SyntheticTokenSource(shards, vocab_size=100, seq_len=32)
    loader = port_data.TokenLoader(src, [s.id for s in shards],
                                   global_batch=8)
    it = iter(loader)
    b1 = next(it)
    b2 = next(it)
    loader.close()
    assert b1["tokens"].shape == (8, 32)
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    loader2 = port_data.TokenLoader(src, [s.id for s in shards],
                                    global_batch=8)
    loader2.load_state_dict({"cursor": 8, "shard_order": [0, 1, 2, 3]})
    b2b = next(iter(loader2))
    loader2.close()
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])


def test_paged_kv_rebalance_reduces_variance():
    pool = port_kv.PagedKVPool(port_kv.PagedKVSpec(
        n_chips=8, page_tokens=16, pages_per_chip=1024))
    rng = np.random.default_rng(2)
    for _ in range(64):
        pool.admit(int(rng.integers(16, 2048)))
    for sid, chip in list(pool.seq_chip.items())[:8]:
        pool.seq_chip[sid] = 0
    var_before = pool.utilization().var()
    plan = pool.rebalance()
    assert pool.utilization().var() < var_before
    assert plan, "skewed pool must produce migrations"
