"""The port's host cluster model against the JAX package's: the same seed
builds the same cluster field by field (``used`` bitwise), the mutators
emit the same delta sequence, and a mutated reference state carried
across with ``ClusterState.from_plain`` equals the reference."""

import dataclasses

import numpy as np
import pytest

from repro.core import clustergen as ref_gen
from repro.core import cluster as ref_cluster
from repro_torch.core import clustergen as port_gen
from repro_torch.core import cluster as port_cluster

CLUSTERS = [
    ("small_test_cluster", {}),
    ("cluster_a", {}),
    ("cluster_c", {}),
    ("sim_cluster", {"seed": 0}),
    ("sim_cluster", {"seed": 3}),
    ("sim_cluster", {"seed": 11, "n_ssd": 0}),
]


def ref_to_plain(state) -> dict:
    """A reference ``repro.core.cluster.ClusterState`` in the port's plain
    form (:meth:`repro_torch.core.cluster.ClusterState.to_plain`): the port
    cannot import the reference, so the helper lives here."""
    return {
        "devices": [dataclasses.asdict(d) for d in state.devices],
        "pools": [{"id": p.id, "name": p.name, "pg_count": p.pg_count,
                   "rule": [dataclasses.asdict(s) for s in p.rule.steps],
                   "ec_k": p.ec_k, "stored_bytes": p.stored_bytes,
                   "is_user_data": p.is_user_data}
                  for p in state.pools.values()],
        "acting": {pg: list(osds) for pg, osds in state.acting.items()},
        "shard_sizes": dict(state.shard_sizes),
        "out_osds": sorted(state.out_osds),
        "used": state.used(),
        "mutation_epoch": state.mutation_epoch,
    }


def assert_same_state(ref, port):
    """Field-by-field equality of a reference and a port ClusterState,
    with ``used`` compared bit for bit."""
    assert [dataclasses.asdict(d) for d in ref.devices] \
        == [dataclasses.asdict(d) for d in port.devices]
    assert ref_to_plain(ref)["pools"] == port.to_plain()["pools"]
    assert list(ref.acting.items()) == list(port.acting.items())
    assert list(ref.shard_sizes.items()) == list(port.shard_sizes.items())
    assert ref.out_osds == port.out_osds
    assert ref.mutation_epoch == port.mutation_epoch
    assert ref.used().view(np.int64).tolist() \
        == port.used().view(np.int64).tolist()
    assert ref.pool_counts.keys() == port.pool_counts.keys()
    for p in ref.pool_counts:
        assert np.array_equal(ref.pool_counts[p], port.pool_counts[p])
    assert ref.pgs_of_pool == port.pgs_of_pool
    assert ref.shards_on == port.shards_on
    assert np.array_equal(ref.capacity_vector(), port.capacity_vector())


@pytest.mark.parametrize("name,kwargs", CLUSTERS)
def test_same_seed_builds_same_cluster(name, kwargs):
    ref = getattr(ref_gen, name)(**kwargs)
    port = getattr(port_gen, name)(**kwargs)
    assert_same_state(ref, port)
    assert ref.utilization_variance() == port.utilization_variance()
    for pool in ref.pools:
        assert np.array_equal(
            ref.ideal_shard_count(ref.pools[pool]),
            port.ideal_shard_count(port.pools[pool]))


def _delta_record(delta) -> tuple:
    return type(delta).__name__, dataclasses.asdict(delta)


def _mutate(mod, state) -> None:
    """One of every mutator, the same calls in either package."""
    pg, slot = (0, 0), 0
    src = state.acting[pg][slot]
    dst = next(d.id for d in state.devices
               if state.move_is_legal(pg, slot, d.id))
    state.apply(mod.Movement(pg, slot, src, dst, state.shard_sizes[pg]))
    state.grow_pool(1, 3.5 * mod.TiB)
    state.add_device(mod.Device(id=1000, capacity=9 * mod.TiB,
                                device_class="hdd", host="new-host",
                                rack="new-rack"))
    state.mark_out(state.devices[2].id)
    state.mark_out(state.devices[3].id)
    state.mark_out(state.devices[3].id, out=False)
    rule = mod.PlacementRule.replicated(2, "host", "hdd")
    pool = mod.Pool(7, "late", 2, rule, stored_bytes=0.4 * mod.TiB)
    hdd = [d.id for d in state.devices if d.device_class == "hdd"
           and d.id not in state.out_osds]
    by_host = {}
    for o in hdd:
        by_host.setdefault(state.dev_by_id[o].host, o)
    first = list(by_host.values())
    state.add_pool(pool, {(7, 0): first[:2], (7, 1): first[2:4]},
                   {(7, 0): 0.1 * mod.TiB, (7, 1): 0.2 * mod.TiB})
    back = mod.Movement(pg, slot, dst, src, state.shard_sizes[pg])
    state.apply(back)


def test_mutators_emit_the_same_deltas():
    ref = ref_gen.small_test_cluster()
    port = port_gen.small_test_cluster()
    ref_log, port_log = [], []
    ref.subscribe(lambda d: ref_log.append(_delta_record(d)))
    port.subscribe(lambda d: port_log.append(_delta_record(d)))
    _mutate(ref_cluster, ref)
    _mutate(port_cluster, port)
    assert len(ref_log) == 8
    assert ref_log == port_log
    assert_same_state(ref, port)


def test_from_plain_of_mutated_reference_state():
    ref = ref_gen.small_test_cluster()
    _mutate(ref_cluster, ref)
    port = port_cluster.ClusterState.from_plain(ref_to_plain(ref))
    assert_same_state(ref, port)
    # the round trip through the port's own plain form is exact too
    again = port_cluster.ClusterState.from_plain(port.to_plain())
    assert_same_state(ref, again)


def test_from_plain_carries_used_bits():
    """Moves update ``used`` incrementally; the carried array, not a
    re-sum of shard sizes, is what the port's state holds."""
    ref = ref_gen.cluster_a()
    from repro.core.planner import create_planner
    create_planner("equilibrium_faithful").plan(ref, budget=20)
    port = port_cluster.ClusterState.from_plain(ref_to_plain(ref))
    assert port.used().view(np.int64).tolist() \
        == ref.used().view(np.int64).tolist()
    plain = ref_to_plain(ref)
    plain["used"] = plain["used"][:-1]
    with pytest.raises(ValueError, match="used"):
        port_cluster.ClusterState.from_plain(plain)
