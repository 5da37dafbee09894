"""Lockstep runs of the port's batch engine against the JAX package's,
shared by the tests that hold the port's counters to the reference's
(``test_torch_batch_optins.py``, ``test_torch_source_block.py``).

:func:`lockstep` plans the same seed-built cluster with both engines,
mutated in lockstep between calls (:data:`WARM`'s deltas), and requires
every plan call's record (``_ref_batch_counters.counted_plan``) to be
equal.  The reference engine runs only where the test binds
``_ref_batch_counters.reference_attrs``."""

import repro.core.equilibrium_batch as ref_batch
from _ref_batch_counters import counted_plan
from repro import obs as ref_obs
from repro.core import Device as RefDevice
from repro.core import Movement as RefMovement
from repro.core import PlacementRule as RefRule
from repro.core import Pool as RefPool
from repro.core import clustergen as ref_gen
from repro.core.crush import place_pg as ref_place
from repro.core.equilibrium import EquilibriumConfig as RefConfig
from repro_torch import obs
from repro_torch.core import (Device, Movement, PlacementRule, Pool, TiB,
                              legality, place_pg)
from repro_torch.core import clustergen as port_gen
from repro_torch.core.equilibrium import EquilibriumConfig
from repro_torch.core.equilibrium_batch import BatchPlanner

#: the registry counters as the literal rows list them
ROW = ("tiles_walked", "cand_tiles", "cache_hits", "cache_misses",
       "cache_repairs", "chunks_overlapped", "repads")


def grow(pool_bytes):
    def fn(port, ref):
        for s in (port, ref):
            s.grow_pool(min(s.pools), pool_bytes)
    return fn


def lockstep(cluster: str, budgets, between=None, cfg=None, **kw
             ) -> list[dict]:
    """Plan each budget of ``budgets`` (None: to convergence) with the
    reference engine and the port, each bound to its package's build of
    ``cluster`` (a name in both ``clustergen`` modules) and with the
    engine options ``kw``; ``between[i](port_state, ref_state)`` mutates
    both states before plan ``i``.  Every plan call's record
    (:func:`counted_plan`) must be equal; returns the port's."""
    port_state = getattr(port_gen, cluster)()
    ref_state = getattr(ref_gen, cluster)()
    ref = ref_batch.BatchPlanner(ref_state, RefConfig(**(cfg or {})), **kw)
    port = BatchPlanner(port_state, EquilibriumConfig(**(cfg or {})),
                        device="cpu", **kw)
    got = []
    for i, budget in enumerate(budgets):
        if between and i in between:
            between[i](port_state, ref_state)
        want = counted_plan(ref, ref_obs, budget)
        have = counted_plan(port, obs, budget)
        assert have == want, (i, {key: (have[key], want[key])
                                  for key in have if have[key] != want[key]})
        got.append(have)
    return got


def totals(records: list[dict]) -> dict:
    """Moves and counters summed over plan calls, keyed as :data:`ROW`."""
    out = {"moves": sum(len(r["moves"]) for r in records)}
    for key in ROW:
        out[key] = sum(r[f"batch.{key}"] for r in records)
    return out


def quiet_move(state, avoid):
    """A legal move that leaves every certificate of the devices ``avoid``
    standing: off the emptiest device that can shed a shard whose PG none
    of them holds, from a pool whose destination-count criterion already
    passes there (no count flip), onto the emptiest device that takes
    it."""
    util = state.utilization()
    order = sorted(range(len(util)), key=lambda i: (util[i], i))
    ids = {state.devices[i].id for i in avoid}
    slack = EquilibriumConfig().count_slack
    for i in order:
        osd = state.devices[i].id
        for pg, slot in sorted(state.shards_on[osd]):
            pool = state.pools[pg[0]]
            if osd in ids or ids & set(state.acting[pg]) \
                    or not legality.dst_count_ok(
                        state.pool_counts[pg[0]][i],
                        state.ideal_shard_count(pool)[i], slack):
                continue
            for j in order:
                dst = state.devices[j].id
                if dst not in ids and state.move_is_legal(pg, slot, dst):
                    return pg, slot, osd, dst, state.shard_sizes[pg]
    raise AssertionError("no quiet move")


def pool_create(port, ref):
    for s, m, place in ((port, (Pool, PlacementRule), place_pg),
                        (ref, (RefPool, RefRule), ref_place)):
        pid = 1 + max(s.pools)
        pool = m[0](pid, "fresh", 8, m[1].replicated(2, "host", "hdd"),
                    stored_bytes=0.4 * TiB)
        s.add_pool(pool, {(pid, i): place(s.devices, pool, i, seed=3)
                          for i in range(8)},
                   {(pid, i): pool.nominal_shard_size for i in range(8)})


def foreign(port, ref):
    pg, slot, src, dst, size = quiet_move(port, [])
    port.apply(Movement(pg, slot, src, dst, size))
    ref.apply(RefMovement(pg, slot, src, dst, size))


def each(fn):
    def both(port, ref):
        fn(port, Device)
        fn(ref, RefDevice)
    return both


#: the warm sequence's mutations, before the plan of the same index
WARM = {
    1: grow(0.5e12),
    2: each(lambda s, D: s.mark_out(s.devices[1].id)),
    3: each(lambda s, D: s.mark_out(s.devices[1].id, out=False)),
    4: each(lambda s, D: s.add_device(D(id=900, capacity=8 * TiB,
                                         device_class="hdd", host="hx"))),
    5: foreign,
    6: pool_create,
}
