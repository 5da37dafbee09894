"""The JAX package's ``FleetPlanner`` as the arbiter of the port's fleet.

``repro.fleet`` imports ``jax.experimental.enable_x64``, which JAX 0.9
lacks, and its lanes run the reference's batch engine, which needs the
attributes of ``tests/_ref_batch_counters.py::reference_attrs``.  Run as
a script, this module binds both (``jax.experimental`` for the process,
so only in a process of its own) and plays the named cases of
:data:`CASES` through the reference's fleet, printing :func:`drive`'s
records as one
JSON line keyed by case::

    PYTHONPATH=src python tests/_ref_fleet.py delta_stream multi_bucket

:func:`drive` plays a case through either package's fleet: a few ticks
of every lane at one budget, each lane's state mutated before every tick
by :func:`mutate` (pool growth, a device out or back in, a foreign move)
where the case says so, then ticks until every lane has converged, all
under the package's tracer.  It records each tick's moves and
certificate counters per lane and the ``fleet.*`` / ``batch.*`` registry
deltas of :data:`COUNTERS`.  tests/test_torch_fleet.py holds the port's
record to this one's.  Every case pads devices in each lane (9, 10, 12,
18 and 20 devices in buckets of 16 and 32).
"""

from __future__ import annotations

import json
import sys

#: registry counters the port's fleet is held to
COUNTERS = ("fleet.rounds", "fleet.chunks", "fleet.rebuckets",
            "fleet.rounds.overlapped", "fleet.ticks", "fleet.planned_moves",
            "batch.tiles_walked", "batch.cand_tiles")
#: per-plan stats held equal (wall times and engine labels differ)
STAT_KEYS = ("bound_hits", "pruned_sources", "tail_moves",
             "sources_tried_hist")
GiB = 1 << 30

#: name -> (lanes as (n_hdd, seed, empty devices added, row_capacity),
#: ticks with deltas, budget, whether deltas stream in).  A row capacity
#: of 1 starts the lane at its fullest device's rows, so that the lane
#: outgrows its bucket's row axis mid-tick.
CASES = {
    "delta_stream": ([(9, 0, 0, None), (12, 1, 0, None), (9, 2, 0, None)],
                     3, 8, True),
    "multi_bucket": ([(9, 3, 0, None), (18, 4, 0, None)], 2, 8, False),
    "empty_device": ([(9, 5, 1, None), (12, 6, 0, None)], 2, 8, True),
    "rebucket": ([(17, 0, 0, 1), (9, 1, 0, None), (18, 1, 0, 1)], 2, 24,
                 True),
}


def build(clustergen, cluster_mod, n_hdd: int, seed: int, empty: int):
    """``sim_cluster(seed, n_hdd, n_ssd=0, fill=0.6)`` and ``empty`` new
    devices with no shards (real devices at utilization 0.0, which sort
    before the pad devices only by index)."""
    state = clustergen.sim_cluster(seed=seed, n_hdd=n_hdd, n_ssd=0,
                                   fill=0.6)
    base = state.devices[0]
    next_id = 1 + max(d.id for d in state.devices)
    for j in range(empty):
        state.add_device(cluster_mod.Device(
            id=next_id + j, capacity=base.capacity,
            device_class=base.device_class, host=f"empty{j}",
            rack=base.rack))
    return state


def first_legal_move(state, movement):
    for pg in sorted(state.acting):
        for slot, osd in enumerate(state.acting[pg]):
            for dev in state.devices:
                if dev.id != osd and state.move_is_legal(pg, slot, dev.id):
                    return movement(pg, slot, osd, dev.id,
                                    state.shard_sizes[pg])
    raise AssertionError("no legal move in the cluster")


def mutate(t: int, key_idx: int, state, movement) -> None:
    """The tick's delta of one lane: pool growth, a device out / in flip,
    or a foreign movement, in turn."""
    kind = (t + key_idx) % 3
    if kind == 0:
        state.grow_pool(0, 512 * GiB)
    elif kind == 1:
        osd = state.devices[-1].id
        state.mark_out(osd, osd not in state.out_osds)
    else:
        state.apply(first_legal_move(state, movement))


def drive(case: str, clustergen, cluster_mod, obs, make_fleet,
          max_drain: int = 40) -> dict:
    """One case of :data:`CASES` through a fleet of ``make_fleet(chunk=8,
    row_block=8)`` under ``obs``'s tracer (each argument from one
    package): every tick's moves and :data:`STAT_KEYS` per lane, and the
    deltas of :data:`COUNTERS`."""
    lanes, ticks, budget, deltas = CASES[case]
    fleet = make_fleet(chunk=8, row_block=8)
    states = {}
    for j, (*spec, row_capacity) in enumerate(lanes):
        states[f"c{j}"] = build(clustergen, cluster_mod, *spec)
        fleet.add_cluster(f"c{j}", states[f"c{j}"],
                          row_capacity=row_capacity)
    reg = obs.registry()
    plans = []
    with obs.tracing():
        snap = reg.snapshot()
        for t in range(ticks + max_drain):
            if deltas and t < ticks:
                for j, state in enumerate(states.values()):
                    mutate(t, j, state, cluster_mod.Movement)
            res = fleet.plan_fleet({k: budget for k in states})
            plans.append({k: {"moves": [[m.pg, m.slot, m.src_osd, m.dst_osd]
                                        for m in r.moves],
                              **{s: r.stats[s] for s in STAT_KEYS}}
                          for k, r in res.items()})
            if t >= ticks and all(r.stats["converged"]
                                  for r in res.values()):
                break
        d = reg.deltas_since(snap)
    return {"plans": plans,
            "counters": {c: int(d.get(c, 0)) for c in COUNTERS},
            "variance": {k: s.utilization_variance()
                         for k, s in states.items()}}


def reference(case: str) -> dict:
    """:func:`drive` on the JAX package's fleet (this process only: the
    binding on ``jax.experimental`` stays)."""
    import jax
    import jax.experimental
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    from _ref_batch_counters import patched
    with patched():
        from repro import obs
        from repro.core import cluster, clustergen
        from repro.fleet import FleetPlanner
        return drive(case, clustergen, cluster, obs, FleetPlanner)


if __name__ == "__main__":
    print(json.dumps({case: reference(case) for case in sys.argv[1:]}))
