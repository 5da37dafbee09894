"""The JAX package's ``ShardedBatchPlanner`` as the arbiter of the port's
sharded engine.

:data:`CASES` names the plans both packages play and :func:`drive` plays
one through either package's ``create_planner("equilibrium_batch_sharded")``
(or, for the port's serial lane, ``"equilibrium_batch"``) under that
package's tracer: each plan call's moves, variances after each move,
sources tried, certificate counters and the registry deltas of
:data:`COUNTERS`, the per-shard ``batch.shard.*`` counters included.

Run as a script, it plays the named cases (default all) on the
reference's sharded engine with a mesh of ``--mesh`` devices (JAX fixes
the device count at start, so the script sets
``XLA_FLAGS=--xla_force_host_platform_device_count`` before importing it)
and prints the records as one JSON line keyed by case::

    PYTHONPATH=src python tests/_ref_shard.py --mesh 2

``repro.core.shard`` imports ``jax.experimental.enable_x64``, which JAX
0.9 lacks, and its engine needs ``tests/_ref_batch_counters.py::
reference_attrs``: the script binds both for its own process only.
:func:`port_ranks` is what each rank of a ``spawn_ranks`` group runs on
the port.  This module imports neither package at its top, so that a
rank process stays light.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: registry counters held equal (the per-shard ones are added by name)
COUNTERS = ("batch.tiles_walked", "batch.cand_tiles", "batch.rebuilds",
            "absorb.runs")
SHARD_COUNTERS = ("batch.shard.tiles_walked", "batch.shard.cand_tiles",
                  "batch.shard.wins")

#: name -> (cluster generator, planner options, warm): cluster A has 14
#: devices (padded at 4 ranks), small_test_cluster 16 (divides 1, 2, 4),
#: the uniform cluster 16 of one size whose equal utilizations tie the
#: ranks' winners (:func:`uniform_cluster`);
#: ``pad`` widens the padding by one block of the rank count; a warm case
#: plans 8 moves, then grows the first pool, marks the last device out
#: and adds an empty device, and plans to convergence (the carry gathered
#: back to its natural width, absorbed, partitioned at the new width)
CASES = {
    "a": ("cluster_a", {}, False),
    "a_nobounds": ("cluster_a", {"source_bounds": False}, False),
    "a_kb3": ("cluster_a", {"source_block": 3}, False),
    "small": ("small_test_cluster", {}, False),
    "ties": ("uniform_cluster", {}, False),
    "a_pad": ("cluster_a", {"pad": True}, False),
    "a_warm": ("cluster_a", {}, True),
}


def uniform_cluster(clustergen):
    """16 devices of 4 TiB, two a host, and one 3x pool of 48 PGs of
    equal shards (no size jitter): devices holding as many shards share a
    utilization, so the emptiest legal destination ties across the ranks'
    blocks."""
    g = clustergen
    devs = [g.Device(id=i, capacity=4 * g.TiB, device_class="hdd",
                     host=f"host{i // 2}") for i in range(16)]
    pools = [g.Pool(0, "uniform", 48, g.PlacementRule.replicated(3, "host"),
                    stored_bytes=0.3 * 16 * 4 * g.TiB / 3)]
    return g.build_cluster(devs, pools, seed=7, size_jitter=0.0)


def options(case: str, n_shards: int) -> dict:
    """The case's planner options at ``n_shards`` ranks: ``pad`` becomes
    ``pad_devices``, one block of ranks past the natural padded width, as
    ``tools/shard_check.py`` sets it."""
    opts = dict(CASES[case][1])
    if opts.pop("pad", False):
        opts["pad_devices"] = n_shards * (14 // n_shards + 1)
    return opts


def mutate(state, cluster_mod) -> None:
    """The warm case's deltas: growth, a device out, an empty device."""
    pid = sorted(state.pools)[0]
    state.grow_pool(pid, state.pools[pid].stored_bytes * 0.4)
    state.mark_out(state.devices[-1].id, True)
    base = state.devices[0]
    state.add_device(cluster_mod.Device(
        id=1 + max(d.id for d in state.devices), capacity=base.capacity,
        device_class=base.device_class, host="added0", rack=base.rack))


def drive(case: str, clustergen, cluster_mod, obs, create_planner,
          planner: str = "equilibrium_batch_sharded", **kw) -> list[dict]:
    """One case of :data:`CASES` through ``create_planner(planner, **kw,
    **options)`` (each argument from one package); one record a plan
    call."""
    gen, _, warm = CASES[case]
    state = (uniform_cluster(clustergen) if gen == "uniform_cluster"
             else getattr(clustergen, gen)())
    # the registry drops the options a planner does not take
    p = create_planner(planner, **kw,
                       **options(case, kw.get("n_shards") or 1))
    reg = obs.registry()
    plans = []
    for budget in ((8, None) if warm else (None,)):
        if plans:
            mutate(state, cluster_mod)
        with obs.tracing():
            snap = reg.snapshot()
            res = p.plan(state, budget=budget, record_trajectory=True)
            deltas = reg.deltas_since(snap)
        plans.append({
            "moves": [[list(m.pg), m.slot, m.src_osd, m.dst_osd]
                      for m in res.moves],
            "variance_after": [r.variance_after for r in res.records],
            "sources_tried": [r.sources_tried for r in res.records],
            "pruned_sources": res.stats["pruned_sources"],
            "bound_hits": res.stats["bound_hits"],
            "counters": {key: int(v) for key, v in sorted(deltas.items())
                         if key in COUNTERS
                         or key.split("{")[0] in SHARD_COUNTERS}})
    return plans


def port_ranks(cases: tuple) -> dict:
    """What each rank of a port ``spawn_ranks`` group runs: every case on
    the port's sharded engine on the CPU, one torch thread a rank."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import obs
    from repro_torch.core import cluster, clustergen
    from repro_torch.core.planner import create_planner
    return {case: drive(case, clustergen, cluster, obs, create_planner,
                        device="cpu", n_shards=dist.get_world_size())
            for case in cases}


def reference(cases, mesh: int) -> dict:
    """Every case on the reference's sharded engine at a mesh of ``mesh``
    devices (this process only: the bindings stay)."""
    import jax
    import jax.experimental
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    assert len(jax.devices()) == mesh, (jax.devices(), mesh)
    from _ref_batch_counters import patched
    with patched():
        from repro import obs
        from repro.core import cluster, clustergen
        from repro.core.planner import create_planner
        return {case: drive(case, clustergen, cluster, obs, create_planner,
                            n_shards=mesh)
                for case in cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=1,
                    help="devices of the forced host mesh")
    ap.add_argument("cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    if "jax" not in sys.modules:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
            f"device_count={args.mesh}").strip()
    print(json.dumps(reference(args.cases, args.mesh)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
