"""The JAX package's batch engine as the arbiter of the port's counters.

``repro.core.equilibrium_batch`` runs on JAX's CPU backend once three of
its module attributes are bound (:func:`reference_attrs`): JAX 0.9 has no
``jax.experimental.enable_x64``, so the module's guarded import leaves
``enable_x64`` and ``compact_parked`` unbound and ``_HAVE_JAX`` False.
With them set, ``BatchPlanner`` plans with its own ``lax.scan`` chunk and
``lax.while_loop`` tile walk, and its registry counts the tiles it walked,
the tiles that held a candidate, the legality cache's hits, misses and
repairs, the pipelined chunks, re-pads and stash moves.  Nothing in the
JAX package is edited: the tests bind the attributes with pytest's
``monkeypatch``; :func:`patched` does it for a script.

:func:`counted_plan` runs one plan call of either package's
``BatchPlanner`` under that package's tracer and returns what the tests
compare.  Run as a script, this module records the reference engine's
counters on ``cluster_b(scale=1)`` to convergence (chunk 64, row_block 8,
the legality cache on and off) into
``tests/fixtures/batch_counters_cluster_b.json``, which ``chip_smoke.py``
holds the port's run on the card to::

    PYTHONPATH=src python tests/_ref_batch_counters.py   # about 45 s

Imports JAX: the card's tests and ``chip_smoke.py`` read the JSON only.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import sys
import time

import jax

import repro.core.equilibrium_batch as ref_batch
from repro.kernels import select_move as ref_select_move

#: the registry counters every comparison holds equal, per plan call
COUNTERS = ("batch.tiles_walked", "batch.cand_tiles", "batch.cache_hits",
            "batch.cache_misses", "batch.cache_repairs",
            "batch.chunks_overlapped", "batch.repads", "batch.stash_moves",
            "batch.rebuilds")
FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "batch_counters_cluster_b.json")
#: the engine configuration the fixture was recorded with
CLUSTER_B_CONFIG = {"chunk": 64, "row_block": 8, "source_block": 1,
                    "source_bounds": True, "pipeline": True}


def reference_attrs() -> list[tuple[object, str, object]]:
    """(module, attribute, value) that let the reference engine run
    here."""
    return [(ref_batch, "compact_parked", ref_select_move.compact_parked),
            (ref_batch, "enable_x64", lambda: jax.enable_x64(True)),
            (ref_batch, "_HAVE_JAX", True)]


@contextlib.contextmanager
def patched():
    """:func:`reference_attrs` bound for the block, then restored."""
    missing = object()
    saved = [(mod, name, getattr(mod, name, missing))
             for mod, name, _ in reference_attrs()]
    for mod, name, value in reference_attrs():
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            if value is missing:
                delattr(mod, name)
            else:
                setattr(mod, name, value)


def counted_plan(planner, obs, budget: int | None = None) -> dict:
    """One ``planner.plan`` call under ``obs.tracing()`` (``obs``: the
    planner's own package's), with the moves, the certificate counters
    of its stats and the deltas of :data:`COUNTERS`.  ``host_syncs`` is
    not kept: the reference fetches the pruned-source count in a sync of
    its own, which the port packs into its chunk fetch."""
    reg = obs.registry()
    stats: dict = {}
    with obs.tracing():
        snap = reg.snapshot()
        moves, _ = planner.plan(max_moves=budget, stats_out=stats)
        deltas = reg.deltas_since(snap)
    return {"moves": [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves],
            "sources_tried_hist": {int(k): int(v) for k, v in
                                   stats["sources_tried_hist"].items()},
            "bound_hits": int(stats["bound_hits"]),
            "pruned_sources": int(stats["pruned_sources"]),
            **{key: int(deltas.get(key, 0)) for key in COUNTERS}}


def record(state, **kw) -> dict:
    """The reference engine's :func:`counted_plan` of one plan of
    ``state`` to convergence (hold :func:`patched` or the fixture), with
    the move list cut to its length."""
    from repro import obs
    rec = counted_plan(ref_batch.BatchPlanner(state, **kw), obs)
    return {"moves": len(rec.pop("moves")), **rec}


def main() -> int:
    from repro.core.clustergen import cluster_b
    out = {"cluster": "cluster_b(scale=1)", "config": CLUSTER_B_CONFIG,
           "recorded_by": "tests/_ref_batch_counters.py", "runs": {}}
    with patched():
        for cache in (True, False):
            t0 = time.perf_counter()
            state = cluster_b(scale=1)
            rec = record(state, legality_cache=cache, **CLUSTER_B_CONFIG)
            out["runs"][f"legality_cache={cache}"] = rec
            print(f"legality_cache={cache}: {rec['moves']} moves in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
