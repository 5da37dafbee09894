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

    PYTHONPATH=src python tests/_ref_batch_counters.py   # about 75 s
    PYTHONPATH=src python tests/_ref_batch_counters.py --source-block 3 25

At ``source_block`` 1 (the default) the runs are keyed
``legality_cache=<bool>``, at any other block
``source_block=<kb>,legality_cache=<bool>``; the runs of other keys are
kept as they are (about 45 s a run).

Imports JAX: the card's tests and ``chip_smoke.py`` read the JSON only.
"""

from __future__ import annotations

import argparse
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


def as_recorded(run: dict) -> dict:
    """A run read back from the fixture as :func:`record` gives it: the
    histogram's keys integers again, so that the fixture is written in the
    same bytes however often it is recorded."""
    hist = {int(k): v for k, v in run["sources_tried_hist"].items()}
    return {**run, "sources_tried_hist": hist}


def run_key(source_block: int, cache: bool) -> str:
    """The fixture's key of a run."""
    key = f"legality_cache={cache}"
    return key if source_block == 1 else f"source_block={source_block},{key}"


def main(argv=None) -> int:
    from repro.core.clustergen import cluster_b
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source-block", type=int, nargs="+", default=[1],
                    help="source blocks to record (default 1)")
    args = ap.parse_args(argv)
    out = {"cluster": "cluster_b(scale=1)", "config": CLUSTER_B_CONFIG,
           "recorded_by": "tests/_ref_batch_counters.py", "runs": {}}
    if FIXTURE.is_file():
        out["runs"] = {key: as_recorded(run) for key, run in
                       json.loads(FIXTURE.read_text())["runs"].items()}
    with patched():
        for kb in args.source_block:
            for cache in (True, False):
                t0 = time.perf_counter()
                state = cluster_b(scale=1)
                cfg = {**CLUSTER_B_CONFIG, "source_block": kb}
                rec = record(state, legality_cache=cache, **cfg)
                out["runs"][run_key(kb, cache)] = rec
                print(f"{run_key(kb, cache)}: {rec['moves']} moves in "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
