"""The documented telemetry schemas: ``PlanResult.stats`` keys and the
trace record shapes.

``PlanResult.stats`` historically differed per engine (the batch engine
added ``warm``/``rebuilds``, only bounds-capable engines emitted the
prune counters, mgr emitted almost nothing), so every consumer branched
per planner.  :data:`STATS_SCHEMA` is the single contract: **every**
registered planner returns exactly these keys (equivalence-tested in
tests/test_obs.py), with engine-specific signals defaulting to their
neutral value where an engine has nothing to report.  Benchmarks, the
scenario engine and ``tools/tracestat.py`` all read these constants
instead of string literals.

Key groups:

* timing — :data:`PLANNING_SECONDS` (whole plan() wall),
  :data:`SELECTION_SECONDS` / :data:`APPLY_SECONDS` /
  :data:`MOVES_SECONDS` (the per-move split; fused engines attribute the
  whole move time to selection), :data:`TAIL_SECONDS` /
  :data:`TERMINAL_SCAN_SECONDS` (the convergence tail);
* the §3.1 walk — :data:`SOURCES_TRIED_HIST` (rank histogram, string
  keys), :data:`TAIL_MOVES` (moves with rank > 1);
* source-bound certificates — :data:`BOUND_HITS`, :data:`PRUNED_SOURCES`,
  :data:`SOURCE_BOUNDS`;
* batch-engine signals — :data:`HOST_SYNCS`, :data:`JIT_RECOMPILES`,
  :data:`STASH_MOVES`, :data:`REBUILDS`, :data:`ABSORBED_DELTAS`,
  :data:`WARM`, :data:`LEGALITY_CACHE`, :data:`CACHE_HITS`,
  :data:`CACHE_MISSES`, :data:`PIPELINE` (pipelined chunk dispatch
  active) and :data:`SHARDS` (mesh size of the sharded engine; 0 when
  planning unsharded) — 0 / False on engines without the machinery;
* fleet-service signals (:mod:`repro_torch.fleet`) — :data:`FLEET_CLUSTERS`
  (fleet size the plan was batched with; 0 outside a fleet tick),
  :data:`SLO_DEADLINE_SECONDS` / :data:`SLO_EXPIRED` (the latency-SLO
  knob and whether this plan was cut short by it — a partial but valid
  plan), :data:`PLAN_FRESHNESS_SECONDS` (plan-freshness lag: wall time
  between this cluster's delta sync and its plan emission),
  :data:`CONVERGED` / :data:`VARIANCE_AFTER` (plan-quality: did the
  engine certify no further move exists, and the utilization variance
  the plan left behind);
* identity — :data:`ENGINE`, :data:`BUDGET`.
"""

from __future__ import annotations

__all__ = [
    "PLANNING_SECONDS", "BUDGET", "ENGINE", "WARM", "REBUILDS",
    "ABSORBED_DELTAS", "HOST_SYNCS", "JIT_RECOMPILES", "STASH_MOVES",
    "SOURCES_TRIED_HIST", "TAIL_MOVES", "TAIL_SECONDS",
    "TERMINAL_SCAN_SECONDS", "SELECTION_SECONDS", "APPLY_SECONDS",
    "MOVES_SECONDS", "BOUND_HITS", "PRUNED_SOURCES", "SOURCE_BOUNDS",
    "LEGALITY_CACHE", "CACHE_HITS", "CACHE_MISSES", "PIPELINE",
    "SHARDS", "FLEET_CLUSTERS",
    "SLO_DEADLINE_SECONDS", "SLO_EXPIRED", "PLAN_FRESHNESS_SECONDS",
    "CONVERGED", "VARIANCE_AFTER", "STATS_SCHEMA",
    "finalize_stats", "validate_stats", "validate_trace",
]

PLANNING_SECONDS = "planning_seconds"
BUDGET = "budget"
ENGINE = "engine"
WARM = "warm"
REBUILDS = "rebuilds"
ABSORBED_DELTAS = "absorbed_deltas"
HOST_SYNCS = "host_syncs"
JIT_RECOMPILES = "jit_recompiles"
STASH_MOVES = "stash_moves"
SOURCES_TRIED_HIST = "sources_tried_hist"
TAIL_MOVES = "tail_moves"
TAIL_SECONDS = "tail_seconds"
TERMINAL_SCAN_SECONDS = "terminal_scan_seconds"
SELECTION_SECONDS = "selection_seconds"
APPLY_SECONDS = "apply_seconds"
MOVES_SECONDS = "moves_seconds"
BOUND_HITS = "bound_hits"
PRUNED_SOURCES = "pruned_sources"
SOURCE_BOUNDS = "source_bounds"
LEGALITY_CACHE = "legality_cache"
CACHE_HITS = "cache_hits"
CACHE_MISSES = "cache_misses"
PIPELINE = "pipeline"
SHARDS = "shards"
FLEET_CLUSTERS = "fleet_clusters"
SLO_DEADLINE_SECONDS = "slo_deadline_seconds"
SLO_EXPIRED = "slo_expired"
PLAN_FRESHNESS_SECONDS = "plan_freshness_seconds"
CONVERGED = "converged"
VARIANCE_AFTER = "variance_after"

#: key -> (accepted types, neutral default).  ``BUDGET`` may be None
#: (planner default); everything else is concrete.
STATS_SCHEMA: dict[str, tuple[tuple, object]] = {
    PLANNING_SECONDS: ((float,), 0.0),
    BUDGET: ((int, type(None)), None),
    ENGINE: ((str,), ""),
    WARM: ((bool,), False),
    REBUILDS: ((int,), 0),
    ABSORBED_DELTAS: ((int,), 0),
    HOST_SYNCS: ((int,), 0),
    JIT_RECOMPILES: ((int,), 0),
    STASH_MOVES: ((int,), 0),
    SOURCES_TRIED_HIST: ((dict,), None),    # default: fresh {} per call
    TAIL_MOVES: ((int,), 0),
    TAIL_SECONDS: ((float,), 0.0),
    TERMINAL_SCAN_SECONDS: ((float,), 0.0),
    SELECTION_SECONDS: ((float,), 0.0),
    APPLY_SECONDS: ((float,), 0.0),
    MOVES_SECONDS: ((float,), 0.0),
    BOUND_HITS: ((int,), 0),
    PRUNED_SOURCES: ((int,), 0),
    SOURCE_BOUNDS: ((bool,), False),
    LEGALITY_CACHE: ((bool,), False),
    CACHE_HITS: ((int,), 0),
    CACHE_MISSES: ((int,), 0),
    PIPELINE: ((bool,), False),
    SHARDS: ((int,), 0),
    FLEET_CLUSTERS: ((int,), 0),
    SLO_DEADLINE_SECONDS: ((float, type(None)), None),
    SLO_EXPIRED: ((bool,), False),
    PLAN_FRESHNESS_SECONDS: ((float,), 0.0),
    CONVERGED: ((bool,), False),
    VARIANCE_AFTER: ((float,), 0.0),
}


def finalize_stats(stats: dict) -> dict:
    """Fill every missing :data:`STATS_SCHEMA` key with its neutral
    default and return ``stats`` (mutated in place).  Every planner's
    ``plan()`` funnels its stats dict through here, which is what makes
    the cross-planner key set an invariant rather than a convention."""
    for key, (_types, default) in STATS_SCHEMA.items():
        if key not in stats:
            stats[key] = {} if key == SOURCES_TRIED_HIST else default
    return stats


def validate_stats(stats: dict) -> list[str]:
    """Schema-check one stats dict; returns human-readable problems
    (empty = valid).  Extra keys are allowed — the schema is a floor."""
    problems = []
    for key, (types, _default) in STATS_SCHEMA.items():
        if key not in stats:
            problems.append(f"missing key {key!r}")
        elif not isinstance(stats[key], types):
            problems.append(f"{key!r} has type {type(stats[key]).__name__},"
                            f" expected {'/'.join(t.__name__ for t in types)}")
    hist = stats.get(SOURCES_TRIED_HIST)
    if isinstance(hist, dict):
        for k, v in hist.items():
            if not (isinstance(k, str) and k.lstrip("-").isdigit()):
                problems.append(f"hist key {k!r} is not a string integer")
            if not isinstance(v, int):
                problems.append(f"hist count {v!r} is not an int")
    return problems


# ---------------------------------------------------------------------------
# Trace-record schema (the JSONL sink / Chrome export round-trip)

_SPAN_KEYS = {"ev", "name", "cat", "ts", "dur", "cpu", "id", "parent",
              "tid", "args"}
_POINT_KEYS = {"ev", "name", "cat", "ts", "args"}


def validate_trace(records: list[dict]) -> list[str]:
    """Structural check of a trace record list (from
    :func:`repro_torch.obs.trace.read_trace`); returns problems, empty = valid.
    Used by tests, ``tools/tracestat.py --validate`` and the CI trace
    artifact gate."""
    problems = []
    if not records:
        return ["empty trace"]
    if records[0].get("ev") != "meta":
        problems.append("first record is not the meta header")
    if not any(r.get("ev") == "counters" for r in records):
        problems.append("no counters footer (tracer not closed?)")
    span_ids = {0}
    for i, r in enumerate(records):
        ev = r.get("ev")
        if ev == "span":
            missing = _SPAN_KEYS - set(r)
            if missing:
                problems.append(f"record {i}: span missing {sorted(missing)}")
                continue
            if not isinstance(r["args"], dict):
                problems.append(f"record {i}: span args not a dict")
            if r["dur"] < 0 or (r["cpu"] is not None and r["cpu"] < 0):
                problems.append(f"record {i}: negative duration")
            span_ids.add(r["id"])
        elif ev == "point":
            missing = _POINT_KEYS - set(r)
            if missing:
                problems.append(f"record {i}: point missing {sorted(missing)}")
        elif ev == "counters":
            if not isinstance(r.get("values"), dict):
                problems.append(f"record {i}: counters footer without values")
        elif ev == "meta":
            if i != 0:
                problems.append(f"record {i}: stray meta record")
        else:
            problems.append(f"record {i}: unknown ev {ev!r}")
    for i, r in enumerate(records):
        if r.get("ev") == "span" and r.get("parent") not in span_ids:
            problems.append(f"record {i}: dangling parent {r['parent']}")
    return problems
