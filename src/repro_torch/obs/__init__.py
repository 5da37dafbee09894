"""``repro_torch.obs`` — the telemetry spine: structured tracing + metrics.

One zero-dependency layer carries every signal from the planner hot loop
to the scenario artifacts:

* :mod:`repro_torch.obs.trace` — span tracer (nested spans, monotonic
  wall/CPU timing, JSONL sink, Chrome/Perfetto export) with a no-op
  fast path: ``obs.span(...)`` costs one global read when tracing is
  disabled and never perturbs plan bit-identity;
* :mod:`repro_torch.obs.metrics` — the process-global metrics registry
  (counters / gauges / histograms with label sets) every engine writes
  through instead of hand-threaded ``stats_out`` dicts;
* :mod:`repro_torch.obs.schema` — the documented ``PlanResult.stats`` key set
  (every registered planner emits the same schema) and the trace-record
  schema validation used by tests, CI and ``tools/tracestat.py``.

Typical producer::

    from repro_torch import obs

    with obs.span("sim.tick", cat="sim", tick=t):
        ...
    obs.registry().inc("batch.host_syncs")

Typical consumer::

    with obs.tracing("run.jsonl"):
        planner.plan(state)
    summary = obs.read_trace("run.jsonl")

``python tools/tracestat.py run.jsonl`` summarizes a trace (top spans,
syncs/move, prune rate, tail share, absorb/rebuild table) and converts
it for Perfetto.
"""

from .metrics import MetricsRegistry, labelled, registry
from .schema import (STATS_SCHEMA, finalize_stats, validate_stats,
                     validate_trace)
from .trace import (Span, Tracer, enabled, point, read_trace, span,
                    start_tracing, stop_tracing, to_chrome, tracer, tracing)

__all__ = [
    # metrics
    "MetricsRegistry", "registry", "labelled",
    # tracing
    "Tracer", "Span", "enabled", "tracer", "tracing", "start_tracing",
    "stop_tracing", "span", "point", "read_trace", "to_chrome",
    # schema
    "STATS_SCHEMA", "finalize_stats", "validate_stats", "validate_trace",
]
