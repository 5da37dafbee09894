"""Label-set metrics registry: counters, gauges, histograms.

One process-global :class:`MetricsRegistry` (:func:`registry`) is the
single accumulation point for every counter the planners, the batch
engine, the certificate ledger and the scenario engine maintain — the
"one telemetry spine" replacing the per-engine ``stats_out`` threading.
Instruments are plain dict adds (no locks, no allocation beyond the
label key), cheap enough to stay always-on; anything hotter than
per-chunk/per-plan frequency accumulates locally and flushes here
(see :mod:`repro_torch.core.tail`), so the hot loops never pay per-event.

Naming: dotted lowercase (``batch.host_syncs``, ``tail.bound_hits``);
labels are keyword pairs (``inc("absorb.deltas", type="PoolGrowthDelta")``)
rendered as ``name{k=v,...}`` in snapshots, sorted by key.  The snapshot
form is what lands in the trace footer (:mod:`repro_torch.obs.trace`) and what
``tools/tracestat.py`` reads back.
"""

from __future__ import annotations

__all__ = ["MetricsRegistry", "registry", "labelled"]


def labelled(name: str, labels: dict | None = None) -> str:
    """Canonical flat key: ``name`` or ``name{k=v,...}`` (keys sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Counters / gauges / histograms keyed by ``name{labels}``.

    * counter — monotonic float/int sum (:meth:`inc`);
    * gauge — last-written value (:meth:`set_gauge`);
    * histogram — running (count, sum, min, max) per key
      (:meth:`observe`) — enough for means and extrema without
      bucket-boundary bikeshedding.
    """

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list] = {}   # [count, sum, min, max]

    # -- instruments ---------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = labelled(name, labels)
        self.counters[key] = self.counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[labelled(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        key = labelled(name, labels)
        h = self.histograms.get(key)
        if h is None:
            self.histograms[key] = [1, value, value, value]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)

    # -- reads ---------------------------------------------------------

    def get(self, name: str, **labels) -> float:
        """Current counter value (0 when never incremented)."""
        return self.counters.get(labelled(name, labels), 0)

    def total(self, prefix: str) -> float:
        """Sum of every counter whose key starts with ``prefix``
        (aggregates across label sets: ``total("absorb.deltas")``)."""
        return sum(v for k, v in self.counters.items()
                   if k.startswith(prefix))

    def snapshot(self, prefix: str = "") -> dict[str, float]:
        """Copy of the counter map (optionally key-prefix filtered)."""
        if not prefix:
            return dict(self.counters)
        return {k: v for k, v in self.counters.items()
                if k.startswith(prefix)}

    def deltas_since(self, snap: dict[str, float],
                     prefix: str = "") -> dict[str, float]:
        """Counter increments since ``snap`` (a :meth:`snapshot`),
        dropping zero deltas — the per-span counter attribution the
        tracer attaches to ``counters=True`` spans."""
        out = {}
        for k, v in self.counters.items():
            if prefix and not k.startswith(prefix):
                continue
            d = v - snap.get(k, 0)
            if d:
                out[k] = d
        return out

    def dump(self) -> dict:
        """JSON-able full state (trace footer / tracestat input)."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: {"count": h[0], "sum": h[1],
                               "min": h[2], "max": h[3]}
                           for k, h in self.histograms.items()},
        }


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented module writes to."""
    return _REGISTRY
