"""Span tracer: nested spans, monotonic wall/CPU timing, JSONL sink,
Chrome/Perfetto ``trace.json`` export.

Zero dependencies, and a no-op fast path: when no tracer is installed
(:func:`enabled` is False, the default) :func:`span` returns a shared
inert singleton — one module-attribute read and one ``is None`` test per
call site, so instrumented code costs ~nothing and, because every write
happens host-side at span close, never perturbs plan bit-identity
(property-tested in tests/test_obs.py).

Event records (one JSON object per line in the ``.jsonl`` sink):

* ``{"ev": "meta", "version": 1, ...}`` — header (first line);
* ``{"ev": "span", "name", "cat", "ts", "dur", "cpu", "id", "parent",
  "tid", "args"}`` — a closed span; ``ts``/``dur`` are µs on the
  monotonic wall clock (``perf_counter``) relative to tracer start,
  ``cpu`` is µs of process CPU time (``process_time``);
* ``{"ev": "point", "name", "cat", "ts", "args"}`` — an instant event
  (a dense rebuild, an absorbed delta run, an overshoot stash);
* ``{"ev": "counters", "ts", "values", "gauges", "histograms"}`` — the
  final registry snapshot, written once by :meth:`Tracer.close` (the
  footer ``tools/tracestat.py`` and the CI counter assertions read).

A sink path ending in ``.jsonl`` gets the native line format; any other
path gets the same information as a Chrome JSON trace object
(``{"traceEvents": [...]}``), loadable directly in Perfetto / chrome://
tracing.  :func:`read_trace` normalizes both back to record dicts.
"""

from __future__ import annotations

import json
import threading
import time

from .metrics import registry

__all__ = ["Tracer", "Span", "enabled", "tracer", "start_tracing",
           "stop_tracing", "tracing", "span", "point", "read_trace",
           "to_chrome"]

TRACE_VERSION = 1

_tracer: "Tracer | None" = None
_lock = threading.Lock()


def enabled() -> bool:
    """True iff a tracer is installed (spans are live, not no-ops)."""
    return _tracer is not None


def tracer() -> "Tracer | None":
    return _tracer


class _NoopSpan:
    """Inert stand-in returned while tracing is disabled.  Carries the
    real Span surface so call sites never branch; timing reads are 0."""

    __slots__ = ()
    wall_s = 0.0
    cpu_s = 0.0
    args: dict = {}         # read-only empty view (set() discards writes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class Span:
    """One timed region.  Use as a context manager; attributes set via
    :meth:`set` (or the ``span(...)`` kwargs) land in the record's
    ``args``.  ``counters=True`` additionally attaches the global
    registry's counter deltas over the span's lifetime as
    ``args["counters"]`` — the per-plan / per-bench-row attribution the
    trace consumers aggregate."""

    __slots__ = ("_tracer", "name", "cat", "args", "_counters", "_snap",
                 "_t0", "_c0", "wall_s", "cpu_s", "id", "parent", "_tid")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 counters: bool, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._counters = counters
        self.wall_s = 0.0
        self.cpu_s = 0.0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        t = self._tracer
        self.id = t._next_id()
        self._tid = threading.get_ident()
        stack = t._stack()
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        if self._counters:
            self._snap = registry().snapshot()
        self._c0 = time.process_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        c1 = time.process_time()
        self.wall_s = t1 - self._t0
        self.cpu_s = c1 - self._c0
        t = self._tracer
        stack = t._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        if self._counters:
            deltas = registry().deltas_since(self._snap)
            if deltas:
                self.args["counters"] = deltas
        t._emit({
            "ev": "span", "name": self.name, "cat": self.cat,
            "ts": t._us(self._t0), "dur": round(self.wall_s * 1e6, 3),
            "cpu": round(self.cpu_s * 1e6, 3), "id": self.id,
            "parent": self.parent, "tid": self._tid,
            "args": self.args,
        })
        return False


class Tracer:
    """Collects records and writes them to ``path`` on :meth:`close`
    (or keeps them in memory when ``path`` is None — the test sink)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = [
            {"ev": "meta", "version": TRACE_VERSION,
             "clock": "perf_counter_us"}]
        self._epoch = time.perf_counter()
        self._id = 0
        self._local = threading.local()
        self._closed = False

    # -- internals -----------------------------------------------------

    def _us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 3)

    def _next_id(self) -> int:
        with _lock:
            self._id += 1
            return self._id

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, record: dict) -> None:
        self.records.append(record)

    # -- producer API --------------------------------------------------

    def span(self, name: str, /, cat: str = "", counters: bool = False,
             **args) -> Span:
        return Span(self, name, cat, counters, args)

    def point(self, name: str, /, cat: str = "", **args) -> None:
        self._emit({"ev": "point", "name": name, "cat": cat,
                    "ts": self._us(time.perf_counter()), "args": args})

    def close(self) -> list[dict]:
        """Append the registry footer and write the sink; idempotent.
        Returns the record list (the in-memory sink)."""
        if self._closed:
            return self.records
        self._closed = True
        dump = registry().dump()
        self.records.append({
            "ev": "counters", "ts": self._us(time.perf_counter()),
            "values": dump["counters"], "gauges": dump["gauges"],
            "histograms": dump["histograms"]})
        if self.path:
            if self.path.endswith(".jsonl"):
                with open(self.path, "w") as f:
                    for r in self.records:
                        f.write(json.dumps(r, sort_keys=True) + "\n")
            else:
                with open(self.path, "w") as f:
                    json.dump(to_chrome(self.records), f)
        return self.records


# ---------------------------------------------------------------------------
# Module-level producer API (the instrumented call sites)


def span(name: str, /, cat: str = "", counters: bool = False, **args):
    """A live span when tracing is enabled, the shared no-op otherwise.
    This is the only call instrumented hot paths make — its disabled
    cost is one global read and one comparison."""
    t = _tracer
    if t is None:
        return _NOOP
    return t.span(name, cat, counters, **args)


def point(name: str, /, cat: str = "", **args) -> None:
    """Instant event (no duration); dropped when tracing is disabled."""
    t = _tracer
    if t is not None:
        t.point(name, cat, **args)


def start_tracing(path: str | None = None) -> Tracer:
    """Install a process-global tracer writing to ``path`` on stop
    (in-memory when None).  Raises if one is already installed."""
    global _tracer
    with _lock:
        if _tracer is not None:
            raise RuntimeError("tracing already started")
        t = Tracer(path)
    _tracer = t         # publish only after construction
    return t


def stop_tracing() -> list[dict]:
    """Uninstall the tracer, close its sink, return the records."""
    global _tracer
    with _lock:
        t, _tracer = _tracer, None
    if t is None:
        return []
    return t.close()


class tracing:
    """``with tracing("run.jsonl") as t:`` — scoped start/stop."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []

    def __enter__(self) -> Tracer:
        self.tracer = start_tracing(self.path)
        return self.tracer

    def __exit__(self, *exc) -> bool:
        self.records = stop_tracing()
        return False


# ---------------------------------------------------------------------------
# Consumers (tracestat, tests, CI)


def read_trace(path: str) -> list[dict]:
    """Load a trace back into record dicts — accepts both the native
    JSONL sink and the Chrome JSON export."""
    with open(path) as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(obj, dict) and "traceEvents" in obj:
        return _from_chrome(obj)
    return [obj]        # a one-record .jsonl parses whole-file too


def to_chrome(records: list[dict]) -> dict:
    """Convert native records to the Chrome trace-event JSON object
    Perfetto loads.  Spans become complete ("X") events; points become
    instants ("i"); the counters footer becomes one metadata instant
    (args carry the full registry dump) so nothing is lost round-trip."""
    events = []
    for r in records:
        ev = r.get("ev")
        if ev == "span":
            events.append({"ph": "X", "name": r["name"], "cat": r["cat"]
                           or "span", "ts": r["ts"], "dur": r["dur"],
                           "pid": 0, "tid": r.get("tid", 0),
                           "args": {**r.get("args", {}),
                                    "cpu_us": r.get("cpu"),
                                    "span_id": r.get("id"),
                                    "parent": r.get("parent")}})
        elif ev == "point":
            events.append({"ph": "i", "name": r["name"], "cat": r["cat"]
                           or "point", "ts": r["ts"], "pid": 0, "tid": 0,
                           "s": "g", "args": r.get("args", {})})
        elif ev == "counters":
            events.append({"ph": "i", "name": "trace.counters",
                           "cat": "__footer__", "ts": r["ts"], "pid": 0,
                           "tid": 0, "s": "g",
                           "args": {"values": r["values"],
                                    "gauges": r.get("gauges", {}),
                                    "histograms": r.get("histograms", {})}})
        elif ev == "meta":
            events.append({"ph": "M", "name": "trace_meta", "pid": 0,
                           "args": {"version": r.get("version"),
                                    "clock": r.get("clock")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _from_chrome(obj: dict) -> list[dict]:
    """Inverse of :func:`to_chrome` (lossless for our own exports)."""
    records: list[dict] = []
    for e in obj.get("traceEvents", []):
        ph = e.get("ph")
        if ph == "M":
            records.insert(0, {"ev": "meta", **e.get("args", {})})
        elif ph == "X":
            args = dict(e.get("args", {}))
            cpu = args.pop("cpu_us", None)
            sid = args.pop("span_id", None)
            parent = args.pop("parent", 0)
            records.append({"ev": "span", "name": e["name"],
                            "cat": e.get("cat", ""), "ts": e["ts"],
                            "dur": e["dur"], "cpu": cpu, "id": sid,
                            "parent": parent, "tid": e.get("tid", 0),
                            "args": args})
        elif ph == "i" and e.get("cat") == "__footer__":
            a = e.get("args", {})
            records.append({"ev": "counters", "ts": e["ts"],
                            "values": a.get("values", {}),
                            "gauges": a.get("gauges", {}),
                            "histograms": a.get("histograms", {})})
        elif ph == "i":
            records.append({"ev": "point", "name": e["name"],
                            "cat": e.get("cat", ""), "ts": e["ts"],
                            "args": e.get("args", {})})
    return records
