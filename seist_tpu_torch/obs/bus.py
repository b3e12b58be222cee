"""Process-wide metrics bus: counters, gauges, histograms, a span API for
timing phases, Prometheus text exposition and a JSONL event log (the
port's copy of ``seist_tpu/obs/bus.py``; metric names, the ``seist``
prefix, the snapshot's JSON shape and the exposition text are the JAX
package's, so one scraper reads both).

* :class:`MetricsBus`: a registry of :class:`Counter`, :class:`Gauge` and
  :class:`Histogram` keyed by name and labels. ``BUS`` is the process's.
* Spans: ``with BUS.span("checkpoint_save"):`` times a phase on
  ``time.monotonic()``, observes it into the ``<name>_ms`` histogram and
  hands it to every span sink (the flight recorder is one).
  ``BUS.begin(name)`` is the form whose end is called explicitly.
* Collectors: callables read at scrape time (the data-plane guard's
  counters, each serve batcher's stats), flattened into samples.
* :func:`render_prometheus`: text exposition 0.0.4 of the whole bus.
* :class:`EventLog`: append-only JSONL of structured events.

A span costs two ``monotonic()`` calls, a dictionary lookup and one locked
histogram observe: microseconds on the host, and it reads nothing from the
device.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from seist_tpu_torch.utils.meters import LATENCY_BOUNDS_MS, LatencyHistogram

#: Histogram bounds of span durations (ms): the serve latency ladder, from
#: sub-ms host waits to multi-second saves.
SPAN_BOUNDS_MS = LATENCY_BOUNDS_MS

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def monotonic() -> float:
    """The bus clock: every interval of the telemetry plane reads it."""
    return time.monotonic()


@contextlib.contextmanager
def stopwatch() -> Iterator[Callable[[], float]]:
    """``with stopwatch() as elapsed:``: ``elapsed()`` returns the seconds
    since entry, inside the block and after it. Registered on no bus."""
    t0 = monotonic()
    done: List[float] = []

    def elapsed() -> float:
        return (done[0] if done else monotonic()) - t0

    try:
        yield elapsed
    finally:
        done.append(monotonic())


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins value (Prometheus ``gauge``)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(LatencyHistogram):
    """A bus-registered :class:`LatencyHistogram` (the serve payload keeps
    its shape); adds the registry identity."""

    def __init__(self, name: str, labels: Dict[str, str],
                 bounds: Sequence[float] = SPAN_BOUNDS_MS):
        super().__init__(bounds=bounds)
        self.name = name
        self.labels = labels


class Span:
    """One timed phase: a context manager, or ``s = bus.begin(...)`` then
    ``s.end()``. ``duration_s`` is set at the end."""

    __slots__ = ("name", "labels", "_bus", "_t0", "duration_s")

    def __init__(self, bus: "MetricsBus", name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._bus = bus
        self._t0 = monotonic()
        self.duration_s: Optional[float] = None

    def end(self) -> float:
        """Stop the clock, record on the bus, return the seconds; a second
        call returns the first duration."""
        if self.duration_s is None:
            self.duration_s = monotonic() - self._t0
            self._bus._record_span(self)
        return self.duration_s

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class MetricsBus:
    """Metric registry keyed by name and labels, span sinks and collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], Any] = {}
        self._collectors: Dict[str, Tuple[Callable[[], Dict[str, Any]], Dict[str, str],
                                          str]] = {}
        self._span_sinks: List[Callable[[Span], None]] = []

    # ------------------------------------------------------------ metrics
    def _get(self, cls, name: str, labels: Dict[str, Any], **kw) -> Any:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, {k: str(v) for k, v in labels.items()}, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric '{name}' already registered as {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Sequence[float] = SPAN_BOUNDS_MS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    # -------------------------------------------------------------- spans
    def span(self, name: str, **labels) -> Span:
        """Start a span now; use it as a context manager."""
        return Span(self, name, labels)

    begin = span  # the explicit begin/end form: same object

    def _record_span(self, span: Span) -> None:
        self.histogram(f"{span.name}_ms", **span.labels).observe((span.duration_s or 0.0) * 1e3)
        # A copy under the lock: another thread may install or remove a
        # sink (a flight recorder swapped on a death path) meanwhile.
        with self._lock:
            sinks = list(self._span_sinks)
        for sink in sinks:
            try:
                sink(span)
            except Exception:  # noqa: BLE001 - a sick sink must not break the timed code
                pass

    def add_span_sink(self, sink: Callable[[Span], None]) -> None:
        with self._lock:
            if sink not in self._span_sinks:
                self._span_sinks.append(sink)

    def remove_span_sink(self, sink: Callable[[Span], None]) -> None:
        with self._lock:
            if sink in self._span_sinks:
                self._span_sinks.remove(sink)

    # --------------------------------------------------------- collectors
    def register_collector(self, key: str, fn: Callable[[], Dict[str, Any]],
                           name: Optional[str] = None, **labels) -> None:
        """Register a scrape-time source: ``fn`` returns a (nested) dict of
        numbers; a key registered again replaces its collector. ``name``
        is the metric-name prefix (default the key), so per-instance keys
        can share one family told apart by ``labels``."""
        with self._lock:
            self._collectors[key] = (fn, {k: str(v) for k, v in labels.items()}, name or key)

    def unregister_collector(self, key: str,
                             fn: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
        """Remove a collector; with ``fn``, only while it is still the one
        registered (a replaced instance's late shutdown leaves its
        successor in place)."""
        with self._lock:
            cur = self._collectors.get(key)
            if cur is None or (fn is not None and cur[0] != fn):
                return
            self._collectors.pop(key, None)

    def _collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        """The collectors' samples: (name, labels, value)."""
        with self._lock:
            collectors = dict(self._collectors)
        out: List[Tuple[str, Dict[str, str], float]] = []
        for fn, labels, name in collectors.values():
            try:
                data = fn()
            except Exception:  # noqa: BLE001 - one sick collector must not fail the scrape
                continue
            for sample_name, value in _flatten(name, data):
                out.append((sample_name, labels, value))
        return out

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of the bus (the ``/metrics.json`` payload and the
        flight recorder's final state). Histograms carry their raw buckets
        (``bounds``, ``bucket_counts``, ``sum``) beside the summary."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            label_sfx = _label_suffix(m.labels)
            if isinstance(m, Counter):
                out["counters"][m.name + label_sfx] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name + label_sfx] = m.value
            elif isinstance(m, Histogram):
                entry = m.summary()
                bounds, counts, _, total_sum = m.buckets()
                entry["bounds"] = bounds
                entry["bucket_counts"] = counts
                entry["sum"] = total_sum
                out["histograms"][m.name + label_sfx] = entry
        out["collectors"] = {name + _label_suffix(labels): value
                             for name, labels, value in self._collect()}
        return out


def _flatten(prefix: str, data: Any) -> List[Tuple[str, float]]:
    out: List[Tuple[str, float]] = []
    if isinstance(data, dict):
        for k, v in data.items():
            out.extend(_flatten(f"{prefix}_{k}", v))
    elif isinstance(data, bool):
        out.append((prefix, 1.0 if data else 0.0))
    elif isinstance(data, (int, float)):
        out.append((prefix, float(data)))
    # Strings and lists are dropped: a Prometheus sample is a number.
    return out


# ------------------------------------------------------------- exposition
def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name).strip("_") or "metric"


def _label_suffix(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_sanitize(k)}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(bus: MetricsBus, prefix: str = "seist") -> str:
    """Prometheus text exposition (format 0.0.4) of the bus: its metrics
    and the collectors' samples. Histograms emit cumulative
    ``_bucket{le=...}`` series, ``_sum`` and ``_count``."""
    lines: List[str] = []
    typed: Dict[str, str] = {}

    def emit(name: str, mtype: str, labels: Dict[str, str], value: float) -> None:
        full = f"{prefix}_{_sanitize(name)}"
        if typed.get(full) is None:
            lines.append(f"# TYPE {full} {mtype}")
            typed[full] = mtype
        lines.append(f"{full}{_prom_labels(labels)} {_fmt(value)}")

    with bus._lock:
        metrics = list(bus._metrics.values())
    for m in metrics:
        if isinstance(m, Counter):
            emit(m.name + "_total", "counter", m.labels, m.value)
        elif isinstance(m, Gauge):
            emit(m.name, "gauge", m.labels, m.value)
    for m in metrics:
        if not isinstance(m, Histogram):
            continue
        bounds, counts, total, total_sum = m.buckets()
        full = f"{prefix}_{_sanitize(m.name)}"
        if typed.get(full) is None:
            lines.append(f"# TYPE {full} histogram")
            typed[full] = "histogram"
        cum = 0
        for bound, c in zip(bounds, counts[:-1]):
            cum += c
            le = 'le="' + _fmt(bound) + '"'
            lines.append(f"{full}_bucket{_prom_labels(m.labels, le)} {cum}")
        inf = 'le="+Inf"'
        lines.append(f"{full}_bucket{_prom_labels(m.labels, inf)} {total}")
        lines.append(f"{full}_sum{_prom_labels(m.labels)} {_fmt(total_sum)}")
        lines.append(f"{full}_count{_prom_labels(m.labels)} {total}")
    # Collector samples are untyped: their source decides what they mean.
    for name, labels, value in bus._collect():
        emit(name, "untyped", labels, value)
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# --------------------------------------------------------------- event log
class EventLog:
    """Append-only JSONL, one ``{"t": <unix seconds>, "event": <kind>,
    ...fields}`` line per event (``t`` is a timestamp; intervals come from
    spans). Line-buffered, not fsynced: forensic context, where the
    flight recorder's dump is the crash record."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def emit(self, event: str, **fields) -> None:
        rec = {"t": round(time.time(), 3), "event": event}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            line = json.dumps({"t": rec["t"], "event": event, "error": "unserializable fields"})
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def timed_iter(iterator, name: str, bus: Optional[MetricsBus] = None, **labels):
    """Wrap an iterator so that every ``next()`` is a recorded span (the
    train loop's ``host_wait``). The end-of-iterator probe is not one."""
    bus = bus if bus is not None else BUS
    it = iter(iterator)
    while True:
        sp = bus.span(name, **labels)
        try:
            item = next(it)
        except StopIteration:
            return
        sp.end()
        yield item


# ------------------------------------------------------------- process bus
BUS = MetricsBus()


def register_default_collectors(bus: Optional[MetricsBus] = None) -> None:
    """Attach the standing sources to ``bus`` (idempotent): the data-plane
    guard's counters, through ``ops/metrics.py::data_plane_counters``."""
    bus = bus if bus is not None else BUS

    def _data_plane() -> Dict[str, int]:
        from seist_tpu_torch.ops.metrics import data_plane_counters

        return data_plane_counters()

    bus.register_collector("data_plane", _data_plane)
