"""Per-request tracing: W3C ``traceparent`` IDs, the spans a request
records in this process, a bounded ring with tail-based retention, and
``GET /traces`` (the port's copy of ``seist_tpu/obs/trace.py``; header
formats, span names and JSON shapes are the JAX package's).

* IDs: ``00-<32 hex trace id>-<16 hex span id>-01``, minted by the first
  hop that sees the request and passed on in the ``traceparent`` header;
  the header's span id is the parent of this hop's root span.
* :class:`RequestTrace`: one request's spans here, a root span and its
  children (``with rt.span("parse"):``, or ``rt.add_child("queue_wait",
  dur_ms, ...)`` for a duration measured elsewhere). They also render as
  the ``Server-Timing`` response header.
* :class:`TraceBuffer`: the process's bounded ring (``BUFFER``). Traces
  flagged ``error``, ``shed``, ``retried``, ``hedged`` or ``slo_breach``
  are always kept and evicted last; the others are sampled by a hash of
  the trace id (``SEIST_TRACE_SAMPLE``, default 1.0), so every process of
  a fleet keeps the same subset. ``SEIST_TRACE_CAPACITY`` (default 256)
  bounds the ring; ``SEIST_TRACE_SLO_MS`` (0: off) flags slow requests.
* Flush scope: one batcher flush serves many requests with one forward;
  :func:`flush_scope` carries the flush's member traces through it on a
  thread-local, so ``serve/pool.py`` annotates the shared ``forward``
  span (program, replayed graph or not, variant) without plumbing.

A traced request (root, five children, commit) costs microseconds of host
time and reads nothing from the device.
"""

from __future__ import annotations

import contextlib
import os
import re
import secrets
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from seist_tpu_torch.obs.bus import monotonic

#: The propagation header (W3C Trace Context name; we use its 00-...-01
#: shape but do not implement the full spec's tracestate).
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


def mint_traceparent() -> str:
    """A fresh edge-minted traceparent (sampled flag always 01 — the
    retention decision is tail-based, per buffer, not head-based)."""
    return f"00-{_new_trace_id()}-{_new_span_id()}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """-> (trace_id, span_id) or None for a missing/malformed header
    (a malformed header starts a fresh trace rather than erroring the
    request — tracing must never fail traffic)."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # all-zero ids are invalid per the W3C shape
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# --------------------------------------------------------- process identity
def replica_ordinal() -> Optional[int]:
    """The fleet ordinal the supervisor assigned this process
    (``SEIST_SERVE_REPLICA``), or None outside a fleet."""
    raw = os.environ.get("SEIST_SERVE_REPLICA", "")
    try:
        return int(raw)
    except ValueError:
        return None


def replica_suffix() -> str:
    """``"_r<N>"`` inside a fleet, else ``""`` — the disambiguator for
    per-replica observability artifacts sharing one ``--logdir``
    (``events_r0.jsonl``, ``flight_<reason>_r0_<pid>_<seq>.json``):
    N replicas must never interleave or clobber one another's files."""
    n = replica_ordinal()
    return f"_r{n}" if n is not None else ""


def process_label() -> str:
    """The ``process`` tag of recorded spans: ``replica-<N>`` in a fleet,
    else ``proc-<pid>``."""
    n = replica_ordinal()
    return f"replica-{n}" if n is not None else f"proc-{os.getpid()}"


# --------------------------------------------------------------- the buffer
class _Entry:
    __slots__ = ("spans", "flags", "committed", "created")

    def __init__(self) -> None:
        self.spans: List[Dict[str, Any]] = []
        self.flags: set = set()
        self.committed = False
        self.created = monotonic()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


class TraceBuffer:
    """Bounded per-process ring of trace span segments with tail-based
    retention. Thread-safe: handler threads, the batcher flush thread and
    scrape threads all touch it concurrently."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        sample: Optional[float] = None,
        max_spans_per_trace: int = 64,
    ):
        if capacity is None:
            capacity = int(_env_float("SEIST_TRACE_CAPACITY", 256))
        if sample is None:
            sample = _env_float("SEIST_TRACE_SAMPLE", 1.0)
        self.capacity = max(1, int(capacity))
        self.sample = min(1.0, max(0.0, float(sample)))
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.process = process_label()
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Entry]" = OrderedDict()
        self._kept = 0
        self._dropped = 0
        self._evicted = 0

    # ------------------------------------------------------------ recording
    def add_span(self, trace_id: str, span: Dict[str, Any]) -> None:
        span.setdefault("process", self.process)
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = _Entry()
                self._traces[trace_id] = entry
                self._evict_locked()
            if len(entry.spans) < self.max_spans_per_trace:
                entry.spans.append(span)

    def flag(self, trace_id: str, *flags: str) -> None:
        """Flags decide retention, so flagging must work before any span
        was recorded: a missing entry is created."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = _Entry()
                self._traces[trace_id] = entry
                self._evict_locked()
            entry.flags.update(flags)

    def flags(self, trace_id: str) -> frozenset:
        with self._lock:
            entry = self._traces.get(trace_id)
            return frozenset(entry.flags) if entry is not None else frozenset()

    def sampled(self, trace_id: str) -> bool:
        """Deterministic keep-verdict from the trace id alone, so every
        process in the fleet keeps the SAME unflagged subset and a kept
        trace always stitches end to end."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        try:
            frac = int(trace_id[:8], 16) / float(0xFFFFFFFF)
        except ValueError:
            return False
        return frac < self.sample

    def commit(self, trace_id: str) -> bool:
        """The request is over: decide retention. Flagged traces are
        always kept; unflagged ones survive only the deterministic
        sample. Returns whether the trace was kept."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return False
            entry.committed = True
            if not entry.flags and not self.sampled(trace_id):
                del self._traces[trace_id]
                self._dropped += 1
                return False
            self._kept += 1
            self._evict_locked()
            return True

    def _evict_locked(self) -> None:
        while len(self._traces) > self.capacity:
            victim = None
            # Oldest committed-unflagged first, then oldest committed
            # (flagged), then — only if everything is still in flight —
            # the oldest open entry (bounds a leak of never-committed
            # traces).
            for tid, e in self._traces.items():
                if e.committed and not e.flags:
                    victim = tid
                    break
            if victim is None:
                for tid, e in self._traces.items():
                    if e.committed:
                        victim = tid
                        break
            if victim is None:
                victim = next(iter(self._traces))
            del self._traces[victim]
            self._evicted += 1

    # ----------------------------------------------------------- exposition
    def index(self) -> List[Dict[str, Any]]:
        """Newest-first trace index (the GET /traces payload body)."""
        with self._lock:
            items = [
                (tid, list(e.spans), sorted(e.flags), e.committed)
                for tid, e in self._traces.items()
            ]
        out = []
        for tid, spans, flags, committed in reversed(items):
            t0s = [s["t0"] for s in spans]
            ends = [s["t0"] + s["dur_ms"] / 1e3 for s in spans]
            out.append({
                "trace_id": tid,
                "flags": flags,
                "spans": len(spans),
                "committed": committed,
                "t0": min(t0s) if t0s else 0.0,
                "dur_ms": round((max(ends) - min(t0s)) * 1e3, 3)
                if t0s else 0.0,
            })
        return out

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The GET /traces/<id> payload: this process's segments."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = [dict(s) for s in entry.spans]
            flags = sorted(entry.flags)
        return {
            "trace_id": trace_id,
            "process": self.process,
            "flags": flags,
            "spans": spans,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "open": sum(
                    1 for e in self._traces.values() if not e.committed
                ),
                "resident": len(self._traces),
                "kept": self._kept,
                "dropped": self._dropped,
                "evicted": self._evicted,
            }

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._traces.clear()
            self._kept = self._dropped = self._evicted = 0


#: Process singleton every serve/obs surface records into and every
#: /traces endpoint reads from.
BUFFER = TraceBuffer()


def register_trace_collector(bus=None) -> None:
    """Publish the buffer's retention counters on the metrics bus
    (``seist_trace_*``). Called by the serve and train entry points (not
    at import: importing the module must not mutate the bus)."""
    if bus is None:
        from seist_tpu_torch.obs.bus import BUS as bus
    bus.register_collector("trace", BUFFER.stats)


# ----------------------------------------------------------- request traces
def _sanitize_token(name: str) -> str:
    out = "".join(c if (c.isalnum() or c in "_-") else "_" for c in name)
    return out or "span"


class _SpanHandle:
    """Yielded by :meth:`RequestTrace.span`; ``annotate`` adds fields to
    the span while it is open."""

    __slots__ = ("name", "annotations")

    def __init__(self, name: str, annotations: Dict[str, Any]):
        self.name = name
        self.annotations = annotations

    def annotate(self, **fields: Any) -> None:
        self.annotations.update(fields)


class RequestTrace:
    """One request's span recorder in one process.

    Created from the upstream ``traceparent`` header (or minting a fresh
    trace when there is none); the header's span-id becomes this
    process's root-span parent. Children append to the process
    :data:`BUFFER` immediately; :meth:`finish` closes the root span,
    applies status-derived flags and makes the tail-retention decision.
    Thread-safe (the batcher flush thread records children concurrently
    with the handler thread)."""

    def __init__(
        self,
        traceparent: Optional[str] = None,
        name: str = "request",
        buffer: Optional[TraceBuffer] = None,
        process: Optional[str] = None,
        slo_ms: Optional[float] = None,
    ):
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            self.trace_id, self.upstream_span_id = parsed
            self.minted_here = False
        else:
            self.trace_id = _new_trace_id()
            self.upstream_span_id = None
            self.minted_here = True
        self.root_span_id = _new_span_id()
        self.name = name
        self._buffer = buffer if buffer is not None else BUFFER
        # A span's ``process`` tag when it is not the buffer's own (the
        # router's spans in the supervisor's process say "router").
        self._process = process
        self._slo_ms = (
            slo_ms
            if slo_ms is not None
            else _env_float("SEIST_TRACE_SLO_MS", 0.0)
        )
        self._lock = threading.Lock()
        self._segments: List[Tuple[str, float]] = []
        self._annotations: Dict[str, Any] = {}  # the root span's (model, tier, ...)
        self._finished = False
        self.dur_ms: Optional[float] = None
        self._t0_mono = monotonic()
        self._t0_wall = time.time()  # timestamp only; intervals are mono

    # ------------------------------------------------------------- identity
    @property
    def traceparent(self) -> str:
        """The header value identifying THIS hop (echoed on responses so
        a client that didn't mint can still fetch the trace)."""
        return format_traceparent(self.trace_id, self.root_span_id)

    # ------------------------------------------------------------ recording
    @contextlib.contextmanager
    def span(self, name: str, **annotations: Any) -> Iterator[_SpanHandle]:
        """Time a child span; exceptions still close (and annotate) it
        before propagating — a shed verdict is exactly an exception path
        we want on the trace."""
        handle = _SpanHandle(name, dict(annotations))
        t0_wall = time.time()
        t0 = monotonic()
        try:
            yield handle
        except BaseException as e:
            handle.annotations.setdefault("error", type(e).__name__)
            raise
        finally:
            self._record(name, (monotonic() - t0) * 1e3, t0_wall,
                         handle.annotations)

    def add_child(self, name: str, dur_ms: float, span_id: Optional[str] = None,
                  **annotations: Any) -> None:
        """Record a child span whose duration was measured elsewhere
        (the batcher's queue wait / flush forward). The wall start stamp
        is back-dated by the measured duration. ``span_id`` keeps an id
        the caller minted beforehand (the router's attempt span, sent
        downstream as the replica's parent)."""
        self._record(name, float(dur_ms), time.time() - dur_ms / 1e3, dict(annotations),
                     span_id=span_id)

    def _record(self, name: str, dur_ms: float, t0_wall: float,
                annotations: Dict[str, Any], span_id: Optional[str] = None) -> None:
        with self._lock:
            if self._finished:
                # A straggler (an abandoned batcher item flushing after
                # the caller already timed out and finished the trace):
                # the retention verdict is in; drop the late segment.
                return
            self._segments.append((name, dur_ms))
        span = {
            "span_id": span_id or _new_span_id(),
            "parent_id": self.root_span_id,
            "name": name,
            "t0": round(t0_wall, 6),
            "dur_ms": round(dur_ms, 3),
        }
        if annotations:
            span["annotations"] = annotations
        if self._process:
            span["process"] = self._process
        self._buffer.add_span(self.trace_id, span)

    def annotate(self, **fields: Any) -> None:
        """Annotate the root span (the request's model, tier, station)."""
        with self._lock:
            self._annotations.update(fields)

    def flag(self, *flags: str) -> None:
        with self._lock:
            if self._finished:
                # The retention verdict is in; a late flag (hedge-drain
                # straggler) must not resurrect a dropped trace.
                return
        self._buffer.flag(self.trace_id, *flags)

    # ------------------------------------------------------------- finishing
    def finish(self, status: Optional[int] = None) -> float:
        """Close the root span, derive flags from ``status`` (0/5xx ->
        ``error`` unless the trace is a deliberate ``shed``), check the
        SLO-breach threshold, and commit the retention decision.
        Idempotent."""
        with self._lock:
            if self._finished:
                return self.dur_ms or 0.0
            self._finished = True
            dur_ms = (monotonic() - self._t0_mono) * 1e3
            self.dur_ms = dur_ms
            annotations: Dict[str, Any] = dict(self._annotations)
        if status is not None:
            annotations["status"] = int(status)
        span = {
            "span_id": self.root_span_id,
            "parent_id": self.upstream_span_id,
            "name": self.name,
            "t0": round(self._t0_wall, 6),
            "dur_ms": round(dur_ms, 3),
            "root": True,
        }
        if annotations:
            span["annotations"] = annotations
        if self._process:
            span["process"] = self._process
        self._buffer.add_span(self.trace_id, span)
        if status is not None and (status == 0 or status >= 500):
            # A shed 503 is a deliberate policy verdict, not a failure;
            # it keeps its own flag.
            if "shed" not in self._buffer.flags(self.trace_id):
                self._buffer.flag(self.trace_id, "error")
        if self._slo_ms > 0 and dur_ms > self._slo_ms:
            self._buffer.flag(self.trace_id, "slo_breach")
        self._buffer.commit(self.trace_id)
        return dur_ms

    def server_timing(self) -> str:
        """``Server-Timing``-style header value: ``total`` plus every
        recorded child segment, millisecond durations."""
        with self._lock:
            segments = list(self._segments)
            total = (
                self.dur_ms
                if self.dur_ms is not None
                else (monotonic() - self._t0_mono) * 1e3
            )
        parts = [f"total;dur={total:.1f}"]
        parts.extend(
            f"{_sanitize_token(name)};dur={dur:.1f}"
            for name, dur in segments
        )
        return ", ".join(parts)


class NullTrace:
    """No-op stand-in so instrumented call sites never branch on ``if
    trace is not None`` (offline tools, tests, untraced requests)."""

    trace_id = ""
    root_span_id = ""
    minted_here = False

    @contextlib.contextmanager
    def span(self, name: str, **annotations: Any) -> Iterator[_SpanHandle]:
        yield _SpanHandle(name, {})

    def add_child(self, name: str, dur_ms: float, **annotations) -> None:
        pass

    def annotate(self, **fields: Any) -> None:
        pass

    def flag(self, *flags: str) -> None:
        pass

    def finish(self, status: Optional[int] = None) -> float:
        return 0.0

    def server_timing(self) -> str:
        return ""


NULL = NullTrace()


def ensure(trace: Optional[RequestTrace]) -> Any:
    """``trace or NULL`` with the type spelled out at call sites."""
    return trace if trace is not None else NULL


# -------------------------------------------------------------- flush scope
class _FlushScope:
    """One micro-batch flush's trace set + shared annotations (filled by
    serve/pool.py while the forward runs)."""

    __slots__ = ("traces", "annotations")

    def __init__(self, traces: Sequence[Any]):
        self.traces = [t for t in traces if t is not None]
        self.annotations: Dict[str, Any] = {}


_TLS = threading.local()


@contextlib.contextmanager
def flush_scope(traces: Sequence[Any]) -> Iterator[_FlushScope]:
    """Carry a flush's member traces through the batched forward on a
    thread-local, so device-side code (pool programs) can annotate the
    shared span without threading trace objects through model code.
    Nests (an /annotate window loop inside a flush keeps the outer
    scope on exit)."""
    scope = _FlushScope(traces)
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = scope
    try:
        yield scope
    finally:
        _TLS.scope = prev


def annotate_flush(**fields: Any) -> None:
    """Attach fields to the current flush's shared forward span (no-op
    outside a flush — warm-up, offline tools, the train plane)."""
    scope = getattr(_TLS, "scope", None)
    if scope is not None:
        scope.annotations.update(fields)


def in_flush() -> bool:
    return getattr(_TLS, "scope", None) is not None


# ------------------------------------------------------------ HTTP payloads
def handle_traces_path(
    path: str, buffer: Optional[TraceBuffer] = None
) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Shared routing for the ``/traces`` endpoints of the HTTP shims
    (the serve replica, the train ``--metrics-port``): returns
    ``(status, json_payload)`` for a trace route, ``None`` when ``path``
    is not one. Query strings are stripped uniformly — one place decides
    the trace-id parse, so the shims cannot drift."""
    p = path.split("?", 1)[0]
    if p == "/traces":
        return 200, index_payload(buffer)
    if p.startswith("/traces/"):
        payload = trace_payload(p[len("/traces/"):], buffer)
        if payload is None:
            return 404, {"error": "unknown_trace", "message": p}
        return 200, payload
    return None


def index_payload(buffer: Optional[TraceBuffer] = None) -> Dict[str, Any]:
    buffer = buffer if buffer is not None else BUFFER
    return {
        "process": buffer.process,
        "sample": buffer.sample,
        "capacity": buffer.capacity,
        "stats": buffer.stats(),
        "traces": buffer.index(),
    }


def trace_payload(
    trace_id: str, buffer: Optional[TraceBuffer] = None
) -> Optional[Dict[str, Any]]:
    buffer = buffer if buffer is not None else BUFFER
    return buffer.get(trace_id)
