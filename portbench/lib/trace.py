"""Device traces: ``torch.profiler`` over a stretch of a lane's timed calls,
reduced to what the per-layer readers need.

The traced stretch is one ``record_function("portbench.window")`` span
that ends in a synchronise. From the Chrome trace the profiler writes:

* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside that span; ``window_s``: the span's length;
* the device seconds and launches of every kernel name;
* the idle gaps inside the span (where no device interval lies), each
  named by the innermost host event under its midpoint (gaps under
  ``SHORT_GAP_US`` together, as the launch gaps between kernels). The
  host events are the profiler's, and, where the caller gives the
  program's metrics bus, the bus's spans (``batch_infer_decode``, ...),
  placed by the monotonic clock read as the traced span opens.

A trace that misses kernels (the profiler's first traces in a process
sometimes do) is taken again: the caller gives the launches it expects of
a kernel pattern per call.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
#: Idle gaps shorter than this (us) are counted together, unnamed.
SHORT_GAP_US = 20.0
#: Host events searched back from a gap for the innermost one under it.
LOOKBACK = 4000


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


class Summary:
    """A reduced trace (module docstring). Times in seconds. ``bus_spans``:
    (name, start, end) host spans in microseconds from the traced span's
    start."""

    def __init__(self, events: List[Dict], calls: int,
                 bus_spans: Sequence[Tuple[str, float, float]] = ()):
        self.calls = calls
        spans = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not spans:
            raise RuntimeError("the trace holds no portbench.window span")
        w = max(spans, key=lambda e: float(e["dur"]))
        lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
               for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        dev = [d for d in dev if d[1] > lo and d[0] < hi]
        self.window_s = (hi - lo) * 1e-6
        self.busy_s = union_length([(a, b) for a, b, _ in dev], lo, hi) * 1e-6
        self.kernels: Dict[str, List[float]] = {}
        for a, b, name in dev:
            k = self.kernels.setdefault(name, [0.0, 0])
            k[0] += (b - a) * 1e-6
            k[1] += 1
        host = sorted([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                        e.get("name", "")) for e in events
                       if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                       and e.get("name") != WINDOW]
                      + [(lo + a, lo + b, name) for name, a, b in bus_spans])
        starts = [h[0] for h in host]
        by_host: Dict[str, float] = {}
        for a, b in gaps([(x, y) for x, y, _ in dev], lo, hi):
            if b - a < SHORT_GAP_US:
                name = f"gaps under {SHORT_GAP_US:g} us (between kernels)"
            else:
                mid = 0.5 * (a + b)
                at = bisect.bisect_right(starts, mid)
                under = [h for h in host[max(0, at - LOOKBACK):at] if h[1] >= mid]
                name = min(under, key=lambda h: h[1] - h[0])[2] if under else "no host event"
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
        self.idle_by_host = by_host

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names match."""
        rx = re.compile(pattern)
        secs, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if rx.search(name):
                secs += s
                n += int(c)
        return secs, n

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(((k, v[0]) for k, v in self.kernels.items()), key=lambda kv: -kv[1])
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, s] for k, s in ops[:top]],
                "idle_gaps": [[k, s] for k, s in idle[:top]]}


def _profile_once(fn: Callable[[], None], calls: int, sync: Callable[[], None],
                  tmpdir: str, span_bus: Optional[Any] = None) -> Summary:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    spans: List[Tuple[str, float, float]] = []

    def sink(span) -> None:  # called as a span ends
        end = time.monotonic()
        spans.append((span.name, end - span.duration_s, end))

    if span_bus is not None:
        span_bus.add_span_sink(sink)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                opened = time.monotonic()
                for _ in range(calls):
                    fn()
                sync()
    finally:
        if span_bus is not None:
            span_bus.remove_span_sink(sink)
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    torch.cuda.synchronize()
    return Summary(events, calls, [(name, (a - opened) * 1e6, (b - opened) * 1e6)
                                   for name, a, b in spans])


def profile_calls(fn: Callable[[], None], calls: int, sync: Callable[[], None], tmpdir: str,
                  expect: Optional[Dict[str, int]] = None, attempts: int = 3,
                  span_bus: Optional[Any] = None) -> Summary:
    """Trace ``calls`` calls of ``fn`` after one throwaway trace of one
    call. ``expect`` maps a kernel pattern to its launches per call; a
    trace that holds other counts is taken again, up to ``attempts``
    times, and the last one raises. ``span_bus``: the program's metrics bus
    (``add_span_sink``/``remove_span_sink``), whose spans name idle gaps."""
    _profile_once(fn, 1, sync, tmpdir)
    for attempt in range(attempts):
        s = _profile_once(fn, calls, sync, tmpdir, span_bus)
        wrong = {p: (s.kernel_seconds(p)[1], n * calls) for p, n in (expect or {}).items()
                 if s.kernel_seconds(p)[1] != n * calls}
        if not wrong:
            return s
    names = [k for k, _ in s.breakdown(8)["device_ops"]]
    raise RuntimeError(f"profiler traces keep missing kernels: {wrong} (found, expected); "
                       f"the top kernels: {names}")
