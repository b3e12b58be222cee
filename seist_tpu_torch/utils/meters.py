"""Latency histogram behind the server's /metrics and the metrics bus's
histograms (the port's copy of ``seist_tpu/utils/meters.py::LatencyHistogram``)."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence, Tuple

#: Default latency buckets (ms): roughly log-spaced from sub-ms dispatch to
#: multi-second stalls, the range an online inference service spans.
LATENCY_BOUNDS_MS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
    500.0, 1000.0, 2000.0, 5000.0, 10000.0,
)


class LatencyHistogram:
    """Fixed-bucket histogram with percentile estimates: O(1) observe,
    O(buckets) quantile, bounded memory regardless of traffic volume.

    Thread-safe: serve handler threads observe concurrently with /metrics
    reads. Percentiles are estimated by linear interpolation inside the
    owning bucket; values above the last bound are clamped to the largest
    observed value.
    """

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS_MS):
        self._bounds = [float(b) for b in bounds]
        if self._bounds != sorted(self._bounds):
            raise ValueError(f"bounds must be sorted, got {bounds}")
        self._counts = [0] * (len(self._bounds) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (q in [0, 1])."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total, mx = self._count, self._max
        return self._percentile_from(q, counts, total, mx)

    def _percentile_from(
        self, q: float, counts: List[int], total: int, mx: float
    ) -> float:
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) else mx
                frac = (rank - seen) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(est, mx)
            seen += c
        return mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def buckets(self) -> Tuple[List[float], List[int], int, float]:
        """Consistent snapshot ``(bounds, counts, count, sum)``; counts has
        ``len(bounds) + 1`` entries (the last is the overflow), the raw view
        that ``obs/bus.py`` renders as cumulative Prometheus buckets."""
        with self._lock:
            return list(self._bounds), list(self._counts), self._count, self._sum

    def summary(self) -> Dict[str, float]:
        """{count, mean, p50, p90, p99, max} from ONE locked snapshot, so
        the fields are mutually consistent under concurrent observes."""
        with self._lock:
            counts = list(self._counts)
            total, sm, mx = self._count, self._sum, self._max
        return {
            "count": float(total),
            "mean": sm / total if total else 0.0,
            "p50": self._percentile_from(0.50, counts, total, mx),
            "p90": self._percentile_from(0.90, counts, total, mx),
            "p99": self._percentile_from(0.99, counts, total, mx),
            "max": mx,
        }
