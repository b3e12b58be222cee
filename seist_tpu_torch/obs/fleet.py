"""Fleet metrics aggregation: merge N replicas' bus snapshots (plus the
router's) into one pane — ``GET /fleet/metrics`` on the fleet supervisor.

The port's copy of ``seist_tpu/obs/fleet.py``. A fleet's
observability is per-process on its own: N
``/metrics`` endpoints nobody aggregates. The ROADMAP's autoscaling
control plane and the canary-rollback path both need ONE signal source
(fleet-wide queue delay, per-replica error deltas) — this module is that
single pane:

* :class:`FleetAggregator` — named *sources* (a replica base URL whose
  ``/metrics.json`` is scraped, or a callable returning a bus snapshot
  for the in-process router), scraped periodically on a background
  thread and on demand when a read finds the view stale.
* **Merging** — counters and gauges sum across live sources; histograms
  merge **bucket-wise** (summing per-bucket counts, then re-deriving
  percentiles from the merged distribution — averaging per-replica p99s
  would be statistically meaningless, which is why ``bus.snapshot()``
  ships raw ``bounds``/``bucket_counts``). The per-source breakdown is
  retained verbatim next to the aggregate.
* **Exposition** — ``merged()`` is the JSON view
  (``/fleet/metrics.json``); :meth:`render_prometheus` emits every
  sample with a ``replica`` label (``replica="fleet"`` for the
  aggregate, the source name for the breakdown) plus
  ``seist_fleet_source_up{source=...}`` liveness.

Stdlib + obs only — neither torch nor numpy: the aggregator runs in the (model-free)
supervisor/router process. A failed scrape marks the source down and
excludes it from the aggregate (no ghost counters from a dead replica);
it rejoins on the next successful scrape.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from seist_tpu_torch.obs.bus import _escape, _fmt, _sanitize, monotonic
from seist_tpu_torch.utils.logger import logger
from seist_tpu_torch.utils.meters import LatencyHistogram

Source = Union[str, Callable[[], Dict[str, Any]]]


def _split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``'serve_batcher_submitted{model=phasenet}'`` ->
    ``('serve_batcher_submitted', {'model': 'phasenet'})`` — the inverse
    of ``bus._label_suffix``."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class FleetAggregator:
    """See module docstring. Thread-safe; scrapes never hold the data
    lock across network I/O (lockgraph-clean: results are swapped in
    under the lock only after every fetch returned)."""

    def __init__(self, interval_s: float = 5.0, timeout_s: float = 2.0):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._sources: Dict[str, Source] = {}
        self._lock = threading.Lock()
        self._results: Dict[str, Dict[str, Any]] = {}
        self._last_scrape = 0.0  # monotonic; 0 = never
        self._scrapes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- sources
    def add_source(self, name: str, target: Source) -> None:
        """Register a source: a replica base URL (``host:port`` or
        ``http://host:port`` — ``/metrics.json`` is appended) or a
        callable returning a bus snapshot (the in-process router)."""
        with self._lock:
            self._sources[name] = target

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)
            self._results.pop(name, None)

    # ------------------------------------------------------------- scraping
    def _fetch(self, target: Source) -> Dict[str, Any]:
        if callable(target):
            return target()
        hostport = str(target).split("://", 1)[-1].rstrip("/")
        conn = http.client.HTTPConnection(hostport, timeout=self.timeout_s)
        try:
            conn.request("GET", "/metrics.json")
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise OSError(f"/metrics.json -> {resp.status}")
            snap = json.loads(payload.decode())
            if not isinstance(snap, dict):
                raise ValueError("snapshot is not a JSON object")
            return snap
        finally:
            conn.close()

    def scrape_once(self) -> None:
        """Pull every source once; store per-source result. No lock is
        held while fetching (network I/O), so concurrent scrapes are
        allowed and last-write-wins — the merge reads one consistent
        stored set either way."""
        with self._lock:
            sources = dict(self._sources)
        results: Dict[str, Dict[str, Any]] = {}
        for name, target in sources.items():
            try:
                snap = self._fetch(target)
                results[name] = {"up": True, "snapshot": snap, "error": ""}
            except (OSError, ValueError, http.client.HTTPException) as e:
                results[name] = {
                    "up": False, "snapshot": None,
                    "error": f"{type(e).__name__}: {e}",
                }
        with self._lock:
            # Keep results only for sources still registered (a source
            # removed mid-scrape must not resurrect).
            self._results = {
                n: r for n, r in results.items() if n in self._sources
            }
            self._last_scrape = monotonic()
            self._scrapes += 1

    def _refresh_if_stale(self) -> None:
        with self._lock:
            stale = (
                self._last_scrape == 0.0
                or monotonic() - self._last_scrape > self.interval_s
            )
        if stale:
            self.scrape_once()

    # ----------------------------------------------------------- background
    def start(self) -> None:
        """Periodic scraping on a daemon thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-aggregator", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        # A dead aggregator silently freezes the fleet pane the
        # autoscaler reads; say so loudly (threadlint thread-target-raises).
        try:
            while not self._stop.is_set():
                try:
                    self.scrape_once()
                except Exception as e:  # noqa: BLE001 — one bad cycle
                    # must not end aggregation forever
                    logger.warning(f"[fleet] scrape cycle failed: {e!r}")
                self._stop.wait(self.interval_s)
        except BaseException:
            logger.exception(
                "[fleet] aggregator thread died — /fleet/metrics is "
                "frozen until the supervisor restarts"
            )
            raise

    # -------------------------------------------------------------- merging
    def merged(self, refresh: bool = True) -> Dict[str, Any]:
        """The ``/fleet/metrics.json`` payload: aggregate + per-source
        breakdown + liveness. ``refresh`` scrapes first when the stored
        view is older than the scrape interval."""
        if refresh:
            self._refresh_if_stale()
        with self._lock:
            results = {
                n: dict(r) for n, r in self._results.items()
            }
            scrapes = self._scrapes
        aggregate: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {},
            "collectors": {},
        }
        skipped: List[str] = []
        for name, res in results.items():
            snap = res.get("snapshot")
            if not res.get("up") or not isinstance(snap, dict):
                continue
            for family in ("counters", "gauges", "collectors"):
                for key, value in (snap.get(family) or {}).items():
                    if isinstance(value, (int, float)) and not isinstance(
                        value, bool
                    ):
                        agg = aggregate[family]
                        agg[key] = agg.get(key, 0.0) + float(value)
            for key, entry in (snap.get("histograms") or {}).items():
                if not isinstance(entry, dict):
                    continue
                merged = _merge_histogram(
                    aggregate["histograms"].get(key), entry
                )
                if merged is None:
                    skipped.append(f"{name}:{key}")
                else:
                    aggregate["histograms"][key] = merged
        for entry in aggregate["histograms"].values():
            _finalize_histogram(entry)
        return {
            "scraped_at": round(time.time(), 3),
            "scrapes": scrapes,
            "sources": {
                n: {"up": r.get("up", False), "error": r.get("error", "")}
                for n, r in results.items()
            },
            "up": sum(1 for r in results.values() if r.get("up")),
            "aggregate": aggregate,
            "replicas": {
                n: r.get("snapshot") for n, r in results.items()
            },
            # Bucket-ladder mismatches cannot merge bucket-wise; they are
            # reported, never silently averaged.
            "skipped_histograms": skipped,
        }

    # ----------------------------------------------------------- exposition
    def render_prometheus(self, refresh: bool = True) -> str:
        """Prometheus text exposition of the fleet: every sample labeled
        ``replica="<source>"`` plus the aggregate as ``replica="fleet"``
        (so ``sum()`` over the breakdown and the pre-merged series never
        double-count under one unlabeled name)."""
        view = self.merged(refresh=refresh)
        lines: List[str] = []
        typed: Dict[str, str] = {}

        def sample(name: str, labels: Dict[str, str], value: float,
                   extra: str = "") -> None:
            """One sample line, no metadata (histogram component series
            must NOT get their own # TYPE lines — same shape as
            bus.render_prometheus)."""
            parts = [
                f'{_sanitize(k)}="{_escape(str(v))}"'
                for k, v in sorted(labels.items())
            ]
            if extra:
                parts.append(extra)
            label_str = "{" + ",".join(parts) + "}" if parts else ""
            lines.append(
                f"seist_{_sanitize(name)}{label_str} {_fmt(float(value))}"
            )

        def emit(name: str, mtype: str, labels: Dict[str, str],
                 value: float, extra: str = "") -> None:
            full = f"seist_{_sanitize(name)}"
            if typed.get(full) is None:
                lines.append(f"# TYPE {full} {mtype}")
                typed[full] = mtype
            sample(name, labels, value, extra)

        def emit_snapshot(snap: Dict[str, Any], replica: str) -> None:
            for key, value in (snap.get("counters") or {}).items():
                name, labels = _split_key(key)
                labels["replica"] = replica
                emit(name + "_total", "counter", labels, value)
            for key, value in (snap.get("gauges") or {}).items():
                name, labels = _split_key(key)
                labels["replica"] = replica
                emit(name, "gauge", labels, value)
            for key, entry in (snap.get("histograms") or {}).items():
                if not isinstance(entry, dict):
                    continue
                bounds = entry.get("bounds")
                counts = entry.get("bucket_counts")
                name, labels = _split_key(key)
                labels["replica"] = replica
                if not bounds or not counts:
                    emit(name + "_count", "untyped", labels,
                         entry.get("count", 0.0))
                    continue
                full = f"seist_{_sanitize(name)}"
                if typed.get(full) is None:
                    lines.append(f"# TYPE {full} histogram")
                    typed[full] = "histogram"
                cum = 0
                for bound, c in zip(bounds, counts[:-1]):
                    cum += c
                    sample(name + "_bucket", labels, cum,
                           extra='le="' + _fmt(float(bound)) + '"')
                total = int(sum(counts))
                sample(name + "_bucket", labels, total, extra='le="+Inf"')
                sample(name + "_sum", labels, entry.get("sum", 0.0))
                sample(name + "_count", labels, total)
            for key, value in (snap.get("collectors") or {}).items():
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    continue
                name, labels = _split_key(key)
                labels["replica"] = replica
                emit(name, "untyped", labels, value)

        for name, res in view["sources"].items():
            emit("fleet_source_up", "gauge", {"source": name},
                 1.0 if res["up"] else 0.0)
        emit("fleet_sources", "gauge", {}, len(view["sources"]))
        emit_snapshot(view["aggregate"], "fleet")
        for name, snap in view["replicas"].items():
            if isinstance(snap, dict):
                emit_snapshot(snap, name)
        return "\n".join(lines) + "\n"


def _merge_histogram(
    acc: Optional[Dict[str, Any]], entry: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Fold one source's histogram entry into the accumulator.
    Bucket-wise when both sides carry matching bucket ladders; count /
    sum / max stay mergeable regardless. Returns None (skip) on a
    bucket-ladder mismatch."""
    fresh = {
        "count": float(entry.get("count", 0.0)),
        "sum": float(entry.get("sum",
                               entry.get("mean", 0.0)
                               * entry.get("count", 0.0))),
        "max": float(entry.get("max", 0.0)),
        "bounds": list(entry.get("bounds") or []),
        "bucket_counts": list(entry.get("bucket_counts") or []),
    }
    if acc is None:
        return fresh
    if acc["bounds"] != fresh["bounds"]:
        return None
    acc["count"] += fresh["count"]
    acc["sum"] += fresh["sum"]
    acc["max"] = max(acc["max"], fresh["max"])
    if acc["bucket_counts"] and fresh["bucket_counts"]:
        acc["bucket_counts"] = [
            a + b
            for a, b in zip(acc["bucket_counts"], fresh["bucket_counts"])
        ]
    return acc


def _finalize_histogram(entry: Dict[str, Any]) -> None:
    """Re-derive the summary fields of a merged histogram from its
    merged buckets (the whole point of bucket-wise merging: fleet p99 is
    computed over the union distribution, never averaged)."""
    total = int(entry.get("count", 0))
    entry["mean"] = entry["sum"] / total if total else 0.0
    bounds = entry.get("bounds") or []
    counts = entry.get("bucket_counts") or []
    if bounds and counts:
        h = LatencyHistogram(bounds)
        for q, key in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
            entry[key] = h._percentile_from(
                q, counts, total, entry.get("max", 0.0)
            )
