"""StationMux: thousands of StreamSessions through ONE model tenant (the
port's copy of ``seist_tpu/stream/mux.py``, with its metric names).

Sessions are host-side state (ring buffer + stitch accumulators, a few
hundred KB each); the device never learns stations exist. Every due
window is submitted through the serve replica's MicroBatcher as an
ordinary single-window request, so thousands of stations' windows
coalesce into the SAME captured bucket programs the /predict path
replays; nothing new is captured.

Concurrency model: one lock per station keeps each session's
push -> submit -> integrate sequence ordered (a session is not
thread-safe); different stations proceed in parallel, and the batcher
flush is where their windows meet. A packet's handler thread blocks in
``submit`` exactly like a /predict caller — per-station backpressure is
the batcher's bounded queue + the shed ladder, surfaced per station:

* a QueueFull/Overloaded on a due window counts into
  ``windows_dropped`` and marks the session DEGRADED (its stitched
  curve now has a coverage hole; picks remain well-defined — the mean
  stitch divides by actual hits — but the offline-parity pin no longer
  holds for that station), and the error propagates so the transport
  returns 429/503 and the station backs off;
* duplicate packets (``seq`` <= last seen) are dropped idempotently;
  sequence gaps are counted but the stream continues (the session
  stitches what actually arrived).

Stage stamps (arrival -> due -> queue -> device -> pick) ride every
emitted pick into the associator, which completes the
sample -> alert latency budget.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.stream.assoc import Associator, StationPick
from seist_tpu_torch.stream.session import SessionConfig, StreamSession

__all__ = ["MuxClosed", "MuxConfig", "StationMux", "StationLimit"]


class StationLimit(Exception):
    """New station rejected: the mux is at ``max_stations``."""


class MuxClosed(Exception):
    """Packet rejected: the mux is shut down (``close_all`` ran).

    The structured answer to the close-vs-feed race: a feed that loses
    the race gets THIS (the server maps it to 503 shutting_down, which
    the router retries on a survivor) — it never integrates into a
    session that shutdown already journaled and released."""


@dataclass(frozen=True)
class MuxConfig:
    session: SessionConfig = field(default_factory=SessionConfig)
    max_stations: int = 4096
    idle_timeout_s: float = 900.0  # reap sessions idle this long
    journal_every_s: float = 5.0  # per-station journal cadence (with journal)
    model: str = ""  # metrics label


class _Entry:
    __slots__ = (
        "session", "lock", "last_seq", "degraded", "dropped",
        "duplicates", "gaps", "last_feed", "station", "closed",
        "last_journal",
    )

    def __init__(self, session: StreamSession, station: Dict[str, object]):
        self.session = session
        self.lock = threading.Lock()
        self.last_seq: Optional[int] = None
        self.degraded = False
        self.dropped = 0
        self.duplicates = 0
        self.gaps = 0
        self.last_feed = 0.0
        self.station = station
        self.closed = False
        self.last_journal = 0.0


class StationMux:
    """Funnel per-station packets into due windows, through ``submit``
    (the batcher), back into sessions, and picks into the associator.

    ``submit``: (window, C) float32 -> (window, 3) float32 probabilities
    — typically ``lambda x: batcher.submit(x, timeout_ms=...)[0]``.
    """

    def __init__(
        self,
        submit: Callable[[np.ndarray], np.ndarray],
        config: MuxConfig,
        assoc: Optional[Associator] = None,
        clock: Callable[[], float] = time.monotonic,
        journal=None,  # journal.StationJournal; None = no durability
    ) -> None:
        self.config = config
        self.assoc = assoc or Associator()
        self._submit = submit
        self._clock = clock
        self._journal = journal
        self._lock = threading.Lock()
        self._closed = False
        self._entries: Dict[str, _Entry] = {}
        self._counts = {
            "packets": 0, "windows": 0, "windows_dropped": 0,
            "duplicates": 0, "gaps": 0, "picks": 0, "alerts": 0,
            "alerts_deduped": 0, "journal_writes": 0, "restores": 0,
            "restores_failed": 0,
            "sessions_opened": 0, "sessions_closed": 0, "sessions_reaped": 0,
        }
        lbl = {"model": config.model or "default"}
        # Counter names WITHOUT the _total suffix: the prometheus
        # renderer appends it (seist_stream_packets_total on the wire).
        self._m_packets = BUS.counter("stream_packets", **lbl)
        self._m_windows = BUS.counter("stream_windows", **lbl)
        self._m_dropped = BUS.counter("stream_windows_dropped", **lbl)
        self._m_dups = BUS.counter("stream_duplicate_packets", **lbl)
        self._m_gaps = BUS.counter("stream_sequence_gaps", **lbl)
        self._m_picks = BUS.counter("stream_picks", **lbl)
        self._m_alerts = BUS.counter("assoc_alerts", **lbl)
        self._m_dedup = BUS.counter("alert_dedup", **lbl)
        self._m_journal = BUS.counter("stream_journal_writes", **lbl)
        self._m_restores = BUS.counter("stream_session_restores", **lbl)
        self._m_restore_failed = BUS.counter("stream_restore_failed", **lbl)
        self._m_sessions = BUS.gauge("stream_sessions", **lbl)
        self._m_window_ms = BUS.histogram("stream_window_latency_ms", **lbl)
        self._m_alert_ms = BUS.histogram("assoc_sample_to_alert_ms", **lbl)
        if self.assoc.on_dedup is None:
            # Surface the associator's exactly-once suppressions as
            # seist_alert_dedup_total. Lock order stays acyclic: the
            # hook runs under assoc._lock and takes mux._lock — the
            # established order is entry.lock -> assoc._lock ->
            # mux._lock, and nothing takes them the other way around
            # (stats() reads the associator AFTER dropping mux._lock).
            self.assoc.on_dedup = self._on_dedup

    def _on_dedup(self) -> None:
        self._count("alerts_deduped", self._m_dedup)

    # ------------------------------------------------------------- feed
    def feed(
        self,
        station: Mapping[str, object],
        data: np.ndarray,
        *,
        seq: Optional[int] = None,
        end: bool = False,
        t_arrival: Optional[float] = None,
    ) -> Dict[str, object]:
        """Process one packet for ``station`` (needs at least ``id``;
        ``lat``/``lon`` enable association). Returns the per-packet
        result: windows run, newly final picks, any alerts triggered."""
        sid = str(station.get("id") or "")
        if not sid:
            raise ValueError("station.id is required")
        now = self._clock()
        t_arrival = now if t_arrival is None else t_arrival
        entry = self._entry_for(sid, station)
        with entry.lock:
            if entry.closed:
                # Lost the race against close_all(): the session was
                # journaled and released; integrating now would mutate
                # state the failover successor has already adopted.
                raise MuxClosed(f"station mux closed (station {sid!r})")
            entry.last_feed = now
            self._count("packets", self._m_packets)
            if seq is not None:
                if entry.last_seq is not None and seq <= entry.last_seq:
                    entry.duplicates += 1
                    self._count("duplicates", self._m_dups)
                    return self._result(sid, entry, duplicate=True)
                if entry.last_seq is not None and seq > entry.last_seq + 1:
                    entry.gaps += 1
                    self._count("gaps", self._m_gaps)
                entry.last_seq = seq
            sess = entry.session
            picks = {"ppk": [], "spk": [], "det": []}
            alerts: List[Dict] = []
            n_windows = 0
            due = sess.push(np.asarray(data, np.float32))
            if end:
                due = due + sess.finish()
            for i, w in enumerate(due):
                n_windows += 1
                try:
                    self._run_window(entry, w, t_arrival, picks, alerts)
                except Exception:
                    # The batcher refused this window; the transport is
                    # about to surface that. The REST of this packet's
                    # due windows would otherwise sit in _pending
                    # forever (the retried packet is a duplicate seq and
                    # is dropped idempotently) — abandon them too, so
                    # the frontier keeps moving past the coverage hole.
                    for w2 in due[i + 1 :]:
                        self._abandon_window(
                            entry, w2.offset, t_arrival, picks, alerts
                        )
                    raise
            if end:
                t_fin = self._clock()
                tail = sess.finalize()
                self._merge(picks, tail)
                self._route_picks(entry, tail, alerts, stamps={
                    "arrival": t_arrival, "due": t_fin, "submitted": t_fin,
                    "returned": t_fin, "picked": t_fin,
                })
                self._close(sid, "sessions_closed")
            n_picks = sum(len(v) for v in picks.values())
            if n_picks:
                self._count("picks", self._m_picks, n_picks)
            if (
                self._journal is not None
                and not end
                and now - entry.last_journal >= self.config.journal_every_s
            ):
                self._journal_entry(sid, entry, now)
            return self._result(
                sid, entry, windows=n_windows, picks=picks, alerts=alerts,
                closed=end,
            )

    # ------------------------------------------------------- inspection
    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {k: float(v) for k, v in self._counts.items()}
            out["sessions"] = float(len(self._entries))
            out["degraded_sessions"] = float(
                sum(1 for e in self._entries.values() if e.degraded)
            )
        out.update({f"assoc_{k}": v for k, v in self.assoc.stats().items()})
        return out

    def reap_idle(self) -> int:
        """Drop sessions idle past ``idle_timeout_s`` (no tail forward —
        an idle station's final partial window is stale by definition;
        the journal goes with it, so a resurrected station re-warms
        fresh instead of restoring ancient state)."""
        cutoff = self._clock() - self.config.idle_timeout_s
        reaped: List[str] = []
        with self._lock:
            for sid in [
                s for s, e in self._entries.items() if e.last_feed < cutoff
            ]:
                del self._entries[sid]
                self._counts["sessions_reaped"] += 1
                reaped.append(sid)
            self._m_sessions.set(float(len(self._entries)))
        if self._journal is not None:
            for sid in reaped:
                self._journal.remove(sid)
        return len(reaped)

    def close_all(self) -> None:
        """Shut the mux down for good: drain or reject every in-flight
        feed, journal each session's final state (the failover handoff),
        release the registry. Three phases so the lock order stays
        acyclic (feed holds entry.lock and then takes mux._lock inside
        ``_count`` — close_all must NEVER hold mux._lock while waiting
        on an entry lock, or the two deadlock):

        1. under mux._lock: latch ``_closed`` (new stations bounce with
           :class:`MuxClosed`), snapshot the entries;
        2. per entry, under entry.lock only: waiting for the lock IS the
           drain — an in-flight feed finishes its push -> submit ->
           integrate sequence first; then mark the entry closed (a feed
           that was still waiting on the lock rejects on wake) and
           journal the now-quiescent session;
        3. under mux._lock: clear the registry.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._entries.items())
        now = self._clock()
        for sid, entry in entries:
            with entry.lock:
                entry.closed = True
                self._journal_entry(sid, entry, now)
        with self._lock:
            self._counts["sessions_closed"] += len(self._entries)
            self._entries.clear()
            self._m_sessions.set(0.0)

    @property
    def n_sessions(self) -> int:
        with self._lock:
            return len(self._entries)

    # ---------------------------------------------------------- innards
    def _entry_for(self, sid: str, station: Mapping[str, object]) -> _Entry:
        with self._lock:
            if self._closed:
                raise MuxClosed("station mux closed")
            entry = self._entries.get(sid)
            if entry is None:
                if len(self._entries) >= self.config.max_stations:
                    raise StationLimit(
                        f"station mux at capacity ({self.config.max_stations})"
                    )
                entry = self._restored_entry_locked(sid, station)
                if entry is None:
                    entry = _Entry(
                        StreamSession(self.config.session), dict(station)
                    )
                self._entries[sid] = entry
                self._counts["sessions_opened"] += 1
                self._m_sessions.set(float(len(self._entries)))
            else:
                # Latest metadata wins (a station can learn its coords late).
                for k in ("network", "lat", "lon"):
                    if k in station:
                        entry.station[k] = station[k]
            return entry

    def _restored_entry_locked(
        self, sid: str, station: Mapping[str, object]
    ) -> Optional[_Entry]:
        """Failover adoption: a station this mux has never seen whose
        journal exists was homed on a dead replica — resume its session
        at the journal watermark. Any failure (corrupt file, version
        skew, config drift) falls back to a fresh session: the stream
        plane already stitches through sequence gaps, so re-warming is
        degraded, not broken. Called under ``self._lock`` (first packet
        of a station only), so counters are bumped inline."""
        if self._journal is None:
            return None
        state = self._journal.load(sid)
        if state is None:
            return None
        try:
            sess = StreamSession.restore(state)
            if sess.config != self.config.session:
                raise ValueError("journaled config != mux session config")
        except Exception:  # noqa: BLE001 - journal loss => fresh session
            self._counts["restores_failed"] += 1
            self._m_restore_failed.inc()
            return None
        mx = state["meta"].get("mux") or {}
        st = dict(mx.get("station") or {})
        st.update(station)
        entry = _Entry(sess, st)
        last_seq = mx.get("last_seq")
        entry.last_seq = None if last_seq is None else int(last_seq)
        entry.degraded = bool(mx.get("degraded", False))
        entry.dropped = int(mx.get("dropped", 0))
        entry.duplicates = int(mx.get("duplicates", 0))
        entry.gaps = int(mx.get("gaps", 0))
        self._counts["restores"] += 1
        self._m_restores.inc()
        return entry

    def _journal_entry(self, sid: str, entry: _Entry, now: float) -> None:
        """Write one station's journal record (caller holds entry.lock,
        so the session is quiescent — no pending windows). Best-effort:
        a failed write costs durability, not the stream."""
        if self._journal is None or entry.session._finished:
            return
        try:
            state = entry.session.snapshot()
            state["meta"]["mux"] = {
                "last_seq": entry.last_seq,
                "station": dict(entry.station),
                "degraded": entry.degraded,
                "dropped": entry.dropped,
                "duplicates": entry.duplicates,
                "gaps": entry.gaps,
            }
            self._journal.write(sid, state)
        except Exception:  # noqa: BLE001 - durability is best-effort
            return
        entry.last_journal = now
        self._count("journal_writes", self._m_journal)

    def _run_window(self, entry, w, t_arrival, picks, alerts) -> None:
        t_due = self._clock()
        try:
            t_sub = self._clock()
            probs = self._submit(w.data)
            t_ret = self._clock()
        except Exception:
            # Backpressure: the batcher queue (QueueFull) or the shed
            # ladder (Overloaded) refused the window. The curve keeps a
            # coverage hole; parity for this station is gone — say so.
            self._abandon_window(entry, w.offset, t_arrival, picks, alerts)
            raise
        probs = np.asarray(probs, np.float32)
        if probs.ndim == 3:  # batcher returns the leading-dim-1 slice
            probs = probs[0]
        got = entry.session.integrate(w.offset, probs)
        t_picked = self._clock()
        self._count("windows", self._m_windows)
        self._m_window_ms.observe((t_ret - t_sub) * 1000.0)
        stamps = {
            "arrival": t_arrival, "due": t_due, "submitted": t_sub,
            "returned": t_ret, "picked": t_picked,
        }
        self._merge(picks, got)
        self._route_picks(entry, got, alerts, stamps=stamps)

    def _abandon_window(
        self, entry, offset, t_arrival, picks, alerts
    ) -> None:
        """Account a refused window and un-wedge the finality frontier:
        without ``session.abandon`` the offset would gate finality
        forever and the station never emits another pick. Picks that
        became final across the new coverage hole still flow to the
        associator — a degraded station keeps contributing."""
        entry.dropped += 1
        entry.degraded = True
        self._count("windows_dropped", self._m_dropped)
        try:
            got = entry.session.abandon(offset)
        except Exception:  # noqa: BLE001 - the transport error wins
            return
        t_now = self._clock()
        self._merge(picks, got)
        self._route_picks(entry, got, alerts, stamps={
            "arrival": t_arrival, "due": t_now, "submitted": t_now,
            "returned": t_now, "picked": t_now,
        })

    def _route_picks(self, entry, got, alerts, stamps) -> None:
        """P picks with known coordinates go to the associator."""
        if stamps is None:
            return
        st = entry.station
        lat, lon = st.get("lat"), st.get("lon")
        if lat is None or lon is None:
            return
        fs = self.config.session.sampling_rate
        for p in got.get("ppk", ()):
            alert = self.assoc.add(
                StationPick(
                    station_id=str(st.get("id")),
                    network=str(st.get("network") or ""),
                    lat=float(lat),
                    lon=float(lon),
                    t_s=p / fs,
                    phase="P",
                    stamps=dict(stamps),
                )
            )
            if alert is not None:
                alerts.append(alert.to_dict())
                self._count("alerts", self._m_alerts)
                s2a = alert.latency_ms.get("sample_to_alert")
                if s2a is not None:
                    self._m_alert_ms.observe(s2a)

    @staticmethod
    def _merge(into: Dict[str, list], got: Dict[str, list]) -> None:
        for k in ("ppk", "spk", "det"):
            into[k].extend(got.get(k, ()))

    def _close(self, sid: str, key: str) -> None:
        with self._lock:
            if sid in self._entries:
                del self._entries[sid]
                self._counts[key] += 1
                self._m_sessions.set(float(len(self._entries)))
        if self._journal is not None:
            # A cleanly finished stream needs no failover handoff.
            self._journal.remove(sid)

    def _count(self, key: str, metric, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n
        metric.inc(n)

    def _result(self, sid, entry, windows=0, picks=None, alerts=None,
                duplicate=False, closed=False) -> Dict[str, object]:
        return {
            "station": sid,
            "windows": windows,
            "picks": picks or {"ppk": [], "spk": [], "det": []},
            "alerts": alerts or [],
            "duplicate": duplicate,
            "closed": closed,
            "degraded": entry.degraded,
            "dropped_windows": entry.dropped,
            "n_samples": entry.session.n_samples,
        }
