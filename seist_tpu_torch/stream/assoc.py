"""Cross-station association: co-detections -> event hypotheses -> alerts
(the port's copy of ``seist_tpu/stream/assoc.py``: the same alerts, ids
and dedup for the same picks).

A single station's P pick is weak evidence; the early-warning decision
is made by the *network*. The :class:`Associator` keeps a moving window
of recent picks across all stations and, whenever enough distinct
stations co-detect, grid-searches candidate origins over the station
footprint: a hypothesis is the grid node that makes the most picks'
back-projected origin times (``t_pick - dist/velocity``) agree. When the
coherent set reaches ``min_stations``, an :class:`Alert` is emitted and
its contributing picks are consumed (one event does not re-alert as
later phases trickle in).

This is deliberately the coarse end of association — a plane-wave/grid
origin scorer, not a full locator: good enough to separate "N stations
saw the same event" from "N stations each saw noise," deterministic
(fixed grid order, explicit tie-breaks) so the digital twin
can gate on exact alert behavior, and cheap (host-side,
O(picks x grid) per trigger).

Latency accounting: every pick carries its stage stamps (arrival ->
window-due -> queue -> device -> pick); the associator adds
``t_assoc``/``t_alert`` so an alert's ``latency_ms`` breaks the whole
sample->alert budget down per stage.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["AssocConfig", "Alert", "Associator", "StationPick"]

_EARTH_R_KM = 6371.0


@dataclass(frozen=True)
class AssocConfig:
    window_s: float = 30.0  # co-detection window across stations
    min_stations: int = 4  # distinct stations to form an event
    velocity_kms: float = 6.0  # P-wave moveout for back-projection
    grid_step_deg: float = 0.25  # origin search resolution
    margin_deg: float = 0.5  # search bbox margin past the footprint
    tolerance_s: float = 2.0  # origin-time coherence tolerance
    max_recent_alerts: int = 256  # alert ring retained for GET /stream/alerts
    # Exactly-once surface ("alert dedup"): a new
    # hypothesis within dedup_window_s AND one id grid cell of a recent
    # alert is the SAME event re-forming (failover replay, late phases
    # after a WAL'd emit) and is suppressed. Deliberately smaller than
    # any plausible inter-event time at one location — the digital
    # twin's aftershock refractory is 3 s, so distinct events never
    # fall inside the default window.
    dedup_window_s: float = 2.0
    dedup_dist_deg: float = 0.5  # spatial slack: subsets shift the origin
    id_grid_deg: float = 0.25  # alert-id origin cell size
    id_time_bucket_s: float = 5.0  # alert-id origin-time bucket


@dataclass(frozen=True)
class StationPick:
    station_id: str
    network: str
    lat: float
    lon: float
    t_s: float  # pick time in stream seconds (sample / sampling_rate)
    phase: str = "P"
    stamps: Dict[str, float] = field(default_factory=dict)


@dataclass
class Alert:
    event_id: int
    origin_lat: float
    origin_lon: float
    origin_t_s: float  # back-projected origin time (stream seconds)
    n_stations: int
    picks: List[StationPick] = field(default_factory=list)
    t_alert: float = 0.0  # wall-clock emission time
    latency_ms: Dict[str, float] = field(default_factory=dict)
    # Deterministic content-derived id, "ev-<cell>-<bucket>-<hash8>":
    # origin grid cell + origin-time bucket + station-set hash. A
    # failover replay that re-forms the event from the same picks mints
    # the SAME id (a consumer deduping on alert_id counts it once); two
    # replicas alerting on disjoint station subsets share the
    # cell+bucket prefix, which is what consumers group on to count
    # distinct events.
    alert_id: str = ""

    def to_dict(self) -> Dict:
        return {
            "event_id": self.event_id,
            "alert_id": self.alert_id,
            "origin": {
                "lat": round(self.origin_lat, 4),
                "lon": round(self.origin_lon, 4),
                "t_s": round(self.origin_t_s, 3),
            },
            "n_stations": self.n_stations,
            "picks": [
                {
                    "station": p.station_id,
                    "network": p.network,
                    "t_s": round(p.t_s, 3),
                    "phase": p.phase,
                }
                for p in self.picks
            ],
            "latency_ms": {k: round(v, 3) for k, v in self.latency_ms.items()},
        }


def _dist_km(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Equirectangular distance — plenty for regional association and
    monotone in true distance at these scales."""
    la1, la2 = math.radians(lat1), math.radians(lat2)
    dlat = la2 - la1
    dlon = math.radians(lon2 - lon1) * math.cos(0.5 * (la1 + la2))
    return _EARTH_R_KM * math.hypot(dlat, dlon)


class Associator:
    """Thread-safe pick buffer + grid origin scorer. ``add`` returns the
    alert it triggered, if any.

    Exactly-once surface ("never double-counts, never misses"): a
    hypothesis proximate to a recently emitted (or WAL-replayed) alert
    — within ``dedup_window_s`` and ``dedup_dist_deg`` — whose station
    set adds NOTHING over what those alerts already reported is a
    re-emission (the failover-replay signature) and is suppressed: its
    picks are consumed, ``on_dedup`` fires (the mux counts it into
    ``seist_alert_dedup_total``), but no second alert reaches any
    consumer. A proximate hypothesis that carries at least one NEW
    station is a genuine follow-up (a later moveout wave cohering) and
    is emitted — suppressing those would trade a duplicate for a missed
    detection, the wrong side of the alert-tier bargain. With a ``wal``
    attached, every alert is fsync'd to the WAL BEFORE ``add`` returns
    it (durable-before-visible); :meth:`seed_from_wal` replays the log
    after a restart so the dedup window survives the process."""

    def __init__(
        self,
        config: Optional[AssocConfig] = None,
        clock=None,
        wal=None,
        on_dedup=None,
    ) -> None:
        import time

        self.config = config or AssocConfig()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._picks: List[StationPick] = []  # pending, time-ordered-ish
        self._alerts: List[Alert] = []
        self._next_event_id = 1
        self.alerts_total = 0
        self.alerts_deduped = 0
        self.wal = wal  # journal.AlertWAL-shaped: .append(dict), .replay()
        self.on_dedup = on_dedup  # called (no args) per suppressed alert
        # (lat, lon, t0, alert_id, station_ids) of recent emissions,
        # newest last; station_ids accumulate the dedup subset check.
        self._recent_events: List[tuple] = []

    # ------------------------------------------------------------- feed
    def add(self, pick: StationPick) -> Optional[Alert]:
        c = self.config
        with self._lock:
            self._picks.append(pick)
            horizon = pick.t_s - c.window_s
            self._picks = [p for p in self._picks if p.t_s >= horizon]
            if len({p.station_id for p in self._picks}) < c.min_stations:
                return None
            hypo = self._best_origin(self._picks)
            if hypo is None:
                return None
            lat, lon, t0, coherent = hypo
            if len({p.station_id for p in coherent}) < c.min_stations:
                return None
            # Consume the coherent picks either way: a suppressed
            # duplicate must not leave its picks around to re-form the
            # same hypothesis on the very next add().
            consumed = set(id(p) for p in coherent)
            self._picks = [p for p in self._picks if id(p) not in consumed]
            sids = {p.station_id for p in coherent}
            if self._is_duplicate(lat, lon, t0, sids):
                self.alerts_deduped += 1
                hook = self.on_dedup
                if hook is not None:
                    hook()
                return None
            return self._emit(lat, lon, t0, coherent)

    def recent_alerts(self, n: int = 50) -> List[Dict]:
        with self._lock:
            return [a.to_dict() for a in self._alerts[-n:]]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "alerts": float(self.alerts_total),
                "alerts_deduped": float(self.alerts_deduped),
                "pending_picks": float(len(self._picks)),
            }

    # ------------------------------------------------------ exactly-once
    def alert_id_for(self, lat: float, lon: float, t0: float,
                     station_ids) -> str:
        """Deterministic alert id — see :class:`Alert`. Public so the
        chaos lane and consumers can recompute/group ids."""
        import hashlib

        c = self.config
        ci = int(round(lat / c.id_grid_deg))
        cj = int(round(lon / c.id_grid_deg))
        bt = int(math.floor(t0 / c.id_time_bucket_s))
        sids = ",".join(sorted(set(str(s) for s in station_ids)))
        h = hashlib.sha1(sids.encode()).hexdigest()[:8]
        return f"ev-{ci}:{cj}-{bt}-{h}"

    def _is_duplicate(self, lat: float, lon: float, t0: float,
                      sids) -> bool:
        """True iff the hypothesis is proximate to recent emissions AND
        its stations are all already reported by them (union over every
        proximate entry: an event whose picks arrived in two waves has
        two entries, and a replay re-forming from their union must still
        dedup)."""
        c = self.config
        seen: set = set()
        proximate = False
        for rlat, rlon, rt0, _rid, rsids in self._recent_events:
            if (
                abs(t0 - rt0) <= c.dedup_window_s
                and abs(lat - rlat) <= c.dedup_dist_deg
                and abs(lon - rlon) <= c.dedup_dist_deg
            ):
                proximate = True
                seen |= rsids
        return proximate and set(sids) <= seen

    def _note_recent(self, lat: float, lon: float, t0: float,
                     alert_id: str, sids) -> None:
        self._recent_events.append((lat, lon, t0, alert_id,
                                    frozenset(sids)))
        if len(self._recent_events) > 4 * self.config.max_recent_alerts:
            self._recent_events = self._recent_events[
                -self.config.max_recent_alerts :
            ]

    def seed_from_wal(self) -> int:
        """Replay the attached WAL into the dedup window (restart path).
        Returns the number of records seeded. Does not touch
        ``alerts_total`` — these alerts were already counted by the
        process that emitted them."""
        if self.wal is None:
            return 0
        n = 0
        with self._lock:
            for rec in self.wal.replay():
                origin = rec.get("origin") or {}
                try:
                    self._note_recent(
                        float(origin["lat"]),
                        float(origin["lon"]),
                        float(origin["t_s"]),
                        str(rec.get("alert_id") or ""),
                        {str(pk["station"])
                         for pk in rec.get("picks") or []},
                    )
                except (KeyError, TypeError, ValueError):
                    continue
                n += 1
        return n

    # ---------------------------------------------------------- scoring
    def _slack_s(self, step_deg: float) -> float:
        """Origin-time error from grid discretization: the true origin can
        sit half a grid diagonal from the nearest node."""
        return 0.5 * math.sqrt(2.0) * step_deg * 111.19 / self.config.velocity_kms

    def _score(self, picks: List[StationPick], glat: float, glon: float,
               tol: float):
        """(count, -spread, t0, coherent) at one candidate node: how many
        picks' back-projected origin times agree within ``tol`` of their
        median."""
        c = self.config
        ots = sorted(
            (
                (p.t_s - _dist_km(glat, glon, p.lat, p.lon) / c.velocity_kms, p)
                for p in picks
            ),
            key=lambda x: (x[0], x[1].station_id),
        )
        t_med = ots[len(ots) // 2][0]
        coherent = [(ot, p) for ot, p in ots if abs(ot - t_med) <= tol]
        if not coherent:
            return None
        # Residual-weighted soft count: a pick scores 1 at zero residual,
        # 0 at the tolerance edge. A raw count is degenerate — a far-away
        # node compresses moveout until unrelated picks BARELY cohere; a
        # node near the true origin fits fewer-or-equal picks nearly
        # exactly and must win.
        # fsum: exactly-rounded regardless of pairing order, so the score
        # (and the alert IDs downstream of t0) cannot drift by an ulp
        # when the coherent-pick list arrives chunked differently.
        soft = math.fsum(1.0 - abs(ot - t_med) / tol for ot, _ in coherent)
        spread = coherent[-1][0] - coherent[0][0]
        t0 = math.fsum(ot for ot, _ in coherent) / len(coherent)
        return (soft, len(coherent), -spread, t0, [p for _, p in coherent])

    def _best_origin(self, picks: List[StationPick]):
        """Deterministic two-stage grid search. The coarse pass needs its
        coherence tolerance widened by the discretization slack — but that
        widened tolerance is exactly what lets a far-away node fake
        coherence for unrelated picks (back-projected times compress with
        distance). So the coarse pass only NOMINATES nodes (top-8 by
        count/spread); the fine pass (step/5, proportionally tighter
        slack) around each nominee makes the final coherence decision.
        Ties break to the smaller spread, then grid order."""
        c = self.config
        lats = [p.lat for p in picks]
        lons = [p.lon for p in picks]
        lat0, lat1 = min(lats) - c.margin_deg, max(lats) + c.margin_deg
        lon0, lon1 = min(lons) - c.margin_deg, max(lons) + c.margin_deg
        step = c.grid_step_deg
        coarse_tol = c.tolerance_s + self._slack_s(step)
        steps = lambda a, b: max(1, int(round((b - a) / step)) + 1)
        scored = []
        for i in range(steps(lat0, lat1)):
            glat = lat0 + i * step
            for j in range(steps(lon0, lon1)):
                glon = lon0 + j * step
                got = self._score(picks, glat, glon, coarse_tol)
                if got is not None:
                    scored.append((got[0], got[1], got[2], i, j, glat, glon))
        if not scored:
            return None
        scored.sort(key=lambda s: (-s[0], -s[1], -s[2], s[3], s[4]))
        fine_step = step / 5.0
        fine_tol = c.tolerance_s + self._slack_s(fine_step)
        best = None  # ((soft, count, -spread), lat, lon, t0, coherent)
        for _, _, _, _, _, nlat, nlon in scored[:8]:
            for di in range(-5, 6):
                for dj in range(-5, 6):
                    glat = nlat + di * fine_step
                    glon = nlon + dj * fine_step
                    got = self._score(picks, glat, glon, fine_tol)
                    if got is None:
                        continue
                    soft, count, nspread, t0, coherent = got
                    key = (soft, count, nspread)
                    if best is None or key > best[0]:
                        best = (key, glat, glon, t0, coherent)
        if best is None:
            return None
        _, glat, glon, t0, coherent = best
        return glat, glon, t0, coherent

    def _emit(self, lat, lon, t0, coherent: List[StationPick]) -> Alert:
        now = self._clock()
        latency: Dict[str, float] = {}
        # Per-stage budget: worst (max) stage latency over contributing
        # picks — the straggler is what the alert actually waited on.
        for a, b, name in (
            ("arrival", "due", "arrival_to_due"),
            ("due", "submitted", "due_to_queue"),
            ("submitted", "returned", "queue_device"),
            ("returned", "picked", "pick"),
        ):
            vals = [
                (p.stamps[b] - p.stamps[a]) * 1000.0
                for p in coherent
                if a in p.stamps and b in p.stamps
            ]
            if vals:
                latency[name] = max(vals)
        picked = [p.stamps.get("picked") for p in coherent]
        picked = [t for t in picked if t is not None]
        if picked:
            latency["association"] = (now - max(picked)) * 1000.0
        arrivals = [p.stamps.get("arrival") for p in coherent]
        arrivals = [t for t in arrivals if t is not None]
        if arrivals:
            latency["sample_to_alert"] = (now - min(arrivals)) * 1000.0
        alert = Alert(
            event_id=self._next_event_id,
            origin_lat=lat,
            origin_lon=lon,
            origin_t_s=t0,
            n_stations=len({p.station_id for p in coherent}),
            picks=sorted(coherent, key=lambda p: (p.t_s, p.station_id)),
            t_alert=now,
            latency_ms=latency,
            alert_id=self.alert_id_for(
                lat, lon, t0, (p.station_id for p in coherent)
            ),
        )
        self._next_event_id += 1
        self.alerts_total += 1
        self._alerts.append(alert)
        if len(self._alerts) > self.config.max_recent_alerts:
            self._alerts = self._alerts[-self.config.max_recent_alerts :]
        self._note_recent(lat, lon, t0, alert.alert_id,
                          (p.station_id for p in coherent))
        if self.wal is not None:
            # Durable-before-visible: the WAL line lands (fsync) before
            # any caller can observe the alert. A crash right here
            # re-forms and re-suppresses on replay; a crash after is a
            # delivered alert that replay dedups. Either way the
            # consumer sees exactly one.
            self.wal.append(alert.to_dict())
        return alert
